"""Multi-host distributed k-min-mer pipeline.

Scales the reference's thread-pool data parallelism (reference
src/main.rs:65-79: file split across OS threads, one closure per record) to
multiple hosts/processes:

  * `jax.distributed` runtime; ONE global mesh over every device of every
    host, `data` axis.
  * Per-global-batch record sharding: batch g covers records
    [g*B, g*B + B); each host packs ONLY the rows its local devices own
    (contiguous block) with the native reader, then assembles the global
    array with `jax.make_array_from_process_local_data` — no host ever
    materializes another host's reads.
  * The jitted step is the same shard_map pipeline as single-host
    (driver.make_dp_pipeline): the only cross-device traffic is the
    counts-only all-gather (4 bytes/read) that assigns every read its base
    offset in the globally ordered output stream.
  * Ordered merge WITHOUT moving records across hosts: each host stitches
    its own rows into an ordered chunk (driver.stitch_records rebased by
    the chunk's first global offset); concatenating the per-host chunks in
    host order IS the global stream.  Each host can write its chunk + a
    manifest entry; nothing big ever crosses DCN.

Run one process per host, e.g.:

    python -m seq2kminmers.parallel.multihost \
        --coordinator host0:9876 --num-processes 2 --process-id $RANK \
        --out-dir /shared/out reads.fa
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import List, Optional

import numpy as np


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize the jax.distributed runtime.  Returns True if a
    multi-process runtime was started (False for single-process runs, where
    initialization is skipped and everything degrades to one host)."""
    import jax

    if num_processes in (None, 1):
        return False
    jax.distributed.initialize(
        coordinator_address, num_processes=num_processes,
        process_id=process_id,
    )
    return True


def global_data_mesh():
    """1-D 'data' mesh over every device of every process.  jax.devices()
    orders devices grouped by process, so P('data') row-blocks are
    contiguous per host."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), ("data",))


def _addressable_rows(arr) -> np.ndarray:
    """Concatenate this process's shards of a global row-sharded array, in
    row order."""
    shards = sorted(
        arr.addressable_shards, key=lambda s: s.index[0].start or 0
    )
    return np.concatenate([np.asarray(s.data) for s in shards], axis=0)


@dataclasses.dataclass
class HostChunk:
    """This host's piece of the globally ordered stream for one batch."""

    batch_index: int
    first_record: int  # global index of this chunk's first read row
    stream_start: int  # global stream offset of this chunk's first element
    records: dict  # stitch_records struct-of-arrays (local chunk)
    batch_total: int  # k-min-mers in the WHOLE batch (all hosts)


def run_file_distributed(
    path,
    spec,
    mesh=None,
    rows_per_device: int = 8,
    max_len: Optional[int] = None,
    threads: int = 0,
    out_dir: Optional[str] = None,
    progress: bool = False,
) -> List[HostChunk]:
    """Enumerate k-min-mers of a FASTA/FASTQ file across all hosts.

    Every process calls this with the same arguments (same file visible on
    each host).  Returns this host's ordered chunks; if out_dir is given,
    also writes one .npz per (host, batch) plus a host-0 manifest that
    records the global order and stream offsets.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..constants import XCODE_PAD, family_of_mode
    from ..io.fasta import FastaFile
    from ..ops.u64 import to_py_u64
    from .driver import make_dp_pipeline, stitch_records

    if mesh is None:
        mesh = global_data_mesh()
    n_dev = int(mesh.devices.size)
    proc = jax.process_index()
    nproc = jax.process_count()
    ldev = n_dev // nproc
    local_rows = ldev * rows_per_device
    B = n_dev * rows_per_device
    row0 = proc * local_rows

    f = FastaFile(path)
    n = len(f)
    if max_len is None:
        # global max over records; every host computes the same value
        max_len = f.max_seq_len()
    pad = max(1024, -(-max_len // 1024) * 1024)
    if spec.max_minimizers is None:
        spec = dataclasses.replace(
            spec, max_minimizers=min(pad, int(pad * spec.density * 4) + 256)
        )
    fam = family_of_mode(spec.mode)

    steps = {}  # spec -> jitted sharded step (capacity-escalation cache)

    def step_for(s):
        if s not in steps:
            steps[s] = make_dp_pipeline(s, mesh)
        return steps[s]

    csh = NamedSharding(mesh, P("data", None))
    lsh = NamedSharding(mesh, P("data"))

    chunks: List[HostChunk] = []
    stream_base = 0  # global stream offset of the current batch's start
    out_paths = []
    for g, first in enumerate(range(0, n, B)):
        lfirst = first + row0
        cnt = max(0, min(local_rows, n - lfirst))
        codes = np.full((local_rows, pad), XCODE_PAD, dtype=np.uint8)
        lengths = np.zeros(local_rows, dtype=np.int64)
        if cnt:
            c, ln = f.pack(lfirst, cnt, pad, threads, fam)
            codes[:cnt] = c
            lengths[:cnt] = ln
        gcodes = jax.make_array_from_process_local_data(csh, codes)
        glens = jax.make_array_from_process_local_data(
            lsh, lengths.astype(np.int32)
        )
        # Collective-safe overflow recovery: `res.lost` is a psum, so every
        # process reads the SAME value and takes the same retry path — the
        # capacity escalation below is deterministic, keeping all hosts'
        # compiled steps identical (no divergence/deadlock).  Mirrors the
        # single-host api.kminmers_batch loop; the reference never drops a
        # minimizer (its drain buffers grow per survivor,
        # reference src/nthash_avx512_32.rs:139-141).
        rspec = spec
        for _ in range(8):
            res = step_for(rspec)(gcodes, glens)
            if int(np.asarray(res.lost)) == 0:
                break
            # The psum'd loss flag cannot carry the exact raw count across
            # hosts, so M doubles.
            cur_m = rspec.max_minimizers or rspec.capacity_for(pad)
            rspec = dataclasses.replace(
                rspec, max_minimizers=min(pad, cur_m * 2)
            )
        else:
            raise RuntimeError(
                "minimizer capacity overflow not resolved after 8 "
                "distributed retries"
            )

        b = res.batch
        counts = _addressable_rows(b.n_kminmers)
        bases = _addressable_rows(res.global_offset)
        hashes = to_py_u64(
            (_addressable_rows(b.hash_hi), _addressable_rows(b.hash_lo))
        )
        local_total = int(counts.sum())
        chunk_start = int(bases[0]) if len(bases) else 0
        rec = stitch_records(
            counts,
            bases - chunk_start,
            local_total,
            hashes,
            _addressable_rows(b.start),
            _addressable_rows(b.end),
            _addressable_rows(b.rev),
            read_base=lfirst,
        )
        chunk = HostChunk(
            batch_index=g,
            first_record=lfirst,
            stream_start=stream_base + chunk_start,
            records=rec,
            batch_total=int(np.asarray(res.total)),
        )
        chunks.append(chunk)
        stream_base += chunk.batch_total
        if out_dir is not None:
            p = Path(out_dir)
            p.mkdir(parents=True, exist_ok=True)
            fp = p / f"part-b{g:05d}-h{proc:03d}.npz"
            np.savez_compressed(
                fp,
                stream_start=chunk.stream_start,
                first_record=chunk.first_record,
                **rec,
            )
            out_paths.append(fp.name)
        if progress:
            print(
                f"[host {proc}] batch {g}: reads [{lfirst}, {lfirst + cnt})"
                f" -> {local_total} k-min-mers (batch total"
                f" {chunk.batch_total})",
                flush=True,
            )

    if out_dir is not None and proc == 0:
        manifest = {
            "file": str(path),
            "num_processes": nproc,
            "rows_per_batch": B,
            "num_records": n,
            "total_kminmers": stream_base,
            "spec": {
                "l": spec.l, "k": spec.k, "density": spec.density,
                "mode": spec.mode, "hash_width": spec.hash_width,
                "variant": spec.variant,
            },
            "part_pattern": "part-b{batch:05d}-h{host:03d}.npz",
            "order": "ascending (batch, host); concatenation is the "
            "globally ordered stream",
        }
        (Path(out_dir) / "manifest.json").write_text(
            json.dumps(manifest, indent=2)
        )
    f.close()
    return chunks


def main(argv=None):
    import argparse
    import time

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("fasta")
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--mode", default="regular")
    ap.add_argument("--l", type=int, default=31)
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--density", type=float, default=0.01)
    ap.add_argument("--rows-per-device", type=int, default=8)
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--threads", type=int, default=0)
    args = ap.parse_args(argv)

    init_distributed(args.coordinator, args.num_processes, args.process_id)
    from ..ops.pipeline import PipelineSpec
    from ..runtime import enable_compile_cache

    enable_compile_cache()

    spec = PipelineSpec(
        l=args.l, k=args.k, density=args.density, mode=args.mode
    )
    t0 = time.perf_counter()
    chunks = run_file_distributed(
        args.fasta,
        spec,
        rows_per_device=args.rows_per_device,
        threads=args.threads,
        out_dir=args.out_dir,
        progress=True,
    )
    dt = time.perf_counter() - t0
    local = sum(len(c.records["hash"]) for c in chunks)
    total = sum(c.batch_total for c in chunks)
    import jax

    print(
        f"[host {jax.process_index()}] done in {dt:.3f}s: {local} local / "
        f"{total} total k-min-mers over {len(chunks)} batches"
    )
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
