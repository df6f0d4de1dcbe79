"""Streaming FASTA/FASTQ -> k-min-mer runner: length-bucketed batches with
host/device overlap.

The reference streams records through a thread pool, one closure per record
(reference src/main.rs:65-79).  The device equivalent must batch reads into
static shapes; the two throughput killers for a naive batcher are

  * padding every read to the file-global max length (ruinous for
    mixed-length long-read files), and
  * serial pack -> transfer -> compute (the device idles while the host
    packs the next batch).

This runner fixes both:

  * **Length bucketing**: records are binned by padded length into
    power-of-two buckets (multiples of 1024), so a 2 kb read never pays for
    a 100 kb neighbour.  Rows per batch scale inversely with the bucket pad
    (constant cells per batch), so every bucket compiles exactly ONE
    pipeline shape and loads the device equally.
  * **Pipelined packing**: a producer thread runs the native multithreaded
    packer (io/native/fasta_reader.cpp, s2k_pack16_idx gather-pack) ahead
    of the device through a small bounded queue, so host packing overlaps
    device compute.

Bucketing permutes batch order, not output order: every k-min-mer keeps its
original record id, and `collect()` re-stitches the globally ordered stream
(read 0's k-min-mers, then read 1's, ... — the reference's sequential
iterator order, src/lib.rs:258-259) in O(total) at the end.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..constants import XCODE_PAD, family_of_mode

PAD_QUANTUM = 1024
ROW_QUANTUM = 8

_packed_pipelines: Dict = {}


def _nibble_unpack_expr(jnp, packed):
    """Traced-side nibble unpack: uint8[B, C/2] -> uint8[B, C] (shared by
    the packed pipeline, the retry path, and ops/long_read's step)."""
    lo = packed & jnp.uint8(0xF)
    hi = packed >> jnp.uint8(4)
    return jnp.stack([lo, hi], axis=-1).reshape(
        packed.shape[0], packed.shape[1] * 2
    )


def _cached_packed_pipeline(spec):
    """Jitted pipeline over nibble-packed codes (two 4-bit xcodes per
    byte): the device unpacks, so H2D traffic per batch halves (see
    ops/long_read.py pack_transfer).  Keyed like api._cached_pipeline;
    setdefault keeps one canonical jit object even when the warm thread
    and the dispatch loop race on the first call (two objects would mean
    two compiles of the same program)."""
    fn = _packed_pipelines.get(spec)
    if fn is None:
        import jax
        import jax.numpy as jnp

        from ..ops.pipeline import kminmer_pipeline

        @jax.jit
        def fn(packed, lengths):
            return kminmer_pipeline(
                _nibble_unpack_expr(jnp, packed), lengths, spec
            )

        fn = _packed_pipelines.setdefault(spec, fn)
    return fn


def _unpack_jit(packed):
    """Device-side nibble unpack (rare paths: the overflow-retry rerun).
    The jitted wrapper is cached so repeated retries don't retrace."""
    fn = _packed_pipelines.get("_unpack")
    if fn is None:
        import jax
        import jax.numpy as jnp

        fn = _packed_pipelines.setdefault(
            "_unpack", jax.jit(lambda p: _nibble_unpack_expr(jnp, p))
        )
    return fn(packed)


def plan_buckets(
    lens: np.ndarray,
    target_cells: int = 1 << 25,
    max_rows: int = 1024,
) -> List[Tuple[int, int, np.ndarray]]:
    """Bin record lengths into power-of-two pads (multiples of 1024).

    Returns [(pad, rows_per_batch, record_indices)] with indices ascending
    inside each bucket; rows_per_batch ~ target_cells / pad so batches cost
    the same compute regardless of read length, and each bucket compiles
    one (rows, pad) pipeline shape.  rows_per_batch is also clamped to the
    bucket's actual occupancy (rounded up to the row quantum), so a small
    file never compiles — or runs — a mostly-dead batch shape (a single
    100 kb read gets an [8, 131072] batch, not [256, 131072]).
    """
    lens = np.asarray(lens, dtype=np.int64)
    pads = np.maximum(PAD_QUANTUM, 1 << np.ceil(
        np.log2(np.maximum(lens, 1))).astype(np.int64))
    out = []
    for pad in np.unique(pads):
        idx = np.nonzero(pads == pad)[0]
        rows = int(min(max_rows, max(ROW_QUANTUM, target_cells // pad)))
        occupancy = -(-len(idx) // ROW_QUANTUM) * ROW_QUANTUM
        rows = min((rows // ROW_QUANTUM) * ROW_QUANTUM, occupancy)
        out.append((int(pad), rows, idx))
    return out


@dataclasses.dataclass
class StreamStats:
    total_kminmers: int
    total_bases: int
    num_records: int
    wall_s: float
    pack_s: float  # producer-thread packing time (overlapped)
    batches: int
    buckets: int
    # Background executable warm-up: the warm thread compiles and first
    # runs every bucket's program concurrently with packing/staging
    # instead of synchronously on the first real batch.  warm_s = warm
    # thread duration; first_result_s = time from run start to the first
    # settled batch (their overlap is the hidden share).
    warm_s: float = 0.0
    first_result_s: float = 0.0


class StreamingRunner:
    """Length-bucketed, double-buffered FASTA -> k-min-mer stream.

    Usage:
        with StreamingRunner(path, spec) as r:
            stats = r.run()
            records = r.collect()   # optional: globally ordered stream
    """

    def __init__(
        self,
        path,
        spec,
        threads: int = 0,
        target_cells: int = 1 << 25,
        queue_depth: int = 3,
        keep_records: bool = True,
        pack_transfer: bool = True,
    ):
        from .fasta import FastaFile

        self.path = path
        self.spec = spec
        self.threads = threads
        self.target_cells = target_cells
        self.queue_depth = queue_depth
        self.keep_records = keep_records
        self.pack_transfer = pack_transfer
        self.file = FastaFile(path)
        self.family = family_of_mode(spec.mode)
        self._chunks: List[Dict[str, np.ndarray]] = []
        self._counts: Optional[np.ndarray] = None
        self.stats: Optional[StreamStats] = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.file.close()
        return False

    # ---- producer: pack batches ahead of the device ----
    def _produce(self, plan, q):
        t_pack = 0.0
        try:
            for pad, rows, idx in plan:
                for first in range(0, len(idx), rows):
                    chunk = idx[first : first + rows]
                    t0 = time.perf_counter()
                    codes, lengths = self.file.pack_indices(
                        chunk, pad, self.threads, self.family
                    )
                    if len(chunk) < rows:  # pad to the static row count
                        codes = np.concatenate([
                            codes,
                            np.full((rows - len(chunk), pad), XCODE_PAD,
                                    dtype=codes.dtype),
                        ])
                        lengths = np.concatenate([
                            lengths,
                            np.zeros(rows - len(chunk), dtype=lengths.dtype),
                        ])
                    if self.pack_transfer:
                        from ..ops.long_read import _pack_nibbles

                        codes = _pack_nibbles(codes)
                    t_pack += time.perf_counter() - t0
                    q.put((chunk, codes, lengths))
        except BaseException as e:  # surface packer errors to the consumer
            q.put(e)
            return
        q.put(t_pack)  # sentinel: done, with accumulated pack time

    def _settle(self, chunk, dcodes, dlens, out, counts, progress):
        """Block on one in-flight batch: overflow check (rare synchronous
        retry through the api recovery loop) + host-side record stitch."""
        from ..api import kminmers_batch
        from ..ops.u64 import to_py_u64
        from ..parallel.driver import stitch_records

        n_raw = np.asarray(out.n_minimizers_raw)
        if (np.asarray(out.n_minimizers) < n_raw).any():
            # m_cap overflow: redo this batch with recovery retries
            # (unpack once on device first if the batch rode packed)
            if self.pack_transfer:
                dcodes = _unpack_jit(dcodes)
            out = kminmers_batch(dcodes, dlens, self.spec)
        nk = np.asarray(out.n_kminmers)[: len(chunk)]
        counts[chunk] = nk
        if self.keep_records:
            bases = np.cumsum(nk) - nk
            rec = stitch_records(
                nk,
                bases,
                int(nk.sum()),
                to_py_u64((
                    np.asarray(out.hash_hi)[: len(chunk)],
                    np.asarray(out.hash_lo)[: len(chunk)],
                )),
                np.asarray(out.start)[: len(chunk)],
                np.asarray(out.end)[: len(chunk)],
                np.asarray(out.rev)[: len(chunk)],
                read_ids=chunk,
            )
            self._chunks.append(rec)
        if progress:
            print(
                f"  batch of {len(chunk)} reads -> {int(nk.sum())} "
                "k-min-mers",
                flush=True,
            )
        return int(nk.sum())

    def run(self, progress: bool = False) -> StreamStats:
        import collections

        import jax

        from ..api import _cached_pipeline

        lens = self.file.seq_lens()
        n = len(lens)
        plan = plan_buckets(lens, self.target_cells)
        q: queue.Queue = queue.Queue(maxsize=self.queue_depth)
        producer = threading.Thread(
            target=self._produce, args=(plan, q), daemon=True
        )
        t0 = time.perf_counter()

        # Kick every bucket executable's FIRST execution (dummy batch) on a
        # background thread, so compiles and program loads overlap
        # packing, uploads and first-batch staging instead of blocking the
        # first real batch.  Shares the executables via _cached_pipeline,
        # so the real batches reuse the warmed programs.
        warm_stat = {"s": 0.0}
        warm_moot = threading.Event()  # real work done; stop starting more
        dispatched_pads = set()  # bucket shapes a REAL batch already warmed

        def _warm():
            t_w = time.perf_counter()
            try:
                for pad, rows, _ in plan:
                    if warm_moot.is_set():
                        break
                    if pad in dispatched_pads:
                        # a real batch of this shape is already in flight —
                        # it pays the program load itself; a dummy would
                        # only steal device time
                        continue
                    wlens = np.zeros((rows,), dtype=np.int32)
                    if self.pack_transfer:
                        wp = np.full(
                            (rows, pad // 2),
                            XCODE_PAD | (XCODE_PAD << 4),
                            dtype=np.uint8,
                        )
                        jax.block_until_ready(
                            _cached_packed_pipeline(self.spec)(wp, wlens)
                        )
                    else:
                        wcodes = np.full(
                            (rows, pad), XCODE_PAD, dtype=np.uint8
                        )
                        jax.block_until_ready(
                            _cached_pipeline(self.spec)(wcodes, wlens)
                        )
            except Exception:  # pragma: no cover — warm-up is best-effort
                pass
            warm_stat["s"] = time.perf_counter() - t_w

        warm = threading.Thread(target=_warm, daemon=True)
        warm.start()
        producer.start()

        counts = np.zeros(n, dtype=np.int64)
        total = 0
        batches = 0
        pack_s = 0.0
        first_result_s = 0.0
        self._chunks = []
        # Depth-2 in-flight window: batch g+1's transfer + dispatch are
        # issued before batch g's results are read back, so the device never
        # idles on host readback and the producer thread packs g+2 meanwhile.
        inflight = collections.deque()
        while True:
            item = q.get()
            if isinstance(item, BaseException):
                raise item
            if isinstance(item, float):  # producer done
                pack_s = item
                break
            chunk, codes, lengths = item
            dispatched_pads.add(
                codes.shape[1] * (2 if self.pack_transfer else 1)
            )
            dcodes = jax.device_put(codes)  # async
            dlens = jax.device_put(lengths.astype(np.int32))
            pipe = (
                _cached_packed_pipeline(self.spec)
                if self.pack_transfer
                else _cached_pipeline(self.spec)
            )
            out = pipe(dcodes, dlens)  # async
            inflight.append((chunk, dcodes, dlens, out))
            batches += 1
            if len(inflight) >= 2:
                total += self._settle(*inflight.popleft(), counts, progress)
                if not first_result_s:
                    first_result_s = time.perf_counter() - t0
        while inflight:
            total += self._settle(*inflight.popleft(), counts, progress)
            if not first_result_s:
                first_result_s = time.perf_counter() - t0
        producer.join()
        warm_moot.set()  # skip not-yet-started warm shapes
        warm.join()  # bounded by at most one in-flight dummy batch
        self._counts = counts
        self.stats = StreamStats(
            total_kminmers=total,
            total_bases=int(lens.sum()),
            num_records=n,
            wall_s=time.perf_counter() - t0,
            pack_s=pack_s,
            batches=batches,
            buckets=len(plan),
            warm_s=warm_stat["s"],
            first_result_s=first_result_s,
        )
        return self.stats

    def collect(self) -> Dict[str, np.ndarray]:
        """Re-stitch the bucketed per-batch chunks into ONE globally
        ordered struct-of-arrays (ascending record id, then within-read
        offset) — the reference's sequential iteration order."""
        if self._counts is None:
            raise RuntimeError("run() first")
        if not self.keep_records:
            raise RuntimeError("constructed with keep_records=False")
        base = np.cumsum(self._counts) - self._counts  # global read bases
        total = int(self._counts.sum())
        out = {
            "hash": np.zeros(total, dtype=np.uint64),
            "start": np.zeros(total, dtype=np.int64),
            "end": np.zeros(total, dtype=np.int64),
            "offset": np.zeros(total, dtype=np.int64),
            "rev": np.zeros(total, dtype=bool),
            "read": np.zeros(total, dtype=np.int64),
        }
        for rec in self._chunks:
            dest = base[rec["read"]] + rec["offset"]
            for kcol in out:
                out[kcol][dest] = rec[kcol]
        return out


def stream_file(
    path,
    spec,
    threads: int = 0,
    out: Optional[str] = None,
    progress: bool = False,
    target_cells: int = 1 << 25,
) -> StreamStats:
    """One-shot streaming run; optionally writes the ordered stream to a
    compressed .npz (columns hash/start/end/offset/rev/read)."""
    with StreamingRunner(
        path, spec, threads=threads, target_cells=target_cells,
        keep_records=out is not None,
    ) as runner:
        stats = runner.run(progress=progress)
        if out is not None:
            np.savez_compressed(out, **runner.collect())
    return stats
