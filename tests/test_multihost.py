"""Multi-host distributed correctness: two jax.distributed processes on a
CPU mesh must produce the IDENTICAL globally ordered k-min-mer stream as a
single-process run.

This is the multi-host scaling of the reference's thread-pool data
parallelism (reference src/main.rs:65-79) to hosts: per-host packing of its
own record rows, one global mesh, counts-only collective for ordering, and
per-host ordered chunks whose concatenation is the global stream."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

# The one 2-process session runs THREE pipeline configs back to back —
# the r3 matrix only covered regular/hpcsimd at u32/nthash1; this adds the
# hpc mode + H=u64 config (reference src/lib.rs:32) and the NtHash2-31
# l>31 variant (src/nthash2_avx512_32.rs) through the full distributed
# driver (per-host packing, global mesh, counts collective, ordered
# parts + manifest).
WORKER_CONFIGS = [
    # (subdir, mode, l, k, density, hash_width, variant)
    ("hpcsimd_u32", "hpcsimd", 9, 3, 0.05, 32, "nthash1"),
    ("hpc_u64", "hpc", 9, 3, 0.05, 64, "nthash1"),
    ("regular_nthash2_l45", "regular", 45, 2, 0.05, 32, "nthash2"),
]

WORKER = r"""
import os, sys
pid = int(sys.argv[1])
port = sys.argv[2]
fasta = sys.argv[3]
out_dir = sys.argv[4]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, os.getcwd())
from seq2kminmers.parallel.multihost import init_distributed

init_distributed(f"localhost:{port}", num_processes=2, process_id=pid)
from seq2kminmers.parallel.multihost import run_file_distributed
from seq2kminmers.ops.pipeline import PipelineSpec

assert jax.process_count() == 2 and len(jax.devices()) == 8
CONFIGS = __CONFIGS__
for sub, mode, l, k, d, hw, variant in CONFIGS:
    spec = PipelineSpec(l=l, k=k, density=d, mode=mode, hash_width=hw,
                        variant=variant)
    chunks = run_file_distributed(
        fasta, spec, rows_per_device=2, out_dir=os.path.join(out_dir, sub)
    )
    print(f"worker {pid} {sub} ok: "
          f"{sum(len(c.records['hash']) for c in chunks)}")
"""


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def fasta_file(tmp_path_factory):
    rng = np.random.default_rng(42)
    p = tmp_path_factory.mktemp("mh") / "reads.fa"
    seqs = []
    for i in range(37):  # deliberately not a multiple of the batch size
        n = int(rng.integers(40, 900))
        seqs.append("".join(rng.choice(list("ACGT"), size=n)))
    p.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(seqs)))
    return p, seqs


def test_distributed_overflow_recovery(tmp_path):
    """The collective-safe retry loop: a deliberately starved capacity must
    escalate (same decision on every host, driven by the replicated `lost`
    psum) until nothing is dropped — the reference never drops a minimizer
    (src/nthash_avx512_32.rs:139-141)."""
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")
    import dataclasses

    import numpy as np

    from seq2kminmers.oracle import HashMode, kminmers
    from seq2kminmers.ops.pipeline import PipelineSpec
    from seq2kminmers.parallel.multihost import (
        global_data_mesh,
        run_file_distributed,
    )

    rng = np.random.default_rng(11)
    seqs = ["".join(rng.choice(list("ACGT"), size=600)) for _ in range(16)]
    p = tmp_path / "dense.fa"
    p.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(seqs)))
    # density 0.4 with capacity for ~8 minimizers: guaranteed overflow
    spec = PipelineSpec(
        l=9, k=3, density=0.4, mode="regular", max_minimizers=8
    )
    chunks = run_file_distributed(
        p, spec, mesh=global_data_mesh(), rows_per_device=2
    )
    got_hash = np.concatenate([c.records["hash"] for c in chunks])
    got_read = np.concatenate([c.records["read"] for c in chunks])
    pos = 0
    for i, s in enumerate(seqs):
        for rec in kminmers(s, 9, 3, 0.4, HashMode.Regular):
            assert got_read[pos] == i and got_hash[pos] == np.uint64(
                rec.hash
            ), (i, pos)
            pos += 1
    assert pos == len(got_hash)


@pytest.mark.slow
def test_two_process_stream_matches_single(fasta_file, tmp_path):
    fasta, seqs = fasta_file
    out = tmp_path / "parts"
    port = _free_port()
    wpath = tmp_path / "worker.py"
    wpath.write_text(WORKER.replace("__CONFIGS__", repr(WORKER_CONFIGS)))
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, str(wpath), str(pid), str(port), str(fasta),
             str(out)],
            env=env, cwd=str(Path(__file__).resolve().parent.parent),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for pid in range(2)
    ]
    outs = [p.communicate(timeout=900)[0] for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-4000:]

    from seq2kminmers.oracle import HashMode, kminmers

    for sub, mode, l, k, d, hw, variant in WORKER_CONFIGS:
        cdir = out / sub
        # ---- reassemble the distributed stream from the per-host parts
        manifest = json.loads((cdir / "manifest.json").read_text())
        assert manifest["num_processes"] == 2
        parts = sorted(cdir.glob("part-*.npz"))  # (batch, host) ascending
        hashes, starts, ends, offs, reads = [], [], [], [], []
        expected_pos = 0
        for fp in parts:
            z = np.load(fp)
            assert int(z["stream_start"]) == expected_pos
            expected_pos += len(z["hash"])
            hashes.append(z["hash"])
            starts.append(z["start"])
            ends.append(z["end"])
            offs.append(z["offset"])
            reads.append(z["read"])
        got = {
            "hash": np.concatenate(hashes),
            "start": np.concatenate(starts),
            "end": np.concatenate(ends),
            "offset": np.concatenate(offs),
            "read": np.concatenate(reads),
        }
        assert manifest["total_kminmers"] == len(got["hash"]) == expected_pos

        # ---- single-process reference: the oracle per read, in order
        p = 0
        for i, s in enumerate(seqs):
            ref = kminmers(s, l, k, d, HashMode(mode), hw, variant)
            for r in ref:
                assert got["read"][p] == i, (sub, i, p)
                assert got["hash"][p] == np.uint64(r.hash), (sub, i, p)
                assert got["start"][p] == r.start, (sub, i, p)
                assert got["end"][p] == r.end, (sub, i, p)
                assert got["offset"][p] == r.offset, (sub, i, p)
                p += 1
        assert p == len(got["hash"]), sub
