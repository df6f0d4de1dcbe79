#!/usr/bin/env python3
"""Smoke test of the k-min-mer engine on one GPU: the main paths at real
sizes, every output record-exact against the numpy oracle.

    python3 chip_smoke.py [--seed N]           # one card
    python3 chip_smoke.py [--seed N] --four    # four cards: DP + seq-shard

Run from the repository root.  All data is generated from --seed.  Phases
(one card):
  1. card check: nvidia-smi name and power limit, jax.devices();
  2. goldens: the reference's u32 and u64 golden hashes through
     KminmersIterator;
  3. the reference CLI job end to end (`-o out.npz`) on a >=100 Mbp
     homopolymer-rich multi-record FASTA, regular and hpc (l=31, k=5,
     d=0.01, reference src/main.rs:53-60);
  4. long reads: kminmers_long on one >=128 Mbp sequence at the default
     chunk (>=3 carry hand-offs), hpc and regular, and kminmers_long_batch
     on two reads;
  5. performance lines: wall time and bases/s of phases 3-4, and the rate
     of a large device copy.
With --four only the multi-card paths run: make_dp_pipeline on a 4x1 mesh
and make_seq_pipeline on a 1x4 mesh, each record-exact against the
one-card pipeline on the same input.

Any failed phase exits non-zero.  The last line of a passing run is
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
Without a GPU, or outside the repository, it exits non-zero and prints no
such line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import traceback

import numpy as np

# Sizes of a real run.  Tests and rehearsals pass smaller ones.
SIZES = {
    "fasta_bp": 100_000_000,  # total bases of the CLI job's FASTA
    "rec_min": 1_000,
    "rec_max": 1_000_000,
    "long_bp": 140_000_000,  # one chromosome-scale sequence
    "batch_bp": (40_000_000, 25_000_000),  # two reads for the batch driver
    "chunk": None,  # None = ops.long_read.DEFAULT_CHUNK
    "dp_shape": (32, 1 << 20),  # reads x padded length, 4x1 mesh
    "seq_len": 1 << 26,  # one read split over a 1x4 mesh
}
L, K, D = 31, 5, 0.01  # reference CLI defaults (src/main.rs:53-60)
BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def homopolymer_rich(rng, n: int) -> bytes:
    """n bases of runs with geometric lengths (mean ~1.7, HiFi-like), a
    rare long homopolymer, and rare N runs."""
    sym = np.cumsum(rng.integers(1, 4, size=n)) % 4  # no equal neighbours
    runs = rng.geometric(0.6, size=n)  # n runs of >= 1 base cover n bases
    long_ = rng.random(n) < 1e-3
    runs[long_] = rng.integers(10, 60, size=int(long_.sum()))
    out = np.repeat(BASES[sym], runs)[:n].copy()
    for start in rng.integers(0, max(n - 200, 1), size=max(n // 500_000, 1)):
        out[start : start + int(rng.integers(1, 200))] = ord("N")
    return out.tobytes()


def write_fasta(path: str, rng, total_bp: int, lo: int, hi: int) -> list:
    """Log-uniform record lengths in [lo, hi] until total_bp is reached."""
    seqs, total = [], 0
    with open(path, "wb") as f:
        while total < total_bp:
            n = int(np.exp(rng.uniform(np.log(lo), np.log(hi))))
            s = homopolymer_rich(rng, n)
            f.write(b">r%d\n%s\n" % (len(seqs), s))
            seqs.append(s)
            total += n
    return seqs


def expect_equal(name: str, got: dict, ref: dict) -> None:
    for key in ("hash", "start", "end", "offset", "rev"):
        g, r = np.asarray(got[key]), np.asarray(ref[key])
        if g.shape != r.shape or not np.array_equal(g, r):
            bad = (
                "length %d vs %d" % (len(g), len(r))
                if g.shape != r.shape
                else "first mismatch at %d" % int(np.flatnonzero(g != r)[0])
            )
            raise AssertionError(f"{name}: column {key!r} differs ({bad})")


def oracle_records(seqs, mode: str) -> dict:
    """The oracle's ordered stream over many records, with read ids."""
    from seq2kminmers.oracle import HashMode, kminmer_arrays

    parts = [kminmer_arrays(s, L, K, D, HashMode(mode)) for s in seqs]
    out = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    out["read"] = np.repeat(
        np.arange(len(seqs)), [len(p["hash"]) for p in parts]
    )
    return out


def rate(label: str, nbases: int, seconds: float) -> str:
    return (
        f"{label}: {seconds:.3f} s, {nbases} bases, "
        f"{nbases / seconds / 1e9:.3f} Gbases/s"
    )


def phase_goldens(sizes, rng, tmp):
    import importlib.util

    from seq2kminmers import KminmersIterator

    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    # by path: an installed package named `tests` may shadow the directory
    spec = importlib.util.spec_from_file_location(
        "_goldens", os.path.join(tests, "test_goldens.py")
    )
    goldens = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(goldens)
    with open(os.path.join(tests, "data", "ecoli.genome.100k.fa")) as f:
        seq = f.read().split("\n")[1]
    for width, want in (
        (32, goldens.GOLDEN_HASHES_U32), (64, goldens.GOLDEN_HASHES_U64)
    ):
        got = [km.hash for km in KminmersIterator(
            seq, 10, 5, 0.0001, "regular", hash_width=width)]
        if got != want:
            raise AssertionError(f"u{width} goldens differ: {got[:3]}")
        print(f"  u{width} goldens: {len(got)} k-min-mers, exact")


def phase_cli(sizes, rng, tmp):
    from seq2kminmers.__main__ import main as cli_main
    from seq2kminmers.io.fasta import _load_native
    from seq2kminmers.io.stream import stream_file
    from seq2kminmers.ops.pipeline import PipelineSpec

    fa = os.path.join(tmp, "reads.fa")
    t0 = time.perf_counter()
    seqs = write_fasta(fa, rng, sizes["fasta_bp"], sizes["rec_min"],
                       sizes["rec_max"])
    nb = sum(map(len, seqs))
    print(f"  FASTA: {len(seqs)} records, {nb} bases, lengths "
          f"{min(map(len, seqs))}..{max(map(len, seqs))} "
          f"(generated in {time.perf_counter() - t0:.1f} s)")
    print("  FASTA reader: "
          + ("native" if _load_native() is not None else "python"))
    for mode in ("regular", "hpc"):
        out = os.path.join(tmp, f"out-{mode}.npz")
        t0 = time.perf_counter()
        rc = cli_main([fa, "0", "--mode", mode, "-o", out])
        cold = time.perf_counter() - t0
        if rc:
            raise AssertionError(f"CLI exited {rc}")
        with np.load(out) as z:
            got = {k: z[k] for k in z.files}
        ref = oracle_records(seqs, mode)
        expect_equal(f"CLI {mode}", got, ref)
        if not np.array_equal(got["read"], ref["read"]):
            raise AssertionError(f"CLI {mode}: read ids differ")
        spec = PipelineSpec(l=L, k=K, density=D, mode=mode)
        t0 = time.perf_counter()
        st = stream_file(fa, spec)
        warm = time.perf_counter() - t0
        print(f"  CLI {mode}: {len(ref['hash'])} k-min-mers over "
              f"{len(seqs)} records, record-exact vs oracle")
        print("  " + rate(f"perf CLI {mode} first run (with compile, "
                          "writing .npz)", nb, cold))
        print("  " + rate(f"perf stream_file {mode} warm", nb, warm)
              + f" (first result at {st.first_result_s:.3f} s)")


def phase_long(sizes, rng, tmp):
    from seq2kminmers.ops.long_read import (
        DEFAULT_CHUNK,
        kminmers_long,
        kminmers_long_batch,
    )
    from seq2kminmers.oracle import HashMode, kminmer_arrays

    chunk = sizes["chunk"] or DEFAULT_CHUNK
    seq = homopolymer_rich(rng, sizes["long_bp"])
    n = len(seq)
    print(f"  long read: {n} bases, chunk {chunk}, "
          f"{-(-n // chunk) - 1} chunk boundaries")
    for mode in ("hpc", "regular"):
        t0 = time.perf_counter()
        got = kminmers_long(seq, L, K, D, mode, chunk=chunk)
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        kminmers_long(seq, L, K, D, mode, chunk=chunk)
        warm = time.perf_counter() - t0
        ref = kminmer_arrays(seq, L, K, D, HashMode(mode))
        expect_equal(f"kminmers_long {mode}", got, ref)
        print(f"  kminmers_long {mode}: {len(ref['hash'])} k-min-mers, "
              "record-exact vs oracle")
        print("  " + rate(f"perf kminmers_long {mode} first run", n, cold))
        print("  " + rate(f"perf kminmers_long {mode} warm", n, warm))
    reads = [homopolymer_rich(rng, int(b)) for b in sizes["batch_bp"]]
    t0 = time.perf_counter()
    batch = kminmers_long_batch(reads, L, K, D, "hpc", chunk=chunk)
    dt = time.perf_counter() - t0
    for i, (r, got) in enumerate(zip(reads, batch)):
        ref = kminmer_arrays(r, L, K, D, HashMode.Hpc)
        expect_equal(f"kminmers_long_batch read {i}", got, ref)
    print(f"  kminmers_long_batch hpc: {len(reads)} reads "
          f"({[len(r) for r in reads]} bases), "
          f"{sum(len(b['hash']) for b in batch)} k-min-mers, "
          "record-exact vs oracle")
    print("  " + rate("perf kminmers_long_batch hpc first run",
                      sum(map(len, reads)), dt))


def phase_copy(sizes, rng, tmp):
    import jax
    import jax.numpy as jnp

    x = jnp.ones((1 << 30,), jnp.int32)  # 4 GiB
    f = jax.jit(lambda a: a + 1)
    jax.block_until_ready(f(x))
    ts = []
    for _ in range(5):
        t0 = time.perf_counter()
        jax.block_until_ready(f(x))
        ts.append(time.perf_counter() - t0)
    t = float(np.median(ts))
    print(f"  perf device copy: {2 * x.nbytes / t / 1e9:.1f} GB/s "
          f"(read + write of {x.nbytes >> 20} MiB, median of 5)")


def _random_batch(rng, B, Lp):
    from seq2kminmers.constants import XCODE_PAD, encode_xcodes

    codes = np.full((B, Lp), XCODE_PAD, dtype=np.uint8)
    lengths = rng.integers(Lp // 2, Lp, size=B).astype(np.int32)
    for b in range(B):
        codes[b, : lengths[b]] = encode_xcodes(
            homopolymer_rich(rng, int(lengths[b])), "scalar"
        )
    return codes, lengths


def _one_card_records(codes, lengths, spec):
    from seq2kminmers.api import kminmers_batch
    from seq2kminmers.ops.u64 import to_py_u64
    from seq2kminmers.parallel.driver import stitch_records

    out = kminmers_batch(codes, lengths, spec)
    nk = np.asarray(out.n_kminmers)
    return stitch_records(
        nk, np.cumsum(nk) - nk, int(nk.sum()),
        to_py_u64((np.asarray(out.hash_hi), np.asarray(out.hash_lo))),
        np.asarray(out.start), np.asarray(out.end), np.asarray(out.rev),
    )


def _spans_all(arr, n: int) -> None:
    devs = {s.device for s in arr.addressable_shards}
    if len(devs) != n:
        raise AssertionError(f"output lives on {len(devs)} devices, not {n}")


def phase_dp4(sizes, rng, tmp):
    import jax

    from seq2kminmers.ops.pipeline import PipelineSpec
    from seq2kminmers.parallel.driver import make_dp_pipeline, merge_ordered
    from seq2kminmers.parallel.mesh import batch_sharding, make_mesh, row_sharding

    mesh = make_mesh(n_data=4, n_seq=1)
    B, Lp = sizes["dp_shape"]
    codes, lengths = _random_batch(rng, B, Lp)
    spec = PipelineSpec(l=L, k=K, density=D, mode="hpc")
    step = make_dp_pipeline(spec, mesh)
    dc = jax.device_put(codes, batch_sharding(mesh))
    dl = jax.device_put(lengths, row_sharding(mesh))
    t0 = time.perf_counter()
    res = jax.block_until_ready(step(dc, dl))
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = jax.block_until_ready(step(dc, dl))
    warm = time.perf_counter() - t0
    if int(res.lost):
        raise AssertionError("DP run overflowed its capacity")
    _spans_all(res.batch.hash_lo, 4)
    ref = _one_card_records(codes, lengths, spec)
    expect_equal("make_dp_pipeline 4x1", merge_ordered(res), ref)
    nb = int(lengths.sum())
    print(f"  make_dp_pipeline 4x1 hpc: {B} reads, {len(ref['hash'])} "
          "k-min-mers, record-exact vs the one-card pipeline")
    print("  " + rate("perf dp 4x1 first run", nb, cold))
    print("  " + rate("perf dp 4x1 warm", nb, warm))


def phase_seq4(sizes, rng, tmp):
    import jax

    from seq2kminmers.ops.pipeline import PipelineSpec
    from seq2kminmers.ops.u64 import to_py_u64
    from seq2kminmers.parallel.mesh import batch_sharding, make_mesh, row_sharding
    from seq2kminmers.parallel.seqshard import make_seq_pipeline, stitch_segments

    mesh = make_mesh(n_data=1, n_seq=4)
    Lp = sizes["seq_len"]
    codes, lengths = _random_batch(rng, 1, Lp)
    for mode in ("hpc", "regular"):
        spec = PipelineSpec(l=L, k=K, density=D, mode=mode)
        fn = make_seq_pipeline(spec, mesh)
        dc = jax.device_put(codes, batch_sharding(mesh, seq_sharded=True))
        dl = jax.device_put(lengths, row_sharding(mesh))
        t0 = time.perf_counter()
        seg = jax.block_until_ready(fn(dc, dl))
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        seg = jax.block_until_ready(fn(dc, dl))
        warm = time.perf_counter() - t0
        _spans_all(seg.hash_lo, 4)
        out = stitch_segments(seg)
        if (out.n_minimizers_raw > out.n_minimizers).any():
            raise AssertionError("seq-sharded run overflowed its capacity")
        nk = int(out.n_kminmers[0])
        got = {
            "hash": to_py_u64((out.hash_hi[0, :nk], out.hash_lo[0, :nk])),
            "start": out.start[0, :nk].astype(np.int64),
            "end": out.end[0, :nk].astype(np.int64),
            "offset": np.arange(nk),
            "rev": out.rev[0, :nk],
        }
        ref = _one_card_records(codes, lengths, spec)
        expect_equal(f"make_seq_pipeline 1x4 {mode}", got, ref)
        nb = int(lengths.sum())
        print(f"  make_seq_pipeline 1x4 {mode}: one {nb}-base read, {nk} "
              "k-min-mers, record-exact vs the one-card pipeline")
        print("  " + rate(f"perf seq 1x4 {mode} first run", nb, cold))
        print("  " + rate(f"perf seq 1x4 {mode} warm", nb, warm))


ONE_CARD = [
    ("goldens", phase_goldens),
    ("cli", phase_cli),
    ("long_read", phase_long),
    ("copy", phase_copy),
]
FOUR_CARDS = [("dp_4x1", phase_dp4), ("seq_1x4", phase_seq4)]


def run_phases(phases, seed: int, sizes=SIZES) -> list:
    """Runs each phase; returns the names of those that failed."""
    failed = []
    rng = np.random.default_rng(seed)
    with tempfile.TemporaryDirectory() as tmp:
        for name, fn in phases:
            print(f"phase {name}:", flush=True)
            t0 = time.perf_counter()
            try:
                fn(sizes, rng, tmp)
            except Exception:
                traceback.print_exc()
                failed.append(name)
            status = "FAIL" if failed and failed[-1] == name else "pass"
            print(f"phase {name}: {status} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card paths (DP and seq-shard)")
    args = ap.parse_args(argv)
    try:
        from seq2kminmers.runtime import card_description, enable_compile_cache
    except ImportError as e:
        print(f"chip_smoke: cannot import the seq2kminmers package ({e}); "
              "run from the repository root", file=sys.stderr)
        return 2
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU, JAX found {devices[0].platform}",
              file=sys.stderr)
        return 1
    n_need = 4 if args.four else 1
    if len(devices) < n_need:
        print(f"chip_smoke: needs {n_need} GPUs, found {len(devices)}",
              file=sys.stderr)
        return 1
    print(f"card: {card_description()}")
    print(f"jax devices: {devices}")
    print(f"compile cache: {enable_compile_cache()}", flush=True)
    failed = run_phases(FOUR_CARDS if args.four else ONE_CARD, args.seed)
    if failed:
        print(f"chip_smoke: FAILED phases: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
