"""Correctness tests for the carry-aware stage chain (ops/scan.py) — the
production hot path — validated element-exactly against the numpy oracle.

Batches are cut into chunks and scanned chunk by chunk with the carry
threaded between steps, so every test also crosses chunk boundaries.  The
chain covers the reference's entire L1+L2 layer (HPC + rolling NtHash +
density select: src/nthash_hpc.rs, src/hpc.rs:44-147,
src/nthash_avx512_32.rs).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from seq2kminmers.constants import XCODE_PAD, encode_xcodes
from seq2kminmers.oracle import HashMode, minimizers
from seq2kminmers.ops.pipeline import PipelineSpec, kminmer_pipeline
from seq2kminmers.ops.scan import ScanCarry, scan_step, window_limit
from seq2kminmers.ops.u64 import to_py_u64
from seq2kminmers.oracle import kminmers as oracle_kminmers


def _batch(rng, B, L, alphabet="AACCGGTTAAAA"):
    codes = np.full((B, L), XCODE_PAD, dtype=np.uint8)
    lengths = np.zeros(B, dtype=np.int32)
    seqs = []
    for b in range(B):
        n = int(rng.integers(L // 2, L - 1))
        s = "".join(rng.choice(list(alphabet), size=n))
        seqs.append(s)
        codes[b, :n] = encode_xcodes(s, "scalar")
        lengths[b] = n
    return codes, lengths, seqs


def _run_scan(codes, lengths, spec, chunk=1024):
    """Scan [B, L] chunk by chunk, threading the carry; -> per-row lists of
    (start, end, hash) with global positions."""
    B, L = codes.shape
    limit = window_limit(jnp.asarray(lengths), spec.l)
    step = jax.jit(
        lambda c, n, lim, cr: scan_step(c, n, lim, cr, spec, chunk + 1)
    )
    carry = ScanCarry.empty(B, spec.l)
    streams = [[] for _ in range(B)]
    for c0 in range(0, L, chunk):
        part = np.full((B, chunk), XCODE_PAD, dtype=np.uint8)
        part[:, : min(chunk, L - c0)] = codes[:, c0 : c0 + chunk]
        local = np.clip(lengths - c0, 0, chunk).astype(np.int32)
        out, carry = step(part, local, limit, carry)
        # m_cap = chunk + 1 holds every window: nothing may be dropped
        np.testing.assert_array_equal(out.n_min, out.n_raw)
        st, en, hs = map(np.asarray, (out.start, out.end, out.hash))
        for b in range(B):
            n = int(out.n_min[b])
            streams[b].extend(
                (int(st[b, q]) + c0, int(en[b, q]) + c0, int(hs[b, q]))
                for q in range(n)
            )
    return streams


@pytest.mark.parametrize("mode", ["regular", "simd", "hpc", "hpcsimd"])
@pytest.mark.parametrize("l", [5, 31])
def test_scan_step_matches_oracle(rng, mode, l):
    d = 0.05
    codes, lengths, seqs = _batch(rng, B=3, L=2048)
    spec = PipelineSpec(l=l, k=2, density=d, mode=mode)
    streams = _run_scan(codes, lengths, spec)
    for b, got in enumerate(streams):
        ref = minimizers(seqs[b], l, d, HashMode(mode))
        assert got == ref, f"mode={mode} l={l} row {b}"


def test_scan_step_run_spanning_chunks(rng):
    """A homopolymer run crossing the chunk boundary must stay one run."""
    l, d = 5, 0.2
    L = 4096
    chunk = 1024  # _run_scan's default
    s = "".join(rng.choice(list("ACGT"), size=L - 300))
    # plant a long run straddling the first chunk boundary
    s = s[: chunk - 50] + "A" * 120 + s[chunk + 70 :]
    codes = encode_xcodes(s, "scalar")[None, :]
    pad = np.full((1, L), XCODE_PAD, dtype=np.uint8)
    pad[0, : codes.shape[1]] = codes
    lengths = np.array([codes.shape[1]], dtype=np.int32)
    for mode in ["hpc", "hpcsimd"]:
        spec = PipelineSpec(l=l, k=2, density=d, mode=mode)
        got = _run_scan(pad, lengths, spec)[0]
        ref = minimizers(s, l, d, HashMode(mode))
        assert got == ref, mode


@pytest.mark.parametrize("l", [129, 255])
@pytest.mark.parametrize("mode", ["hpc", "hpcsimd"])
def test_scan_step_large_l_carry(rng, mode, l):
    """l in [128, 255] (the reference scalar HPC ring buffer is 256 chars,
    src/nthash_hpc.rs:9-11): the carried prefix is a sizeable share of
    each chunk, and windows reach back across several of its slots."""
    codes, lengths, seqs = _batch(rng, B=2, L=4096, alphabet="AACCGGTT")
    spec = PipelineSpec(l=l, k=2, density=0.2, mode=mode)
    streams = _run_scan(codes, lengths, spec)
    for b, s in enumerate(seqs):
        ref = minimizers(s, l, 0.2, HashMode(mode))
        assert streams[b] == ref, (mode, l, b)


@pytest.mark.parametrize(
    "L,mode,chunk",
    [
        (5120, "hpc", 1000),
        (5120, "hpcsimd", 1000),
        (20480, "hpcsimd", 3000),
    ],
)
def test_scan_step_non_pow2_chunk(rng, L, mode, chunk):
    """Chunk widths that are not powers of two and do not divide the
    padded length (the last chunk runs into padding): positions and
    carries must not assume any alignment."""
    l, d = 11, 0.05
    n = L - 17  # length not aligned to anything
    s = "".join(rng.choice(list("AACCGGTTA"), size=n))
    codes = np.full((1, L), XCODE_PAD, dtype=np.uint8)
    codes[0, :n] = encode_xcodes(s, "scalar")
    lengths = np.array([n], dtype=np.int32)
    spec = PipelineSpec(l=l, k=2, density=d, mode=mode)
    got = _run_scan(codes, lengths, spec, chunk=chunk)[0]
    ref = minimizers(s, l, d, HashMode(mode))
    assert got == ref


def test_scan_step_short_and_gated_reads(rng):
    """Reads with len <= l yield nothing (src/lib.rs:97 strict gate)."""
    l = 31
    L = 1024
    codes = np.full((3, L), XCODE_PAD, dtype=np.uint8)
    lengths = np.array([l, l - 5, l + 1], dtype=np.int32)
    for b in range(3):
        codes[b, : lengths[b]] = encode_xcodes(
            "".join(rng.choice(list("ACGT"), size=int(lengths[b]))),
            "scalar",
        )
    spec = PipelineSpec(l=l, k=2, density=1.0, mode="regular")
    streams = _run_scan(codes, lengths, spec)
    assert streams[0] == [] and streams[1] == []
    # len = l+1 admits exactly two windows at density 1.0 (starts 0 and 1)
    assert len(streams[2]) == 2


@pytest.mark.parametrize("mode", ["regular", "simd", "hpc", "hpcsimd"])
def test_scan_step_pipeline_end_to_end(rng, mode):
    """Full kminmer_pipeline (scan_step with an empty carry + assembly)
    against the oracle, record-for-record."""
    codes, lengths, seqs = _batch(rng, B=2, L=4096, alphabet="AACCGGTTAANN")
    spec = PipelineSpec(
        l=7,
        k=3,
        density=0.02,
        mode=mode,
        max_minimizers=256,
    )
    out = jax.jit(lambda c, n: kminmer_pipeline(c, n, spec))(
        jnp.asarray(codes), jnp.asarray(lengths)
    )
    for b in range(2):
        nk = int(out.n_kminmers[b])
        h = to_py_u64(
            (np.asarray(out.hash_hi[b, :nk]), np.asarray(out.hash_lo[b, :nk]))
        )
        ref = oracle_kminmers(seqs[b], 7, 3, 0.02, HashMode(mode))
        assert nk == len(ref)
        for i, r in enumerate(ref):
            assert (
                int(h[i]),
                int(out.start[b, i]),
                int(out.end[b, i]),
                bool(out.rev[b, i]),
            ) == (r.hash, r.start, r.end, r.rev)


@pytest.mark.parametrize("mode", ["regular", "hpc"])
def test_scan_step_pipeline_u64_lanes(rng, mode):
    """hash_width=64 through the pipeline (64-bit hash lanes as hi/lo
    uint32 pairs — the reference's H=u64 compile-time alternative,
    src/lib.rs:32) against the oracle, record-for-record.
    SIMD modes are excluded by PipelineSpec (u64 is a scalar-path config)."""
    codes, lengths, seqs = _batch(rng, B=2, L=4096, alphabet="AACCGGTTAANN")
    spec = PipelineSpec(
        l=9,
        k=3,
        density=0.02,
        mode=mode,
        hash_width=64,
        max_minimizers=256,
    )
    out = jax.jit(lambda c, n: kminmer_pipeline(c, n, spec))(
        jnp.asarray(codes), jnp.asarray(lengths)
    )
    for b in range(2):
        nm = int(out.n_minimizers[b])
        mh = to_py_u64(
            (
                np.asarray(out.min_hash_hi[b, :nm]),
                np.asarray(out.min_hash[b, :nm]),
            )
        )
        ref_min = minimizers(seqs[b], 9, 0.02, HashMode(mode), hash_width=64)
        assert nm == len(ref_min), (mode, b)
        assert [int(x) for x in mh] == [h for (_, _, h) in ref_min]
        assert list(np.asarray(out.min_start[b, :nm])) == [
            s for (s, _, _) in ref_min
        ]
        nk = int(out.n_kminmers[b])
        h = to_py_u64(
            (np.asarray(out.hash_hi[b, :nk]), np.asarray(out.hash_lo[b, :nk]))
        )
        ref = oracle_kminmers(
            seqs[b], 9, 3, 0.02, HashMode(mode), hash_width=64
        )
        assert nk == len(ref)
        for i, r in enumerate(ref):
            assert (
                int(h[i]),
                int(out.start[b, i]),
                int(out.end[b, i]),
                bool(out.rev[b, i]),
            ) == (r.hash, r.start, r.end, r.rev), (mode, b, i)


@pytest.mark.parametrize("mode", ["regular", "hpc"])
def test_scan_step_pipeline_u16_lanes(rng, mode):
    """hash_width=16 through the pipeline (16-bit rotates on low-half
    lanes; murmur MixHash at assembly — the reference's H=u16 config,
    src/lib.rs:30,142-155) against the oracle."""
    codes, lengths, seqs = _batch(rng, B=2, L=4096, alphabet="AACCGGTTAANN")
    spec = PipelineSpec(
        l=9,
        k=3,
        density=0.02,
        mode=mode,
        hash_width=16,
        max_minimizers=512,
    )
    out = jax.jit(lambda c, n: kminmer_pipeline(c, n, spec))(
        jnp.asarray(codes), jnp.asarray(lengths)
    )
    for b in range(2):
        nm = int(out.n_minimizers[b])
        ref_min = minimizers(seqs[b], 9, 0.02, HashMode(mode), hash_width=16)
        assert nm == len(ref_min), (mode, b)
        assert [int(x) for x in np.asarray(out.min_hash[b, :nm])] == [
            h for (_, _, h) in ref_min
        ]
        nk = int(out.n_kminmers[b])
        h = to_py_u64(
            (np.asarray(out.hash_hi[b, :nk]), np.asarray(out.hash_lo[b, :nk]))
        )
        ref = oracle_kminmers(
            seqs[b], 9, 3, 0.02, HashMode(mode), hash_width=16
        )
        assert nk == len(ref)
        for i, r in enumerate(ref):
            assert (
                int(h[i]),
                int(out.start[b, i]),
                int(out.end[b, i]),
                bool(out.rev[b, i]),
            ) == (r.hash, r.start, r.end, r.rev), (mode, b, i)
