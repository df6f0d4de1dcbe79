"""Chunked long-read driver (ops/long_read.py): scan_step's carry
(base rank + pending prefix) threaded across chunk steps must reproduce
the oracle bit-for-bit — including chunks that keep ZERO stream elements
(mega-homopolymer runs spanning whole chunks) and windows straddling chunk
boundaries in every mode.

Reference behavior being generalized: the scalar iterator's O(1) rolling
state over unbounded sequences (src/nthash_hpc.rs:137-174) and the AVX-512
block hand-off (src/nthash_avx512_32.rs:404-425).
"""

import numpy as np
import pytest

from seq2kminmers.oracle import HashMode
from seq2kminmers.oracle import kminmers as oracle_kminmers
from seq2kminmers.ops.long_read import (
    assemble_stream,
    kminmers_long,
    minimizer_stream_long,
)
from seq2kminmers.ops.pipeline import PipelineSpec


def _check(seq, l, k, d, mode, chunk, variant="nthash1"):
    got = kminmers_long(
        seq, l=l, k=k, density=d, mode=mode, variant=variant,
        chunk=chunk, )
    ref = oracle_kminmers(seq, l, k, d, HashMode(mode), 32, variant)
    assert len(got["hash"]) == len(ref), (mode, len(got["hash"]), len(ref))
    for i, r in enumerate(ref):
        assert int(got["hash"][i]) == r.hash, (mode, i)
        assert int(got["start"][i]) == r.start, (mode, i)
        assert int(got["end"][i]) == r.end, (mode, i)
        assert int(got["offset"][i]) == r.offset
        assert bool(got["rev"][i]) == r.rev, (mode, i)


@pytest.mark.parametrize("mode", ["regular", "simd", "hpc", "hpcsimd"])
def test_long_read_multichunk_matches_oracle(rng, mode):
    n = 9000
    seq = "".join(rng.choice(list("AACCGGTTAAAANN"), size=n))
    _check(seq, l=11, k=3, d=0.05, mode=mode, chunk=2048)


@pytest.mark.parametrize("mode", ["hpc", "hpcsimd"])
def test_long_read_runs_spanning_whole_chunks(rng, mode):
    # multi-chunk homopolymer runs: chunks inside a run keep 0 elements,
    # so the pending prefix must thread THROUGH chunks unchanged.
    parts = []
    for _ in range(14):
        parts.append(
            "".join(rng.choice(list("ACGT"), size=int(rng.integers(30, 200))))
        )
        parts.append(
            str(rng.choice(list("ACGT"))) * int(rng.integers(800, 3000))
        )
    seq = "".join(parts)
    _check(seq, l=13, k=3, d=0.15, mode=mode, chunk=1024)
    _check(seq, l=31, k=2, d=0.3, mode=mode, chunk=1024)


def test_long_read_nthash2_variant(rng):
    seq = "".join(rng.choice(list("ACGT"), size=6000))
    _check(seq, l=45, k=2, d=0.05, mode="regular", chunk=2048,
           variant="nthash2")
    _check(seq, l=45, k=2, d=0.1, mode="hpc", chunk=2048, variant="nthash2")


def test_long_read_short_sequence_and_single_chunk(rng):
    seq = "".join(rng.choice(list("ACGT"), size=700))
    # single chunk (chunk > n) must equal the batch pipeline semantics
    _check(seq, l=9, k=2, d=0.2, mode="hpcsimd", chunk=1024)
    # n <= l -> empty
    got = kminmers_long("ACGTACG", l=10, k=2, density=0.5, mode="regular")
    assert len(got["hash"]) == 0


def test_assemble_stream_tiling_matches_unsplit(rng):
    # the overlap-tiled assembly must be invariant to the tile size
    from seq2kminmers.ops.assemble import assemble_kminmers
    import jax.numpy as jnp

    m = rng.integers(0, 2**32, size=1337, dtype=np.uint64).astype(np.uint32)
    k = 5
    (hi, lo), rev = assemble_kminmers(jnp.asarray(m[None, :]), k)
    want = (
        np.asarray(hi[0]).astype(np.uint64) << np.uint64(32)
    ) | np.asarray(lo[0]).astype(np.uint64)
    got_h, got_rev = assemble_stream(m, k, tile=256)
    np.testing.assert_array_equal(got_h, want)
    np.testing.assert_array_equal(got_rev, np.asarray(rev[0]))


@pytest.mark.parametrize("mode", ["hpc", "hpcsimd"])
def test_hpc_run_spanning_a_whole_chunk_carries_through(rng, mode):
    """A homopolymer run covering a whole chunk: that chunk keeps no
    stream element, so scan_step must hand the carry on unchanged (base
    rank kept, pending prefix only rebased to the next origin) and emit
    nothing, and the chunked result must still match the oracle."""
    import jax.numpy as jnp

    from seq2kminmers.constants import encode_xcodes
    from seq2kminmers.ops.scan import ScanCarry, scan_step, window_limit

    chunk, l, d = 1024, 11, 0.3
    seq = (
        "".join(rng.choice(list("ACGT"), size=900))
        + "G" * 2500  # covers chunk 1 = [1024, 2048) entirely
        + "".join(rng.choice(list("ACGT"), size=700))
    )
    x = encode_xcodes(seq, "scalar")
    spec = PipelineSpec(l=l, k=2, density=d, mode=mode)
    lengths = jnp.asarray([len(x)], dtype=jnp.int32)
    limit = window_limit(lengths, l)
    carry = ScanCarry.empty(1, l)
    for ci in range(2):
        part = x[None, ci * chunk : (ci + 1) * chunk]
        before = carry
        out, carry = scan_step(
            part, jnp.asarray([chunk], dtype=jnp.int32), limit, carry,
            spec, chunk + 1,
        )
    assert int(out.kept[0]) == 0 and int(out.n_raw[0]) == 0
    assert int(carry.base[0]) == int(before.base[0])
    np.testing.assert_array_equal(
        np.asarray(carry.pend), np.asarray(before.pend) - (chunk << 3)
    )
    _check(seq, l=l, k=2, d=d, mode=mode, chunk=chunk)


def test_minimizer_stream_long_overflow_recovery(rng):
    # a dense low-complexity region must escalate the capacity, not lose
    # minimizers: every window of a repeat hashes identically, so a tiny
    # M overflows without recovery.
    seq = "ACGT" * 1500  # highly repetitive, d=0.9 selects nearly all
    spec = PipelineSpec(l=5, k=2, density=0.9, mode="regular",
                        max_minimizers=64)
    st, en, hs = minimizer_stream_long(
        np.asarray(
            __import__(
                "seq2kminmers.constants", fromlist=["encode_xcodes"]
            ).encode_xcodes(seq, "scalar")
        ),
        spec,
        chunk=1024,
    )
    from seq2kminmers.oracle import minimizers

    ref = minimizers(seq, 5, 0.9, HashMode.Regular)
    assert len(st) == len(ref)
    for i, (s_, e_, h_) in enumerate(ref):
        assert (int(st[i]), int(en[i]), int(hs[i])) == (s_, e_, h_)


@pytest.mark.parametrize("mode", ["regular", "hpc"])
def test_long_read_u16_width(rng, mode):
    """H=u16 through the chunked driver (the reference's u16 compile-time
    config, src/lib.rs:30): 16-bit hash lanes, murmur-finalizer
    MixHash (src/lib.rs:142-155) over the tiled stream."""
    n = 9000
    seq = "".join(rng.choice(list("AACCGGTTAAAANN"), size=n))
    got = kminmers_long(
        seq, l=11, k=3, density=0.05, mode=mode, chunk=2048,
        hash_width=16,
    )
    ref = oracle_kminmers(seq, 11, 3, 0.05, HashMode(mode), 16)
    assert len(got["hash"]) == len(ref), (mode, len(got["hash"]), len(ref))
    for i, r in enumerate(ref):
        assert int(got["hash"][i]) == r.hash, (mode, i)
        assert int(got["start"][i]) == r.start, (mode, i)
        assert int(got["end"][i]) == r.end, (mode, i)
        assert bool(got["rev"][i]) == r.rev, (mode, i)


@pytest.mark.parametrize("mode", ["regular", "hpc"])
def test_long_read_u64_width(rng, mode):
    """H=u64 through the chunked driver: 64-bit hash lanes with the
    carry threaded across chunks, identity-mixhash assembly over the tiled
    uint64 stream (reference's H=u64 compile-time config, src/lib.rs:32)."""
    n = 9000
    seq = "".join(rng.choice(list("AACCGGTTAAAANN"), size=n))
    got = kminmers_long(
        seq, l=11, k=3, density=0.05, mode=mode, chunk=2048,
        hash_width=64,
    )
    ref = oracle_kminmers(seq, 11, 3, 0.05, HashMode(mode), 64)
    assert len(got["hash"]) == len(ref), (mode, len(got["hash"]), len(ref))
    for i, r in enumerate(ref):
        assert int(got["hash"][i]) == r.hash, (mode, i)
        assert int(got["start"][i]) == r.start, (mode, i)
        assert int(got["end"][i]) == r.end, (mode, i)
        assert bool(got["rev"][i]) == r.rev, (mode, i)


def test_long_read_batch_matches_per_read(rng):
    """kminmers_long_batch (B>1 rows riding the same chunk launches, with
    the producer-thread staging pipeline) must be bit-identical to
    per-read kminmers_long AND the oracle — including rows of different
    lengths (short rows pad out mid-stream) and a row shorter than l."""
    from seq2kminmers.ops.long_read import kminmers_long_batch

    seqs = []
    for n in (9000, 5200, 7):
        parts = []
        m = 0
        while m < n:
            if rng.random() < 0.25:
                p = str(rng.choice(list("ACGT"))) * int(
                    rng.integers(2, 400)
                )
            else:
                p = "".join(
                    rng.choice(list("ACGTN"), size=int(rng.integers(30, 300)))
                )
            parts.append(p)
            m += len(p)
        seqs.append("".join(parts)[:n])
    l, k, d, mode = 13, 3, 0.08, "hpcsimd"
    batch = kminmers_long_batch(
        seqs, l=l, k=k, density=d, mode=mode, chunk=2048
    )
    for seq, got in zip(seqs, batch):
        one = kminmers_long(
            seq, l=l, k=k, density=d, mode=mode, chunk=2048
        )
        ref = oracle_kminmers(seq, l, k, d, HashMode(mode))
        assert len(got["hash"]) == len(ref) == len(one["hash"])
        for key in ("hash", "start", "end", "offset", "rev"):
            assert np.array_equal(got[key], one[key]), key
        for i, r in enumerate(ref):
            assert int(got["hash"][i]) == r.hash, i
            assert int(got["start"][i]) == r.start, i
            assert int(got["end"][i]) == r.end, i
