"""Overflow recovery: dense low-bound regions must never silently drop
minimizers — the reference's drain buffers grow per survivor
(src/nthash_avx512_32.rs:139-141), so the pipeline's fixed minimizer
capacity M is backed by a host-side retry loop (api.kminmers_batch) that
re-runs with M raised to the raw count until nothing is dropped."""

import numpy as np
import pytest

from seq2kminmers.api import kminmers_batch, kminmers_list
from seq2kminmers.oracle import HashMode, kminmers as oracle_kminmers
from seq2kminmers.ops.pipeline import PipelineSpec
from seq2kminmers.constants import XCODE_PAD, encode_xcodes


@pytest.mark.parametrize("mode", ["regular", "hpcsimd"])
def test_high_density_single_read(rng, mode):
    """density=0.9 selects nearly every window — far beyond the default
    slot/capacity estimates; recovery must still yield the full stream."""
    seq = "".join(rng.choice(list("ACGT"), size=3000))
    got = kminmers_list(seq, 7, 3, 0.9, HashMode(mode))
    ref = oracle_kminmers(seq, 7, 3, 0.9, HashMode(mode))
    assert len(got) == len(ref) and len(ref) > 2000
    assert [g.hash for g in got] == [r.hash for r in ref]
    assert [g.start for g in got] == [r.start for r in ref]


def test_batch_recovery_no_drops(rng):
    """Batch path: one adversarial row (dense) among normal rows; the
    retried batch must report zero drops and match the oracle row-wise."""
    B, L = 4, 2048
    rows = []
    for b in range(B):
        rows.append("".join(rng.choice(list("ACGT"), size=L)))
    codes = np.stack([encode_xcodes(s, "scalar") for s in rows])
    lengths = np.full(B, L, dtype=np.int32)
    # small initial capacity + high density forces an M overflow
    spec = PipelineSpec(
        l=9, k=4, density=0.5, mode="regular", max_minimizers=256
    )
    out = kminmers_batch(codes, lengths, spec)
    n_raw = np.asarray(out.n_minimizers_raw)
    n_min = np.asarray(out.n_minimizers)
    assert (n_min >= n_raw).all()
    for b in range(B):
        ref = oracle_kminmers(rows[b], 9, 4, 0.5, HashMode.Regular)
        nk = int(np.asarray(out.n_kminmers)[b])
        assert nk == len(ref)
        lo = np.asarray(out.hash_lo)[b, :nk].astype(np.uint64)
        hi = np.asarray(out.hash_hi)[b, :nk].astype(np.uint64)
        assert [int(x) for x in ((hi << np.uint64(32)) | lo)] == [
            r.hash & 0xFFFFFFFFFFFFFFFF for r in ref
        ]


def test_rescue_single_retry_and_executable_reuse(rng, monkeypatch):
    """Recovery must (a) resolve an m_cap overflow in ONE retry and (b)
    reuse the SAME pipeline object — hence the same jit executable — for a
    later recovery of a similar batch, because the raised M is rounded to
    a power of two instead of compiled per raw count."""
    from seq2kminmers import api

    calls = []
    orig = api._cached_pipeline

    def spy(s):
        calls.append(s)
        return orig(s)

    monkeypatch.setattr(api, "_cached_pipeline", spy)
    B, L = 2, 1024
    # ~600 of 1016 windows pass at d=0.6: far beyond M = 64
    spec = PipelineSpec(
        l=9, k=2, density=0.6, mode="regular", max_minimizers=64
    )

    def overflowing_batch(seed):
        r = np.random.default_rng(seed)
        rows = ["".join(r.choice(list("ACGT"), size=L)) for _ in range(B)]
        codes = np.stack([encode_xcodes(s, "scalar") for s in rows])
        return rows, codes, np.full(B, L, dtype=np.int32)

    rows, codes, lengths = overflowing_batch(0)
    out = kminmers_batch(codes, lengths, spec)
    assert (np.asarray(out.n_minimizers) >= np.asarray(out.n_minimizers_raw)).all()
    assert len(calls) == 2, "must recover in exactly one retry"
    raw = int(np.asarray(out.n_minimizers_raw).max())
    assert calls[1] == api.rescue_spec(spec, raw)
    assert calls[1].max_minimizers == 1024, "M rounds up to a power of two"
    ref = oracle_kminmers(rows[0], 9, 2, 0.6, HashMode.Regular)
    assert int(np.asarray(out.n_kminmers)[0]) == len(ref)

    first_rescue = calls[1]
    calls.clear()
    _, codes2, lengths2 = overflowing_batch(1)
    out2 = kminmers_batch(codes2, lengths2, spec)
    assert (np.asarray(out2.n_minimizers) >= np.asarray(out2.n_minimizers_raw)).all()
    assert len(calls) == 2
    # the lru-cached pipeline object is identical -> jit reuses the
    # already-compiled executable (same function, same avals)
    assert orig(calls[1]) is orig(first_rescue)


def test_homopolymer_bomb_hpc(rng):
    """Long homopolymer runs crush the HPC stream length while the raw
    length stays big — positions and counts must still be exact."""
    parts = []
    for _ in range(50):
        parts.append("".join(rng.choice(list("ACGT"), size=40)))
        parts.append(rng.choice(list("ACGT")) * int(rng.integers(2, 60)))
    seq = "".join(parts)
    for mode in (HashMode.Hpc, HashMode.HpcSimd):
        got = kminmers_list(seq, 6, 2, 0.7, mode)
        ref = oracle_kminmers(seq, 6, 2, 0.7, mode)
        assert [(g.hash, g.start, g.end) for g in got] == [
            (r.hash, r.start, r.end) for r in ref
        ]
