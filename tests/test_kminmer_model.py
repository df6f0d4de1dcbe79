"""Tests for the k-min-mer data model (kminmer.py): canonicalization,
hash-identity semantics, and the host hashers (FxHash64/32, SipHash-1-3).

Mirrors the reference's KminmerVec/KminmerHash semantics
(reference src/kminmer.rs): identity is the canonical mers vector;
positions are payload.
"""

import numpy as np
import pytest

from seq2kminmers.kminmer import (
    KminmerVec,
    SipHash13,
    fxhash32_of_mers,
    fxhash64_bytes,
    fxhash64_of_mers,
    kminmer_hash_from_mers,
    kminmers_vec,
    siphash13_of_mers,
)
from seq2kminmers.oracle import HashMode, kminmers


def test_normalize_picks_lexicographic_min():
    v = KminmerVec(mers=[5, 2, 9])  # reversed [9, 2, 5] > [5, 2, 9]
    assert v.mers == [5, 2, 9] and v.rev is False
    w = KminmerVec(mers=[9, 2, 5])
    assert w.mers == [5, 2, 9] and w.rev is True
    assert v == w  # identity on canonical mers (kminmer.rs:97-101)
    assert v.is_normalized() and w.is_normalized()


def test_palindrome_not_reversed():
    v = KminmerVec(mers=[3, 7, 3])
    assert v.mers == [3, 7, 3] and v.rev is False


def test_ordering_on_mers():
    a = KminmerVec(mers=[1, 2, 3])
    b = KminmerVec(mers=[1, 2, 4])
    assert a < b
    assert sorted([b, a]) == [a, b]


def test_hash_from_mers_orientation_invariant():
    r1 = kminmer_hash_from_mers([5, 2, 9], 0, 10, 0)
    r2 = kminmer_hash_from_mers([9, 2, 5], 3, 14, 1)
    assert r1.hash == r2.hash  # same canonical vec
    assert r1.rev is False and r2.rev is True
    assert r1 == r2  # KminmerRecord equality is hash-only


def test_fxhash64_reference_fold():
    """Independent step-by-step transcription of the fxhash fold
    (fxhash 0.2.1: h = (rol64(h, 5) ^ word) * 0x517cc1b727220a95)."""
    M = (1 << 64) - 1
    SEED = 0x51_7C_C1_B7_27_22_0A_95

    def fold(h, w):
        return (((h << 5) | (h >> 59)) & M ^ w) * SEED & M

    data = bytes(range(20))  # 2 full words + 4-byte tail
    h = fold(0, int.from_bytes(data[0:8], "little"))
    h = fold(h, int.from_bytes(data[8:16], "little"))
    h = fold(h, int.from_bytes(data[16:20], "little"))
    assert fxhash64_bytes(data) == h


def test_fxhash_of_mers_is_length_prefixed():
    # Vec hashing = write_usize(len) + raw LE bytes: [0] vs [0, 0] differ
    assert fxhash64_of_mers([0]) != fxhash64_of_mers([0, 0])
    assert fxhash32_of_mers([1, 2]) != fxhash32_of_mers([2, 1])
    # u32 pair packs to one 8-byte word: order matters
    assert fxhash64_of_mers([1, 2]) != fxhash64_of_mers([2, 1])


def test_siphash13_stream_invariance():
    """Streaming writes must equal one-shot writes (same byte stream)."""
    h1 = SipHash13()
    h1.write(b"abcdefghij")
    one = h1.finish()
    h2 = SipHash13()
    h2.write(b"abc")
    h2.write(b"defghij")
    assert h2.finish() == one
    assert siphash13_of_mers([1, 2, 3]) != siphash13_of_mers([1, 2, 4])


def test_kminmers_vec_consistent_with_rolling_path(ecoli_seq):
    """KminmerVec stream agrees with the production rolling-hash stream on
    count, positions and window contents; the hash VALUES differ by design
    (fxhash-of-vec vs rolling minimizer-space NtHash — two coexisting
    KminmerType choices in the reference, src/lib.rs:39)."""
    seq = ecoli_seq[:20000]
    vecs = kminmers_vec(seq, 10, 5, 0.005, HashMode.Regular)
    recs = kminmers(seq, 10, 5, 0.005, HashMode.Regular)
    assert len(vecs) == len(recs) > 0
    for v, r in zip(vecs, recs):
        assert v.start == r.start
        assert v.end == r.end
        assert v.offset == r.offset


def test_get_hash_warns():
    v = KminmerVec(mers=[1, 2, 3])
    with pytest.warns(UserWarning, match="performance issue"):
        h = v.get_hash()
    assert 0 <= h < (1 << 64)
