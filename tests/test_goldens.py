"""Golden-value tests transcribed from the reference test suite
(reference tests/main.rs:12-90).  These literal values are the bit-identity
oracle for the whole framework."""

import numpy as np
import pytest

from seq2kminmers.api import KminmersIterator, kminmers_list
from seq2kminmers.oracle import HashMode, kminmers as oracle_kminmers

# Golden k-min-mer hashes for KminmersIterator(l=10, k=5, d=0.0001, Regular)
# with the active H=u32 configuration (reference tests/main.rs:41-57).
GOLDEN_HASHES_U32 = [
    143479479014703,
    1415094313937202,
    7085699921625713,
    2731023262850893,
    3529660833839258,
    2520689800435504,
    3515165585325381,
    2855190423625803,
    5122855536061684,
    244022361441902,
    2856446528761135,
    906939906227534,
    2115341643533671,
    246274980452770,
    159737436030657,
]


# Golden hashes for the same config with the H=u64 compile-time alternative
# (reference tests/main.rs:18-39, src/lib.rs:32): full 64-bit NtHash1 seeds,
# identity mixhash (src/lib.rs:171-177), bound = density * (u64::MAX as f64).
GOLDEN_HASHES_U64 = [
    6097375827354318,
    5077268723048817,
    17093614815813553,
    13932651659877218,
    2254626575123847,
    4725847317728813,
    10971942364167709,
    1406844240705087,
    15284878278949327,
    13429516156719180,
    10760699289819902,
    11244197813995113,
    6993910349997344,
    22098843726082404,
    4944933674400292,
    14212811059278321,
    9310664830401458,
    11232758307960192,
    9720472733789719,
    13210101786532125,
]


def test_oracle_goldens(ecoli_seq):
    recs = oracle_kminmers(ecoli_seq, 10, 5, 0.0001, HashMode.Regular)
    assert [r.hash for r in recs] == GOLDEN_HASHES_U32


def test_oracle_goldens_u64(ecoli_seq):
    recs = oracle_kminmers(
        ecoli_seq, 10, 5, 0.0001, HashMode.Regular, hash_width=64
    )
    assert [r.hash for r in recs] == GOLDEN_HASHES_U64


def test_jax_pipeline_goldens(ecoli_seq):
    recs = kminmers_list(ecoli_seq, 10, 5, 0.0001, HashMode.Regular)
    assert [r.hash for r in recs] == GOLDEN_HASHES_U32


@pytest.mark.parametrize("mode", list(HashMode))
def test_jax_matches_oracle_all_modes(ecoli_seq, mode):
    """Full-record equality (hash, start, end, offset, rev) between the JAX
    pipeline and the numpy oracle on the golden fixture."""
    got = kminmers_list(ecoli_seq, 10, 5, 0.0005, mode)
    ref = oracle_kminmers(ecoli_seq, 10, 5, 0.0005, mode)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert (g.hash, g.start, g.end, g.offset, g.rev) == (
            r.hash,
            r.start,
            r.end,
            r.offset,
            r.rev,
        )


def test_jax_pipeline_goldens_u64(ecoli_seq):
    recs = kminmers_list(
        ecoli_seq, 10, 5, 0.0001, HashMode.Regular, hash_width=64
    )
    assert [r.hash for r in recs] == GOLDEN_HASHES_U64


@pytest.mark.parametrize("mode", [HashMode.Regular, HashMode.Hpc])
@pytest.mark.parametrize("width", [16, 64])
def test_jax_matches_oracle_hash_widths(ecoli_seq, mode, width):
    """The u16/u64 JAX paths (emulated 64-bit lanes / murmur mix) match the
    numpy oracle record-for-record."""
    seq = ecoli_seq[:4096]
    d = 0.03 if width == 16 else 0.003
    got = kminmers_list(seq, 11, 3, d, mode, hash_width=width)
    ref = oracle_kminmers(seq, 11, 3, d, mode, hash_width=width)
    assert len(got) == len(ref) and len(ref) > 0
    for g, r in zip(got, ref):
        assert (g.hash, g.start, g.end, g.offset, g.rev) == (
            r.hash,
            r.start,
            r.end,
            r.offset,
            r.rev,
        )


def test_iterator_facade(ecoli_seq):
    it = KminmersIterator(ecoli_seq, 10, 5, 0.0001, "regular")
    hashes = [km.get_hash() for km in it]
    assert hashes == GOLDEN_HASHES_U32
    offsets = [km.offset for km in it]
    assert offsets == list(range(len(GOLDEN_HASHES_U32)))
