"""Cross-mode equivalence stress tests (reference tests/main.rs:82-89):
Regular == Simd and Hpc == HpcSimd as hash streams, over the l x k grid.

Hash-only equality, like the reference KminmerHash Eq (src/kminmer.rs:181).
We run the grid on the oracle (fast, bit-exact) and a subsample through the
JAX pipeline.
"""

import pytest

from seq2kminmers.api import kminmers_list
from seq2kminmers.oracle import HashMode, kminmers as oracle_kminmers

GRID_L = [5, 7, 11, 17, 25, 31]
GRID_K = [2, 5, 8]


@pytest.mark.parametrize("l", GRID_L)
@pytest.mark.parametrize("k", GRID_K)
def test_oracle_cross_mode(ecoli_seq, l, k):
    reg = oracle_kminmers(ecoli_seq, l, k, 0.01, HashMode.Regular)
    simd = oracle_kminmers(ecoli_seq, l, k, 0.01, HashMode.Simd)
    assert [r.hash for r in reg] == [r.hash for r in simd]
    hpc = oracle_kminmers(ecoli_seq, l, k, 0.01, HashMode.Hpc)
    hpcs = oracle_kminmers(ecoli_seq, l, k, 0.01, HashMode.HpcSimd)
    assert [r.hash for r in hpc] == [r.hash for r in hpcs]


@pytest.mark.parametrize("l,k", [(5, 2), (11, 5), (31, 8)])
def test_jax_cross_mode(ecoli_seq, l, k):
    reg = kminmers_list(ecoli_seq, l, k, 0.01, HashMode.Regular)
    simd = kminmers_list(ecoli_seq, l, k, 0.01, HashMode.Simd)
    assert [r.hash for r in reg] == [r.hash for r in simd]
    hpc = kminmers_list(ecoli_seq, l, k, 0.01, HashMode.Hpc)
    hpcs = kminmers_list(ecoli_seq, l, k, 0.01, HashMode.HpcSimd)
    assert [r.hash for r in hpc] == [r.hash for r in hpcs]


@pytest.mark.parametrize("l,k", [(7, 2), (17, 5), (25, 3)])
@pytest.mark.parametrize(
    "mode", [HashMode.Regular, HashMode.Simd, HashMode.Hpc, HashMode.HpcSimd]
)
def test_jax_matches_oracle_grid(ecoli_seq, l, k, mode):
    seq = ecoli_seq[:20000]
    got = kminmers_list(seq, l, k, 0.01, mode)
    ref = oracle_kminmers(seq, l, k, 0.01, mode)
    assert [(r.hash, r.start, r.end, r.rev) for r in got] == [
        (r.hash, r.start, r.end, r.rev) for r in ref
    ]
