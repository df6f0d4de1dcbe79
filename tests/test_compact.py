"""Masked compaction (ops/compact.py), validated element-exactly against
numpy.

compact() is the equivalent of the reference's AVX-512 compress-store loops
(reference src/nthash_avx512_32.rs:130-141, src/hpc.rs:104-108).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from seq2kminmers.ops.compact import compact


def _np_compact(mask, vals, m):
    idx = np.nonzero(mask)[0]
    out = vals[idx[:m]]
    return out, len(idx)


@pytest.mark.parametrize(
    "density,tag",
    [(0.0, "empty"), (1.0, "full"), (0.3, "mid"), (0.01, "sparse")],
)
def test_masked_compact_density(rng, density, tag):
    B, N, m = 3, 4096, 1024
    mask = rng.random((B, N)) < density
    vals = rng.integers(0, 2**31, size=(B, N)).astype(np.int32)
    (pv,), cnt = compact(
        jnp.asarray(mask), [jnp.asarray(vals)], m, [np.int32(-1)]
    )
    pv, cnt = np.asarray(pv), np.asarray(cnt)
    for b in range(B):
        exp, n_exp = _np_compact(mask[b], vals[b], m)
        assert cnt[b] == n_exp
        assert (pv[b, : len(exp)] == exp).all()
        assert (pv[b, len(exp) :] == -1).all()


def test_masked_compact_multicol_and_dtypes(rng):
    B, N, m = 2, 2048, 2048
    mask = rng.random((B, N)) < 0.5
    a = rng.integers(0, 2**31, size=(B, N)).astype(np.int32)
    b8 = rng.integers(0, 256, size=(B, N)).astype(np.uint8)
    c32 = rng.integers(0, 2**32, size=(B, N), dtype=np.uint64).astype(
        np.uint32
    )
    (pa, pb, pc), cnt = compact(
        jnp.asarray(mask),
        [jnp.asarray(a), jnp.asarray(b8), jnp.asarray(c32)],
        m,
        [np.int32(0), np.uint8(0), np.uint32(0)],
    )
    assert pb.dtype == jnp.uint8 and pc.dtype == jnp.uint32
    for bb in range(B):
        idx = np.nonzero(mask[bb])[0]
        assert cnt[bb] == len(idx)
        assert (np.asarray(pa)[bb, : len(idx)] == a[bb, idx]).all()
        assert (np.asarray(pb)[bb, : len(idx)] == b8[bb, idx]).all()
        assert (np.asarray(pc)[bb, : len(idx)] == c32[bb, idx]).all()


def test_masked_compact_boundary_patterns():
    N = 2048
    mask = np.zeros((4, N), bool)
    mask[0, -1] = True  # single survivor at the very end
    mask[1, 0] = True  # single survivor at the start
    mask[2, 127:1025] = True  # long run in the middle
    # row 3 stays empty
    vals = np.arange(4 * N, dtype=np.int32).reshape(4, N)
    (pv,), cnt = compact(
        jnp.asarray(mask), [jnp.asarray(vals)], 1024, [np.int32(0)]
    )
    pv, cnt = np.asarray(pv), np.asarray(cnt)
    for b in range(4):
        exp, n_exp = _np_compact(mask[b], vals[b], 1024)
        assert cnt[b] == n_exp
        assert (pv[b, : len(exp)] == exp).all()


def test_masked_compact_overflow_truncates():
    mask = np.ones((1, 2048), bool)
    vals = np.arange(2048, dtype=np.int32)[None, :]
    (pv,), cnt = compact(
        jnp.asarray(mask), [jnp.asarray(vals)], 256, [np.int32(0)]
    )
    assert int(cnt[0]) == 2048  # raw count reports the overflow
    assert (np.asarray(pv)[0, :256] == vals[0, :256]).all()
