"""Unit tests for the low-level device ops: u64 pair arithmetic, XOR-scan
NtHash, and edge-case behavior of the pipeline."""

import numpy as np
import pytest

from seq2kminmers.api import kminmers_list
from seq2kminmers.constants import encode_bases
from seq2kminmers.oracle import (
    HashMode,
    kminmers as oracle_kminmers,
    minimizers as oracle_minimizers,
    sliding_nthash32 as np_sliding,
)


def _rand_seq(rng, n, alphabet="ACGT"):
    return "".join(rng.choice(list(alphabet), size=n))


class TestU64Pairs:
    def _pairs(self, rng, n=1024):
        import jax.numpy as jnp

        vals = rng.integers(0, 2**64, size=n, dtype=np.uint64)
        hi = jnp.asarray((vals >> np.uint64(32)).astype(np.uint32))
        lo = jnp.asarray((vals & np.uint64(0xFFFFFFFF)).astype(np.uint32))
        return vals, (hi, lo)

    def test_rol64(self, rng):
        from seq2kminmers.ops.u64 import rol64, to_py_u64

        vals, pair = self._pairs(rng)
        r = rng.integers(0, 64, size=len(vals), dtype=np.uint32)
        import jax.numpy as jnp

        got = to_py_u64(rol64(pair, jnp.asarray(r)))
        r64 = r.astype(np.uint64)
        want = ((vals << r64) | (vals >> ((np.uint64(64) - r64) % np.uint64(64)))) & np.uint64(
            0xFFFFFFFFFFFFFFFF
        )
        want = np.where(r == 0, vals, want)
        np.testing.assert_array_equal(got, want)

    def test_min_lt(self, rng):
        from seq2kminmers.ops.u64 import lt2, min2, to_py_u64

        va, pa = self._pairs(rng)
        vb, pb = self._pairs(rng)
        np.testing.assert_array_equal(to_py_u64(min2(pa, pb)), np.minimum(va, vb))
        np.testing.assert_array_equal(np.asarray(lt2(pa, pb)), va < vb)

    def test_mixhash(self, rng):
        import jax.numpy as jnp

        from seq2kminmers.oracle import mixhash_u32
        from seq2kminmers.ops.u64 import mix64_from_u32, to_py_u64

        x = rng.integers(0, 2**32, size=4096, dtype=np.uint32)
        got = to_py_u64(mix64_from_u32(jnp.asarray(x)))
        np.testing.assert_array_equal(got, mixhash_u32(x))


class TestSlidingNtHash:
    @pytest.mark.parametrize("l", [2, 5, 31, 33, 64, 100])
    def test_matches_numpy_oracle(self, rng, l):
        import jax.numpy as jnp

        from seq2kminmers.ops.nthash import sliding_nthash32

        seq = _rand_seq(rng, 500, "ACGTN")
        codes = encode_bases(seq)
        fh_np, rh_np = np_sliding(codes, l)
        fh, rh = sliding_nthash32(jnp.asarray(codes[None, :]), l)
        np.testing.assert_array_equal(np.asarray(fh[0]), fh_np)
        np.testing.assert_array_equal(np.asarray(rh[0]), rh_np)

    def test_reverse_complement_symmetry(self, rng):
        """Canonical hash of a window equals that of its reverse
        complement — the defining NtHash property."""
        seq = _rand_seq(rng, 64)
        comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
        rc = "".join(comp[c] for c in reversed(seq))
        l = len(seq)
        f1, r1 = np_sliding(encode_bases(seq), l)
        f2, r2 = np_sliding(encode_bases(rc), l)
        assert min(f1[0], r1[0]) == min(f2[0], r2[0])
        assert f1[0] == r2[0] and r1[0] == f2[0]


class TestEdgeCases:
    CASES = [
        "",
        "A",
        "ACGT",
        "ACGTACGTAC",  # len == l
        "ACGTACGTACG",  # len == l+1
        "AAAAAAAAAAAAAAAAAAAAAAAA",  # collapses to one char
        "ACGTNNNACGTACGTNACGTNNNN",
        "AACCTTGGAACCTTGGAACCTTGG",
    ]

    @pytest.mark.parametrize("mode", list(HashMode))
    @pytest.mark.parametrize("seq", CASES)
    def test_edges_match_oracle(self, seq, mode):
        got = kminmers_list(seq, 10, 2, 0.9, mode)
        ref = oracle_kminmers(seq, 10, 2, 0.9, mode)
        assert [(r.hash, r.start, r.end, r.rev) for r in got] == [
            (r.hash, r.start, r.end, r.rev) for r in ref
        ]

    def test_len_equal_l_yields_nothing(self):
        # seq.len() > l is required to construct any sub-iterator
        # (src/lib.rs:97, strict inequality).
        assert kminmers_list("ACGTACGTAC", 10, 1, 1.0, "regular") == []
        assert oracle_kminmers("ACGTACGTAC", 10, 1, 1.0, HashMode.Regular) == []

    def test_density_one_selects_everything(self, rng):
        seq = _rand_seq(rng, 300)
        mins = oracle_minimizers(seq, 10, 1.0, HashMode.Regular)
        assert len(mins) == len(seq) - 10 + 1
        got = kminmers_list(seq, 10, 3, 1.0, "regular")
        ref = oracle_kminmers(seq, 10, 3, 1.0, HashMode.Regular)
        assert [r.hash for r in got] == [r.hash for r in ref]

    def test_simd_l_limit(self):
        from seq2kminmers.api import KSizeTooBig

        with pytest.raises(KSizeTooBig):
            kminmers_list("ACGT" * 30, 32, 2, 0.5, "simd")
