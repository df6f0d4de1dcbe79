"""NtHash2-hybrid 31-bit variant tests (reference src/nthash2_avx512_32.rs,
the disabled l > 31 path).  Validated by construction: the numpy oracle
implements the reference's rori31/rorv31 recurrences literally (see
oracle.sliding_nthash2_31 docstring for the derivation); the JAX path is
checked element-exactly against it, including l > 31 where 32-bit NtHash1
degenerates.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from seq2kminmers.api import kminmers_list
from seq2kminmers.constants import (
    encode_bases,
    hash_bound_nthash2_31,
    hash_bound_simd_u32,
)
from seq2kminmers.oracle import (
    HashMode,
    kminmers as oracle_kminmers,
    sliding_nthash2_31,
)
from seq2kminmers.ops.nthash import (
    sliding_nthash2_31 as jax_nthash2,
)


def _literal_nthash2(codes, l):
    """Direct transcription of the reference init loops
    (src/nthash2_avx512_32.rs:271-311) — the independent cross-check for
    the oracle's closed form."""
    M31 = (1 << 31) - 1

    def rol31(x, r):
        r %= 31
        return ((x << r) | (x >> (31 - r))) & M31 if r else x

    def ror31(x, r):
        r %= 31
        return ((x >> r) | (x << (31 - r))) & M31 if r else x

    seeds = [0x3C8BFBB395C60474, 0x3193C18562A02B4C,
             0x20323ED082572324, 0x295549F54BE24456]
    sf = [s >> 33 for s in seeds] + [0, 1, 0]
    sr = [seeds[3] >> 33, seeds[2] >> 33, seeds[1] >> 33, seeds[0] >> 33,
          0, 1, 0]
    ck = 31 - (l % 31)
    out_f, out_r = [], []
    for w in range(len(codes) - l + 1):
        fh = 0
        for i in range(l):
            fh = rol31(fh, 1)
            fh ^= sf[codes[w + i]]
        rh = 0
        for i in range(l):
            rh ^= ror31(sr[codes[w + i]], ck)
            rh = ror31(rh, 1)
        out_f.append(fh)
        out_r.append(rh)
    return np.array(out_f, dtype=np.uint64), np.array(out_r, dtype=np.uint64)


@pytest.mark.parametrize("l", [7, 31, 41])
def test_oracle_matches_reference_loops(rng, l):
    codes = encode_bases("".join(rng.choice(list("ACGT"), size=300)))
    fo, ro = sliding_nthash2_31(codes, l)
    fl, rl = _literal_nthash2(codes, l)
    assert (fo == fl).all()
    assert (ro == rl).all()


@pytest.mark.parametrize("l", [7, 31, 45])
def test_jax_nthash2_matches_oracle(rng, l):
    codes = encode_bases("".join(rng.choice(list("ACGTN"), size=1024)))
    fo, ro = sliding_nthash2_31(codes, l)
    fj, rj = jax.jit(lambda c: jax_nthash2(c, l))(jnp.asarray(codes[None]))
    assert (np.asarray(fj)[0].astype(np.uint64) == fo).all()
    assert (np.asarray(rj)[0].astype(np.uint64) == ro).all()


def test_bound_is_halved():
    assert hash_bound_nthash2_31(0.01) == hash_bound_simd_u32(0.01) // 2


@pytest.mark.parametrize("mode", ["regular", "simd", "hpc", "hpcsimd"])
def test_pipeline_nthash2_matches_oracle(rng, mode):
    """Full k-min-mer pipeline with variant=nthash2 at l=35 > 31 (the
    variant's reason to exist) against the oracle."""
    seq = "".join(rng.choice(list("AACCGGTTAA"), size=3000))
    got = kminmers_list(seq, 35, 3, 0.05, mode, variant="nthash2")
    ref = oracle_kminmers(seq, 35, 3, 0.05, HashMode(mode), variant="nthash2")
    assert len(got) == len(ref) and len(ref) > 0
    for g, r in zip(got, ref):
        assert (g.hash, g.start, g.end, g.offset, g.rev) == (
            r.hash, r.start, r.end, r.offset, r.rev
        )


@pytest.mark.parametrize("l", [35, 63, 129])
@pytest.mark.parametrize("mode", ["regular", "hpcsimd"])
def test_chunked_scan_nthash2_matches_oracle(rng, mode, l):
    """variant=nthash2 at l > 31 through the carry-aware scan cut into
    chunks (the mod-31 rank carry crosses every chunk boundary),
    element-exact vs the oracle."""
    from seq2kminmers.ops.long_read import kminmers_long

    seq = "".join(rng.choice(list("AACCGGTTAANN"), size=2500))
    got = kminmers_long(
        seq, l, 3, 0.08, mode=mode, variant="nthash2", chunk=700
    )
    ref = oracle_kminmers(
        seq, l, 3, 0.08, HashMode(mode), variant="nthash2"
    )
    nk = len(got["hash"])
    assert nk == len(ref) and len(ref) > 0, (mode, l)
    for w, r in enumerate(ref):
        assert int(got["hash"][w]) == r.hash, (mode, l, w)
        assert int(got["start"][w]) == r.start
        assert int(got["end"][w]) == r.end
        assert bool(got["rev"][w]) == r.rev
