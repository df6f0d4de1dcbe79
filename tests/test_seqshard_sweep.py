"""Seeded differential sweep of the seq-sharded pipeline: random
mode x hash-width x variant x shard-count x alphabet combinations on the
virtual CPU mesh, stitched output checked record-for-record against the
numpy oracle.  Extends tests/test_seqshard.py's targeted cases the way
test_fidelity_sweep.py extends the byte-fidelity suite — in particular it
adds the NtHash2-31 variant through the mesh (its mod-31 rank carry must
survive the base-space hand-off) and width x S cross products.
"""

import zlib

import numpy as np
import jax.numpy as jnp
import pytest

from seq2kminmers.constants import XCODE_PAD, encode_xcodes, family_of_mode
from seq2kminmers.oracle import HashMode
from seq2kminmers.oracle import kminmers as oracle_kminmers
from seq2kminmers.ops.pipeline import PipelineSpec
from seq2kminmers.parallel.mesh import make_mesh
from seq2kminmers.parallel.seqshard import (
    make_seq_pipeline,
    stitch_segments,
)

COMBOS = [
    # (mode, width, variant, S, l, k, d)
    ("regular", 32, "nthash1", 8, 19, 4, 0.05),
    ("simd", 32, "nthash1", 2, 25, 6, 0.12),
    ("hpc", 32, "nthash1", 8, 9, 2, 0.2),
    ("hpcsimd", 32, "nthash1", 4, 17, 5, 0.03),
    ("regular", 16, "nthash1", 4, 11, 3, 0.15),
    ("hpc", 16, "nthash1", 2, 15, 4, 0.1),
    ("regular", 64, "nthash1", 8, 21, 2, 0.08),
    ("hpc", 64, "nthash1", 2, 13, 3, 0.1),
    ("regular", 32, "nthash2", 4, 45, 3, 0.1),
    ("hpc", 32, "nthash2", 8, 39, 2, 0.12),
    ("simd", 32, "nthash2", 2, 61, 4, 0.08),
    ("hpcsimd", 32, "nthash2", 4, 35, 2, 0.15),
]


def _gen(rng, B, L):
    codes = np.full((B, L), XCODE_PAD, dtype=np.uint8)
    lengths = np.zeros(B, dtype=np.int32)
    seqs = []
    alpha = [list("ACGT"), list("ACGTN"), list("ACGTacgtNnQX")]
    for b in range(B):
        n = int(rng.integers(L // 3, L - 1))
        parts = []
        m = 0
        while m < n:
            if rng.random() < 0.3:  # homopolymer bomb (may span shards)
                p = str(rng.choice(list("ACGT"))) * int(
                    rng.integers(2, 700)
                )
            else:
                p = "".join(
                    rng.choice(alpha[b % 3], size=int(rng.integers(30, 200)))
                )
            parts.append(p)
            m += len(p)
        s = "".join(parts)[:n]
        seqs.append(s)
        codes[b, :n] = encode_xcodes(s, family_of_mode("regular"))
        lengths[b] = n
    return codes, lengths, seqs


@pytest.mark.parametrize(
    "combo",
    COMBOS,
    ids=[f"{m}-w{w}-{v}-S{S}-l{l}" for m, w, v, S, l, k, d in COMBOS],
)
def test_seqshard_sweep(combo):
    mode, width, variant, S, l, k, d = combo
    rng = np.random.default_rng(zlib.crc32(repr(combo).encode()))
    mesh = make_mesh(n_data=1, n_seq=S)
    B, L = 2, S * 1024 * (2 if S <= 4 else 1)
    codes, lengths, seqs = _gen(rng, B, L)
    # re-encode with the mode's family (garbage/lowercase differ)
    fam = family_of_mode(mode)
    for b, s in enumerate(seqs):
        codes[b, : len(s)] = encode_xcodes(s, fam)
    spec = PipelineSpec(
        l=l, k=k, density=d, mode=mode, hash_width=width, variant=variant,
    )
    fn = make_seq_pipeline(spec, mesh)
    with mesh:
        out = stitch_segments(fn(jnp.asarray(codes), jnp.asarray(lengths)))
    if (np.asarray(out.n_minimizers_raw) > np.asarray(out.n_minimizers)).any():
        # Dense homopolymer runs whose window hash clears the bound can
        # overflow the per-shard capacity (survivors may concentrate in
        # one shard); the seqshard contract is report-don't-retry, so
        # callers escalate with a raw-count-sized capacity —
        # api.rescue_spec, worth sweeping through the mesh itself.  S
        # scales the capacity because cap_s = capacity // S must cover a
        # maximally skewed shard.
        from seq2kminmers.api import rescue_spec

        spec = rescue_spec(
            spec, int(np.asarray(out.n_minimizers_raw).max()) * S
        )
        fn = make_seq_pipeline(spec, mesh)
        with mesh:
            out = stitch_segments(
                fn(jnp.asarray(codes), jnp.asarray(lengths))
            )
    for b, s in enumerate(seqs):
        ref = oracle_kminmers(s, l, k, d, HashMode(mode), width, variant)
        nk = int(out.n_kminmers[b])
        assert int(out.n_minimizers_raw[b]) == int(out.n_minimizers[b])
        assert nk == len(ref), (combo, b, nk, len(ref))
        hh = np.asarray(out.hash_hi[b, :nk]).astype(np.uint64)
        hl = np.asarray(out.hash_lo[b, :nk]).astype(np.uint64)
        got_h = (hh << np.uint64(32)) | hl
        for i, r in enumerate(ref):
            assert int(got_h[i]) == r.hash, (combo, b, i)
            assert int(out.start[b, i]) == r.start, (combo, b, i)
            assert int(out.end[b, i]) == r.end, (combo, b, i)
            assert bool(out.rev[b, i]) == r.rev, (combo, b, i)
