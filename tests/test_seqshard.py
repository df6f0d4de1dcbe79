"""Sequence-parallel SPMD pipeline (parallel/seqshard.py): the stage chain
sharded over the 'seq' mesh axis with carry hand-off collectives must match
the oracle bit-for-bit on the virtual 8-device CPU mesh, in every mode,
including reads whose HPC runs span shard boundaries.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from seq2kminmers.constants import XCODE_PAD, encode_xcodes
from seq2kminmers.oracle import HashMode
from seq2kminmers.oracle import kminmers as oracle_kminmers
from seq2kminmers.ops.pipeline import PipelineSpec
from seq2kminmers.parallel.mesh import make_mesh
from seq2kminmers.parallel.seqshard import (
    make_seq_pipeline,
    stitch_segments,
)


def _mixed_batch(rng, B, L, lo_frac=0.4):
    codes = np.full((B, L), XCODE_PAD, dtype=np.uint8)
    lengths = np.zeros(B, dtype=np.int32)
    seqs = []
    for b in range(B):
        n = int(rng.integers(int(L * lo_frac), L - 1))
        parts = []
        while sum(map(len, parts)) < n:
            if rng.random() < 0.3:
                parts.append(
                    str(rng.choice(list("ACGT"))) * int(rng.integers(2, 60))
                )
            else:
                parts.append(
                    "".join(
                        rng.choice(list("ACGTN"), size=int(rng.integers(20, 90)))
                    )
                )
        s = "".join(parts)[:n]
        seqs.append(s)
        codes[b, :n] = encode_xcodes(s, "scalar")
        lengths[b] = n
    return codes, lengths, seqs


def _check_against_oracle(out, seqs, l, k, d, mode):
    for b, s in enumerate(seqs):
        ref = oracle_kminmers(s, l, k, d, HashMode(mode))
        nk = int(out.n_kminmers[b])
        assert int(out.n_minimizers_raw[b]) == int(out.n_minimizers[b])
        assert nk == len(ref), (mode, b, nk, len(ref))
        hh = np.asarray(out.hash_hi[b, :nk]).astype(np.uint64)
        hl = np.asarray(out.hash_lo[b, :nk]).astype(np.uint64)
        got_h = (hh << np.uint64(32)) | hl
        for i, r in enumerate(ref):
            assert int(got_h[i]) == r.hash, (mode, b, i)
            assert int(out.start[b, i]) == r.start, (mode, b, i)
            assert int(out.end[b, i]) == r.end, (mode, b, i)
            assert bool(out.rev[b, i]) == r.rev, (mode, b, i)


@pytest.mark.parametrize("mode", ["regular", "simd", "hpc", "hpcsimd"])
def test_seq_sharded_matches_oracle(rng, mode):
    mesh = make_mesh(n_data=2, n_seq=4)
    B, L = 2, 4 * 1024
    codes, lengths, seqs = _mixed_batch(rng, B, L)
    l, k, d = 13, 3, 0.08
    spec = PipelineSpec(
        l=l, k=k, density=d, mode=mode
    )
    fn = make_seq_pipeline(spec, mesh)
    with mesh:
        out = stitch_segments(fn(jnp.asarray(codes), jnp.asarray(lengths)))
    _check_against_oracle(out, seqs, l, k, d, mode)


def test_seq_sharded_two_shards_large_l(rng):
    # l = 31 windows straddling the single shard boundary; read shorter
    # than one shard (second shard all padding) must also be exact.
    mesh = make_mesh(n_data=4, n_seq=2)
    B, L = 4, 2 * 1024
    codes, lengths, seqs = _mixed_batch(rng, B, L, lo_frac=0.3)
    l, k, d = 31, 2, 0.15
    spec = PipelineSpec(
        l=l, k=k, density=d, mode="hpcsimd"
    )
    fn = make_seq_pipeline(spec, mesh)
    with mesh:
        out = stitch_segments(fn(jnp.asarray(codes), jnp.asarray(lengths)))
    _check_against_oracle(out, seqs, l, k, d, "hpcsimd")


def test_seq_sharded_run_spanning_shards(rng):
    # one homopolymer run covering an ENTIRE middle shard: that shard keeps
    # zero elements and its predecessors' tails must splice through.
    mesh = make_mesh(n_data=1, n_seq=4)
    L = 4 * 1024
    mid = str(rng.choice(list("ACGT"))) * 1400
    pre = "".join(rng.choice(list("ACGT"), size=900))
    post = "".join(rng.choice(list("ACGT"), size=1100))
    s = (pre + mid + post)[: L - 1]
    codes = np.full((1, L), XCODE_PAD, dtype=np.uint8)
    codes[0, : len(s)] = encode_xcodes(s, "scalar")
    lengths = np.array([len(s)], dtype=np.int32)
    l, k, d = 13, 2, 0.2
    spec = PipelineSpec(
        l=l, k=k, density=d, mode="hpc"
    )
    fn = make_seq_pipeline(spec, mesh)
    with mesh:
        out = stitch_segments(fn(jnp.asarray(codes), jnp.asarray(lengths)))
    _check_against_oracle(out, [s], l, k, d, "hpc")


def test_seq_sharded_rejects_misaligned_length():
    mesh = make_mesh(n_data=2, n_seq=4)
    spec = PipelineSpec(l=7, k=2, density=0.1, mode="regular")
    fn = make_seq_pipeline(spec, mesh)
    with pytest.raises(ValueError, match="multiple"):
        with mesh:
            fn(
                jnp.zeros((2, 2050), dtype=jnp.uint8),
                jnp.array([100, 100], dtype=jnp.int32),
            )


@pytest.mark.parametrize("width,mode", [(16, "regular"), (64, "regular"), (64, "hpc")])
def test_seq_sharded_hash_widths(rng, width, mode):
    """u16/u64 hash widths through the sequence-sharded path: the
    64-bit lanes' carry crosses 'seq' shard boundaries and the (hi, lo)
    pair rides the splice collective; u16 assembles via the murmur mix."""
    mesh = make_mesh(n_data=2, n_seq=4)
    B, L = 2, 4 * 1024
    codes, lengths, seqs = _mixed_batch(rng, B, L)
    l, k, d = 13, 3, 0.08
    spec = PipelineSpec(
        l=l, k=k, density=d, mode=mode, hash_width=width,
    )
    fn = make_seq_pipeline(spec, mesh)
    with mesh:
        out = stitch_segments(fn(jnp.asarray(codes), jnp.asarray(lengths)))
    for b, s in enumerate(seqs):
        ref = oracle_kminmers(s, l, k, d, HashMode(mode), width)
        nk = int(out.n_kminmers[b])
        assert int(out.n_minimizers_raw[b]) == int(out.n_minimizers[b])
        assert nk == len(ref), (width, mode, b, nk, len(ref))
        hh = np.asarray(out.hash_hi[b, :nk]).astype(np.uint64)
        hl = np.asarray(out.hash_lo[b, :nk]).astype(np.uint64)
        got_h = (hh << np.uint64(32)) | hl
        for i, r in enumerate(ref):
            assert int(got_h[i]) == r.hash, (width, mode, b, i)
            assert int(out.start[b, i]) == r.start, (width, mode, b, i)
            assert int(out.end[b, i]) == r.end, (width, mode, b, i)
            assert bool(out.rev[b, i]) == r.rev, (width, mode, b, i)


def test_seq_sharded_halo_spans_many_shards(rng):
    # density so low that each shard holds FEWER than k-1 survivors: the
    # k-window halo must splice across several predecessor shards, and
    # the first shards' window coverage starts mid-segment (km_off > 0).
    mesh = make_mesh(n_data=1, n_seq=8)
    B, L = 1, 8 * 1024
    codes, lengths, seqs = _mixed_batch(rng, B, L, lo_frac=0.9)
    l, k, d = 13, 7, 0.004
    spec = PipelineSpec(
        l=l, k=k, density=d, mode="regular"
    )
    fn = make_seq_pipeline(spec, mesh)
    with mesh:
        seg = fn(jnp.asarray(codes), jnp.asarray(lengths))
    out = stitch_segments(seg)
    _check_against_oracle(out, seqs, l, k, d, "regular")


def test_seq_sharded_k1_no_halo(rng):
    # k=1: every minimizer is a k-min-mer; the halo collective vanishes.
    mesh = make_mesh(n_data=2, n_seq=4)
    B, L = 2, 4 * 1024
    codes, lengths, seqs = _mixed_batch(rng, B, L)
    l, k, d = 11, 1, 0.05
    spec = PipelineSpec(
        l=l, k=k, density=d, mode="hpcsimd"
    )
    fn = make_seq_pipeline(spec, mesh)
    with mesh:
        out = stitch_segments(fn(jnp.asarray(codes), jnp.asarray(lengths)))
    _check_against_oracle(out, seqs, l, k, d, "hpcsimd")
