"""Multi-device tests on the virtual 8-device CPU mesh: data-parallel
shard_map pipeline, ordered merge, and sequence-sharded SPMD execution."""

import numpy as np
import pytest

from seq2kminmers.constants import (
    CODE_TO_BYTE,
    XCODE_PAD,
    with_keep_bits,
)
from seq2kminmers.oracle import HashMode, kminmers as oracle_kminmers
from seq2kminmers.ops.pipeline import PipelineSpec, kminmer_pipeline


def _random_batch(rng, B, L, lmin=200):
    codes = with_keep_bits(rng.integers(0, 4, size=(B, L)))
    lengths = rng.integers(lmin, L, size=B).astype(np.int32)
    for b in range(B):
        codes[b, lengths[b] :] = XCODE_PAD
    return codes, lengths


def _decode(codes, length):
    return CODE_TO_BYTE[codes[:length] & 7].tobytes().decode()


@pytest.mark.parametrize("mode", ["regular", "hpcsimd"])
def test_dp_pipeline_matches_oracle(rng, mode):
    import jax

    from seq2kminmers.parallel.driver import (
        make_dp_pipeline,
        merge_ordered,
    )
    from seq2kminmers.parallel.mesh import make_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    B, L = 16, 1024
    codes, lengths = _random_batch(rng, B, L)
    mesh = make_mesh(n_data=8)
    spec = PipelineSpec(l=10, k=3, density=0.05, mode=mode, max_minimizers=128)
    res = make_dp_pipeline(spec, mesh)(codes, lengths)
    merged = merge_ordered(res)

    p = 0
    for b in range(B):
        ref = oracle_kminmers(
            _decode(codes[b], lengths[b]), 10, 3, 0.05, HashMode(mode)
        )
        n = len(ref)
        assert int(np.asarray(res.batch.n_kminmers).reshape(-1)[b]) == n
        for i in range(n):
            assert int(merged["hash"][p + i]) == ref[i].hash
            assert int(merged["start"][p + i]) == ref[i].start
            assert int(merged["offset"][p + i]) == i
        p += n
    assert p == int(res.total)


def test_merge_ordered_large_batch(rng):
    """The stitch is vectorized O(total): validate it directly at B=10k
    against a per-read reference loop on synthetic padded outputs."""
    from seq2kminmers.ops.pipeline import KminmerBatch
    from seq2kminmers.parallel.driver import (
        ShardedKminmers,
        merge_ordered,
    )

    B, Mk = 10_000, 7
    counts = rng.integers(0, Mk + 1, size=B).astype(np.int32)
    bases = (np.cumsum(counts) - counts).astype(np.int32)
    total = int(counts.sum())
    hi = rng.integers(0, 2**31, size=(B, Mk)).astype(np.uint32)
    lo = rng.integers(0, 2**31, size=(B, Mk)).astype(np.uint32)
    start = rng.integers(0, 1000, size=(B, Mk)).astype(np.int32)
    end = start + 30
    rev = rng.random((B, Mk)) < 0.5
    batch = KminmerBatch(
        hash_hi=hi, hash_lo=lo, start=start, end=end, rev=rev,
        n_kminmers=counts,
        min_hash=lo, min_hash_hi=hi, min_start=start, min_end=end,
        n_minimizers=counts, n_minimizers_raw=counts,
    )
    merged = merge_ordered(
        ShardedKminmers(
            batch=batch, global_offset=bases, total=np.int32(total),
            lost=np.int32(0),
        )
    )
    assert len(merged["hash"]) == total
    # spot-check a sample of reads element-exactly
    for b in rng.integers(0, B, size=50):
        n = counts[b]
        sl = slice(bases[b], bases[b] + n)
        exp_h = (hi[b, :n].astype(np.uint64) << np.uint64(32)) | lo[b, :n]
        assert (merged["hash"][sl] == exp_h).all()
        assert (merged["start"][sl] == start[b, :n]).all()
        assert (merged["end"][sl] == end[b, :n]).all()
        assert (merged["offset"][sl] == np.arange(n)).all()
        assert (merged["rev"][sl] == rev[b, :n]).all()
        assert (merged["read"][sl] == b).all()


def test_sequence_sharded_spmd(rng):
    """Shard the length axis over the 'seq' mesh axis and let XLA SPMD
    partition the XOR-scans (distributed scan + halo collectives)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from seq2kminmers.parallel.mesh import make_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    B, L = 8, 2048
    codes, lengths = _random_batch(rng, B, L, lmin=1500)
    mesh = make_mesh(n_data=4, n_seq=2)
    spec = PipelineSpec(l=13, k=4, density=0.02, mode="regular", max_minimizers=128)

    fn = jax.jit(
        lambda c, n: kminmer_pipeline(c, n, spec),
        in_shardings=(
            NamedSharding(mesh, P("data", "seq")),
            NamedSharding(mesh, P("data")),
        ),
    )
    out = fn(jnp.asarray(codes), jnp.asarray(lengths))
    for b in range(B):
        ref = oracle_kminmers(
            _decode(codes[b], lengths[b]), 13, 4, 0.02, HashMode.Regular
        )
        n = int(out.n_kminmers[b])
        assert n == len(ref)
        hh = np.asarray(out.hash_hi[b, :n], dtype=np.uint64)
        ll = np.asarray(out.hash_lo[b, :n], dtype=np.uint64)
        got = (hh << np.uint64(32)) | ll
        assert [int(x) for x in got] == [r.hash for r in ref]
