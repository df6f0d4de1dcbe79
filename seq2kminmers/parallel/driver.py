"""Data-parallel sharded pipeline with ordered global k-min-mer offsets.

Replaces the reference's thread-pool driver (src/main.rs:65-79): reads are
sharded over the `data` mesh axis; each device runs the full pipeline on its
shard; the only cross-device communication is an all-gather of per-read
k-min-mer *counts* used to assign each read its base offset in the global
ordered output stream (counts-only collective + host-side stitch — the big
arrays never move cross-device).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P


from ..ops.compact import I32
from ..ops.pipeline import KminmerBatch, PipelineSpec, kminmer_pipeline
from ..ops.u64 import to_py_u64


class ShardedKminmers(NamedTuple):
    batch: KminmerBatch  # all arrays sharded over 'data'
    global_offset: jnp.ndarray  # int32[B]: base offset of each read's
    # k-min-mers in the globally ordered stream
    total: jnp.ndarray  # int32[]: total k-min-mers across the batch
    lost: jnp.ndarray  # int32[]: REPLICATED count of shards that dropped
    # minimizers (capacity overflow) — every host sees the same value, so
    # the distributed retry loop (multihost.py) stays collective-safe


def make_dp_pipeline(spec: PipelineSpec, mesh: Mesh):
    """Returns a jitted fn(codes[B, L], lengths[B]) -> ShardedKminmers.

    B must be divisible by the 'data' axis size.  Inside the shard_map
    region each device computes its local shard; `all_gather` over 'data'
    exchanges only the count vectors (4 bytes per read).
    """

    n_data = mesh.shape["data"]

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P("data", None), P("data")),
        out_specs=ShardedKminmers(
            batch=KminmerBatch(*([P("data", None)] * 5 + [P("data")] + [P("data", None)] * 4 + [P("data")] * 2)),
            global_offset=P("data"),
            total=P(),
            lost=P(),
        ),
        check_vma=False,
    )
    def step(codes, lengths):
        out = kminmer_pipeline(codes, lengths, spec)
        counts = out.n_kminmers  # [B_local]
        all_counts = jax.lax.all_gather(counts, "data", tiled=True)  # [B]
        excl = jnp.cumsum(all_counts) - all_counts
        b_local = counts.shape[0]
        my = jax.lax.axis_index("data") * b_local
        local_base = jax.lax.dynamic_slice_in_dim(excl, my, b_local)
        total = jnp.sum(all_counts).astype(I32)
        lost = jax.lax.psum(
            jnp.any(out.n_minimizers < out.n_minimizers_raw).astype(I32),
            "data",
        )
        return ShardedKminmers(
            batch=out,
            global_offset=local_base.astype(I32),
            total=total,
            lost=lost,
        )

    return jax.jit(step)


def stitch_records(
    counts: np.ndarray,  # int[B] valid k-min-mers per read
    bases: np.ndarray,  # int[B] output base offset per read (rebased)
    total: int,  # output length (>= bases[b] + counts[b] for all b)
    hashes: np.ndarray,  # uint64[B, Mk]
    start: np.ndarray,
    end: np.ndarray,
    rev: np.ndarray,
    read_base: int = 0,  # global index of read 0 (multi-host shards)
    read_ids=None,  # int[B] explicit record ids (bucketed batches); wins
) -> dict:
    """Vectorized O(total) stitch of padded per-read outputs into one
    ordered struct-of-arrays: every output slot's (read, within-read offset)
    pair is derived from the counts alone, then one fancy-index gathers each
    column.  `bases` may be any collision-free offset assignment (e.g. the
    cross-host global offsets rebased to this host's chunk)."""
    counts = counts.astype(np.int64)
    read_of = np.repeat(np.arange(len(counts), dtype=np.int64), counts)
    seg_start = np.repeat(
        np.cumsum(counts) - counts, counts
    )  # packed start of each element's segment
    off_in_read = np.arange(counts.sum(), dtype=np.int64) - seg_start
    dest = np.repeat(bases.astype(np.int64), counts) + off_in_read
    out_h = np.zeros(total, dtype=np.uint64)
    out_s = np.zeros(total, dtype=np.int64)
    out_e = np.zeros(total, dtype=np.int64)
    out_o = np.zeros(total, dtype=np.int64)
    out_r = np.zeros(total, dtype=bool)
    out_read = np.zeros(total, dtype=np.int64)
    out_h[dest] = hashes[read_of, off_in_read]
    out_s[dest] = start[read_of, off_in_read]
    out_e[dest] = end[read_of, off_in_read]
    out_o[dest] = off_in_read
    out_r[dest] = rev[read_of, off_in_read]
    if read_ids is not None:
        out_read[dest] = np.asarray(read_ids, dtype=np.int64)[read_of]
    else:
        out_read[dest] = read_of + read_base
    return {
        "hash": out_h,
        "start": out_s,
        "end": out_e,
        "offset": out_o,
        "rev": out_r,
        "read": out_read,
    }


def merge_ordered(result: ShardedKminmers) -> dict:
    """Host-side stitch: device-sharded padded outputs -> one globally
    ordered struct-of-arrays {hash u64, start, end, offset, rev}[total].

    The sequence order is preserved: read b's k-min-mers occupy
    [global_offset[b], global_offset[b] + n_kminmers[b]), and within a read
    offsets are 0..n-1 as in the reference (src/lib.rs:258-259).
    """
    b = result.batch
    hashes = to_py_u64((np.asarray(b.hash_hi), np.asarray(b.hash_lo)))
    return stitch_records(
        np.asarray(b.n_kminmers),
        np.asarray(result.global_offset),
        int(np.asarray(result.total)),
        hashes,
        np.asarray(b.start),
        np.asarray(b.end),
        np.asarray(b.rev),
    )
