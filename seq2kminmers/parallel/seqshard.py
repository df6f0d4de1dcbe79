"""Sequence-parallel (SPMD) pipeline: shard ONE read's bases over the
'seq' mesh axis and run the carry-aware stage chain (ops/scan.py) on every
shard in parallel.

The reference processes each sequence serially (one thread, one AVX-512
lane-block at a time, src/nthash_avx512_32.rs); its block hand-off algebra
(lane-15 carry + variable rotate, :404-425) is what makes the scan
resumable mid-stream.  This module is that hand-off lifted to the mesh,
applied TWICE — once per stream level:

  1. Base space: each shard computes, locally and in parallel, its
     kept-stream length and its last-l kept (position, code) elements.
     One all-gather over 'seq' exchanges those tiny carries (l packed
     int32 per read per shard); each shard reconstructs its global base
     rank and pending prefix (spliced across as many predecessor shards as
     needed — a shard inside a mega-homopolymer run may contribute 0) and
     runs the SAME scan_step as the single-device paths with that carry.
     The emission intervals guarantee each minimizer is emitted by exactly
     one shard.
  2. Minimizer space: each shard compacts its survivors locally — they
     form a CONTIGUOUS slice of the global minimizer stream, so the
     stream is already sharded over 'seq' in order.  K-min-mer windows
     that straddle a shard boundary need only the k-1 minimizers
     preceding the shard: a second tiny all-gather exchanges each
     shard's last-(k-1) survivor (start, hash) tails (same splice
     algebra as step 1, l -> k-1), and every shard assembles its own
     windows.  The survivor streams themselves never move.

Outputs stay sharded over 'seq' as ordered per-shard stream segments
(KminmerSegments); `stitch_segments` concatenates them on the host.

Communication per read per step is O(l + k) int32 — independent of both
the sequence length and the density — vs the O(L/S) local scan.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.assemble import assemble_for_width
from ..ops.compact import I32, compact
from ..ops.pipeline import KminmerBatch, PipelineSpec
from ..ops.scan import ScanCarry, scan_step, window_limit

U32 = jnp.uint32


class KminmerSegments(NamedTuple):
    """Seq-sharded pipeline output: ordered per-shard stream segments.

    Every [B, S*cap] array holds S segments of cap columns per read; the
    valid entries of segment s are rows [:, s*cap + off : s*cap + off +
    n] with off/n from the matching [B, S] columns (off is nonzero only
    on shards whose k-window coverage starts mid-segment, i.e. while the
    global stream is still shorter than k-1).  `stitch_segments`
    produces the dense single-stream view on the host.
    """

    hash_hi: jnp.ndarray  # uint32[B, S*cap]
    hash_lo: jnp.ndarray  # uint32[B, S*cap]
    start: jnp.ndarray  # int32[B, S*cap]
    end: jnp.ndarray  # int32[B, S*cap]
    rev: jnp.ndarray  # bool[B, S*cap]
    n_kminmers_seg: jnp.ndarray  # int32[B, S]
    km_off_seg: jnp.ndarray  # int32[B, S]
    min_hash: jnp.ndarray  # uint32[B, S*cap]
    min_hash_hi: jnp.ndarray  # uint32[B, S*cap] (zeros unless width 64)
    min_start: jnp.ndarray  # int32[B, S*cap]
    min_end: jnp.ndarray  # int32[B, S*cap]
    n_minimizers_seg: jnp.ndarray  # int32[B, S]
    n_minimizers_raw_seg: jnp.ndarray  # int32[B, S]


def _local_tail(codes, local_len, l, s, c, do_hpc):
    """Per-shard carry stats: kept-stream count + the shard's last
    min(count, l) kept elements as packed ((global_pos << 3) | code),
    left-aligned in an l-slot buffer."""
    Bl, C = codes.shape
    ci = codes.astype(I32)
    gpos0 = s * c
    pos_i = jax.lax.broadcasted_iota(I32, (Bl, C), dimension=1)
    if do_hpc:
        keep = ((ci & 8) != 0) & (pos_i < local_len[:, None])
        cnt = keep.sum(axis=1).astype(I32)
        packed = ((gpos0 + pos_i) << 3) | (ci & 7)
        # last-l kept = first-l kept of the flipped stream; compact
        # left-packs them so tail[:, i] is the (i+1)-th element FROM THE
        # END (reversed order — _build_pending flips once at the end).
        comp, _ = compact(
            jnp.flip(keep, axis=1),
            [jnp.flip(packed, axis=1)],
            l,
            [I32(0)],
        )
        tail = comp[0]
        v = jnp.minimum(cnt, l)
    else:
        # every padded position is a stream element (scan_step's non-HPC
        # semantics); the tail is simply the last l columns.
        cnt = jnp.full((Bl,), C, dtype=I32)
        seg = ci[:, C - l :]
        gp = gpos0 + C - l + jax.lax.broadcasted_iota(
            I32, (Bl, l), dimension=1
        )
        tail_fwd = (gp << 3) | (seg & 7)
        tail = jnp.flip(tail_fwd, axis=1)  # reversed order, like above
        v = jnp.full((Bl,), l, dtype=I32)
    return cnt, tail, v


def _build_pending(all_tail, all_v, s, my_off, l):
    """Reconstruct the pending prefix for shard s from every predecessor's
    reversed tail buffer: the last l global stream elements before this
    shard, right-aligned in scan_step's [Bl, l] carry layout with positions
    rebased to this shard's origin."""
    S, Bl, _ = all_tail.shape
    # Walk shards in REVERSE order (s-1, s-2, ...): their reversed tails
    # concatenated give the global stream's last elements nearest-first.
    order = jnp.arange(S - 1, -1, -1, dtype=I32)
    rev_tails = all_tail[order].transpose(1, 0, 2).reshape(Bl, S * l)
    # validity per (shard j, slot i): shard j contributes its first v_j
    # reversed-slots, and only shards j < s count.
    slot_i = jnp.arange(l, dtype=I32)[None, None, :]
    vmask = (order[None, :, None] < s) & (
        slot_i < all_v[order].transpose(1, 0)[:, :, None]
    )
    vmask = vmask.reshape(Bl, S * l)
    comp, p_raw = compact(vmask, [rev_tails], l, [I32(0)])
    near_first = comp[0]  # [Bl, l]: element j = (j+1)-th before the shard
    # Rebase positions to this shard's origin: packed layout makes that a
    # subtraction of (offset << 3) on valid slots only.
    pv = jnp.minimum(p_raw, l)[:, None]
    iv = jnp.arange(l, dtype=I32)[None, :]
    near_first = jnp.where(
        iv < pv, near_first - (my_off << 3), 0
    )
    # Right-align: pend[:, l-1-j] = the (j+1)-th element before the shard.
    return jnp.flip(near_first, axis=1)


def _rev_tail(col, n, t):
    """Reversed t-tail of each row's valid prefix: out[:, i] = col[:,
    n-1-i] (clamped; slots i >= min(n, t) carry garbage and are masked by
    the caller's validity counts)."""
    idx = jnp.maximum(
        n[:, None] - 1 - jnp.arange(t, dtype=I32)[None, :], 0
    )
    return jnp.take_along_axis(col, idx, axis=1)


def _build_min_halo(all_tails, all_v, s, t):
    """Splice the k-1 global-stream minimizers preceding shard s out of
    every predecessor's reversed tail (same algebra as _build_pending at
    the minimizer level, over multiple payload columns).

    all_tails: list of [S, Bl, t] reversed-tail columns; all_v: [S, Bl]
    valid tail lengths (min(count, t)).  Returns (halo columns [Bl, t] in
    FORWARD stream order right-aligned — the element at slot t-1 is the
    one immediately before the shard — and h [Bl] = number of valid halo
    slots, occupying slots t-h..t-1)."""
    S, Bl, _ = all_tails[0].shape
    order = jnp.arange(S - 1, -1, -1, dtype=I32)
    slot_i = jnp.arange(t, dtype=I32)[None, None, :]
    vmask = (order[None, :, None] < s) & (
        slot_i < all_v[order].transpose(1, 0)[:, :, None]
    )
    vmask = vmask.reshape(Bl, S * t)
    rev_cols = [
        a[order].transpose(1, 0, 2).reshape(Bl, S * t) for a in all_tails
    ]
    comp, cnt = compact(
        vmask, rev_cols, t, [c.dtype.type(0) for c in rev_cols]
    )
    h = jnp.minimum(cnt, t).astype(I32)
    iv = jnp.arange(t, dtype=I32)[None, :]
    halo = [
        jnp.flip(jnp.where(iv < h[:, None], c, c.dtype.type(0)), axis=1)
        for c in comp
    ]
    return halo, h


def _seq_sharded_body(codes, lengths, *, spec: PipelineSpec, S: int,
                      cap_s: int):
    l, k = spec.l, spec.k
    Bl, C = codes.shape
    s = jax.lax.axis_index("seq").astype(I32)
    local_len = jnp.clip(lengths - s * C, 0, C).astype(I32)

    cnt, tail, v = _local_tail(codes, local_len, l, s, C, spec.is_hpc)
    all_cnt = jax.lax.all_gather(cnt, "seq")  # [S, Bl]
    all_tail = jax.lax.all_gather(tail, "seq")  # [S, Bl, l]
    all_v = jax.lax.all_gather(v, "seq")  # [S, Bl]
    shard_ids = jnp.arange(S, dtype=I32)[:, None]
    base = jnp.sum(
        jnp.where(shard_ids < s, all_cnt, 0), axis=0
    ).astype(I32)
    carry = ScanCarry(base, _build_pending(all_tail, all_v, s, s * C, l))

    out, _ = scan_step(
        codes, local_len, window_limit(lengths, l), carry, spec, cap_s
    )
    n_min_s, n_raw_s = out.n_min, out.n_raw
    wide = spec.hash_width == 64
    # Rebase this shard's survivor positions to global coordinates (the
    # columns are already zero beyond the valid prefix).
    ok = jnp.arange(cap_s, dtype=I32)[None, :] < n_min_s[:, None]
    mst = jnp.where(ok, out.start + s * C, 0)
    men = jnp.where(ok, out.end + s * C, 0)
    hs_lo = out.hash
    hs_hi = out.hash_hi if wide else jnp.zeros_like(hs_lo)

    # ---- minimizer-space carry hand-off: each shard's survivors are a
    # contiguous slice of the global stream, so only the k-1 preceding
    # minimizers (start for the record, hash for the window) ever cross
    # shards.  Payload: S * (k-1) * (2|3) int32 per read — O(k), vs the
    # O(density * L) survivor all-gather this replaces.
    g_n = jax.lax.all_gather(n_min_s, "seq")  # [S, Bl]
    prefix = jnp.sum(
        jnp.where(shard_ids < s, g_n, 0), axis=0
    ).astype(I32)
    t = k - 1
    if t > 0:
        tail_cols = [_rev_tail(c, n_min_s, t) for c in (
            [mst, hs_lo] + ([hs_hi] if wide else [])
        )]
        tv = jnp.minimum(n_min_s, t)
        g_tails = [jax.lax.all_gather(c, "seq") for c in tail_cols]
        g_tv = jax.lax.all_gather(tv, "seq")
        halo, _h = _build_min_halo(g_tails, g_tv, s, t)
        halo_start, halo_lo = halo[0], halo[1]
        halo_hi = halo[2] if wide else jnp.zeros_like(halo_lo)
        buf_start = jnp.concatenate([halo_start, mst], axis=1)
        buf_lo = jnp.concatenate([halo_lo, hs_lo], axis=1)
        buf_hi = jnp.concatenate([halo_hi, hs_hi], axis=1)
    else:
        buf_start, buf_lo, buf_hi = mst, hs_lo, hs_hi

    # Assembly over [Bl, t + cap_s]: window w covers buffer slots
    # w..w+k-1, i.e. ends at LOCAL minimizer w — exactly the windows this
    # shard owns.  start = buffer slot w (may live in the halo), end =
    # local minimizer w's end (never gathered).
    (kh_hi, kh_lo), rev = assemble_for_width(
        buf_lo, buf_hi, k, spec.hash_width
    )
    # Window w is valid iff the global stream reaches back k-1 before it:
    # prefix + w >= k-1, and w < local survivor count.
    j0 = jnp.maximum(t - prefix, 0)
    n_km_s = jnp.maximum(n_min_s - j0, 0)
    w = jnp.arange(cap_s, dtype=I32)[None, :]
    km_valid = (w >= j0[:, None]) & (w < n_min_s[:, None])
    zero32 = jnp.zeros((), dtype=U32)
    return KminmerSegments(
        hash_hi=jnp.where(km_valid, kh_hi[:, :cap_s], zero32),
        hash_lo=jnp.where(km_valid, kh_lo[:, :cap_s], zero32),
        start=jnp.where(km_valid, buf_start[:, :cap_s], 0),
        end=jnp.where(km_valid, men, 0),
        rev=km_valid & rev[:, :cap_s],
        n_kminmers_seg=n_km_s[:, None],
        km_off_seg=j0[:, None],
        min_hash=hs_lo,
        min_hash_hi=hs_hi,
        min_start=mst,
        min_end=men,
        n_minimizers_seg=n_min_s[:, None],
        n_minimizers_raw_seg=n_raw_s[:, None],
    )


def make_seq_pipeline(spec: PipelineSpec, mesh: Mesh):
    """Returns a jitted fn(codes[B, L], lengths[B]) -> KminmerSegments
    with codes sharded P('data', 'seq'): reads data-parallel over 'data',
    each read's bases sequence-parallel over 'seq' through scan_step,
    outputs sharded over 'seq' as ordered stream segments
    (stitch_segments gives the dense host view).

    L must be divisible by mesh.shape['seq'].  Supports every hash width
    (u16/u32/u64).  Overflow is reported, not retried: callers check
    n_minimizers_raw_seg vs n_minimizers_seg like kminmers_batch and
    escalate with api.rescue_spec — sized as max_raw * S, because the
    per-shard capacity is capacity // S and survivors may concentrate in
    one shard (tests/test_seqshard_sweep.py exercises this recovery).
    """
    S = mesh.shape["seq"]

    def run(codes, lengths):
        B, L = codes.shape
        if L % S:
            raise ValueError(
                f"padded length {L} must be a multiple of seq={S} shards"
            )
        cap_s = max(-(-spec.capacity_for(L) // S), spec.k)
        body = partial(_seq_sharded_body, spec=spec, S=S, cap_s=cap_s)
        seg2 = P("data", "seq")
        smapped = shard_map(
            body,
            mesh=mesh,
            in_specs=(P("data", "seq"), P("data")),
            out_specs=KminmerSegments(*([seg2] * 13)),
            check_vma=False,
        )
        return smapped(codes, lengths.astype(I32))

    return jax.jit(run)


def stitch_segments(seg: KminmerSegments) -> KminmerBatch:
    """Host-side stitch of the seq-sharded segments into the dense
    single-stream KminmerBatch view (numpy arrays, same field contract as
    the unsharded pipeline: first n valid entries per row, in order)."""
    nk_seg = np.asarray(seg.n_kminmers_seg)
    off_seg = np.asarray(seg.km_off_seg)
    nm_seg = np.asarray(seg.n_minimizers_seg)
    nr_seg = np.asarray(seg.n_minimizers_raw_seg)
    B, S = nk_seg.shape
    cap = seg.hash_hi.shape[1] // S

    def dense(col, counts, offs, total_cap):
        a = np.asarray(col).reshape(B, S, cap)
        out = np.zeros((B, total_cap), dtype=a.dtype)
        for b in range(B):
            pos = 0
            for s in range(S):
                n = int(counts[b, s])
                o = int(offs[b, s])
                out[b, pos : pos + n] = a[b, s, o : o + n]
                pos += n
        return out

    n_km = nk_seg.sum(axis=1).astype(np.int32)
    n_min = nm_seg.sum(axis=1).astype(np.int32)
    n_raw = nr_seg.sum(axis=1).astype(np.int32)
    km_cap = max(int(n_km.max(initial=0)), 1)
    mn_cap = max(int(n_min.max(initial=0)), 1)
    zo = np.zeros_like(off_seg)
    return KminmerBatch(
        hash_hi=dense(seg.hash_hi, nk_seg, off_seg, km_cap),
        hash_lo=dense(seg.hash_lo, nk_seg, off_seg, km_cap),
        start=dense(seg.start, nk_seg, off_seg, km_cap),
        end=dense(seg.end, nk_seg, off_seg, km_cap),
        rev=dense(seg.rev, nk_seg, off_seg, km_cap),
        n_kminmers=n_km,
        min_hash=dense(seg.min_hash, nm_seg, zo, mn_cap),
        min_hash_hi=dense(seg.min_hash_hi, nm_seg, zo, mn_cap),
        min_start=dense(seg.min_start, nm_seg, zo, mn_cap),
        min_end=dense(seg.min_end, nm_seg, zo, mn_cap),
        n_minimizers=n_min,
        n_minimizers_raw=n_raw,
    )
