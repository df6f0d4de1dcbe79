"""Carry-aware minimizer scan: the one stage chain behind the batch,
long-read and sequence-sharded paths.

`scan_step` takes one chunk of a [B, C] xcode batch and, resuming from the
stream state the chunk before it left, runs

    HPC keep-mask + compaction (hpc modes)            [ops/hpc.py]
      -> sliding canonical NtHash, every width/variant [ops/nthash.py]
      -> per-mode density threshold
      -> selection compaction into m_cap slots         [ops/compact.py]

Carry contract (ScanCarry):
  * base[b] is the global kept rank before the chunk: the number of stream
    elements of row b in earlier chunks.  In the non-HPC modes every padded
    position is a stream element, so base is the chunk's origin.
  * pend[b] holds the last min(base, l) kept elements as (pos << 3) | code,
    right-aligned in l slots, with positions relative to the chunk origin
    (so negative).  Slots before them are never read by an emitted window.
A window is emitted by the chunk that holds its last element — in hpc mode
the element one past the last, whose position gives the window's end — so
consecutive chunks emit disjoint window sets and need no halo.  The
reference's scalar iterator keeps the same state (a ring buffer of the last
l chars and the rolling hash, src/nthash_hpc.rs:137-174), and its AVX-512
kernel hands it from one 16-lane block to the next
(src/nthash_avx512_32.rs:404-425).

Per-mode conventions (see oracle.py for the file:line provenance):
  regular : all windows, `hash <= f64-bound`, start=i, end=i+l-1
  simd    : all windows, `hash <  f32-bound`, start=i, end=i+l-1
  hpc     : drops the last HPC window, `hash <= f64-bound`,
            start=run_start[i], end=run_start[i+l]-1
  hpcsimd : all windows, `hash <  f32-bound`,
            start=run_start[i], end=run_start[i+l-1]
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax.numpy as jnp

from .compact import I32, compact
from .hpc import hpc_compress_packed, pack_pos_code
from .nthash import (
    sliding_nthash16,
    sliding_nthash2_31,
    sliding_nthash32,
    sliding_nthash64,
)
from .u64 import U32, lt2, min2


class ScanCarry(NamedTuple):
    base: jnp.ndarray  # int32[B] global kept rank before the chunk
    pend: jnp.ndarray  # int32[B, l] last kept (pos << 3) | code, right-aligned

    @staticmethod
    def empty(B: int, l: int) -> "ScanCarry":
        return ScanCarry(
            jnp.zeros((B,), dtype=I32), jnp.zeros((B, l), dtype=I32)
        )


class ScanOut(NamedTuple):
    """The chunk's minimizer stream: the first n_min entries of each row,
    in order, positions relative to the chunk origin; zeros beyond."""

    start: jnp.ndarray  # int32[B, m_cap]
    end: jnp.ndarray  # int32[B, m_cap]
    hash: jnp.ndarray  # uint32[B, m_cap] (low word when hash_width=64)
    hash_hi: Optional[jnp.ndarray]  # uint32[B, m_cap] when hash_width=64
    n_min: jnp.ndarray  # int32[B] min(n_raw, m_cap)
    n_raw: jnp.ndarray  # int32[B] selected windows; > m_cap means overflow
    kept: jnp.ndarray  # int32[B] stream elements in this chunk


def window_limit(lengths: jnp.ndarray, l: int) -> jnp.ndarray:
    """int32[B]: the largest global window-start rank a read may emit, or
    -1 for reads of length <= l (the reference builds no sub-iterator
    unless len > l, src/lib.rs:97).  In HPC modes the kept stream is
    shorter than the read and bounds the windows itself."""
    return jnp.where(lengths > l, lengths - l, -1).astype(I32)


def _window_hashes(ext, spec, rank0) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Canonical hash (low word, high word or None) of every l-window."""
    l = spec.l
    if spec.variant == "nthash2":
        fh, rh = sliding_nthash2_31(ext, l, rank0)
    elif spec.hash_width == 64:
        hi, lo = min2(*sliding_nthash64(ext, l, rank0))
        return lo, hi
    elif spec.hash_width == 16:
        fh, rh = sliding_nthash16(ext, l, rank0)
    else:
        fh, rh = sliding_nthash32(ext, l, rank0)
    return jnp.minimum(fh, rh), None


def _passes(h, h_hi, spec) -> jnp.ndarray:
    if h_hi is not None:
        bound = (
            jnp.asarray((spec.bound >> 32) & 0xFFFFFFFF, dtype=U32),
            jnp.asarray(spec.bound & 0xFFFFFFFF, dtype=U32),
        )
        # scalar paths use `<=` (src/nthash_hpc.rs:277, src/lib.rs:228)
        return ~lt2(bound, (h_hi, h))
    bound = jnp.asarray(spec.bound, dtype=U32)
    return (h < bound) if spec.strict_threshold else (h <= bound)


def scan_step(
    codes: jnp.ndarray,  # uint8[B, C] xcodes, XCODE_PAD beyond lengths
    lengths: jnp.ndarray,  # int32[B] valid columns of this chunk
    limit: jnp.ndarray,  # int32[B] window_limit of the whole read
    carry: ScanCarry,
    spec,  # ops.pipeline.PipelineSpec
    m_cap: int,
) -> Tuple[ScanOut, ScanCarry]:
    """One chunk through the stage chain.  Returns the chunk's minimizer
    stream and the carry for a chunk starting right after this one."""
    B, C = codes.shape
    l = spec.l
    hpc_end = spec.mode == "hpc"
    if spec.is_hpc:
        comp, kept = hpc_compress_packed(codes, lengths)
    else:
        comp = pack_pos_code(codes)
        kept = jnp.full((B,), C, dtype=I32)
    # The carried prefix and this chunk's stream, back to back: window f
    # covers ext[f : f+l] and starts at global rank base - l + f.
    ext = jnp.concatenate([carry.pend, comp], axis=1)  # [B, l + C]
    base = carry.base
    h, h_hi = _window_hashes(ext, spec, base - l)  # [B, C + 1]

    # Emission interval per row: the window's last element (hpc: one past
    # it) lies in this chunk and inside its kept stream, and the window
    # starts at a global rank in [0, limit].
    f = jnp.arange(C + 1, dtype=I32)[None, :]
    f_lo = jnp.maximum(0 if hpc_end else 1, l - base)
    f_hi = jnp.minimum(kept - (1 if hpc_end else 0), limit + l - base)
    sel = (
        _passes(h, h_hi, spec) & (f >= f_lo[:, None]) & (f <= f_hi[:, None])
    )

    pos = ext >> 3  # arithmetic: carried positions stay negative
    cols = [pos[:, : C + 1], h]
    fills = [I32(0), U32(0)]
    if spec.is_hpc:
        if hpc_end:  # end = pos[f+l] - 1 (needs one column of lookahead)
            pos = jnp.pad(pos, ((0, 0), (0, 1)))
            cols.append(pos[:, l : l + C + 1] - 1)
        else:  # hpcsimd: end = pos[f+l-1]
            cols.append(pos[:, l - 1 : l + C])
        fills.append(I32(0))
    if h_hi is not None:
        cols.append(h_hi)
        fills.append(U32(0))
    packed, n_raw = compact(sel, cols, m_cap, fills)
    start, min_hash = packed[0], packed[1]
    n_min = jnp.minimum(n_raw, m_cap)
    if spec.is_hpc:
        end = packed[2]
    else:  # every non-HPC window spans exactly l positions
        valid = jnp.arange(m_cap, dtype=I32)[None, :] < n_min[:, None]
        end = jnp.where(valid, start + (l - 1), 0)
    out = ScanOut(
        start=start,
        end=end,
        hash=min_hash,
        hash_hi=packed[-1] if h_hi is not None else None,
        n_min=n_min,
        n_raw=n_raw,
        kept=kept,
    )
    # Carry-out: the last l elements of ext, rebased to the next chunk's
    # origin (a position shift is a plain subtraction on packed values).
    idx = kept[:, None] + jnp.arange(l, dtype=I32)[None, :]
    pend = jnp.take_along_axis(ext, idx, axis=1) - (C << 3)
    return out, ScanCarry(base + kept, pend)
