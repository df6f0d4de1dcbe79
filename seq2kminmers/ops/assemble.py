"""K-min-mer assembly: minimizer-space canonical NtHash over the compacted
minimizer stream (reference src/lib.rs:231-258).

Same XOR-scan algebra as the base-space hash (see ops/nthash.py) but over
64-bit values emulated as uint32 pairs, with k-window rotates mod 64:

    f(w) = rol64(PF[w+k] ^ PF[w], (k-1+w) mod 64),  a[j] = rol64(m[j], -j mod 64)
    r(w) = rol64(PR[w+k] ^ PR[w], (-w)  mod 64),    b[j] = rol64(m[j],  j mod 64)

which matches the reference's rolling recurrences (src/lib.rs:240-249) and
its non-rolling oracle nthash1_minimizer_space (src/lib.rs:275-288).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from .compact import I32
from .nthash import sliding_window_xor
from .u64 import U32, Pair, lt2, min2, mix64_from_u32, mix64_murmur_from_u16, rol64


def assemble_for_width(
    min_hash: jnp.ndarray,  # uint32[B, M] minimizer hashes (low word)
    min_hash_hi,  # uint32[B, M] high words when hash_width=64, else None
    k: int,
    hash_width: int,
) -> Tuple[Pair, jnp.ndarray]:
    """Assembly with the MixHash of the configured hash width
    (src/lib.rs:137-177): u16 murmur finalizer, u32 xorshift, u64
    identity."""
    if hash_width == 64:
        return assemble_kminmers_mixed((min_hash_hi, min_hash), k)
    if hash_width == 16:
        return assemble_kminmers_mixed(mix64_murmur_from_u16(min_hash), k)
    return assemble_kminmers(min_hash, k)


def assemble_kminmers(
    min_hash32: jnp.ndarray,  # uint32[B, M] compacted minimizer hashes
    k: int,
) -> Tuple[Pair, jnp.ndarray]:
    """-> ((hash_hi, hash_lo) uint32[B, M-k+1], rev bool[B, M-k+1]).

    Entries at windows beyond (count - k) are garbage; callers mask.
    """
    return assemble_kminmers_mixed(mix64_from_u32(min_hash32), k)


def assemble_kminmers_mixed(
    mixed: Pair,  # (hi, lo) uint32[B, M] already-mixed minimizer hashes
    k: int,
) -> Tuple[Pair, jnp.ndarray]:
    """Assembly over pre-mixed u64 minimizer hashes (MixHash already applied
    per the configured hash width; identity for H=u64, src/lib.rs:171-177)."""
    B, M = mixed[0].shape
    if M < k:
        raise ValueError(f"minimizer capacity {M} < k={k}")
    j = jnp.arange(M, dtype=U32)
    a = rol64(mixed, (U32(64) - (j & U32(63))) & U32(63))
    b = rol64(mixed, j & U32(63))

    def window(p: Pair) -> Pair:
        return (
            sliding_window_xor(p[0], k),
            sliding_window_xor(p[1], k),
        )

    nwin = M - k + 1
    w = jnp.arange(nwin, dtype=U32)

    def clip(p: Pair) -> Pair:
        return (
            jax.lax.slice_in_dim(p[0], 0, nwin, axis=-1),
            jax.lax.slice_in_dim(p[1], 0, nwin, axis=-1),
        )

    f = rol64(clip(window(a)), (U32(k - 1) + w) & U32(63))
    r = rol64(clip(window(b)), (U32(64) - (w & U32(63))) & U32(63))
    h = min2(f, r)
    rev = lt2(r, f)  # rev = rhash < fhash (src/lib.rs:251)
    return h, rev
