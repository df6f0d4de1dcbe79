"""Emulated 64-bit unsigned integer ops as pairs of uint32 lanes.

JAX keeps 64-bit integers off unless `jax_enable_x64` is set process-wide.
The reference keeps minimizer hashing in u32 (H = u32, reference
src/lib.rs:31) so only the k-min-mer (minimizer-space) hash needs 64 bits
(KH = u64, src/lib.rs:37).  We represent a u64 as an (hi, lo) pair of
uint32 arrays and implement exactly the ops the
pipeline needs: xor, rotate-left mod 64, unsigned compare/min, and the
xorshift mix hash (src/lib.rs:157-169).

All shift amounts here may be traced arrays; shifts by >= 32 are avoided via
the ((x >> (31 - r)) >> 1) decomposition, which is well-defined for
r in [0, 31].
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

U32 = jnp.uint32

Pair = Tuple[jnp.ndarray, jnp.ndarray]  # (hi, lo), both uint32


def _u32(x):
    return jnp.asarray(x, dtype=U32)


def rol32(x: jnp.ndarray, r: jnp.ndarray) -> jnp.ndarray:
    """Rotate-left on uint32 with per-element rotate amounts in [0, 32)."""
    x = _u32(x)
    r = _u32(r) & U32(31)
    return (x << r) | ((x >> (U32(31) - r)) >> U32(1))


def ror32(x: jnp.ndarray, r: jnp.ndarray) -> jnp.ndarray:
    return rol32(x, (U32(32) - (_u32(r) & U32(31))) & U32(31))


def from_u32(lo: jnp.ndarray) -> Pair:
    """Zero-extend uint32 -> u64 pair."""
    lo = _u32(lo)
    return jnp.zeros_like(lo), lo


def xor2(a: Pair, b: Pair) -> Pair:
    return a[0] ^ b[0], a[1] ^ b[1]


def rol64(a: Pair, r) -> Pair:
    """Rotate-left mod 64 of a u64 pair; r may be a traced array in [0, 64)."""
    hi, lo = _u32(a[0]), _u32(a[1])
    r = _u32(r) & U32(63)
    swap = r >= U32(32)
    # After an optional 32-rotate (word swap), rotate by rr in [0, 32).
    h = jnp.where(swap, lo, hi)
    l = jnp.where(swap, hi, lo)
    rr = r & U32(31)
    carry_h = (l >> (U32(31) - rr)) >> U32(1)
    carry_l = (h >> (U32(31) - rr)) >> U32(1)
    return (h << rr) | carry_h, (l << rr) | carry_l


def lt2(a: Pair, b: Pair) -> jnp.ndarray:
    """Unsigned a < b on u64 pairs."""
    return (a[0] < b[0]) | ((a[0] == b[0]) & (a[1] < b[1]))


def min2(a: Pair, b: Pair) -> Pair:
    altb = lt2(a, b)
    return (
        jnp.where(altb, a[0], b[0]),
        jnp.where(altb, a[1], b[1]),
    )


def shl2(a: Pair, s: int) -> Pair:
    """Logical left shift by a *static* amount s in [0, 64)."""
    hi, lo = _u32(a[0]), _u32(a[1])
    if s == 0:
        return hi, lo
    if s < 32:
        return (hi << U32(s)) | (lo >> U32(32 - s)), lo << U32(s)
    return lo << U32(s - 32), jnp.zeros_like(lo)


def shr2(a: Pair, s: int) -> Pair:
    """Logical right shift by a *static* amount s in [0, 64)."""
    hi, lo = _u32(a[0]), _u32(a[1])
    if s == 0:
        return hi, lo
    if s < 32:
        return hi >> U32(s), (lo >> U32(s)) | (hi << U32(32 - s))
    return jnp.zeros_like(hi), hi >> U32(s - 32)


def add2(a: Pair, b: Pair) -> Pair:
    """u64 addition (mod 2^64) on pairs."""
    lo = a[1] + b[1]
    carry = (lo < a[1]).astype(U32)  # unsigned wrap detect
    return a[0] + b[0] + carry, lo


def _mulhi32(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """High 32 bits of the unsigned 32x32 product (16-bit split schoolbook)."""
    a, b = _u32(a), _u32(b)
    al = a & U32(0xFFFF)
    ah = a >> U32(16)
    bl = b & U32(0xFFFF)
    bh = b >> U32(16)
    t = al * bl
    mid1 = ah * bl
    mid2 = al * bh
    carry = ((t >> U32(16)) + (mid1 & U32(0xFFFF)) + (mid2 & U32(0xFFFF))) >> U32(16)
    return ah * bh + (mid1 >> U32(16)) + (mid2 >> U32(16)) + carry


def mul2(a: Pair, b: Pair) -> Pair:
    """u64 multiplication (mod 2^64) on pairs."""
    lo = a[1] * b[1]
    hi = _mulhi32(a[1], b[1]) + a[1] * b[0] + a[0] * b[1]
    return hi, lo


def const2(v: int) -> Pair:
    """Scalar u64 constant as a pair of uint32 scalars."""
    import numpy as np

    return (
        jnp.asarray(np.uint32((v >> 32) & 0xFFFFFFFF), dtype=U32),
        jnp.asarray(np.uint32(v & 0xFFFFFFFF), dtype=U32),
    )


def mix64_murmur_from_u16(x: jnp.ndarray) -> Pair:
    """Murmur64-style MixHash of a zero-extended u16 (src/lib.rs:142-155).

    Note the reference uses rotate_left(33), not right-shifts:
        x ^= rol64(x, 33); x *= 0xff51afd7ed558ccd;
        x ^= rol64(x, 33); x *= 0xc4ceb9fe1a85ec53; x ^= rol64(x, 33)
    """
    v = from_u32(_u32(x) & U32(0xFFFF))
    c1 = const2(0xFF51AFD7ED558CCD)
    c2 = const2(0xC4CEB9FE1A85EC53)
    v = xor2(v, rol64(v, U32(33)))
    v = mul2(v, (jnp.broadcast_to(c1[0], v[0].shape), jnp.broadcast_to(c1[1], v[1].shape)))
    v = xor2(v, rol64(v, U32(33)))
    v = mul2(v, (jnp.broadcast_to(c2[0], v[0].shape), jnp.broadcast_to(c2[1], v[1].shape)))
    v = xor2(v, rol64(v, U32(33)))
    return v


def mix64_from_u32(x: jnp.ndarray) -> Pair:
    """Xorshift mix of a zero-extended u32 (reference src/lib.rs:157-169):
    x ^= x << 13; x ^= x >> 7; x ^= x << 17 — in u64 arithmetic.
    """
    v = from_u32(x)
    v = xor2(v, shl2(v, 13))
    v = xor2(v, shr2(v, 7))
    v = xor2(v, shl2(v, 17))
    return v


def xor_scan_pair(p: Pair, axis: int = -1) -> Pair:
    """Inclusive XOR prefix scan of a u64 pair (two independent u32 scans)."""
    import jax

    return (
        jax.lax.associative_scan(jnp.bitwise_xor, p[0], axis=axis),
        jax.lax.associative_scan(jnp.bitwise_xor, p[1], axis=axis),
    )


def to_py_u64(pair: Pair):
    """Host-side: pair of uint32 arrays -> numpy uint64 array (for tests/IO)."""
    import numpy as np

    hi = np.asarray(pair[0], dtype=np.uint64)
    lo = np.asarray(pair[1], dtype=np.uint64)
    return (hi << np.uint64(32)) | lo
