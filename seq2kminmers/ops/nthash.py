"""Batched sliding canonical NtHash1 as an associative XOR-scan.

Reformulation of the reference's rolling/AVX-512 hash loops
(src/nthash_hpc.rs:245-249, src/nthash_avx512_32.rs:348-509): because the
window hash is an XOR of position-rotated seeds, the entire sliding-hash
stream is

    fh(i) = rol32(P[i+l] ^ P[i], (l-1+i) mod 32)
    rh(i) = rol32(Q[i+l] ^ Q[i], (-i)  mod 32)

with P/Q exclusive XOR-prefixes of pre-rotated seed terms.  One scan per
strand, then shifted-slice + rotate — no sequential dependence, fully
vectorized over [batch, length].  This is the same algebra the reference
exploits intra-register (Hillis-Steele XOR-scan + lane-15 carry,
src/nthash_avx512_32.rs:367-425), scaled to whole reads.

Every function takes `rank0`, the global stream rank of column 0 (an int
or int32[B]): rotations depend only on the rank modulo the hash width, so
a chunk that resumes mid-stream (ops/scan.py) hashes exactly like the
whole stream.  Codes may carry extra bits above bit 2 (xcodes, packed
(pos << 3) | code stream elements): only the low 3 bits are read.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import SEED_TABLE_F, SEED_TABLE_R, seed_tables
from .u64 import U32, Pair, rol32, rol64

# NOTE: no module-level jnp.asarray — creating device arrays at import time
# would initialize the XLA backend before jax.distributed.initialize() can
# run (parallel/multihost.py).  _seed_select consumes numpy tables directly.


def _seed_select(table: np.ndarray, codes: jnp.ndarray) -> jnp.ndarray:
    """Constant-table lookup as a where-select tree over the 3 code bits
    (codes 0..6, see constants.py); it fuses into the surrounding
    elementwise work like any other select."""
    t = [jnp.asarray(np.uint32(v), dtype=U32) for v in table] + [
        jnp.asarray(np.uint32(0), dtype=U32)
    ] * (8 - len(table))
    b0 = (codes & 1) != 0
    b1 = (codes & 2) != 0
    b2 = (codes & 4) != 0
    lo = jnp.where(b1, jnp.where(b0, t[3], t[2]), jnp.where(b0, t[1], t[0]))
    hi = jnp.where(b1, jnp.where(b0, t[7], t[6]), jnp.where(b0, t[5], t[4]))
    return jnp.where(b2, hi, lo)


def _shift_left(x: jnp.ndarray, s: int) -> jnp.ndarray:
    """y[..., i] = x[..., i+s], zero-filled at the end (static s >= 0)."""
    if s == 0:
        return x
    L = x.shape[-1]
    zero = jnp.zeros(x.shape[:-1] + (s,), dtype=x.dtype)
    return jnp.concatenate(
        [jax.lax.slice_in_dim(x, s, L, axis=-1), zero], axis=-1
    )


def sliding_window_xor(x: jnp.ndarray, l: int) -> jnp.ndarray:
    """W[..., i] = x[..., i] ^ x[..., i+1] ^ ... ^ x[..., i+l-1].

    Log-doubling scheme: W_{2m}[i] = W_m[i] ^ W_m[i+m], combining the binary
    decomposition of l — log2(l) + popcount(l) shifted XORs over the full
    lane-aligned array (the classic prefix-doubling form of "Parallel
    approach to sliding window sums", arXiv:1811.10074; the reference's
    16-lane Hillis-Steele XOR-scan, src/nthash_avx512_32.rs:367-425, is the
    same recurrence intra-register).  Work is O(L log l), layout-friendly
    (no reshapes), and compile time is independent of L.

    Output has shape [..., L]; entries past L-l+1 mix in zero padding and
    must be masked by the caller.
    """
    if l == 1:
        return x
    acc = None
    acc_len = 0
    w = x  # W_m with m = 1
    m = 1
    rem = l
    while rem:
        if rem & 1:
            term = _shift_left(w, acc_len)
            acc = term if acc is None else acc ^ term
            acc_len += m
        rem >>= 1
        if rem:
            w = w ^ _shift_left(w, m)
            m <<= 1
    return acc


def _ranks(L: int, rank0) -> jnp.ndarray:
    """uint32 global rank of every column ([L], or [B, L] for a per-row
    rank0).  Ranks wrap mod 2^32, which keeps every power-of-two residue."""
    r0 = jnp.asarray(rank0, dtype=jnp.int32).astype(U32)
    return r0[..., None] + jnp.arange(L, dtype=U32)


def _windows(x: jnp.ndarray, l: int, nwin: int) -> jnp.ndarray:
    return jax.lax.slice_in_dim(sliding_window_xor(x, l), 0, nwin, axis=-1)


def _check_len(codes: jnp.ndarray, l: int) -> int:
    L = codes.shape[-1]
    if L < l:
        raise ValueError(f"padded length {L} < l={l}")
    return L


def sliding_nthash32(
    codes: jnp.ndarray, l: int, rank0=0
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """codes: [..., L] base codes -> (fh, rh) uint32[..., L-l+1].

    Window i covers codes[..., i : i+l].  Values at windows overlapping
    padding are garbage and must be masked by the caller's validity mask.
    """
    L = _check_len(codes, l)
    j = _ranks(L, rank0)
    a = rol32(_seed_select(SEED_TABLE_F, codes), (U32(0) - j) & U32(31))
    b = rol32(_seed_select(SEED_TABLE_R, codes), j & U32(31))
    nwin = L - l + 1
    i = j[..., :nwin]
    fh = rol32(_windows(a, l, nwin), (U32(l - 1) + i) & U32(31))
    rh = rol32(_windows(b, l, nwin), (U32(0) - i) & U32(31))
    return fh, rh


def sliding_nthash16(
    codes: jnp.ndarray, l: int, rank0=0
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """16-bit NtHash1 (the reference's H=u16 alternative, src/lib.rs:30):
    identical recurrence with seed tables truncated to the low 16 bits and
    rotates mod 16.  Values are carried in uint32 lanes (always < 2^16)."""
    L = _check_len(codes, l)
    tf, tr = seed_tables(16)

    # rol16 via shifts in 32-bit lanes: x < 2^16, so at r == 0 the term
    # x >> 16 contributes nothing (no undefined shift widths).
    def _rol16(x, r):
        r = r & U32(15)
        return ((x << r) | (x >> ((U32(16) - r) & U32(31)))) & U32(0xFFFF)

    j = _ranks(L, rank0)
    a = _rol16(_seed_select(tf.astype(np.uint32), codes), U32(0) - j)
    b = _rol16(_seed_select(tr.astype(np.uint32), codes), j)
    nwin = L - l + 1
    i = j[..., :nwin]
    fh = _rol16(_windows(a, l, nwin), U32(l - 1) + i)
    rh = _rol16(_windows(b, l, nwin), U32(0) - i)
    return fh, rh


def sliding_nthash2_31(
    codes: jnp.ndarray, l: int, rank0=0
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """NtHash2-hybrid 31-bit variant (reference src/nthash2_avx512_32.rs):
    the NtHash1 recurrence at width 31 — rotates mod 31, seeds = top 31
    bits of the 64-bit constants (`SEED >> 33`).  Kept disabled in the
    reference but needed for l > 31, where 32-bit NtHash1 degenerates
    (:4-6).  Values carried in uint32 lanes (< 2^31)."""
    from ..constants import seed_tables_nthash2_31

    L = _check_len(codes, l)
    tf, tr = seed_tables_nthash2_31()

    def rol31(x, r):
        # shift-safe width-31 rotate in 32-bit lanes (x < 2^31): at r == 0
        # the right-shift term must contribute nothing.
        r = r % U32(31)
        lo = (x << r) & U32(0x7FFFFFFF)
        hi = x >> ((U32(31) - r) & U32(31))
        return lo | jnp.where(r == U32(0), U32(0), hi)

    # 31 is not a power of two: reduce rank0 first (floor mod, so negative
    # ranks of a carried prefix stay exact), then add column indices.
    r0 = jnp.remainder(jnp.asarray(rank0, dtype=jnp.int32), 31).astype(U32)
    j = (r0[..., None] + jnp.arange(L, dtype=U32)) % U32(31)
    a = rol31(_seed_select(tf, codes), U32(31) - j)
    b = rol31(_seed_select(tr, codes), j)
    nwin = L - l + 1
    i = j[..., :nwin]
    fh = rol31(_windows(a, l, nwin), U32(l - 1) + i)
    rh = rol31(_windows(b, l, nwin), U32(31) - i)
    return fh, rh


def sliding_nthash64(codes: jnp.ndarray, l: int, rank0=0) -> Tuple[Pair, Pair]:
    """64-bit NtHash1 (the reference's H=u64 alternative, src/lib.rs:32) as
    (hi, lo) uint32 pairs.  Validated bit-for-bit by the 20 u64 golden
    hashes (reference tests/main.rs:18-39).

    Returns (fh, rh) pairs of uint32[..., L-l+1]."""
    L = _check_len(codes, l)
    tf, tr = seed_tables(64)
    tf_hi = (tf >> np.uint64(32)).astype(np.uint32)
    tf_lo = (tf & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    tr_hi = (tr >> np.uint64(32)).astype(np.uint32)
    tr_lo = (tr & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    j = _ranks(L, rank0)
    hf = (_seed_select(tf_hi, codes), _seed_select(tf_lo, codes))
    hr = (_seed_select(tr_hi, codes), _seed_select(tr_lo, codes))
    a = rol64(hf, (U32(0) - j) & U32(63))
    b = rol64(hr, j & U32(63))
    nwin = L - l + 1
    i = j[..., :nwin]

    def win(p: Pair) -> Pair:
        return (_windows(p[0], l, nwin), _windows(p[1], l, nwin))

    fh = rol64(win(a), (U32(l - 1) + i) & U32(63))
    rh = rol64(win(b), (U32(0) - i) & U32(63))
    return fh, rh
