"""Homopolymer compression (HPC) as mask + compaction.

Equivalent of the reference's fused scalar HPC (src/nthash_hpc.rs:149,
253-263) and the AVX-512 RLE kernel (src/hpc.rs:44-147): keep-mask =
(raw_byte[i] != raw_byte[i-1]), first element kept, then left-pack the kept
codes together with their original positions (start-of-run convention,
src/hpc.rs:7-25).  The raw-byte comparison is precomputed into xcode bit 3
by the host encoders (constants.encode_xcodes / the native packer), so the
device only reads it.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from ..constants import CODE_PAD, XCODE_KEEP
from .compact import I32, compact

# Stream elements pack (pos << 3) | code into one int32.
MAX_PACKED_LEN = 1 << 28


def with_keep_bits_device(codes: jnp.ndarray) -> jnp.ndarray:
    """Device-side constants.with_keep_bits: stamp xcode keep bits onto a
    plain 3-bit code tensor [..., L], treating code equality as byte
    equality — for synthetic benchmark/test tensors generated on device.
    Real sequences get their keep bits from the host encoders."""
    low = codes & 7
    prev = jnp.roll(low, 1, axis=-1)
    j = jnp.arange(codes.shape[-1], dtype=I32)
    keep = (low != prev) | (j == 0)
    return (low | jnp.where(keep, 8, 0).astype(codes.dtype)).astype(
        codes.dtype
    )


def hpc_keep_mask(codes: jnp.ndarray, lengths: jnp.ndarray) -> jnp.ndarray:
    """bool[B, L]: True where codes[b, j] starts a new run (precomputed
    raw-byte-diff xcode bit), within length."""
    B, L = codes.shape
    j = jnp.arange(L, dtype=I32)
    return ((codes & XCODE_KEEP) != 0) & (j[None, :] < lengths[:, None])


def pack_pos_code(codes: jnp.ndarray) -> jnp.ndarray:
    """(j << 3) | code packing of a code tensor (identity position map)."""
    B, L = codes.shape
    if L >= MAX_PACKED_LEN:
        raise ValueError(
            f"padded length {L} must be < 2^28 for packed streams"
        )
    j = jnp.arange(L, dtype=I32)[None, :]
    return (jnp.broadcast_to(j, (B, L)) << 3) | (codes.astype(I32) & 7)


def hpc_compress_packed(
    codes: jnp.ndarray, lengths: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """HPC compaction in packed (pos << 3 | code) form: ONE int32 column
    moves through the dense (m = L) compaction.

    -> (packed int32[B, L], (L << 3) | CODE_PAD beyond the count,
        hpc_len int32[B])."""
    B, L = codes.shape
    keep = hpc_keep_mask(codes, lengths)
    (pk,), count = compact(
        keep, [pack_pos_code(codes)], L, [I32((L << 3) | CODE_PAD)]
    )
    return pk, count


def hpc_compress(
    codes: jnp.ndarray, lengths: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """-> (hpc_codes [B, L] padded with CODE_PAD,
           pos int32[B, L] original start-of-run positions (padded with L),
           hpc_len int32[B])."""
    pk, count = hpc_compress_packed(codes, lengths)
    return (pk & 7).astype(codes.dtype), pk >> 3, count
