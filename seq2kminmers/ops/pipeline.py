"""The end-to-end batched k-min-mer pipeline (one jit program).

Dataflow (compare reference call stack §3 of SURVEY.md — the pull-iterator
chain becomes a push/batch dataflow):

    codes[B, L], lengths[B]
      └─ scan_step with an empty carry                  [ops/scan.py]
           (hpc keep-mask → compaction → sliding canonical NtHash →
            density threshold → compaction of the minimizer stream)
      └─ MixHash + k-window XOR-scan assembly           [ops/assemble.py]
      └─ KminmerBatch{hash_hi, hash_lo, start, end, rev, counts}

The per-mode conventions are listed in ops/scan.py.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..constants import hash_bound, hash_bound_simd_u32, hash_bound_u32
from .assemble import assemble_for_width
from .compact import I32
from .scan import ScanCarry, scan_step, window_limit
from .u64 import U32


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    """Static configuration of one compiled pipeline.

    Replaces the reference's compile-time type aliases + runtime args
    (src/lib.rs:29-39,89).  `max_minimizers` is the static capacity M of the
    compacted minimizer stream per read; selected minimizers beyond M are
    dropped (detectable via KminmerBatch.n_minimizers_raw).

    l limits — a DELIBERATE extension over the reference: the reference
    asserts l <= 31 in its SIMD paths (src/nthash_avx512_32.rs:33, because
    32-bit NtHash1 rotations degenerate for l >= 32) and l < 256 in the
    scalar HPC path (BUFLEN=256, src/nthash_hpc.rs:9-11).  This pipeline
    accepts any l for every mode, and for l > 31 the variant="nthash2"
    31-bit scheme gives non-degenerate hashes.  The reference's own limits
    are enforced only at the API layer (api.kminmers_list
    strict_limits=True, the default), so reference-compatible callers get
    reference-compatible errors while the pipeline itself is more general.
    """

    l: int
    k: int
    density: float
    mode: str = "regular"  # regular | hpc | simd | hpcsimd
    max_minimizers: Optional[int] = None
    # Minimizer hash precision: the reference's compile-time H (u16/u32/u64,
    # src/lib.rs:30-32) as runtime config.  SIMD modes are u32-only, like
    # the reference's 32-bit AVX-512 kernels.
    hash_width: int = 32
    # "nthash1" (default) or "nthash2" — the 31-bit-rotate hybrid
    # (reference src/nthash2_avx512_32.rs) for l > 31 support.
    variant: str = "nthash1"

    def __post_init__(self):
        if self.mode not in ("regular", "hpc", "simd", "hpcsimd"):
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.l < 1 or self.k < 1:
            raise ValueError("l and k must be >= 1")
        if self.hash_width not in (16, 32, 64):
            raise ValueError(f"hash_width must be 16/32/64, got {self.hash_width}")
        if self.hash_width != 32 and self.mode in ("simd", "hpcsimd"):
            raise ValueError("SIMD modes require hash_width=32")
        if self.variant not in ("nthash1", "nthash2"):
            raise ValueError(f"unknown variant {self.variant!r}")
        if self.variant == "nthash2" and self.hash_width != 32:
            raise ValueError("nthash2 variant is 32-bit-lane only")

    @property
    def strict_threshold(self) -> bool:
        # SIMD paths use `<` (src/nthash_avx512_32.rs:55,130); scalar `<=`.
        return self.mode in ("simd", "hpcsimd")

    @property
    def bound(self) -> int:
        if self.variant == "nthash2":
            # 31-bit hash space: halved bounds (src/nthash2_avx512_32.rs:54)
            from ..constants import hash_bound_nthash2_31

            if self.strict_threshold:
                return hash_bound_nthash2_31(self.density)
            return hash_bound_u32(self.density) // 2
        if self.strict_threshold:
            return hash_bound_simd_u32(self.density)
        if self.hash_width != 32:
            return hash_bound(self.density, self.hash_width)
        return hash_bound_u32(self.density)

    @property
    def is_hpc(self) -> bool:
        return self.mode in ("hpc", "hpcsimd")

    def capacity_for(self, length: int) -> int:
        if self.max_minimizers is not None:
            return max(self.max_minimizers, self.k)
        nwin = max(length - self.l + 1, 1)
        est = int(nwin * max(self.density, 0.0) * 4.0) + 128
        return min(max(est, self.k), nwin)


class KminmerBatch(NamedTuple):
    """Structured batch of k-min-mer records (reference KminmerHash,
    src/kminmer.rs:129-135, as a struct-of-arrays).  The first
    n_kminmers[b] entries of each row are valid, in sequence order; entry w
    has offset == w (src/lib.rs:258-259)."""

    hash_hi: jnp.ndarray  # uint32[B, Mk]
    hash_lo: jnp.ndarray  # uint32[B, Mk]
    start: jnp.ndarray  # int32[B, Mk]
    end: jnp.ndarray  # int32[B, Mk]
    rev: jnp.ndarray  # bool[B, Mk]
    n_kminmers: jnp.ndarray  # int32[B]
    # The intermediate minimizer stream (exposed like the reference's L2
    # iterators are public API):
    min_hash: jnp.ndarray  # uint32[B, M] (low 32 bits when hash_width=64)
    min_hash_hi: jnp.ndarray  # uint32[B, M] (zeros unless hash_width=64)
    min_start: jnp.ndarray  # int32[B, M]
    min_end: jnp.ndarray  # int32[B, M]
    n_minimizers: jnp.ndarray  # int32[B] (clipped to M)
    n_minimizers_raw: jnp.ndarray  # int32[B] (unclipped; > M means overflow)


def kminmer_pipeline(
    codes: jnp.ndarray, lengths: jnp.ndarray, spec: PipelineSpec
) -> KminmerBatch:
    """codes: uint8[B, L] xcodes (XCODE_PAD beyond lengths), lengths:
    int32[B]."""
    B, L = codes.shape
    l, k = spec.l, spec.k
    if L < l + 1:
        raise ValueError(f"padded length {L} must exceed l={l}")
    lengths = lengths.astype(I32)
    m_cap = spec.capacity_for(L)
    if m_cap < k:
        raise ValueError(f"minimizer capacity {m_cap} < k={k}")
    out, _ = scan_step(
        codes, lengths, window_limit(lengths, l), ScanCarry.empty(B, l),
        spec, m_cap,
    )
    min_hash_hi = (
        out.hash_hi if out.hash_hi is not None else jnp.zeros_like(out.hash)
    )
    (kh_hi, kh_lo), rev = assemble_for_width(
        out.hash, out.hash_hi, k, spec.hash_width
    )
    mk = m_cap - k + 1
    n_km = jnp.maximum(out.n_min - (k - 1), 0)
    w = jnp.arange(mk, dtype=I32)[None, :]
    km_valid = w < n_km[:, None]
    zero32 = jnp.zeros((), dtype=U32)
    return KminmerBatch(
        hash_hi=jnp.where(km_valid, kh_hi, zero32),
        hash_lo=jnp.where(km_valid, kh_lo, zero32),
        start=jnp.where(km_valid, out.start[:, :mk], 0),
        end=jnp.where(km_valid, out.end[:, k - 1 :], 0),
        rev=km_valid & rev,
        n_kminmers=n_km,
        min_hash=out.hash,
        min_hash_hi=min_hash_hi,
        min_start=out.start,
        min_end=out.end,
        n_minimizers=out.n_min,
        n_minimizers_raw=out.n_raw,
    )


def make_pipeline(spec: PipelineSpec):
    """Returns a jitted fn(codes[B, L], lengths[B]) -> KminmerBatch."""

    def fn(codes, lengths):
        return kminmer_pipeline(codes, lengths, spec)

    return jax.jit(fn)
