"""User-facing API mirroring the reference crate's surface.

`KminmersIterator(seq, l, k, density, mode)` corresponds to the reference
KminmersIterator (src/lib.rs:89) and yields KminmerRecord objects whose
equality is hash-only (src/kminmer.rs:181-185).  Under the hood single-read
calls run the batched pipeline on a length-bucketed padded tensor (one
compilation per bucket); use `make_pipeline` / `kminmer_pipeline` directly
for high-throughput batch processing.
"""

from __future__ import annotations

import functools
from typing import Iterator, List

import numpy as np

from .constants import XCODE_PAD, encode_xcodes, family_of_mode
from .oracle import HashMode, KminmerRecord
from .oracle import kminmers as _oracle_kminmers
from .ops.pipeline import PipelineSpec, make_pipeline
from .ops.u64 import to_py_u64

# Reference limits: the scalar HPC path requires l < 256 (BUFLEN,
# src/nthash_hpc.rs:9-11,133); the SIMD paths assert l <= 31
# (src/nthash_avx512_32.rs:33) because 32-bit NtHash1 degenerates for
# l >= 32 (src/nthash2_avx512_32.rs:4-6).
MAX_L_SIMD = 31
MAX_L_HPC = 255


class KSizeTooBig(ValueError):
    """Reference Error::KSizeTooBig (src/nthash_hpc.rs:23-24)."""


def _mode_of(mode) -> HashMode:
    if isinstance(mode, HashMode):
        return mode
    return HashMode(str(mode).lower())


def _bucket_length(n: int) -> int:
    """Pad single-read inputs to a small set of static lengths to bound the
    number of jit compilations."""
    b = 256
    while b < n + 1:
        b *= 2
    return b


@functools.lru_cache(maxsize=64)
def _cached_pipeline(spec: PipelineSpec):
    return make_pipeline(spec)


def _round_cap(n: int) -> int:
    """Round capacities to powers of two to bound distinct compilations."""
    c = 128
    while c < n:
        c *= 2
    return c


def rescue_spec(spec: PipelineSpec, m_cap_needed: int) -> PipelineSpec:
    """The configuration overflow recovery jumps to: the minimizer capacity
    M raised to the raw count, rounded to a power of two so that later
    recoveries of similar batches reuse one executable (the reference's
    analogue: drain buffers that simply grow,
    src/nthash_avx512_32.rs:139-141)."""
    import dataclasses as _dc

    return _dc.replace(spec, max_minimizers=_round_cap(m_cap_needed))


def kminmers_batch(codes, lengths, spec, max_retries: int = 8):
    """Run the batched pipeline with overflow recovery: if any read's
    selected minimizers overflowed the compacted capacity M, ONE retry with
    M raised to the raw count (see rescue_spec) recovers them.  The
    reference never drops a minimizer (src/nthash_avx512_32.rs:139-141).

    Returns a KminmerBatch whose n_minimizers == n_minimizers_raw row-wise.
    """
    import jax.numpy as jnp

    codes = jnp.asarray(codes)
    lengths = jnp.asarray(np.asarray(lengths, dtype=np.int32))
    for _ in range(max_retries):
        out = _cached_pipeline(spec)(codes, lengths)
        n_raw = np.asarray(out.n_minimizers_raw)
        n_min = np.asarray(out.n_minimizers)
        if (n_min >= n_raw).all():
            return out
        spec = rescue_spec(spec, int(n_raw.max()))
    raise RuntimeError(
        f"minimizer overflow not resolved after {max_retries} retries"
    )


def kminmers_list(
    seq,
    l: int,
    k: int,
    density: float,
    mode=HashMode.Regular,
    backend: str = "jax",
    strict_limits: bool = True,
    hash_width: int = 32,
    variant: str = "nthash1",
) -> List[KminmerRecord]:
    """Compute all k-min-mers of one sequence, in order.

    hash_width selects the minimizer hash precision (the reference's
    compile-time H, src/lib.rs:30-32): 32 is the reference's active config;
    64 reproduces its u64 golden values (tests/main.rs:18-39).

    variant="nthash2" selects the 31-bit-rotate hybrid scheme (reference
    src/nthash2_avx512_32.rs) intended for l > 31, where 32-bit NtHash1
    degenerates; the SIMD l <= 31 limit is lifted for it."""
    mode = _mode_of(mode)
    if strict_limits and variant == "nthash1":
        if mode in (HashMode.Simd, HashMode.HpcSimd) and l > MAX_L_SIMD:
            raise KSizeTooBig(f"l={l} exceeds {MAX_L_SIMD} for SIMD modes")
        if mode is HashMode.Hpc and l > MAX_L_HPC:
            raise KSizeTooBig(f"l={l} exceeds {MAX_L_HPC} for Hpc mode")
    if backend == "oracle":
        return _oracle_kminmers(seq, l, k, density, mode, hash_width, variant)

    if isinstance(seq, np.ndarray) and np.issubdtype(seq.dtype, np.integer):
        codes = seq.astype(np.uint8, copy=False)  # pre-encoded xcodes
    else:
        codes = encode_xcodes(seq, family_of_mode(mode.value))
    n = len(codes)
    if n <= l:
        return []
    L = _bucket_length(max(n, l + 1))
    padded = np.full((1, L), XCODE_PAD, dtype=np.uint8)
    padded[0, :n] = codes
    spec = PipelineSpec(
        l=l,
        k=k,
        density=density,
        mode=mode.value,
        hash_width=hash_width,
        variant=variant,
    )
    # Density-estimated capacity + overflow-recovery retries: never drops a
    # minimizer, without brute-force worst-case capacity.
    out = kminmers_batch(padded, np.array([n], dtype=np.int32), spec)
    nk = int(out.n_kminmers[0])
    if nk == 0:
        return []
    hashes = to_py_u64((out.hash_hi[0, :nk], out.hash_lo[0, :nk]))
    start = np.asarray(out.start[0, :nk])
    end = np.asarray(out.end[0, :nk])
    rev = np.asarray(out.rev[0, :nk])
    return [
        KminmerRecord(
            hash=int(hashes[i]),
            start=int(start[i]),
            end=int(end[i]),
            offset=i,
            rev=bool(rev[i]),
        )
        for i in range(nk)
    ]


class KminmersIterator:
    """Iterator facade over one sequence (reference src/lib.rs:70-131).

    Example:
        it = KminmersIterator(b"ACGT...", l=10, k=5, density=0.1, mode="hpc")
        for km in it:
            print(km.hash, km.start, km.end, km.offset, km.rev)
    """

    def __init__(
        self,
        seq,
        l: int,
        k: int,
        density: float,
        mode=HashMode.Regular,
        backend: str = "jax",
        hash_width: int = 32,
        variant: str = "nthash1",
    ):
        self._records = kminmers_list(
            seq, l, k, density, mode, backend=backend,
            hash_width=hash_width, variant=variant,
        )

    def __iter__(self) -> Iterator[KminmerRecord]:
        return iter(self._records)

    def __len__(self) -> int:
        return len(self._records)

    def collect(self) -> List[KminmerRecord]:
        return list(self._records)
