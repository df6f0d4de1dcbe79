"""Bit-exact numpy oracle for the reference semantics.

This module is the *semantic specification* of rust-seq2kminmers, written in
plain vectorized numpy.  It is used to validate the JAX pipeline
and is itself validated against the literal golden hash values from the
reference test suite (reference: tests/main.rs:41-57, the H=u32 goldens).

Key algebra (this is also what makes the data-parallel port natural): the canonical
NtHash1 sliding-window hash is an associative XOR of position-rotated seeds,

    fh(i) = XOR_{t=0..l-1} rol32(h(s[i+t]), l-1-t)        (src/nthash_hpc.rs:144)
    rh(i) = XOR_{t=0..l-1} rol32(rc(s[i+t]), t)           (src/nthash_hpc.rs:168)
    hash(i) = min(fh(i), rh(i))                            (src/nthash_hpc.rs:231)

so with pre-rotated terms a[j] = rol32(h(s[j]), -j mod 32) and
b[j] = rol32(rc(s[j]), j mod 32) and their exclusive XOR-prefix P, Q:

    fh(i) = rol32(P[i+l] ^ P[i], (l-1+i) mod 32)
    rh(i) = rol32(Q[i+l] ^ Q[i], (-i) mod 32)

The k-min-mer (minimizer-space) hash has the identical structure over the
stream of mixed minimizer hashes with 64-bit rotates (src/lib.rs:240-249 and
the non-rolling oracle at src/lib.rs:275-288).
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import List, Tuple

import numpy as np

from .constants import (
    SEED_TABLE_F,
    SEED_TABLE_R,
    family_of_mode,
    hash_bound,
    hash_bound_nthash2_31,
    hash_bound_simd_u32,
    hash_bound_u32,
    code_table,
    seed_tables,
    seed_tables_nthash2_31,
)


class HashMode(Enum):
    """Mirror of the reference HashMode enum (src/lib.rs:22-27)."""

    Regular = "regular"
    Hpc = "hpc"
    Simd = "simd"
    HpcSimd = "hpcsimd"


@dataclass
class KminmerRecord:
    """One emitted k-min-mer (reference: KminmerHash, src/kminmer.rs:129-135).

    Equality and ordering compare the hash only (src/kminmer.rs:181-204);
    positions are payload.
    """

    hash: int
    start: int
    end: int
    offset: int
    rev: bool

    def __eq__(self, other):  # hash-only equality, like the reference
        return self.hash == other.hash

    def get_hash(self) -> int:
        return self.hash


def _rol32(x: np.ndarray, r: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64)
    r = np.asarray(r, dtype=np.uint64) % np.uint64(32)
    out = ((x << r) | (x >> (np.uint64(32) - r) % np.uint64(64))) & np.uint64(
        0xFFFFFFFF
    )
    # r == 0: (x >> 32) is UB-ish in C but fine in numpy uint64 (shifts in
    # 64-bit width); x << 0 | x >> 32 == x since x < 2**32.
    return out.astype(np.uint32)


def _rol64(x: np.ndarray, r) -> np.ndarray:
    x = np.asarray(x, dtype=np.uint64)
    r = np.asarray(r, dtype=np.uint64) % np.uint64(64)
    left = x << r
    right = np.where(r == 0, np.uint64(0), x >> (np.uint64(64) - r))
    return left | right


def mixhash_u32(x) -> np.ndarray:
    """Zero-extend u32 to u64 and xorshift-mix (src/lib.rs:157-169)."""
    x = np.asarray(x, dtype=np.uint64)
    x = x ^ ((x << np.uint64(13)) & np.uint64(0xFFFFFFFFFFFFFFFF))
    x = x ^ (x >> np.uint64(7))
    x = x ^ ((x << np.uint64(17)) & np.uint64(0xFFFFFFFFFFFFFFFF))
    return x


def mixhash_u16(x) -> np.ndarray:
    """Zero-extend u16 to u64 and murmur64-style finalize with *rotates*
    (the reference uses rotate_left(33), not shifts — src/lib.rs:142-155)."""
    x = np.asarray(x, dtype=np.uint64)
    with np.errstate(over="ignore"):
        x = x ^ _rol64(x, 33)
        x = x * np.uint64(0xFF51AFD7ED558CCD)
        x = x ^ _rol64(x, 33)
        x = x * np.uint64(0xC4CEB9FE1A85EC53)
        x = x ^ _rol64(x, 33)
    return x


def mixhash(x, hash_width: int) -> np.ndarray:
    """MixHash dispatch by hash width (src/lib.rs:137-177): u16 -> murmur,
    u32 -> xorshift, u64 -> identity."""
    if hash_width == 16:
        return mixhash_u16(x)
    if hash_width == 32:
        return mixhash_u32(x)
    if hash_width == 64:
        return np.asarray(x, dtype=np.uint64)
    raise ValueError(f"hash_width must be 16/32/64, got {hash_width}")


def _rolw(x: np.ndarray, r, w: int) -> np.ndarray:
    """Rotate-left of width-w values held in uint64 (w in {16, 32, 64})."""
    if w == 64:
        return _rol64(x, r)
    x = np.asarray(x, dtype=np.uint64)
    r = np.asarray(r, dtype=np.uint64) % np.uint64(w)
    mask = np.uint64((1 << w) - 1)
    return (((x << r) | (x >> ((np.uint64(w) - r) % np.uint64(64)))) & mask)


def sliding_nthash32(codes: np.ndarray, l: int) -> Tuple[np.ndarray, np.ndarray]:
    """Canonical 32-bit NtHash1 for every window of length l.

    Returns (fh, rh) arrays of length len(codes) - l + 1 (empty if the
    sequence is shorter than l).
    """
    n = len(codes)
    if n < l:
        z = np.zeros(0, dtype=np.uint32)
        return z, z
    hf = SEED_TABLE_F[codes]
    hr = SEED_TABLE_R[codes]
    j = np.arange(n, dtype=np.int64)
    a = _rol32(hf, (-j) % 32)
    b = _rol32(hr, j % 32)
    # Exclusive prefix XOR, length n+1.
    pa = np.zeros(n + 1, dtype=np.uint32)
    pb = np.zeros(n + 1, dtype=np.uint32)
    np.bitwise_xor.accumulate(a, out=pa[1:])
    np.bitwise_xor.accumulate(b, out=pb[1:])
    i = np.arange(n - l + 1, dtype=np.int64)
    fh = _rol32(pa[i + l] ^ pa[i], (l - 1 + i) % 32)
    rh = _rol32(pb[i + l] ^ pb[i], (-i) % 32)
    return fh, rh


def sliding_nthash(
    codes: np.ndarray, l: int, hash_width: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Canonical NtHash1 at the configured hash width for every l-window.

    The reference's compile-time H alternatives (src/lib.rs:30-32) truncate
    the seed tables by an `as H` cast and run the identical recurrence at
    that width.  The H=u64 configuration is validated bit-for-bit by the 20
    golden hashes at reference tests/main.rs:18-39.

    Returns (fh, rh) as uint64 arrays holding width-`hash_width` values.
    """
    if hash_width == 32:
        fh, rh = sliding_nthash32(codes, l)
        return fh.astype(np.uint64), rh.astype(np.uint64)
    n = len(codes)
    if n < l:
        z = np.zeros(0, dtype=np.uint64)
        return z, z
    w = hash_width
    tf, tr = seed_tables(w)
    hf = tf[codes].astype(np.uint64)
    hr = tr[codes].astype(np.uint64)
    j = np.arange(n, dtype=np.int64)
    a = _rolw(hf, (-j) % w, w)
    b = _rolw(hr, j % w, w)
    pa = np.zeros(n + 1, dtype=np.uint64)
    pb = np.zeros(n + 1, dtype=np.uint64)
    np.bitwise_xor.accumulate(a, out=pa[1:])
    np.bitwise_xor.accumulate(b, out=pb[1:])
    i = np.arange(n - l + 1, dtype=np.int64)
    fh = _rolw(pa[i + l] ^ pa[i], (l - 1 + i) % w, w)
    rh = _rolw(pb[i + l] ^ pb[i], (-i) % w, w)
    return fh, rh


def hpc_compress(codes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Collapse runs of identical codes (any byte), like the fused scalar HPC
    iterator (src/nthash_hpc.rs:149) and the SIMD RLE kernel (src/hpc.rs:88).

    Returns (hpc_codes, run_start_positions) — position = index of the first
    character of each run in the original sequence (src/hpc.rs:7-25
    convention, asserted equal across implementations at tests/main.rs:76-78).
    """
    n = len(codes)
    if n == 0:
        return codes[:0], np.zeros(0, dtype=np.int64)
    keep = np.ones(n, dtype=bool)
    keep[1:] = codes[1:] != codes[:-1]
    pos = np.nonzero(keep)[0]
    return codes[pos], pos


def sliding_nthash2_31(
    codes: np.ndarray, l: int
) -> Tuple[np.ndarray, np.ndarray]:
    """The NtHash2-hybrid 31-bit variant (reference src/nthash2_avx512_32.rs,
    kept disabled there for future l > 31 support, :4-6): the identical
    NtHash1 recurrence algebra at width 31 — rotates mod 31
    (rori31/rorv31, :186-215), seeds = top 31 bits (`SEED >> 33`, :238-259).

    Derivation from the reference's init loops (:271-311): fh = 0; for i:
    fh = rol31(fh, 1) ^ seedF(s[i])  =>  fh = XOR_i rol31(seedF(s_i), l-1-i);
    rh = ror31(rh ^ ror31(seedR(s_i), ck), 1) with ck = 31 - (l % 31)
    =>  rh = XOR_i rol31(seedR(s_i), i)  (ck + l - i === -i mod 31).
    Canonical = min(fh, rh) (mask_blend on cmpgt, :313-325)."""
    n = len(codes)
    if n < l:
        z = np.zeros(0, dtype=np.uint64)
        return z, z
    tf, tr = seed_tables_nthash2_31()
    hf = tf[codes].astype(np.uint64)
    hr = tr[codes].astype(np.uint64)
    j = np.arange(n, dtype=np.int64)
    a = _rolw(hf, (-j) % 31, 31)
    b = _rolw(hr, j % 31, 31)
    pa = np.zeros(n + 1, dtype=np.uint64)
    pb = np.zeros(n + 1, dtype=np.uint64)
    np.bitwise_xor.accumulate(a, out=pa[1:])
    np.bitwise_xor.accumulate(b, out=pb[1:])
    i = np.arange(n - l + 1, dtype=np.int64)
    fh = _rolw(pa[i + l] ^ pa[i], (l - 1 + i) % 31, 31)
    rh = _rolw(pb[i + l] ^ pb[i], (-i) % 31, 31)
    return fh, rh


def minimizers(
    seq, l: int, density: float, mode: HashMode, hash_width: int = 32,
    variant: str = "nthash1",
) -> List[Tuple[int, int, int]]:
    """The L2 stage: density-selected minimizer stream as a list of
    (start, end, hash) (see minimizer_arrays)."""
    st, en, h = minimizer_arrays(seq, l, density, mode, hash_width, variant)
    return list(zip(st.tolist(), en.tolist(), h.tolist()))


def minimizer_arrays(
    seq, l: int, density: float, mode: HashMode, hash_width: int = 32,
    variant: str = "nthash1",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The L2 stage: density-selected minimizer stream.

    Returns (start int64, end int64, hash uint64) arrays with positions in
    original sequence space, exactly matching the per-mode conventions of
    the reference (see each branch).

    hash_width mirrors the reference's compile-time H (src/lib.rs:30-32).
    The SIMD modes are u32-only, like the reference's AVX-512 kernels
    (src/nthash_avx512_32.rs: 32-bit lanes).

    variant="nthash2" selects the NtHash2-hybrid 31-bit scheme (reference
    src/nthash2_avx512_32.rs, needed for l > 31): SIMD-mode bound is the
    f32 bound halved with strict `<` (:53-58); the scalar-mode bound
    (halved f64 bound, `<=`) is our extension — the reference never
    shipped a scalar nthash2 path.
    """
    if hash_width != 32 and mode in (HashMode.Simd, HashMode.HpcSimd):
        raise ValueError("SIMD modes require hash_width=32")
    if variant not in ("nthash1", "nthash2"):
        raise ValueError(f"unknown variant {variant!r}")
    if variant == "nthash2" and hash_width != 32:
        raise ValueError("nthash2 variant is 32-bit-lane only")
    # Two views of the input: the HPC keep-mask compares RAW BYTES (the
    # reference compares raw bytes, src/nthash_hpc.rs:253-263,
    # src/hpc.rs:88) and `codes` carry the per-mode-family 3-bit hash code
    # (scalar table: uppercase-only, src/nthash_hpc.rs:30-49; SIMD:
    # case-folding low-nibble LUT, src/nthash_avx512_32.rs:178-193).  A
    # pre-encoded integer array is taken as uint8 xcodes
    # ((raw-byte-diff keep << 3) | code3, constants.py).
    if isinstance(seq, np.ndarray) and np.issubdtype(seq.dtype, np.integer):
        x = seq.astype(np.uint8)
        codes = (x & 7).astype(np.uint8)
        keep = (x & 8) != 0
        if len(keep):
            keep[0] = True
    else:
        if isinstance(seq, str):
            seq = seq.encode("latin-1")
        b = np.frombuffer(bytes(seq), dtype=np.uint8)
        codes = code_table(family_of_mode(mode.value))[b]
        keep = np.ones(len(b), dtype=bool)
        keep[1:] = b[1:] != b[:-1]
    n = len(codes)
    empty = (
        np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, np.uint64)
    )
    # KminmersIterator::new constructs no sub-iterator unless seq.len() > l
    # (src/lib.rs:97) — note the *strict* inequality.
    if n <= l:
        return empty

    def _hashes(cs):
        if variant == "nthash2":
            return sliding_nthash2_31(cs, l)
        return sliding_nthash(cs, l, hash_width)

    if variant == "nthash2":
        bound_scalar = hash_bound(density, 32) // 2
        bound_simd = hash_bound_nthash2_31(density)
    else:
        bound_scalar = hash_bound(density, hash_width)
        bound_simd = hash_bound_simd_u32(density)

    if mode in (HashMode.Regular, HashMode.Simd):
        fh, rh = _hashes(codes)
        h = np.minimum(fh, rh)
        if mode is HashMode.Regular:
            # Regular: caller-side filter `hash <= bound` (src/lib.rs:228),
            # f64 bound (src/lib.rs:91); all windows are candidates.
            sel = np.nonzero(h <= np.uint64(bound_scalar))[0]
        else:
            # Simd: strict `<` against the f32-recomputed bound
            # (src/nthash_avx512_32.rs:48,55,130).
            sel = np.nonzero(h < np.uint64(bound_simd))[0]
        return sel, sel + (l - 1), h[sel].astype(np.uint64)

    # HPC keep-mask over raw-byte identity; hashes over the 3-bit codes.
    pos = np.nonzero(keep)[0]
    hpc_codes = codes[pos]
    m = len(hpc_codes)
    if m < l:
        return empty
    fh, rh = _hashes(hpc_codes)
    h = np.minimum(fh, rh)
    if mode is HashMode.Hpc:
        # Scalar fused HPC iterator: emits window i only if run i+l exists
        # (the iterator returns None once the original index walks past the
        # end, src/nthash_hpc.rs:256-267 — the final HPC window is never
        # emitted).  start = original start of run i (src/nthash_hpc.rs:233),
        # end = last original index of run i+l-1, i.e. pos[i+l]-1
        # (src/nthash_hpc.rs:234,281: current_idx_plus_k - 1).
        # Threshold: `<=` f64 bound (src/nthash_hpc.rs:277).
        nwin = m - l  # windows 0 .. m-l-1
        hh = h[:nwin]
        sel = np.nonzero(hh <= np.uint64(bound_scalar))[0]
        return pos[sel], pos[sel + l] - 1, hh[sel].astype(np.uint64)
    # HpcSimd — SIMD-over-HPC-string: all windows; start = pos[i],
    # end = pos[i+l-1] (start of the *last run*, a different convention
    # from scalar Hpc — src/nthash_hpc_simd.rs:64).  Threshold `<` with the
    # f32 bound.
    sel = np.nonzero(h < np.uint64(bound_simd))[0]
    return pos[sel], pos[sel + l - 1], h[sel].astype(np.uint64)


def kminmers(
    seq, l: int, k: int, density: float, mode: HashMode,
    hash_width: int = 32, variant: str = "nthash1",
) -> List[KminmerRecord]:
    """Full pipeline: minimizer stream -> mixhash -> k-window canonical
    minimizer-space NtHash -> KminmerRecord stream (src/lib.rs:179-270).
    """
    r = kminmer_arrays(seq, l, k, density, mode, hash_width, variant)
    return [
        KminmerRecord(hash=h, start=s, end=e, offset=o, rev=v)
        for h, s, e, o, v in zip(
            r["hash"].tolist(), r["start"].tolist(), r["end"].tolist(),
            r["offset"].tolist(), r["rev"].tolist(),
        )
    ]


def kminmer_arrays(
    seq, l: int, k: int, density: float, mode: HashMode,
    hash_width: int = 32, variant: str = "nthash1",
) -> dict:
    """kminmers() as a struct-of-arrays {hash uint64, start, end, offset
    int64, rev bool} — the form large comparisons use."""
    starts, ends, hashes = minimizer_arrays(
        seq, l, density, mode, hash_width, variant
    )
    c = len(hashes)
    nk = max(c - k + 1, 0)
    if nk == 0:
        return {
            "hash": np.zeros(0, np.uint64),
            "start": np.zeros(0, np.int64),
            "end": np.zeros(0, np.int64),
            "offset": np.zeros(0, np.int64),
            "rev": np.zeros(0, bool),
        }
    mixed = mixhash(hashes, hash_width)
    jj = np.arange(c, dtype=np.int64)
    a = _rol64(mixed, (-jj) % 64)
    b = _rol64(mixed, jj % 64)
    pa = np.zeros(c + 1, dtype=np.uint64)
    pb = np.zeros(c + 1, dtype=np.uint64)
    np.bitwise_xor.accumulate(a, out=pa[1:])
    np.bitwise_xor.accumulate(b, out=pb[1:])
    w = np.arange(nk, dtype=np.int64)
    f = _rol64(pa[w + k] ^ pa[w], (k - 1 + w) % 64)
    r = _rol64(pb[w + k] ^ pb[w], (-w) % 64)
    # canonical: min; rev flag = rhash < fhash (src/lib.rs:250-251)
    return {
        "hash": np.minimum(f, r),
        "start": starts[:nk].astype(np.int64),
        "end": ends[k - 1 :].astype(np.int64),
        "offset": w,
        "rev": r < f,
    }


def nthash1_minimizer_space(kminmer) -> Tuple[int, bool]:
    """Hash a single k-min-mer (list of already-mixed u64 minimizer hashes),
    non-rolling — parity with the reference's test oracle
    `nthash1_minimizer_space` (src/lib.rs:275-288).

    Returns (hash, rev).
    """
    m = np.asarray(kminmer, dtype=np.uint64)
    k = len(m)
    i = np.arange(k, dtype=np.int64)
    fhash = np.bitwise_xor.reduce(_rol64(m, (k - 1 - i) % 64))
    rhash = np.bitwise_xor.reduce(_rol64(m, i % 64))
    h = fhash if fhash < rhash else rhash
    return int(h), bool(rhash < fhash)
