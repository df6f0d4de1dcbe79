"""K-min-mer data model: the vector-of-mers record and its hashers.

Mirrors the reference's kminmer.rs:
  * KminmerVec (kminmer.rs:18-126): keeps the k raw minimizer hashes;
    canonical form = lexicographic min of (mers, reversed mers) with a rev
    flag (normalize, :54-61); equality/ordering/hashing on the mers.
  * KminmerHash built from a mers slice (`Kminmer::new`, :140-161): hash =
    fxhash64 of the canonical mers vector.  (The production path
    `new_from_hash`, :169-177, is KminmerRecord in oracle.py.)
  * FxHash (fxhash crate 0.2.1): per 8-byte word
    h = rol(h, 5) ^ word) * SEED, over write_usize(len) + the slice bytes
    (Rust std hashes an integer slice as a length prefix + its raw
    little-endian bytes).
  * SipHash-1-3 with zero keys = Rust's DefaultHasher, used by the
    reference's slow generic get_hash (kminmer.rs:42-47).

These hashers run on host (numpy/python int) — they serve the
KminmerVec identity path, not the rolling-hash production path.
"""

from __future__ import annotations

import struct
import warnings
from dataclasses import dataclass, field
from typing import List, Sequence

import numpy as np

from .oracle import HashMode, minimizers

_M64 = (1 << 64) - 1
_FX_SEED64 = 0x51_7C_C1_B7_27_22_0A_95
_FX_SEED32 = 0x9E_37_79_B9


def _rol64(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def fxhash64_bytes(data: bytes, init: int = 0) -> int:
    """FxHasher64 `write` over a byte string (fxhash 0.2.1 semantics):
    8-byte LE words, then 4/2/1-byte tails, each folded as
    h = (rol64(h, 5) ^ w) * SEED64 mod 2^64."""
    h = init
    i = 0
    n = len(data)
    while n - i >= 8:
        (w,) = struct.unpack_from("<Q", data, i)
        h = (_rol64(h, 5) ^ w) * _FX_SEED64 & _M64
        i += 8
    if n - i >= 4:
        (w,) = struct.unpack_from("<I", data, i)
        h = (_rol64(h, 5) ^ w) * _FX_SEED64 & _M64
        i += 4
    if n - i >= 2:
        (w,) = struct.unpack_from("<H", data, i)
        h = (_rol64(h, 5) ^ w) * _FX_SEED64 & _M64
        i += 2
    if n - i >= 1:
        h = (_rol64(h, 5) ^ data[i]) * _FX_SEED64 & _M64
    return h


def _fx_add64(h: int, w: int) -> int:
    return (_rol64(h, 5) ^ w) * _FX_SEED64 & _M64


def fxhash64_of_mers(mers: Sequence[int], mer_width: int = 32) -> int:
    """fxhash::hash64(&Vec<H>) — Rust hashes an integer vector as
    write_usize(len) followed by the slice's raw LE bytes."""
    h = _fx_add64(0, len(mers) & _M64)  # write_usize(len)
    dt = {16: "<u2", 32: "<u4", 64: "<u8"}[mer_width]
    data = np.asarray(mers, dtype=np.uint64).astype(dt).tobytes()
    return fxhash64_bytes(data, init=h)


def fxhash32_of_mers(mers: Sequence[int], mer_width: int = 32) -> int:
    """fxhash::hash32 (32-bit folding, 4-byte words) of a Vec<H>."""
    M32 = (1 << 32) - 1

    def rol32(x, r):
        return ((x << r) | (x >> (32 - r))) & M32

    def add(h, w):
        return (rol32(h, 5) ^ w) * _FX_SEED32 & M32

    # write_usize writes 8 bytes = two 4-byte words on the 32-bit folder
    h = add(0, len(mers) & M32)
    h = add(h, (len(mers) >> 32) & M32)
    dt = {16: "<u2", 32: "<u4", 64: "<u8"}[mer_width]
    data = np.asarray(mers, dtype=np.uint64).astype(dt).tobytes()
    i, n = 0, len(data)
    while n - i >= 4:
        (w,) = struct.unpack_from("<I", data, i)
        h = add(h, w)
        i += 4
    if n - i >= 2:
        (w,) = struct.unpack_from("<H", data, i)
        h = add(h, w)
        i += 2
    if n - i >= 1:
        h = add(h, data[i])
    return h


class SipHash13:
    """SipHash-1-3 (Rust's DefaultHasher with zero keys)."""

    def __init__(self, k0: int = 0, k1: int = 0):
        self.v0 = k0 ^ 0x736F6D6570736575
        self.v1 = k1 ^ 0x646F72616E646F6D
        self.v2 = k0 ^ 0x6C7967656E657261
        self.v3 = k1 ^ 0x7465646279746573
        self.buf = b""
        self.length = 0

    def _round(self):
        v0, v1, v2, v3 = self.v0, self.v1, self.v2, self.v3
        v0 = (v0 + v1) & _M64
        v1 = _rol64(v1, 13) ^ v0
        v0 = _rol64(v0, 32)
        v2 = (v2 + v3) & _M64
        v3 = _rol64(v3, 16) ^ v2
        v0 = (v0 + v3) & _M64
        v3 = _rol64(v3, 21) ^ v0
        v2 = (v2 + v1) & _M64
        v1 = _rol64(v1, 17) ^ v2
        v2 = _rol64(v2, 32)
        self.v0, self.v1, self.v2, self.v3 = v0, v1, v2, v3

    def _compress(self, m: int):
        self.v3 ^= m
        self._round()  # SipHash-1-3: one compression round
        self.v0 ^= m

    def write(self, data: bytes):
        self.length += len(data)
        self.buf += data
        while len(self.buf) >= 8:
            (m,) = struct.unpack_from("<Q", self.buf, 0)
            self._compress(m)
            self.buf = self.buf[8:]

    def finish(self) -> int:
        b = (self.length & 0xFF) << 56
        tail = self.buf
        for i, c in enumerate(tail):
            b |= c << (8 * i)
        self._compress(b)
        self.v2 ^= 0xFF
        self._round()
        self._round()
        self._round()  # 3 finalization rounds
        return (self.v0 ^ self.v1 ^ self.v2 ^ self.v3) & _M64


def siphash13_of_mers(mers: Sequence[int], mer_width: int = 32) -> int:
    """Rust `Vec<H>.hash(&mut DefaultHasher)` + finish(): usize length
    prefix then the slice's LE bytes through SipHash-1-3(0, 0)."""
    h = SipHash13()
    h.write(struct.pack("<Q", len(mers)))
    dt = {16: "<u2", 32: "<u4", 64: "<u8"}[mer_width]
    h.write(np.asarray(mers, dtype=np.uint64).astype(dt).tobytes())
    return h.finish()


@dataclass
class KminmerVec:
    """Reference KminmerVec (kminmer.rs:18-126)."""

    mers: List[int]
    start: int = 0
    end: int = 0
    offset: int = 0
    rev: bool = False
    mer_width: int = field(default=32, compare=False)

    def __post_init__(self):
        self.mers = [int(m) for m in self.mers]
        self.normalize()

    def normalize(self):
        """Canonical = lexicographic min of (mers, reversed) (:54-61)."""
        rev_mers = list(reversed(self.mers))
        if rev_mers < self.mers:
            self.mers = rev_mers
            self.rev = True

    def is_normalized(self) -> bool:
        return self.mers <= list(reversed(self.mers))

    def print(self) -> str:
        """First 2 decimal digits of each mer (:71-78)."""
        return "".join(f"{str(m)[:2]} " for m in self.mers)

    def get_hash(self) -> int:
        """Generic path (:42-47): DefaultHasher (SipHash-1-3) — the
        reference prints the same performance warning."""
        warnings.warn(
            "[warning, seq2kminmers] generic get_hash() method called; "
            "Shouldn't, it's a performance issue. Use KminmerHash instead"
        )
        return siphash13_of_mers(self.mers, self.mer_width)

    def get_hash_usize(self) -> int:
        return fxhash64_of_mers(self.mers, self.mer_width)

    def get_hash_u32(self) -> int:
        return fxhash32_of_mers(self.mers, self.mer_width)

    def get_hash_u64(self) -> int:
        return fxhash64_of_mers(self.mers, self.mer_width)

    # Equality/ordering on the mers only (:97-126).
    def __eq__(self, other):
        return self.mers == other.mers

    def __lt__(self, other):
        return self.mers < other.mers

    def __hash__(self):
        return hash(tuple(self.mers))


def kminmer_hash_from_mers(
    mers: Sequence[int], start: int, end: int, offset: int,
    mer_width: int = 32,
):
    """Reference `Kminmer::new for KminmerHash` (kminmer.rs:140-161):
    canonicalize, then hash = fxhash64 of the canonical mers vector.
    Returns a KminmerRecord."""
    from .oracle import KminmerRecord

    mers = [int(m) for m in mers]
    rev_mers = list(reversed(mers))
    if rev_mers < mers:
        h = fxhash64_of_mers(rev_mers, mer_width)
        rev = True
    else:
        h = fxhash64_of_mers(mers, mer_width)
        rev = False
    return KminmerRecord(hash=h, start=start, end=end, offset=offset, rev=rev)


def kminmers_vec(
    seq, l: int, k: int, density: float, mode=HashMode.Regular,
    hash_width: int = 32,
) -> List[KminmerVec]:
    """Full pipeline yielding KminmerVec records (the reference's
    alternative KminmerType, src/lib.rs:39 comment + kminmer.rs:18):
    window of k raw (UNMIXED) minimizer hashes, positions as in the
    rolling path."""
    if not isinstance(mode, HashMode):
        mode = HashMode(str(mode).lower())
    mins = minimizers(seq, l, density, mode, hash_width)
    out: List[KminmerVec] = []
    for w in range(len(mins) - k + 1):
        window = mins[w : w + k]
        out.append(
            KminmerVec(
                mers=[m[2] for m in window],
                start=window[0][0],
                end=window[-1][1],
                offset=w,
                mer_width=hash_width,
            )
        )
    return out
