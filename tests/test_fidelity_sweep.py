"""Randomized differential fidelity sweep (VERDICT r4 #6).

~1000 seeded random sequences, swept over mode x hash-width x variant x
l in 2..255 x alphabet family (pure ACGT, ACGTN, mixed case, non-ACGTN
garbage bytes, homopolymer bombs, and sub-l shorties), each checked as
FULL records (hash, start, end, offset, rev) three ways:

    independent literal checker  ==  numpy oracle  ==  jit batch pipeline

The literal checker below recomputes every window hash by DIRECT
accumulation of position-rotated seeds (the closed form the reference's
init loops expand to, src/nthash_hpc.rs:137-174) — it shares no code with
oracle.py's exclusive-prefix-XOR reformulation or with the kernels, and
is vectorized only across windows, never across the l positions.

Reference semantics under test: per-mode thresholds and position
conventions (src/nthash_hpc.rs:253-263,277,281; src/hpc.rs:14;
src/nthash_avx512_32.rs:55,130,178-193; src/nthash_hpc_simd.rs:64),
width configs H=u16/u32/u64 (src/lib.rs:30-32,137-177) and the
NtHash2-31 hybrid (src/nthash2_avx512_32.rs:53-58,238-241).

Cases are grouped into one [B, L] batch per parameter combo so the sweep
stays one pipeline compilation per combo (~1 s CPU each).
"""

import zlib

import numpy as np
import pytest

from seq2kminmers.api import kminmers_batch
from seq2kminmers.constants import (
    XCODE_PAD,
    encode_xcodes,
    family_of_mode,
    hash_bound,
    hash_bound_nthash2_31,
    hash_bound_simd_u32,
    hash_bound_u32,
)
from seq2kminmers.oracle import HashMode
from seq2kminmers.oracle import kminmers as oracle_kminmers
from seq2kminmers.ops.pipeline import PipelineSpec

U64 = np.uint64
M64 = U64(0xFFFFFFFFFFFFFFFF)

# Published 64-bit NtHash1 seeds (src/nthash_hpc.rs:30-49).
_S64 = {
    ord("A"): 0x3C8BFBB395C60474,
    ord("C"): 0x3193C18562A02B4C,
    ord("G"): 0x20323ED082572324,
    ord("T"): 0x295549F54BE24456,
    ord("N"): 0,
}
_COMP = {ord("A"): ord("T"), ord("T"): ord("A"), ord("C"): ord("G"),
         ord("G"): ord("C"), ord("N"): ord("N")}
# SIMD char->code nibble LUT (src/nthash_avx512_32.rs:183-184).
_NIB = [4, 0, 4, 1, 3, 4, 4, 2] + [4] * 8
_CODE_BYTE = [ord("A"), ord("C"), ord("G"), ord("T"), ord("N")]


def _seed_tables(family, width, variant):
    """Byte-indexed (fwd, rc) uint64 seed tables for one configuration.

    scalar family: only uppercase ACGTN populated, default seed 1
    (src/nthash_hpc.rs:31); simd family: case-folding nibble LUT, every
    non-base nibble -> N (src/nthash_avx512_32.rs:178-193).  Width
    truncation is the `as H` cast (low bits); the nthash2 variant takes
    the TOP 31 bits instead (`SEED >> 33`, src/nthash2_avx512_32.rs:238).
    """
    def trunc(s64):
        if variant == "nthash2":
            return s64 >> 33
        return s64 & ((1 << width) - 1)

    f = np.full(256, 1, dtype=U64)
    r = np.full(256, 1, dtype=U64)
    if family == "scalar":
        for b, s in _S64.items():
            f[b] = trunc(s)
            r[b] = trunc(_S64[_COMP[b]])
    else:
        for byte in range(256):
            code = _NIB[byte & 0x0F]
            base = _CODE_BYTE[code]
            f[byte] = trunc(_S64[base])
            r[byte] = trunc(_S64[_COMP[base]])
    return f, r


def _rolv(x, rot, w):
    """Rotate-left by a scalar amount on a uint64 array of width-w values."""
    rot %= w
    mask = M64 if w == 64 else U64((1 << w) - 1)
    if rot == 0:
        return x & mask
    return ((x << U64(rot)) | ((x & mask) >> U64(w - rot))) & mask


def _window_hashes(stream_bytes, l, family, width, variant):
    """Canonical hash of EVERY l-window by direct XOR accumulation over
    the l in-window offsets (no prefix-scan): fh = XOR_t rol(h(s[i+t]),
    l-1-t), rh = XOR_t rol(rc(s[i+t]), t) (src/nthash_hpc.rs:144,168)."""
    w = 31 if variant == "nthash2" else width
    tf, tr = _seed_tables(family, width, variant)
    hs = tf[stream_bytes]
    rs = tr[stream_bytes]
    nwin = len(stream_bytes) - l + 1
    fh = np.zeros(nwin, dtype=U64)
    rh = np.zeros(nwin, dtype=U64)
    for t in range(l):
        fh ^= _rolv(hs[t : t + nwin], l - 1 - t, w)
        rh ^= _rolv(rs[t : t + nwin], t, w)
    return np.minimum(fh, rh)


def _mix(h, width):
    """MixHash per width (src/lib.rs:137-177), vectorized u64 arithmetic."""
    x = h.astype(U64)
    with np.errstate(over="ignore"):
        if width == 32:
            x = x ^ (x << U64(13))
            x = x ^ (x >> U64(7))
            x = x ^ (x << U64(17))
        elif width == 16:
            x = x ^ _rolv(x, 33, 64)
            x = x * U64(0xFF51AFD7ED558CCD)
            x = x ^ _rolv(x, 33, 64)
            x = x * U64(0xC4CEB9FE1A85EC53)
            x = x ^ _rolv(x, 33, 64)
    return x


def lit_kminmers(raw, l, k, density, mode, width, variant):
    """Literal-semantics full-record k-min-mers of one byte sequence."""
    n = len(raw)
    if n <= l:  # strict whole-read gate (src/lib.rs:97)
        return []
    family = family_of_mode(mode)
    if mode in ("hpc", "hpcsimd"):
        keep = np.ones(n, dtype=bool)
        keep[1:] = raw[1:] != raw[:-1]  # raw-byte runs (src/hpc.rs:88)
        pos = np.nonzero(keep)[0]
        stream = raw[pos]
    else:
        pos = np.arange(n)
        stream = raw
    m = len(stream)
    if m < l or (mode == "hpc" and m < l + 1):
        return []
    h = _window_hashes(stream, l, family, width, variant)
    strict = mode in ("simd", "hpcsimd")
    if variant == "nthash2":
        bound = hash_bound_nthash2_31(density) if strict else (
            hash_bound_u32(density) // 2
        )
    else:
        bound = hash_bound_simd_u32(density) if strict else hash_bound(
            density, width
        )
    last = m - l - 1 if mode == "hpc" else m - l
    sel = np.nonzero(
        (h[: last + 1] < U64(bound)) if strict else
        (h[: last + 1] <= U64(bound))
    )[0]
    if mode in ("regular", "simd"):
        ss, ee = sel, sel + l - 1
    elif mode == "hpc":
        ss, ee = pos[sel], pos[sel + l] - 1
    else:
        ss, ee = pos[sel], pos[sel + l - 1]
    c = len(sel)
    if c < k:
        return []
    mixed = _mix(h[sel], width)
    nw = c - k + 1
    f = np.zeros(nw, dtype=U64)
    r = np.zeros(nw, dtype=U64)
    for t in range(k):  # direct accumulation (src/lib.rs:240-249 algebra)
        f ^= _rolv(mixed[t : t + nw], k - 1 - t, 64)
        r ^= _rolv(mixed[t : t + nw], t, 64)
    hh = np.minimum(f, r)
    rev = r < f
    return [
        (int(hh[i]), int(ss[i]), int(ee[i + k - 1]), i, bool(rev[i]))
        for i in range(nw)
    ]


# ---------------------------------------------------------------- cases

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
BASES_N = np.frombuffer(b"ACGTN", dtype=np.uint8)
CASED = np.frombuffer(b"ACGTacgtNn", dtype=np.uint8)
ALPHABETS = ("acgt", "acgtn", "case", "garbage", "homopoly", "short")


def _gen_seq(rng, kind, l, L):
    if kind == "short":  # at/below the gate — must emit nothing
        n = int(rng.integers(1, max(l + 1, 2)))
    else:
        lo = max(2, min(l - 3, L - 40))
        n = int(rng.integers(lo, L - 30))
    if kind == "acgt":
        b = rng.choice(BASES, size=n)
    elif kind == "acgtn":
        b = np.where(
            rng.random(n) < 0.08, ord("N"), rng.choice(BASES, size=n)
        ).astype(np.uint8)
    elif kind == "case":
        b = rng.choice(CASED, size=n)
    elif kind == "garbage":
        b = np.where(
            rng.random(n) < 0.35,
            rng.integers(33, 127, size=n),
            rng.choice(BASES_N, size=n),
        ).astype(np.uint8)
    else:  # homopoly bombs (incl. across any kernel-block geometry)
        b = rng.choice(BASES_N, size=n)
        for _ in range(max(n // 24, 1)):
            i = int(rng.integers(0, n))
            run = int(rng.integers(2, 44))
            b[i : i + run] = b[i]
    return b


def _combos():
    rng = np.random.default_rng(0xF1DE)
    out = []
    # nthash1/u32, every mode, l across the SIMD-legal range
    for rep in range(5):
        for mode in ("regular", "simd", "hpc", "hpcsimd"):
            out.append((mode, 32, "nthash1", int(rng.integers(2, 32)),
                        int(rng.integers(2, 9)),
                        float(rng.choice([0.01, 0.05, 0.1, 0.3]))))
    # scalar paths allow l < 256 (BUFLEN, src/nthash_hpc.rs:9-11): the
    # u32-rotation-aliasing regime l in 32..255
    for mode in ("regular", "hpc"):
        for l in (32, 33, 77, 255):
            out.append((mode, 32, "nthash1", l, int(rng.integers(2, 6)),
                        float(rng.choice([0.05, 0.1, 0.3]))))
    # H=u16 / H=u64 configs (src/lib.rs:30,32)
    for width in (16, 64):
        for mode in ("regular", "hpc"):
            for rep in range(3):
                out.append((mode, width, "nthash1",
                            int(rng.integers(2, 64)),
                            int(rng.integers(2, 9)),
                            float(rng.choice([0.05, 0.1, 0.3]))))
    # NtHash2-31 hybrid, all modes, incl. the l > 31 regime it exists for
    for mode in ("regular", "simd", "hpc", "hpcsimd"):
        for rep in range(2):
            out.append((mode, 32, "nthash2",
                        int(rng.integers(2, 140)),
                        int(rng.integers(2, 9)),
                        float(rng.choice([0.05, 0.1, 0.3]))))
    return out


COMBOS = _combos()
SEQS_PER_COMBO = 21  # x 48 combos = 1008 random cases
L_PAD = 512


@pytest.mark.parametrize(
    "combo",
    COMBOS,
    ids=[f"{m}-w{w}-{v}-l{l}-k{k}-d{d}" for m, w, v, l, k, d in COMBOS],
)
def test_fidelity_sweep(combo):
    mode, width, variant, l, k, d = combo
    rng = np.random.default_rng(zlib.crc32(repr(combo).encode()))
    family = family_of_mode(mode)
    seqs = [
        _gen_seq(rng, ALPHABETS[i % len(ALPHABETS)], l, L_PAD)
        for i in range(SEQS_PER_COMBO)
    ]
    codes = np.full((len(seqs), L_PAD), XCODE_PAD, dtype=np.uint8)
    lengths = np.zeros(len(seqs), dtype=np.int32)
    for i, b in enumerate(seqs):
        x = encode_xcodes(b, family)
        codes[i, : len(x)] = x
        lengths[i] = len(x)
    spec = PipelineSpec(
        l=l, k=k, density=d, mode=mode, hash_width=width, variant=variant
    )
    out = kminmers_batch(codes, lengths, spec)
    n_km = np.asarray(out.n_kminmers)
    hi = np.asarray(out.hash_hi, dtype=np.uint64)
    lo = np.asarray(out.hash_lo, dtype=np.uint64)
    st = np.asarray(out.start)
    en = np.asarray(out.end)
    rv = np.asarray(out.rev)
    for i, b in enumerate(seqs):
        ref = lit_kminmers(b, l, k, d, mode, width, variant)
        orc = [
            (r.hash, r.start, r.end, r.offset, r.rev)
            for r in oracle_kminmers(
                bytes(b), l, k, d, HashMode(mode), width, variant
            )
        ]
        assert orc == ref, (combo, i, "oracle vs literal")
        nk = int(n_km[i])
        got = [
            (int((hi[i, w] << np.uint64(32)) | lo[i, w]), int(st[i, w]),
             int(en[i, w]), w, bool(rv[i, w]))
            for w in range(nk)
        ]
        assert got == ref, (combo, i, "pipeline vs literal")


# ---- chunked-scan sweep -------------------------------------------------
# The cases above run each read whole through the batch pipeline; this
# block cuts the reads into 1000-base chunks scanned one step at a time
# (ops/long_read.py over ops/scan.py), so every per-mode convention is
# also pinned to the literal checker across chunk boundaries, with
# homopolymer bombs and garbage bytes spanning them.

CHUNKED_COMBOS = [
    ("regular", 32, "nthash1", 13, 4, 0.08),
    ("simd", 32, "nthash1", 27, 2, 0.15),
    ("hpc", 32, "nthash1", 9, 3, 0.2),
    ("hpcsimd", 32, "nthash1", 31, 5, 0.05),
    ("regular", 16, "nthash1", 11, 3, 0.1),
    ("hpc", 16, "nthash1", 21, 2, 0.12),
    ("regular", 64, "nthash1", 33, 2, 0.08),
    ("hpc", 64, "nthash1", 15, 4, 0.1),
    ("regular", 32, "nthash2", 45, 3, 0.1),
    ("hpc", 32, "nthash2", 61, 2, 0.1),
    ("simd", 32, "nthash2", 39, 4, 0.12),
    ("hpcsimd", 32, "nthash2", 101, 2, 0.08),
]


@pytest.mark.parametrize(
    "combo",
    CHUNKED_COMBOS,
    ids=[f"{m}-w{w}-{v}-l{l}" for m, w, v, l, k, d in CHUNKED_COMBOS],
)
def test_chunked_scan_fidelity(combo):
    from seq2kminmers.ops.long_read import kminmers_long_batch

    mode, width, variant, l, k, d = combo
    rng = np.random.default_rng(zlib.crc32(repr(combo).encode()))
    family = family_of_mode(mode)
    L = 4096
    seqs = []
    for _ in range(3):
        n = int(rng.integers(L // 2, L - 1))
        parts, m = [], 0
        while m < n:
            if rng.random() < 0.25:
                p = bytes([rng.choice(BASES)]) * int(rng.integers(2, 500))
            else:
                p = bytes(
                    rng.choice(
                        np.frombuffer(b"ACGTNacgtQX", dtype=np.uint8),
                        size=int(rng.integers(30, 200)),
                    )
                )
            parts.append(p)
            m += len(p)
        seqs.append(np.frombuffer(b"".join(parts)[:n], dtype=np.uint8))
    got = kminmers_long_batch(
        [encode_xcodes(b, family) for b in seqs], l, k, d, mode=mode,
        variant=variant, chunk=1000, hash_width=width,
    )
    for i, b in enumerate(seqs):
        ref = lit_kminmers(b, l, k, d, mode, width, variant)
        g = got[i]
        rows = list(zip(
            g["hash"].tolist(), g["start"].tolist(), g["end"].tolist(),
            g["offset"].tolist(), g["rev"].tolist(),
        ))
        assert rows == ref, (combo, i, len(rows), len(ref))
