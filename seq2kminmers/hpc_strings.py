"""String-level HPC utilities mirroring the reference's public HPC API
(reference src/hpc.rs: `hpc`, `encode_rle`, `encode_rle_simd`).

These are host-side utilities (native C++ AVX-512 kernel in io/native when
available, vectorized numpy fallback); the device pipeline uses the
mask+compaction form in ops/hpc.py.  Each function reproduces its reference
counterpart's exact nuance:

  * hpc(s)            — collapse runs of ANY character (src/hpc.rs:28-41).
  * encode_rle(s)     — collapse runs only of characters in "ACTGactgNn"
                        (src/hpc.rs:14); also return the original start
                        position of every kept char (src/hpc.rs:7-25) as an
                        int64 array (the Vec<usize> equivalent).
  * encode_rle_simd(s)— collapse runs of ANY byte, positions as uint32
                        (src/hpc.rs:44-147).

For ACGTN-only input all three agree (asserted by the reference test at
tests/main.rs:76-78).

The hot path stays in native memory end to end: the s2kext CPython
extension (io/native/s2kext.cpp, AVX-512 VBMI2 compress-store — the
64-wide analogue of the reference's 16-wide kernel, src/hpc.rs:88-108)
reads str input zero-copy from the UCS1 buffer and writes kept chars
directly into the result str's buffer and positions into an exact-dtype
numpy array, GIL released, two-phase multithreaded above 4 MB.  Fallbacks:
the ctypes kernel (same SIMD core, one extra copy), then vectorized numpy.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_RLE_COLLAPSIBLE = np.zeros(256, dtype=bool)
for _c in b"ACTGactgNn":
    _RLE_COLLAPSIBLE[_c] = True


def _to_bytes(s) -> np.ndarray:
    if isinstance(s, str):
        s = s.encode()
    return np.frombuffer(bytes(s), dtype=np.uint8)


_ext = None
_ext_checked = False


def _ext_rle(s, collapse_any: int, wide: int, want_pos: int):
    """Zero-copy path through the s2kext CPython extension; returns
    (hpc_str, pos ndarray | None) or None if unavailable/unsuitable."""
    global _ext, _ext_checked
    if not _ext_checked:
        from .io.native_ext import load_ext

        _ext = load_ext()
        _ext_checked = True
    if (
        _ext is None
        or not isinstance(s, (str, bytes, bytearray, memoryview))
        or (not wide and len(s) >= (1 << 31))  # int32 position overflow
    ):
        return None
    try:
        return _ext.rle(s, collapse_any, wide, want_pos)
    except ValueError:  # non-latin-1 str input
        return None


def _native_rle(b: np.ndarray, collapse_any: bool, wide: bool = False):
    """Run the C++ s2k_hpc_rle32/64 kernel if the native lib is available;
    returns (kept chars uint8, kept positions int32|int64) or None."""
    from .io.fasta import _load_native

    lib = _load_native()
    if lib is None or (not wide and len(b) >= (1 << 31)):
        return None
    import ctypes

    b = np.ascontiguousarray(b)
    chars = np.empty(len(b), dtype=np.uint8)
    pos = np.empty(len(b), dtype=np.int64 if wide else np.int32)
    fn = lib.s2k_hpc_rle64 if wide else lib.s2k_hpc_rle32
    m = fn(
        b.ctypes.data_as(ctypes.c_void_p),
        len(b),
        1 if collapse_any else 0,
        chars.ctypes.data_as(ctypes.c_void_p),
        pos.ctypes.data_as(ctypes.c_void_p),
    )
    return chars[:m], pos[:m]


def _decode(chars: np.ndarray) -> str:
    # str(memoryview, 'latin-1') skips the tobytes() intermediate copy
    return str(memoryview(chars), "latin-1")


def _numpy_rle(b: np.ndarray, collapse_any: bool):
    keep = np.ones(len(b), dtype=bool)
    if collapse_any:
        keep[1:] = b[1:] != b[:-1]
    else:
        keep[1:] = (b[1:] != b[:-1]) | ~_RLE_COLLAPSIBLE[b[1:]]
    pos = np.nonzero(keep)[0]
    return b[pos], pos


def hpc(s) -> str:
    """Collapse runs of any repeated character."""
    if len(s) == 0:
        return ""
    ext = _ext_rle(s, 1, 0, 0)
    if ext is not None:
        return ext[0]
    b = _to_bytes(s)
    nat = _native_rle(b, True)
    chars = nat[0] if nat is not None else _numpy_rle(b, True)[0]
    return _decode(chars)


def encode_rle(s) -> Tuple[str, np.ndarray]:
    """Collapse runs of ACTG/actg/N/n only; runs of other characters are
    kept verbatim.  Returns (hpc_string, int64 start positions of kept
    chars)."""
    if len(s) == 0:
        return "", np.zeros(0, dtype=np.int64)
    ext = _ext_rle(s, 0, 1, 1)  # int64 positions in-kernel
    if ext is not None:
        return ext
    b = _to_bytes(s)
    nat = _native_rle(b, False, wide=True)
    chars, pos = nat if nat is not None else _numpy_rle(b, False)
    return _decode(chars), pos if pos.dtype == np.int64 else pos.astype(
        np.int64
    )


def encode_rle_simd(s) -> Tuple[str, np.ndarray]:
    """Collapse runs of any byte; positions returned as uint32 array."""
    if len(s) == 0:
        return "", np.zeros(0, dtype=np.uint32)
    ext = _ext_rle(s, 1, 0, 1)
    if ext is not None:
        return ext[0], ext[1].view(np.uint32)  # zero-copy view
    b = _to_bytes(s)
    nat = _native_rle(b, True)
    if nat is not None:
        return _decode(nat[0]), nat[1].view(np.uint32)
    chars, pos = _numpy_rle(b, True)
    return _decode(chars), pos.astype(np.uint32)
