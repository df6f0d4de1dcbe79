"""Chunked long-read driver: stream ONE sequence of (practically)
unbounded length through the carry-aware stage chain (ops/scan.py).

The reference scans arbitrarily long sequences with O(1) state — a ring
buffer of the last l characters plus the rolling hash pair
(src/nthash_hpc.rs:137-174); its AVX-512 kernel carries the same state
between 16-lane blocks (src/nthash_avx512_32.rs:404-425).  This driver is
the chunk-level generalization: the sequence is cut into fixed
`chunk`-base pieces, each scanned by ONE jitted step whose carry (global
kept rank + the last l kept (pos, code) elements, packed) is threaded from
step to step as device arrays.  Every chunk reuses the SAME compiled
executable — one compile per (chunk, l, mode) regardless of sequence
length — and only the ~density-sized compacted minimizer stream ever
crosses to the host.  Positions are packed into 29 signed bits per chunk
only, so sequences may reach the int32 position range (2^31-1 bases).

Host-sync discipline: the per-chunk (n_min, n_raw) counters accumulate in
a small on-device array threaded through the carry chain, so the whole
phase-A dispatch loop runs with ZERO host round-trips and the counters
arrive in ONE fetch; the survivor arrays of all chunks are then fetched
in one `jax.device_get` (plain D2H copies, no per-chunk slice launches).

Phase A is host-pipelined: a producer thread stages chunks into a ring of
three reusable pre-padded buffers and blocks on each H2D upload off the
dispatch thread, so staging, uploads, and device compute of consecutive
chunks overlap (mirroring io/stream.py's double-buffered batch
streaming).  Many long reads batch into the same steps ([B, chunk] rows,
[B]-shaped carry) via minimizer_stream_long_batch / kminmers_long_batch.

K-min-mer assembly runs at the end over the accumulated minimizer stream,
tiled into overlapping rows (overlap k-1) so one compiled assembly program
covers any stream length.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import XCODE_PAD, encode_xcodes, family_of_mode
from .assemble import assemble_kminmers_mixed
from .compact import I32
from .pipeline import PipelineSpec
from .scan import ScanCarry, scan_step, window_limit
from .u64 import mix64_from_u32, mix64_murmur_from_u16

# Bases per step.  On an H100 (compiled.memory_analysis(), PERF.md) a
# step's temporaries are 28 bytes per base and row: 0.875 GiB here, so a
# batch of 16 reads needs 14 GiB of the card's 80 GB.  Doubling the chunk
# gains under 5 % per base (the fixed cost per step is already amortized).
DEFAULT_CHUNK = 1 << 25


def _counts_cap(nchunks: int) -> int:
    """Static capacity of the on-device per-chunk counter accumulator:
    next power of two >= nchunks (>= 32) so the executable recompiles only
    across pow2 buckets, not per sequence length."""
    cap = 32
    while cap < nchunks:
        cap *= 2
    return cap


def _chunk_step(spec: PipelineSpec, m_cap: int, counts_cap: int = 32,
                packed: bool = False):
    """One jitted step: scan_step with carry in/out.  (n_min, n_raw) are
    written into row `ci` of the threaded `cacc` accumulator
    (int32[counts_cap, B, 2]) so the host never syncs inside the chunk
    loop.

    packed=True: `codes` arrives as uint8[B, chunk/2] with two 4-bit
    xcodes per byte (every xcode is (keep << 3) | code3 <= 14) and is
    unpacked on-device — H2D bytes halve."""

    @jax.jit
    def step(codes, length_local, limit, carry, cacc, ci):
        if packed:
            from ..io.stream import _nibble_unpack_expr

            codes = _nibble_unpack_expr(jnp, codes)
        out, carry = scan_step(codes, length_local, limit, carry, spec, m_cap)
        cacc = jax.lax.dynamic_update_slice(
            cacc,
            jnp.stack([out.n_min, out.n_raw], axis=-1).astype(I32)[None],
            (ci, jnp.int32(0), jnp.int32(0)),
        )
        hashes = (out.hash,) if out.hash_hi is None else (out.hash_hi, out.hash)
        return (out.start, out.end, hashes), carry, cacc

    return step


def _pack_nibbles(buf: np.ndarray) -> np.ndarray:
    """uint8[B, C] xcodes (all <= 15) -> uint8[B, C/2], two per byte."""
    v = buf.view(np.uint16)
    return ((v | (v >> 4)) & 0xFF).astype(np.uint8)


def minimizer_stream_long_batch(
    rows,  # sequence of uint8[n_b] xcode arrays (one per read)
    spec: PipelineSpec,
    chunk: int = DEFAULT_CHUNK,
    pack_transfer: bool = True,
):
    """-> list of (start, end, hash) numpy triples, one per read: the full
    ordered minimizer stream of each read (original-space positions).

    Rows ride the SAME chunk steps ([B, chunk] batches through one
    executable, [B]-shaped carry), so per-step overhead amortizes across
    reads — the reference's one-thread-per-record analogue
    (src/main.rs:65-76) at step granularity.

    Host pipelining: a producer thread stages each chunk into one of three
    reusable pre-padded buffers and issues the device upload, blocking on
    transfer completion OFF the dispatch thread; the main thread only
    dequeues ready device arrays and dispatches compute.  Staging, H2D
    copies and device compute of consecutive chunks overlap; nothing below
    Phase B syncs on results.

    pack_transfer (default on): xcodes are 4-bit values, so the producer
    packs two per byte and the jitted step unpacks on-device — H2D traffic
    halves.
    """
    import queue as _queue
    import threading

    lengths = np.array([int(r.shape[0]) for r in rows], dtype=np.int64)
    B = len(rows)
    n_max = int(lengths.max(initial=0))
    l = spec.l
    wide = spec.hash_width == 64
    hdt = {16: np.uint16, 32: np.uint32, 64: np.uint64}[spec.hash_width]
    empty = (
        np.zeros(0, dtype=np.int64),
        np.zeros(0, dtype=np.int64),
        np.zeros(0, dtype=hdt),
    )
    if n_max <= l:
        return [empty] * B
    if n_max >= 1 << 31:
        raise ValueError("sequences must be shorter than 2^31 bases")
    chunk = int(chunk) + (int(chunk) & 1)  # nibble packing pairs columns
    nchunks = -(-n_max // chunk)
    m_cap = spec.capacity_for(chunk)
    ccap = _counts_cap(nchunks)

    carry = ScanCarry.empty(B, l)
    cacc = jnp.zeros((ccap, B, 2), dtype=I32)
    limit = window_limit(jnp.asarray(lengths.astype(np.int32)), l)
    step = _chunk_step(spec, m_cap, ccap, packed=pack_transfer)

    def stage_chunk(ci, buf):
        for b in range(B):
            part = rows[b][ci * chunk : (ci + 1) * chunk]
            buf[b, : part.shape[0]] = part
            if part.shape[0] < chunk:
                buf[b, part.shape[0] :] = XCODE_PAD
        ll = np.clip(lengths - ci * chunk, 0, chunk).astype(np.int32)
        return jnp.asarray(ll)

    def chunk_input(ci):
        buf = np.full((B, chunk), XCODE_PAD, dtype=np.uint8)
        ll = stage_chunk(ci, buf)
        src = _pack_nibbles(buf) if pack_transfer else buf
        return jnp.asarray(src), ll

    # Phase A — dispatch EVERY chunk asynchronously: the tiny carry chains
    # on-device from step to step and no host round-trip happens inside
    # the loop.  Overflow checks are deferred: the carry is computed from
    # the kept STREAM (exact even when the minimizer capacity overflows),
    # so failed chunks can be re-run afterwards from their saved carry-in
    # without disturbing the chain.
    q: "_queue.Queue" = _queue.Queue(maxsize=2)
    stop = threading.Event()

    def producer():
        bufs = [
            np.empty((B, chunk), dtype=np.uint8) for _ in range(3)
        ]
        try:
            for ci in range(nchunks):
                if stop.is_set():
                    return
                buf = bufs[ci % 3]
                ll = stage_chunk(ci, buf)
                # device_put always receives a PRIVATE array (the packed
                # copy, or an explicit .copy() on the unpacked path): on
                # the CPU backend device_put can alias the numpy buffer
                # zero-copy — never hand it a buffer that will be restaged.
                src = _pack_nibbles(buf) if pack_transfer else buf.copy()
                dev = jax.device_put(src)
                dev.block_until_ready()
                q.put((dev, ll))
        except BaseException as e:  # pragma: no cover — surfaced below
            q.put(e)

    prod = threading.Thread(target=producer, daemon=True)
    prod.start()
    per_chunk = []
    try:
        for ci in range(nchunks):
            item = q.get()
            if isinstance(item, BaseException):  # pragma: no cover
                raise item
            buf_d, length_local = item
            carry_in = carry
            cols, carry, cacc = step(
                buf_d, length_local, limit, carry, cacc, jnp.int32(ci)
            )
            per_chunk.append([cols, carry_in])
    finally:
        stop.set()
    prod.join()

    # Phase B — one sync: fetch the accumulated per-chunk counters.
    counts_host = np.asarray(jax.device_get(cacc))  # [ccap, B, 2]
    nm = counts_host[:nchunks, :, 0].copy()
    nr = counts_host[:nchunks, :, 1]

    # Phase C — rescue chunks whose minimizer stream overflowed m_cap, with
    # M raised to the exact known requirement.  ONE rescue executable
    # serves every failed chunk.
    bad = np.flatnonzero((nm < nr).any(axis=1))
    if bad.size:
        r_cap = m_cap
        while r_cap < int(nr.max()):
            r_cap *= 2
        rstep = _chunk_step(spec, r_cap, ccap, packed=pack_transfer)
        rcacc = jnp.zeros((ccap, B, 2), dtype=I32)
        for ci in bad:
            buf_d, length_local = chunk_input(int(ci))
            cols, _, rcacc = rstep(
                buf_d, length_local, limit, per_chunk[ci][1], rcacc,
                jnp.int32(int(ci)),
            )
            per_chunk[ci][0] = cols
        rch = np.asarray(jax.device_get(rcacc))
        for ci in bad:
            if (rch[ci, :, 0] < rch[ci, :, 1]).any():  # pragma: no cover
                raise RuntimeError(
                    f"chunk {ci} overflow not resolved "
                    f"({rch[ci, :, 0]} < {rch[ci, :, 1]})"
                )
            nm[ci] = rch[ci, :, 0]

    # Phase D — ONE batched fetch of every chunk's survivor arrays (plain
    # D2H copies; prefix slicing happens on the host).
    fetched = jax.device_get([c[0] for c in per_chunk])
    out = []
    for b in range(B):
        starts, ends, hashes = [], [], []
        for ci, (mst, men, mhs) in enumerate(fetched):
            off = ci * chunk
            k_ = int(nm[ci, b])
            starts.append(np.asarray(mst[b, :k_], dtype=np.int64) + off)
            ends.append(np.asarray(men[b, :k_], dtype=np.int64) + off)
            if wide:  # (hi, lo) uint32 pair -> uint64
                hi = mhs[0][b, :k_].astype(np.uint64)
                lo = mhs[1][b, :k_].astype(np.uint64)
                hashes.append((hi << np.uint64(32)) | lo)
            else:
                hashes.append(mhs[0][b, :k_].astype(hdt))
        out.append(
            (
                np.concatenate(starts),
                np.concatenate(ends),
                np.concatenate(hashes),
            )
        )
    return out


def minimizer_stream_long(
    codes: np.ndarray,  # uint8[n] xcodes of ONE sequence
    spec: PipelineSpec,
    chunk: int = DEFAULT_CHUNK,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (start, end, hash) numpy arrays of the full ordered minimizer
    stream of one long sequence (positions in original space, global)."""
    return minimizer_stream_long_batch([codes], spec, chunk=chunk)[0]


def _tile_rows(arr: np.ndarray, R: int, stride: int, tile: int) -> np.ndarray:
    """[M] -> contiguous [R, tile] with rows overlapping by tile - stride
    elements (row r = arr[r*stride : r*stride + tile], zero-padded), via a
    zero-copy strided view + one bulk copy — no per-row Python loop."""
    need = (R - 1) * stride + tile
    if arr.shape[0] < need:
        arr = np.concatenate(
            [arr, np.zeros(need - arr.shape[0], dtype=arr.dtype)]
        )
    it = arr.itemsize
    view = np.lib.stride_tricks.as_strided(
        arr, shape=(R, tile), strides=(stride * it, it), writeable=False
    )
    return np.ascontiguousarray(view)


_assemble_mixed_jit = jax.jit(assemble_kminmers_mixed, static_argnums=1)
_mix16_jit = jax.jit(mix64_murmur_from_u16)
_mix32_jit = jax.jit(mix64_from_u32)


def assemble_stream(
    min_hash: np.ndarray,  # uint16/32/64[M] minimizer hashes, in order
    k: int,
    tile: int = 8192,
) -> Tuple[np.ndarray, np.ndarray]:
    """K-min-mer assembly over an arbitrarily long minimizer stream:
    -> (hash uint64[M-k+1], rev bool[M-k+1]).

    The stream is tiled into [R, tile] rows overlapping by k-1 elements so
    one fixed-shape assembly program serves any M; row r's first tile-k+1
    windows are the stream's windows r*(tile-k+1)..  The window hash
    depends only on each element's offset WITHIN its window, so in-row
    indices give the same values as global stream indices.

    Per-width MixHash (src/lib.rs:137-177): u16 murmur finalizer, u32
    xorshift, u64 identity."""
    M = int(min_hash.shape[0])
    nwin = M - k + 1
    if nwin <= 0:
        return np.zeros(0, dtype=np.uint64), np.zeros(0, dtype=bool)
    stride = tile - (k - 1)
    R = -(-nwin // stride)
    if min_hash.dtype == np.uint64:
        tiled = _tile_rows(min_hash, R, stride, tile)
        mixed = (
            jnp.asarray((tiled >> np.uint64(32)).astype(np.uint32)),
            jnp.asarray((tiled & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
        )
    elif min_hash.dtype == np.uint16:
        rows16 = _tile_rows(min_hash, R, stride, tile).astype(np.uint32)
        mixed = _mix16_jit(jnp.asarray(rows16))
    else:
        rows = _tile_rows(min_hash.astype(np.uint32, copy=False), R, stride, tile)
        mixed = _mix32_jit(jnp.asarray(rows))
    (hi, lo), rev = _assemble_mixed_jit(mixed, k)
    hi = np.asarray(hi)[:, :stride].reshape(-1)[:nwin]
    lo = np.asarray(lo)[:, :stride].reshape(-1)[:nwin]
    rev = np.asarray(rev)[:, :stride].reshape(-1)[:nwin]
    return (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64), rev


def _xcodes(seq, mode: str) -> np.ndarray:
    if isinstance(seq, np.ndarray) and np.issubdtype(seq.dtype, np.integer):
        return seq.astype(np.uint8, copy=False)
    return encode_xcodes(seq, family_of_mode(mode))


def kminmers_long(
    seq,
    l: int,
    k: int,
    density: float,
    mode: str = "regular",
    variant: str = "nthash1",
    chunk: int = DEFAULT_CHUNK,
    hash_width: int = 32,
) -> dict:
    """All k-min-mers of ONE long sequence as a struct-of-arrays dict
    {hash uint64, start, end, offset int64, rev bool}[n_kminmers] —
    the chunked equivalent of KminmersIterator for sequences of any length
    (reference semantics per mode as in ops/scan.py; src/lib.rs:89-131).
    Supports every hash width the batch pipeline does (16/32/64; SIMD
    modes are u32-only, validated by PipelineSpec)."""
    return kminmers_long_batch(
        [seq], l, k, density, mode=mode, variant=variant, chunk=chunk,
        hash_width=hash_width,
    )[0]


def _records_from_stream(start, end, mhash, k):
    nk = max(int(mhash.shape[0]) - (k - 1), 0)
    if nk == 0:
        return {
            "hash": np.zeros(0, np.uint64),
            "start": np.zeros(0, np.int64),
            "end": np.zeros(0, np.int64),
            "offset": np.zeros(0, np.int64),
            "rev": np.zeros(0, bool),
        }
    kh, rev = assemble_stream(mhash, k)
    return {
        "hash": kh,
        "start": start[:nk],
        "end": end[k - 1 :],
        "offset": np.arange(nk, dtype=np.int64),
        "rev": rev,
    }


def kminmers_long_batch(
    seqs,
    l: int,
    k: int,
    density: float,
    mode: str = "regular",
    variant: str = "nthash1",
    chunk: int = DEFAULT_CHUNK,
    hash_width: int = 32,
) -> list:
    """kminmers_long over MANY long reads at once: all reads ride the same
    [B, chunk] steps (one executable, [B]-shaped carry), amortizing
    per-step overhead across rows (the reference's analogue is one thread
    per record, src/main.rs:65-76).  Returns one struct-of-arrays dict per
    read, each bit-identical to its kminmers_long run."""
    spec = PipelineSpec(
        l=l, k=k, density=density, mode=mode, variant=variant,
        hash_width=hash_width,
    )
    rows = [_xcodes(seq, mode) for seq in seqs]
    streams = minimizer_stream_long_batch(rows, spec, chunk=chunk)
    return [_records_from_stream(st, en, mh, k) for st, en, mh in streams]
