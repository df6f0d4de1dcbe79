"""HPC correctness tests (reference tests/main.rs:76-78 plus the device
compaction path)."""

import numpy as np
import pytest

from seq2kminmers.constants import (
    CODE_PAD,
    XCODE_PAD,
    encode_bases,
    encode_xcodes,
)
from seq2kminmers.hpc_strings import encode_rle, encode_rle_simd, hpc


def test_hpc_triple_equivalence_on_fixture(ecoli_seq):
    """encode_rle == hpc == encode_rle_simd, strings and positions
    (reference tests/main.rs:76-78)."""
    s, p = encode_rle(ecoli_seq)
    assert s == hpc(ecoli_seq)
    s2, p2 = encode_rle_simd(ecoli_seq)
    assert s == s2
    np.testing.assert_array_equal(p, p2.astype(np.int64))


def test_hpc_basics():
    assert hpc("AACTGGG") == "ACTG"
    assert hpc("") == ""
    assert hpc("AAAA") == "A"
    s, p = encode_rle("AACCTT")
    assert s == "ACT" and list(p) == [0, 2, 4]


def test_encode_rle_non_acgtn_not_collapsed():
    """encode_rle only collapses runs of "ACTGactgNn" (src/hpc.rs:14);
    other repeated characters are kept verbatim."""
    s, p = encode_rle("AXXA")
    assert s == "AXXA" and list(p) == [0, 1, 2, 3]
    # but hpc() and the simd variant collapse any run (src/hpc.rs:28-41,88)
    assert hpc("AXXA") == "AXA"
    s2, p2 = encode_rle_simd("AXXA")
    assert s2 == "AXA" and list(p2) == [0, 1, 3]


def test_device_hpc_compaction_matches_host(ecoli_seq, rng):
    import jax.numpy as jnp

    from seq2kminmers.ops.hpc import hpc_compress

    for seq in [ecoli_seq[:5000], "AACCTTGG", "A", "AAAAAA"]:
        codes = encode_xcodes(seq, "simd")
        n = len(codes)
        L = 8192
        padded = np.full((1, L), XCODE_PAD, dtype=np.uint8)
        padded[0, :n] = codes
        hcodes, pos, hlen = hpc_compress(
            jnp.asarray(padded), jnp.asarray(np.array([n], np.int32))
        )
        m = int(hlen[0])
        want_s, want_p = encode_rle_simd(seq)
        got = np.asarray(hcodes[0, :m]) & 7
        assert m == len(want_s)
        np.testing.assert_array_equal(got, encode_bases(want_s))
        np.testing.assert_array_equal(
            np.asarray(pos[0, :m]), np.asarray(want_p, dtype=np.int32)
        )
        # padding beyond hpc_len
        assert np.all(np.asarray(hcodes[0, m:]) == CODE_PAD)


@pytest.mark.parametrize("N,M", [(512, 64), (64, 512)])
def test_compaction_fills_beyond_count(rng, N, M):
    """Slots past the selected count hold the fill, including capacities
    larger than the input row."""
    import jax.numpy as jnp

    from seq2kminmers.ops.compact import compact

    B = 4
    mask = rng.random((B, N)) < 0.05
    vals = rng.integers(0, 2**31, size=(B, N)).astype(np.int32)
    (out,), count = compact(
        jnp.asarray(mask), [jnp.asarray(vals)], M, [np.int32(-1)]
    )
    out = np.asarray(out)
    count = np.asarray(count)
    for b in range(B):
        want = vals[b][mask[b]][:M]
        assert count[b] == mask[b].sum()
        np.testing.assert_array_equal(out[b, : len(want)], want)
        assert np.all(out[b, len(want):] == -1)


def test_native_rle_loop_bench_entry():
    """Smoke the criterion-style in-native steady loop (s2kext.rle_loop):
    returns (iters, ns) with the requested minimum duration honored, for
    every (collapse_any, wide, want_pos) combination the bench suite uses,
    plus the empty-input edge."""
    from seq2kminmers.io.native_ext import load_ext

    ext = load_ext()
    if ext is None or not hasattr(ext, "rle_loop"):
        pytest.skip("native extension unavailable")
    data = ("ACGTT" * 400).encode()
    for collapse_any, wide, want_pos in [(1, 0, 0), (0, 1, 1), (1, 0, 1)]:
        iters, ns = ext.rle_loop(data, collapse_any, wide, want_pos, 5)
        assert iters >= 1
        assert ns >= 5_000_000
    assert ext.rle_loop(b"", 1, 0, 1, 5) == (0, 0)
