"""On-card validation suite (`-m gpu`): runs the XLA-compiled pipeline on
a GPU against the numpy oracle — the bridge between the CPU test run and
exactness on the card.  Without a card the fixture skips every test.

    JAX_PLATFORMS=cuda python -m pytest tests/test_gpu.py -m gpu -q

Covers the golden u32/u64 hash values (reference tests/main.rs:18-57), the
four modes, u16/u64 widths and nthash2 across chunk boundaries, the
chunked long-read driver, the stream runner, overflow rescue and the
sequence-sharded path on a one-device mesh.
"""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def gpu_device():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU card; JAX found {dev.platform}")
    return dev


def test_goldens_on_card(gpu_device, ecoli_seq):
    """The reference's golden k-min-mer hashes through the full jitted
    pipeline (reference tests/main.rs:41-57, u32 config)."""
    from seq2kminmers.api import kminmers_list

    kms = kminmers_list(ecoli_seq, 10, 5, 0.0001, "regular")
    assert [k.hash for k in kms[:3]] == [
        143479479014703,
        1415094313937202,
        7085699921625713,
    ]
    assert len(kms) == 15


@pytest.mark.parametrize("mode", ["regular", "simd", "hpc", "hpcsimd"])
def test_pipeline_on_card_matches_oracle(gpu_device, rng, mode):
    """All four modes record-exact vs the oracle on mixed-content (ACGTN +
    lowercase + garbage bytes) reads."""
    from seq2kminmers.api import kminmers_list
    from seq2kminmers.oracle import HashMode, kminmers

    alphabet = list("AACCGGTTAANNacgtQX")
    for trial in range(3):
        n = int(rng.integers(600, 3000))
        s = "".join(rng.choice(alphabet, size=n))
        got = kminmers_list(s, 13, 4, 0.05, HashMode(mode))
        ref = kminmers(s, 13, 4, 0.05, HashMode(mode))
        assert len(got) == len(ref), (mode, trial)
        for g, r in zip(got, ref):
            assert (g.hash, g.start, g.end, g.offset, g.rev) == (
                r.hash, r.start, r.end, r.offset, r.rev,
            ), (mode, trial)


def test_u64_width_on_card(gpu_device, ecoli_seq):
    """u64 golden config (reference tests/main.rs:18-39) on the card."""
    from seq2kminmers.api import kminmers_list
    from seq2kminmers.oracle import HashMode, kminmers

    kms = kminmers_list(ecoli_seq, 12, 5, 0.001, "regular", hash_width=64)
    ref = kminmers(ecoli_seq, 12, 5, 0.001, HashMode.Regular, hash_width=64)
    assert len(kms) > 0
    assert [k.hash for k in kms] == [r.hash for r in ref]


@pytest.mark.parametrize(
    "mode,variant,width",
    [
        ("regular", "nthash1", 32),
        ("simd", "nthash1", 32),
        ("hpc", "nthash1", 32),
        ("hpcsimd", "nthash1", 32),
        ("regular", "nthash2", 32),
        ("hpc", "nthash2", 32),
        ("regular", "nthash1", 64),
        ("hpc", "nthash1", 64),
        ("regular", "nthash1", 16),
        ("hpc", "nthash1", 16),
    ],
)
def test_chunk_boundary_stress_on_card(gpu_device, rng, mode, variant, width):
    """>=200 kb reads whose homopolymer runs deliberately SPAN the chunk
    boundaries of the carry-aware scan, in every mode and width."""
    from seq2kminmers.ops.long_read import kminmers_long
    from seq2kminmers.oracle import HashMode, kminmers

    chunk = 1 << 15
    n = 220_000
    b = rng.choice(list("ACGTN"), size=n)
    # plant runs straddling every chunk boundary (length 9-300, centered)
    for edge in range(chunk, n, chunk):
        ln = int(rng.integers(9, 300))
        lo = max(0, edge - ln // 2)
        b[lo : lo + ln] = b[lo]
    # plus scattered short runs so HPC does real work everywhere
    for i in rng.integers(0, n - 64, size=2000):
        b[i : i + int(rng.integers(2, 9))] = b[i]
    s = "".join(b)
    l = 45 if variant == "nthash2" else 31
    got = kminmers_long(
        s, l, 5, 0.01, mode=mode, variant=variant, chunk=chunk,
        hash_width=width,
    )
    ref = kminmers(s, l, 5, 0.01, HashMode(mode), hash_width=width,
                   variant=variant)
    assert len(got["hash"]) == len(ref) > 50, (mode, variant)
    for i, r in enumerate(ref):
        assert (
            int(got["hash"][i]), int(got["start"][i]),
            int(got["end"][i]), bool(got["rev"][i]),
        ) == (r.hash, r.start, r.end, r.rev), (mode, variant, i)


@pytest.mark.parametrize(
    "mode,width", [("regular", 32), ("hpcsimd", 32), ("hpc", 16)]
)
def test_long_read_chunked_on_card(gpu_device, rng, mode, width):
    """A 3 Mbp read split into 1 Mb chunks must be record-exact vs the
    oracle — the carry injection and the carry-out rebase on the card."""
    from seq2kminmers.ops.long_read import kminmers_long
    from seq2kminmers.oracle import HashMode, kminmers

    n = 3_000_000
    b = rng.choice(list("ACGT"), size=n)
    for i in rng.integers(0, n - 64, size=20000):
        b[i : i + int(rng.integers(2, 12))] = b[i]
    s = "".join(b)
    got = kminmers_long(s, 31, 5, 0.01, mode=mode, chunk=1 << 20,
                        hash_width=width)
    ref = kminmers(s, 31, 5, 0.01, HashMode(mode), hash_width=width)
    assert len(got["hash"]) == len(ref) > 3000
    for i, r in enumerate(ref):
        assert (
            int(got["hash"][i]),
            int(got["start"][i]),
            int(got["end"][i]),
            bool(got["rev"][i]),
        ) == (r.hash, r.start, r.end, r.rev), (mode, i)


def test_stream_on_card(gpu_device, tmp_path, rng):
    """Streaming runner end-to-end: bucketed mixed-length file, ordered
    stream vs oracle."""
    from seq2kminmers.io.stream import StreamingRunner
    from seq2kminmers.oracle import HashMode, kminmers
    from seq2kminmers.ops.pipeline import PipelineSpec

    seqs = [
        "".join(rng.choice(list("ACGT"), size=int(n)))
        for n in rng.integers(100, 2500, size=17)
    ]
    p = tmp_path / "mix.fa"
    p.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(seqs)))
    spec = PipelineSpec(l=11, k=3, density=0.05, mode="hpcsimd")
    with StreamingRunner(p, spec, target_cells=1 << 14) as r:
        st = r.run()
        got = r.collect()
    pos = 0
    for i, s in enumerate(seqs):
        for rec in kminmers(s, 11, 3, 0.05, HashMode.HpcSimd):
            assert got["read"][pos] == i
            assert got["hash"][pos] == np.uint64(rec.hash)
            pos += 1
    assert pos == st.total_kminmers


def test_overflow_rescue_on_card(gpu_device, rng):
    """density=0.9 overflows the estimated M; the retry must recover the
    full stream on the card."""
    from seq2kminmers.api import kminmers_list
    from seq2kminmers.oracle import HashMode, kminmers

    seq = "".join(rng.choice(list("ACGT"), size=3000))
    got = kminmers_list(seq, 7, 3, 0.9, HashMode.Regular)
    ref = kminmers(seq, 7, 3, 0.9, HashMode.Regular)
    assert len(got) == len(ref) > 2000
    assert [(g.hash, g.start) for g in got] == [(r.hash, r.start) for r in ref]


def test_long_read_batched_on_card(gpu_device, rng):
    """kminmers_long_batch: two long reads of different lengths riding the
    same [2, chunk] steps must be record-exact vs their per-read runs and
    the oracle."""
    from seq2kminmers.ops.long_read import kminmers_long, kminmers_long_batch
    from seq2kminmers.oracle import HashMode, kminmers

    seqs = []
    for n in (2_500_000, 1_400_000):
        b = rng.choice(list("ACGT"), size=n)
        for i in rng.integers(0, n - 64, size=n // 150):
            b[i : i + int(rng.integers(2, 12))] = b[i]
        seqs.append("".join(b))
    batch = kminmers_long_batch(
        seqs, 31, 5, 0.01, mode="hpcsimd", chunk=1 << 20
    )
    for s, got in zip(seqs, batch):
        one = kminmers_long(s, 31, 5, 0.01, mode="hpcsimd", chunk=1 << 20)
        for key in ("hash", "start", "end", "offset", "rev"):
            assert np.array_equal(got[key], one[key]), key
        ref = kminmers(s, 31, 5, 0.01, HashMode("hpcsimd"))
        assert len(got["hash"]) == len(ref) > 1000
        for i in (0, len(ref) // 2, len(ref) - 1):
            r = ref[i]
            assert (
                int(got["hash"][i]), int(got["start"][i]),
                int(got["end"][i]), bool(got["rev"][i]),
            ) == (r.hash, r.start, r.end, r.rev), i


def test_seqshard_halo_on_card(gpu_device, rng):
    """The seq-sharded path (O(k) minimizer halo, sharded-segment outputs)
    on a 1x1 device mesh: stitched output record-exact vs the oracle."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from seq2kminmers.constants import XCODE_PAD, encode_xcodes
    from seq2kminmers.oracle import HashMode, kminmers
    from seq2kminmers.ops.pipeline import PipelineSpec
    from seq2kminmers.parallel.seqshard import (
        make_seq_pipeline,
        stitch_segments,
    )

    mesh = Mesh(
        np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "seq")
    )
    B, L = 2, 64 * 1024
    codes = np.full((B, L), XCODE_PAD, dtype=np.uint8)
    lengths = np.zeros(B, dtype=np.int32)
    seqs = []
    for b in range(B):
        n = int(rng.integers(L // 2, L - 1))
        arr = rng.choice(list("ACGTN"), size=n)
        for i in rng.integers(0, n - 40, size=n // 80):
            arr[i : i + int(rng.integers(2, 9))] = arr[i]
        s = "".join(arr)
        seqs.append(s)
        codes[b, :n] = encode_xcodes(s, "scalar")
        lengths[b] = n
    spec = PipelineSpec(l=13, k=3, density=0.02, mode="hpc")
    fn = make_seq_pipeline(spec, mesh)
    with mesh:
        out = stitch_segments(fn(jnp.asarray(codes), jnp.asarray(lengths)))
    for b, s in enumerate(seqs):
        ref = kminmers(s, 13, 3, 0.02, HashMode("hpc"))
        nk = int(out.n_kminmers[b])
        assert nk == len(ref) > 100, (b, nk, len(ref))
        hh = np.asarray(out.hash_hi[b, :nk]).astype(np.uint64)
        hl = np.asarray(out.hash_lo[b, :nk]).astype(np.uint64)
        got_h = (hh << np.uint64(32)) | hl
        for i, r in enumerate(ref):
            assert int(got_h[i]) == r.hash, (b, i)
            assert int(out.start[b, i]) == r.start, (b, i)
            assert int(out.end[b, i]) == r.end, (b, i)
            assert bool(out.rev[b, i]) == r.rev, (b, i)
