"""Streaming runner correctness: length-bucketed, pipelined batches must
yield the identical globally ordered k-min-mer stream as the sequential
oracle (the reference's per-record iterator order, reference
src/lib.rs:258-259, driven by the thread-pool main src/main.rs:65-79)."""

import numpy as np
import pytest

from seq2kminmers.io.stream import plan_buckets, stream_file
from seq2kminmers.io.stream import StreamingRunner
from seq2kminmers.ops.pipeline import PipelineSpec
from seq2kminmers.oracle import HashMode, kminmers


def _write_fasta(path, seqs):
    path.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(seqs)))


@pytest.fixture(scope="module")
def mixed_file(tmp_path_factory):
    """Deliberately mixed-length: three distinct buckets (1k / 2k / 4k)."""
    rng = np.random.default_rng(7)
    seqs = []
    for i in range(41):
        n = int(rng.choice([60, 400, 1100, 1900, 2500, 3900]))
        seqs.append("".join(rng.choice(list("ACGTN"), size=n,
                                       p=[0.24, 0.24, 0.24, 0.24, 0.04])))
    p = tmp_path_factory.mktemp("stream") / "mixed.fa"
    _write_fasta(p, seqs)
    return p, seqs


def test_plan_buckets_shapes():
    lens = np.array([10, 1024, 1025, 5000, 70000])
    plan = plan_buckets(lens, target_cells=1 << 16)
    pads = [p for p, _, _ in plan]
    assert pads == [1024, 2048, 8192, 131072]
    for pad, rows, idx in plan:
        assert rows % 8 == 0 and rows >= 8
        assert (np.asarray(lens)[idx] <= pad).all()
    # constant-cells scaling: bigger pads get fewer rows
    rows_by_pad = {p: r for p, r, _ in plan}
    assert rows_by_pad[1024] >= rows_by_pad[8192] >= rows_by_pad[131072]
    # every record lands in exactly one bucket
    all_idx = np.concatenate([idx for _, _, idx in plan])
    assert sorted(all_idx.tolist()) == list(range(len(lens)))


@pytest.mark.parametrize("mode", ["regular", "hpcsimd"])
def test_stream_matches_oracle_order(mixed_file, tmp_path, mode):
    path, seqs = mixed_file
    spec = PipelineSpec(l=13, k=4, density=0.05, mode=mode)
    with StreamingRunner(path, spec, target_cells=1 << 14) as r:
        stats = r.run()
        got = r.collect()
    assert stats.num_records == len(seqs)
    assert stats.buckets >= 3  # the fixture really exercises bucketing
    assert stats.batches > stats.buckets  # and multi-batch buckets

    hm = HashMode.Regular if mode == "regular" else HashMode.HpcSimd
    p = 0
    for i, s in enumerate(seqs):
        for rec in kminmers(s, 13, 4, 0.05, hm):
            assert got["read"][p] == i
            assert got["hash"][p] == np.uint64(rec.hash)
            assert got["start"][p] == rec.start
            assert got["end"][p] == rec.end
            assert got["offset"][p] == rec.offset
            assert got["rev"][p] == rec.rev
            p += 1
    assert p == stats.total_kminmers == len(got["hash"])


def test_stream_file_writer(mixed_file, tmp_path):
    path, seqs = mixed_file
    spec = PipelineSpec(l=9, k=3, density=0.05, mode="simd")
    out = tmp_path / "stream.npz"
    stats = stream_file(path, spec, out=str(out), target_cells=1 << 14)
    z = np.load(out)
    assert len(z["hash"]) == stats.total_kminmers
    # ordered: read ids ascending, offsets 0..n-1 within each read
    reads = z["read"]
    assert (np.diff(reads) >= 0).all()
    offs = z["offset"]
    starts = np.nonzero(np.r_[True, np.diff(reads) > 0])[0]
    assert (offs[starts] == 0).all()


def test_stream_single_record(tmp_path):
    """Degenerate case: one read, one bucket, one batch (the CLI fixture)."""
    rng = np.random.default_rng(3)
    s = "".join(rng.choice(list("ACGT"), size=777))
    p = tmp_path / "one.fa"
    _write_fasta(p, [s])
    spec = PipelineSpec(l=11, k=3, density=0.1, mode="hpc")
    with StreamingRunner(p, spec) as r:
        st = r.run()
        got = r.collect()
    ref = kminmers(s, 11, 3, 0.1, HashMode.Hpc)
    assert st.total_kminmers == len(ref) == len(got["hash"])
    assert [int(h) for h in got["hash"]] == [r_.hash for r_ in ref]


def test_stream_overflow_retry_on_packed_batch(tmp_path):
    """A deliberately undersized minimizer capacity forces the _settle
    overflow retry while batches ride the nibble-packed transfer path:
    the rerun must unpack on-device and recover the exact oracle stream
    (losslessly, via the api recovery loop)."""
    rng = np.random.default_rng(11)
    seqs = ["".join(rng.choice(list("ACGT"), size=900)) for _ in range(5)]
    p = tmp_path / "dense.fa"
    _write_fasta(p, seqs)
    # density 0.2 over 900 bases ~ 180 minimizers; cap of 8 overflows
    spec = PipelineSpec(
        l=9, k=3, density=0.2, mode="regular", max_minimizers=8
    )
    with StreamingRunner(p, spec) as runner:
        runner.run()
        rec = runner.collect()
    for i, s in enumerate(seqs):
        ref = kminmers(s, 9, 3, 0.2, HashMode("regular"))
        ids = np.nonzero(rec["read"] == i)[0]
        assert len(ids) == len(ref) > 50, i
        for j, r in zip(ids, ref):
            assert int(rec["hash"][j]) == r.hash
            assert int(rec["start"][j]) == r.start
            assert int(rec["end"][j]) == r.end
