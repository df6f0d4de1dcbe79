"""FASTA/FASTQ reader + packer tests: native C++ path vs the pure-Python
fallback, both output formats (exact uint8 xcodes with raw-byte-diff keep
bits, and legacy plain codes), multiline records, batching, and clipping.

The native reader replaces the reference's rust-parallelfastx dependency
(reference src/main.rs:5,79)."""

import numpy as np
import pytest

from seq2kminmers.constants import (
    BYTE_TO_CODE,
    CODE_PAD,
    XCODE_PAD,
    encode_xcodes,
)
from seq2kminmers.io.fasta import FastaFile

FASTA = """>r1 first record
ACGTACGTNNACGT
>r2 multiline
ACGTAC
GTTTTT
ACG
>r3
A
"""

FASTQ = """@q1 desc
ACGTTTACG
+
IIIIIIIII
@q2
NNACGT
+
!!!!!!
"""

RECS_FA = [
    ("r1 first record", "ACGTACGTNNACGT"),
    ("r2 multiline", "ACGTACGTTTTTACG"),
    ("r3", "A"),
]
RECS_FQ = [("q1 desc", "ACGTTTACG"), ("q2", "NNACGT")]


@pytest.fixture(params=[True, False], ids=["native", "python"])
def native(request):
    return request.param


@pytest.mark.parametrize(
    "text,recs", [(FASTA, RECS_FA), (FASTQ, RECS_FQ)], ids=["fasta", "fastq"]
)
def test_index_and_pack(tmp_path, native, text, recs):
    p = tmp_path / "in.txt"
    p.write_text(text)
    with FastaFile(p, prefer_native=native) as f:
        assert f.native == native
        assert len(f) == len(recs)
        assert f.max_seq_len() == max(len(s) for _, s in recs)
        for i, (name, seq) in enumerate(recs):
            assert f.name(i) == name
            assert f.seq_len(i) == len(seq)
        # exact xcode format (default, scalar family)
        codes, lengths = f.pack(family="scalar")
        assert codes.dtype == np.uint8
        for i, (_, seq) in enumerate(recs):
            n = lengths[i]
            assert n == len(seq)
            exp = encode_xcodes(seq, "scalar")
            np.testing.assert_array_equal(codes[i, :n], exp)
            assert (codes[i, n:] == XCODE_PAD).all()
        # legacy uint8 format
        c8, l8 = f.pack(family=None)
        assert c8.dtype == np.uint8
        for i, (_, seq) in enumerate(recs):
            exp = BYTE_TO_CODE[np.frombuffer(seq.encode(), np.uint8)]
            np.testing.assert_array_equal(c8[i, : l8[i]], exp)
            assert (c8[i, l8[i]:] == CODE_PAD).all()


def test_batches_and_clip(tmp_path, native):
    p = tmp_path / "many.fa"
    rng = np.random.default_rng(3)
    seqs = [
        "".join(rng.choice(list("ACGT"), size=int(n)))
        for n in rng.integers(5, 60, size=7)
    ]
    p.write_text("".join(f">s{i}\n{s}\n" for i, s in enumerate(seqs)))
    with FastaFile(p, prefer_native=native) as f:
        assert f.native == native
        got = []
        for codes, lengths, first in f.batches(3, max_len=32):
            assert codes.shape[1] == 32
            got.extend(
                (first + i, int(lengths[i])) for i in range(len(lengths))
            )
        assert [g[0] for g in got] == list(range(7))
        assert [g[1] for g in got] == [min(len(s), 32) for s in seqs]


def test_simd_family_table(tmp_path, native):
    p = tmp_path / "low.fa"
    p.write_text(">x\nacgtQXN\n")
    with FastaFile(p, prefer_native=native) as f:
        codes, _ = f.pack(family="simd")
        # simd family case-folds and maps non-base nibbles to N's code
        assert [int(c) & 7 for c in codes[0, :7]] == [0, 1, 2, 3, 0, 4, 4]
        # raw-byte-diff keep bits (all 7 bytes are distinct from their
        # predecessor, so every position keeps)
        assert [(int(c) >> 3) & 1 for c in codes[0, :7]] == [1] * 7
