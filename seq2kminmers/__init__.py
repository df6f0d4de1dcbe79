"""seq2kminmers — an accelerator sequence-sketching engine.

A from-scratch JAX/XLA re-design of the capabilities of the Rust
crate rust-seq2kminmers (the sketching front-end of rust-mdbg): DNA reads ->
ordered streams of k-min-mers (k-tuples of density-selected minimizer
hashes), with optional homopolymer compression and positions reported in
original sequence space.  Output is bit-identical to the reference crate.
"""

from .api import KminmersIterator, KSizeTooBig, kminmers_list
from .constants import encode_bases, hash_bound_u32, hash_bound_simd_u32
from .hpc_strings import encode_rle, encode_rle_simd, hpc
from .kminmer import (
    KminmerVec,
    fxhash32_of_mers,
    fxhash64_of_mers,
    kminmer_hash_from_mers,
    kminmers_vec,
)
from .oracle import HashMode, KminmerRecord, nthash1_minimizer_space
from .ops.long_read import kminmers_long, kminmers_long_batch
from .ops.pipeline import KminmerBatch, PipelineSpec, kminmer_pipeline, make_pipeline

__version__ = "0.1.0"
