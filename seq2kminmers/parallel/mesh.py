"""Device-mesh construction for the sharded sketching pipeline.

The reference's entire parallelism story is thread-level data parallelism
over reads (src/main.rs:57,79 via rust-parallelfastx — no inter-thread
communication).  Here it becomes a `data` mesh axis over devices, plus an
optional `seq` axis that splits long reads along the sequence dimension
(parallel/seqshard.py).  Every device reaches every other at the same
rate, so the mesh shape follows the algorithm alone.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    n_data: Optional[int] = None,
    n_seq: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    if n_data is None:
        n_data = len(devices) // n_seq
    n = n_data * n_seq
    if n > len(devices):
        raise ValueError(
            f"mesh {n_data}x{n_seq} needs {n} devices, have {len(devices)}"
        )
    arr = np.asarray(devices[:n]).reshape(n_data, n_seq)
    return Mesh(arr, axis_names=("data", "seq"))


def batch_sharding(mesh: Mesh, seq_sharded: bool = False) -> NamedSharding:
    """Sharding for codes[B, L]: always split B over 'data'; optionally split
    L over 'seq' (sequence parallelism for long reads)."""
    return NamedSharding(mesh, P("data", "seq" if seq_sharded else None))


def row_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for per-read vectors like lengths[B]."""
    return NamedSharding(mesh, P("data"))
