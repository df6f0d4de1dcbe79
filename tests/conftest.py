"""Test configuration: run JAX on a virtual 8-device CPU mesh unless
JAX_PLATFORMS says otherwise.

Multi-device sharding is validated on host CPU devices
(xla_force_host_platform_device_count).  The `gpu`-marked suite
(tests/test_gpu.py) runs on a card; its fixture skips it elsewhere:

    JAX_PLATFORMS=cuda python -m pytest tests/test_gpu.py -m gpu -q
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import sys
from pathlib import Path

import numpy as np
import pytest

REPO_ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO_ROOT))

FIXTURE = Path(__file__).parent / "data" / "ecoli.genome.100k.fa"


@pytest.fixture(scope="session")
def ecoli_seq() -> str:
    """The reference's golden fixture: E. coli NZ_CP027599.1, 99,925 bp,
    single record on line 2 of the file (reference tests/main.rs:15-16)."""
    return FIXTURE.read_text().split("\n")[1]


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0x5E12)
