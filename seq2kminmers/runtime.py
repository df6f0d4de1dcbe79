"""Runtime configuration shared by the entry points (CLI, benchmarks,
chip_smoke.py)."""

from __future__ import annotations

import os
from pathlib import Path

# A fixed path: the cache directory is part of the cache key, so a
# directory that moves between runs never hits.
DEFAULT_CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache so repeated runs skip
    the first compile of each pipeline shape.  Where
    JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing is
    set here; otherwise the cache lives in .jax_cache/ at the repository
    root.  Returns the cache directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    DEFAULT_CACHE_DIR.mkdir(exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return str(DEFAULT_CACHE_DIR)


def require_gpu():
    """The first JAX device, or SystemExit when it is not a GPU: device
    measurements never fall back to the CPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX found {dev.platform} ({dev})")
    return dev


def card_description() -> str:
    """The card's name and power limit as nvidia-smi reports them, to be
    printed beside every device number."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()
