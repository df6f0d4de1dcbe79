"""The compile-cache helper (seq2kminmers/runtime.py): JAX_COMPILATION_CACHE_DIR
wins and is left to JAX; otherwise the cache sits at a fixed path in the
checkout."""

import jax

from seq2kminmers import runtime


def test_env_cache_dir_is_left_to_jax(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.enable_compile_cache() == str(tmp_path)
    assert calls == []


def test_default_cache_dir_is_in_the_checkout(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = runtime.enable_compile_cache()
    root = runtime.Path(runtime.__file__).resolve().parent.parent
    assert path == str(root / ".jax_cache")
    assert ("jax_compilation_cache_dir", path) in calls
