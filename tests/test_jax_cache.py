"""Compile-cache placement: JAX_COMPILATION_CACHE_DIR wins and is left
to JAX; otherwise the cache is <repo>/.jax_cache."""
import os

import jax

from rslo_tpu.utils import jax_cache


def _record(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    return calls


def test_env_var_is_honoured(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = _record(monkeypatch)
    jax_cache.enable()
    assert jax_cache.cache_dir() == str(tmp_path)
    assert not any(name == "jax_compilation_cache_dir"
                   for name, _ in calls)


def test_default_is_repo_local(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = _record(monkeypatch)
    jax_cache.enable()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    expected = os.path.join(repo, ".jax_cache")
    assert jax_cache.cache_dir() == expected
    assert ("jax_compilation_cache_dir", expected) in calls
