"""enable_compilation_cache: JAX_COMPILATION_CACHE_DIR wins when set;
otherwise the fixed <repo>/.jax_cache. The jax config is replaced by a
recorder so the test leaves the process's real cache settings alone."""

import os
import types

import pytest

from unidom_tpu.utils import cache


@pytest.fixture
def recorder(monkeypatch):
    updates = {}
    fake = types.SimpleNamespace(config=types.SimpleNamespace(
        update=lambda k, v: updates.__setitem__(k, v)))
    monkeypatch.setattr(cache, "jax", fake)
    return updates


def test_env_var_wins(recorder, monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    monkeypatch.setattr(cache, "DEFAULT_DIR", str(tmp_path / "default"))
    assert cache.enable_compilation_cache() == str(tmp_path / "env")
    assert "jax_compilation_cache_dir" not in recorder  # JAX reads the variable
    assert not (tmp_path / "default").exists()
    assert recorder["jax_persistent_cache_min_compile_time_secs"] == 0
    assert recorder["jax_persistent_cache_min_entry_size_bytes"] == 0


def test_default_is_fixed_repo_dir(recorder, monkeypatch, tmp_path):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert cache.DEFAULT_DIR == os.path.join(repo, ".jax_cache")
    monkeypatch.setattr(cache, "DEFAULT_DIR", str(tmp_path / "default"))
    assert cache.enable_compilation_cache() == str(tmp_path / "default")
    assert recorder["jax_compilation_cache_dir"] == str(tmp_path / "default")
    assert (tmp_path / "default").is_dir()
    assert recorder["jax_persistent_cache_min_compile_time_secs"] == 0
