"""Where the persistent compilation cache lives (fem_tpu/utils/cache.py)."""

import os

import jax

from fem_tpu.utils import cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_dir_is_the_variable_when_set(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    before = jax.config.jax_compilation_cache_dir
    try:
        assert cache.enable_compile_cache() == str(tmp_path / "c")
        assert jax.config.jax_compilation_cache_dir == str(tmp_path / "c")
        assert (tmp_path / "c").is_dir()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_cache_dir_defaults_to_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert cache.compile_cache_dir() == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
