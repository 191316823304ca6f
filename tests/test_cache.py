"""Placement of the persistent compilation cache (utils/cache.py):
JAX_COMPILATION_CACHE_DIR when set, else a fixed path in the checkout."""

import os

import jax
import pytest

import pyfft_tpu.utils.cache as cachemod
from pyfft_tpu import Plan


@pytest.fixture
def fresh_cache(monkeypatch):
    """Undo the conftest opt-out and restore the process's cache config."""
    monkeypatch.delenv("PYFFT_TPU_NO_CACHE", raising=False)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(cachemod, "_enabled", False)
    before = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", None)
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_cache_follows_env_var(fresh_cache, monkeypatch, tmp_path):
    path = str(tmp_path / "jc")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", path)
    Plan((64,))                                # the first Plan enables it
    assert cachemod._enabled
    assert jax.config.jax_compilation_cache_dir == path
    assert os.path.isdir(path)
    # an explicit path loses to the variable
    monkeypatch.setattr(cachemod, "_enabled", False)
    assert cachemod.enable_compile_cache(str(tmp_path / "other")) == path


def test_cache_default_is_fixed_path_in_checkout(fresh_cache, monkeypatch):
    made = []
    monkeypatch.setattr(cachemod.os, "makedirs",
                        lambda p, exist_ok=False: made.append(p))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert cachemod.DEFAULT_DIR == os.path.join(root, ".jax_cache")
    assert cachemod.enable_compile_cache() == cachemod.DEFAULT_DIR
    assert jax.config.jax_compilation_cache_dir == cachemod.DEFAULT_DIR
    assert made == [cachemod.DEFAULT_DIR]
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_cache_opt_out(fresh_cache, monkeypatch):
    monkeypatch.setenv("PYFFT_TPU_NO_CACHE", "1")
    assert cachemod.enable_compile_cache() is None
    assert jax.config.jax_compilation_cache_dir is None
