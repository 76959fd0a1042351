"""The compile-cache helper: honour JAX_COMPILATION_CACHE_DIR, otherwise
use the fixed .jax_cache/ directory of the checkout."""
import os

import jax
import pytest

from minipic_tpu.compile_cache import CHECKOUT, enable_compile_cache


@pytest.fixture
def cache_config():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_variable_wins_and_nothing_is_set(monkeypatch, cache_config):
    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    assert enable_compile_cache() == "/elsewhere/cache"
    assert jax.config.jax_compilation_cache_dir is None


def test_default_is_fixed_path_in_checkout(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = enable_compile_cache()
    assert path == os.path.join(CHECKOUT, ".jax_cache")
    assert os.path.isfile(os.path.join(CHECKOUT, "minipic_tpu", "__init__.py"))
    assert jax.config.jax_compilation_cache_dir == path
    assert enable_compile_cache() == path  # stable across calls
