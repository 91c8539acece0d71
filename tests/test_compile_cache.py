"""The compile-cache rule shared by the CLI, bench.py and chip_smoke.py."""

import os

import jax
import pytest

from apm.utils.compile_cache import ENV, enable_compile_cache, repo_cache_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("env_set", [True, False])
def test_cache_dir_rule(monkeypatch, tmp_path, restore_cache_dir, env_set):
    """``JAX_COMPILATION_CACHE_DIR`` wins when set; otherwise the cache
    lives in ``<repo>/.jax_cache`` (listed in .gitignore)."""
    if env_set:
        monkeypatch.setenv(ENV, str(tmp_path))
        want = str(tmp_path)
    else:
        monkeypatch.delenv(ENV, raising=False)
        want = os.path.join(REPO, ".jax_cache")
        assert repo_cache_dir() == want
        with open(os.path.join(REPO, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()
    assert enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want
