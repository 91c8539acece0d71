"""Where JAX keeps its persistent compilation cache for this program.

One rule for every entry point (the CLI, ``bench.py``, ``chip_smoke.py``):
when ``JAX_COMPILATION_CACHE_DIR`` is set, JAX uses that directory and no
other is set here; otherwise the cache lives in ``<repo>/.jax_cache`` (a
fixed path, so later runs from the same checkout hit it).
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"


def repo_cache_dir() -> str:
    """``<repo>/.jax_cache``, the repo being the directory above ``apm``."""
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.join(os.path.dirname(os.path.dirname(here)), ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory; returns
    it. Call before the first compilation."""
    import jax

    path = os.environ.get(ENV) or repo_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
