"""Where JAX keeps its persistent compilation cache.

``JAX_COMPILATION_CACHE_DIR``, when set, is honoured as it is (JAX reads
the variable itself) and no other directory is set. Otherwise the cache
goes to ``.jax_cache/`` at the root of the checkout, a fixed path that
every entry point of one checkout shares. The entry points that compile (the CLI, ``bench.py``, ``chip_smoke.py``,
the test suite) call :func:`use_compile_cache` once at start-up.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

CHECKOUT_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def use_compile_cache() -> str:
    """Resolve the cache directory and hand it to JAX -> the directory."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    path = str(CHECKOUT_CACHE)
    if "jax" in sys.modules:  # already imported: its config read the env
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    else:
        os.environ["JAX_COMPILATION_CACHE_DIR"] = path
    return path
