"""Persistent XLA compilation cache (pay each compile once per checkout).

The reference pays zero compile time (SciPy's spsolve is pre-built,
ref src/hydromodel/preissmann.py:146); a JAX process compiles every solver
program on first use.  JAX's persistent compilation cache stores each
compiled executable (keyed on the lowered HLO, compile options, backend and
jax version) on disk, so a later process that compiles the same program
loads it instead.

Where the cache lives:

* ``$JAX_COMPILATION_CACHE_DIR`` when it is set — JAX reads that variable
  itself, and nothing here overrides it;
* otherwise ``<checkout>/.jax_cache`` (listed in ``.gitignore``).  The path
  is fixed on purpose: it is part of what a later process must find again.

Usage (bench.py and chip_smoke.py call this)::

    from flowsim_tpu.utils import compile_cache
    compile_cache.enable()

The directory is safe to delete at any time.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def cache_dir() -> str:
    """The directory :func:`enable` uses (see the module docstring)."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable(min_compile_time_secs: float = 0.5) -> str:
    """Turn on the persistent compilation cache; returns the directory.

    ``min_compile_time_secs`` skips caching trivial executables (they
    recompile faster than they deserialize).  Safe to call more than once
    and before or after backend init.
    """
    import jax

    path = cache_dir()
    if not os.environ.get(ENV_VAR):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      float(min_compile_time_secs))
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    # also persist XLA-internal caches (GPU autotuning results and the like)
    jax.config.update("jax_persistent_cache_enable_xla_caches", "all")
    return path


def disable() -> None:
    import jax

    jax.config.update("jax_compilation_cache_dir", None)
