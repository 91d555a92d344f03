"""Persistent compilation cache (utils/compile_cache.py).

Two fresh subprocesses compile the same nontrivial program with the cache
enabled: the first must populate the on-disk directory, the second must
reuse it rather than growing the directory.  The location rules: the
``JAX_COMPILATION_CACHE_DIR`` directory when that variable is set (and no
other set in code), else the fixed ``<checkout>/.jax_cache``.
"""

import os
import subprocess
import sys
import tempfile

import jax
import pytest

from flowsim_tpu.utils import compile_cache

pytestmark = pytest.mark.fast

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_INNER = r"""
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
from flowsim_tpu.utils import compile_cache
print("DIR", compile_cache.enable(min_compile_time_secs=0.0))
print("CFG", jax.config.jax_compilation_cache_dir)
import jax.numpy as jnp

def body(c, _):
    x = c
    for i in range(4):
        x = jnp.tanh(x @ x.T @ x * 1e-3 + i)
    return x, jnp.sum(x)

f = jax.jit(lambda x: jax.lax.scan(body, x, None, length=3))
y = f(jnp.ones((32, 32)))
jax.block_until_ready(y)
print("OK")
"""


def _run(cache_dir):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_COMPILATION_CACHE_DIR=cache_dir)
    r = subprocess.run([sys.executable, "-c", _INNER], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "OK" in r.stdout
    return r.stdout


def test_cache_populated_and_reused():
    with tempfile.TemporaryDirectory() as d:
        cache = os.path.join(d, "xla")
        stdout = _run(cache)
        assert f"DIR {cache}" in stdout and f"CFG {cache}" in stdout
        entries = set(os.listdir(cache))
        assert entries, "first process wrote no cache entries"
        _run(cache)
        # second process must REUSE, not duplicate (same keys -> same files)
        assert set(os.listdir(cache)) == entries


def test_env_var_wins_and_nothing_else_is_set(monkeypatch):
    monkeypatch.setenv(compile_cache.ENV_VAR, "/nonexistent/cache/dir")
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.cache_dir() == "/nonexistent/cache/dir"
    assert compile_cache.enable() == "/nonexistent/cache/dir"
    # the directory is JAX's own to read from the variable: no code override
    assert jax.config.jax_compilation_cache_dir == before
    assert not os.path.exists("/nonexistent/cache/dir")


def test_default_is_fixed_path_in_checkout(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    path = compile_cache.cache_dir()
    assert path == os.path.join(REPO, ".jax_cache")
    # fixed: no process id or time in it, so a later process finds it again
    assert str(os.getpid()) not in path
    assert compile_cache.cache_dir() == path
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_enable_default_sets_and_creates_checkout_dir(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    try:
        got = compile_cache.enable()
        assert got == compile_cache.DEFAULT_DIR and os.path.isdir(got)
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        compile_cache.disable()
    assert jax.config.jax_compilation_cache_dir is None


def test_old_variable_is_ignored(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    monkeypatch.setenv("FLOWSIM_COMPILE_CACHE", "/elsewhere")
    assert compile_cache.cache_dir() == compile_cache.DEFAULT_DIR
