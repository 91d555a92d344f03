"""Global numeric configuration.

The reference code is float64-NumPy throughout (ref: solver.py:43-44), and
float64 is native on the CPU and the GPU, so production runs, benchmarks and
parity tests all enable ``jax_enable_x64`` and carry ``float64`` state.  With
x64 disabled the solver state falls back to ``float32`` (Newton tolerances
are expressed on the residual norm, which is well-scaled for f32).
"""

from __future__ import annotations

import jax.numpy as jnp

# Standard gravity, identical to scipy.constants.g used throughout the
# reference (ref: hydraulics.py:2, preissmann.py:2).
GRAVITY = 9.80665

_DEFAULT_DTYPE = jnp.float32


def default_dtype():
    """Current default floating dtype for solver state."""
    import jax

    if jax.config.jax_enable_x64:
        return jnp.float64
    return _DEFAULT_DTYPE


def set_default_dtype(dtype) -> None:
    global _DEFAULT_DTYPE
    _DEFAULT_DTYPE = jnp.dtype(dtype)


def farray(x):
    """Array in the current default float dtype (f64 when x64 is enabled)."""
    return jnp.asarray(x, dtype=default_dtype())
