"""Manning-n calibration: vmapped sweeps and gradient descent through the solver.

The reference calibration (ref: cases/gerd_roseires/n_calibrate.py) re-runs
the full simulation serially for each candidate roughness (ref :58-62) and
carries a commented L-BFGS-B scaffold (ref :33-52).  Here the whole sweep is
**one batched simulation**: roughness enters the geometry pytree, so `vmap`
over the geometry batches every Newton solve and every PCR sweep, and the
batch shards across devices (see flowsim_tpu.parallel.ensemble).

Because the fixed-iteration Newton path is reverse-mode differentiable, the
RMSE objective also admits exact gradients (`jax.grad` through the entire
solver), upgrading the reference's grid sweep to gradient calibration.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable

import numpy as np
import jax
import jax.numpy as jnp

from flowsim_tpu.ops import preissmann as prs


def set_main_roughness(geo, n_main):
    """Return geometry with the main-channel Manning n replaced (scalar or
    per-node); the calibration parameter of ref n_calibrate.py:5-17."""
    n = jnp.broadcast_to(jnp.asarray(n_main, dtype=geo.n_main.dtype), geo.n_main.shape)
    return dataclasses.replace(geo, n_main=n)


def simulate_with_roughness(geo, us_bc, ds_bc, h0, Q0, settings, n_main):
    return prs.simulate(set_main_roughness(geo, n_main), us_bc, ds_bc, h0, Q0, settings)


def upstream_stage_at(out: prs.SimOutput, z_bed_us, Q_targets):
    """Interpolate upstream stage at target discharges (ref model.py:105-113)."""
    return jnp.interp(jnp.asarray(Q_targets), out.flow[:, 0], out.depth[:, 0] + z_bed_us)


def gvf_ic_fn(dx, Q_init, h_downstream):
    """In-graph GVF initial conditions as a function of the geometry.

    The reference rebuilds the whole model per candidate roughness, so the
    GVF backwater initial profile changes with n (ref n_calibrate.py:5-17 ->
    model.py:73-87 -> channel.initialize_conditions); a calibration sweep
    must therefore recompute ICs per ensemble member.
    """
    from flowsim_tpu.ops import initial_conditions as ic

    def f(geo):
        res = ic.gvf_profile(geo, Q_init, h_downstream, dx)
        return res.depth, jnp.full((geo.n_nodes,), Q_init, dtype=res.depth.dtype)

    return f


def rmse_objective(geo, us_bc, ds_bc, h0, Q0, settings, Q_targets, H_targets, ic_fn=None):
    """RMSE of simulated vs target stages as a pure function of n_main
    (ref n_calibrate.py:55-63).  ``ic_fn(geo) -> (h0, Q0)`` recomputes the
    initial state per candidate (pass :func:`gvf_ic_fn` for GVF cases)."""

    def f(n_main):
        g = set_main_roughness(geo, n_main)
        h, Q = (h0, Q0) if ic_fn is None else ic_fn(g)
        out = prs.simulate(g, us_bc, ds_bc, h, Q, settings)
        H = upstream_stage_at(out, g.z_bed[0], Q_targets)
        return jnp.sqrt(jnp.mean((H - jnp.asarray(H_targets)) ** 2))

    return f


def rmse_sweep(geo, us_bc, ds_bc, h0, Q0, settings, Q_targets, H_targets, n_values,
               sharded: bool = False, ic_fn=None):
    """Vectorized replacement for the serial sweep of ref n_calibrate.py:55-75.

    All candidates run as one vmapped batch (optionally sharded over the
    device mesh ensemble axis); pass ``ic_fn`` (e.g. :func:`gvf_ic_fn`) to
    recompute per-candidate initial conditions, as the reference's
    per-candidate model rebuild does.
    """
    n_values = jnp.asarray(n_values)
    obj = rmse_objective(geo, us_bc, ds_bc, h0, Q0, settings, Q_targets,
                         H_targets, ic_fn=ic_fn)
    fv = jax.jit(jax.vmap(obj))
    if sharded:
        from flowsim_tpu.parallel.ensemble import shard_batch

        n_values = shard_batch(n_values)
    return fv(n_values)


def bfgs_calibrate(geo, us_bc, ds_bc, h0, Q0, settings, Q_targets, H_targets,
                   n0=0.028, bounds=(0.020, 0.060), maxiter=30):
    """Quasi-Newton (BFGS) Manning-n calibration through the solver.

    The reference carries a commented-out scipy L-BFGS-B scaffold it never
    ran (ref cases/gerd_roseires/n_calibrate.py:33-52 — each evaluation
    would have re-simulated serially with FD gradients).  Here the whole
    optimize runs as jitted JAX: ``jax.scipy.optimize.minimize(method=
    "BFGS")`` over the RMSE objective with EXACT adjoint gradients
    (``newton="implicit"``, ops/adjoint.py).  Bounds are enforced by a
    smooth sigmoid reparameterization (BFGS itself is unconstrained).

    Returns ``(n_opt, rmse_opt, result)``.
    """
    from jax.scipy.optimize import minimize as jsp_minimize

    sset = dataclasses.replace(settings, newton="implicit")
    obj = rmse_objective(geo, us_bc, ds_bc, h0, Q0, sset, Q_targets,
                         H_targets)
    lo, hi = bounds

    def to_n(t):  # unconstrained -> (lo, hi)
        return lo + (hi - lo) * jax.nn.sigmoid(t)

    def to_t(n):
        f = (n - lo) / (hi - lo)
        return jnp.log(f / (1.0 - f))

    def f(t):
        return obj(to_n(t[0]))

    res = jsp_minimize(f, jnp.asarray([float(to_t(jnp.asarray(n0)))]),
                       method="BFGS", options=dict(maxiter=maxiter))
    n_opt = float(to_n(res.x[0]))
    return n_opt, float(res.fun), res


def gradient_calibrate(geo, us_bc, ds_bc, h0, Q0, settings, Q_targets, H_targets,
                       n0=0.028, lr=2e-4, steps=25, bounds=(0.020, 0.060),
                       newton: str = "implicit"):
    """Gradient descent on the squared-stage objective through the solver.

    ``newton="implicit"`` (default) uses the adjoint path (ops/adjoint.py):
    fast while-Newton forward + one transposed block-tridiagonal solve per
    level backward — O(1) gradient memory.  ``newton="fixed"`` keeps the
    legacy unrolled-autodiff path (max_iter x nt assemblies on the tape).

    Returns (n_opt, history of (n, loss)).
    """
    if settings.newton != newton:
        settings = dataclasses.replace(settings, newton=newton)

    def loss(n_main):
        out = simulate_with_roughness(geo, us_bc, ds_bc, h0, Q0, settings, n_main)
        H = upstream_stage_at(out, geo.z_bed[0], Q_targets)
        return jnp.sum((H - jnp.asarray(H_targets)) ** 2)

    vg = jax.jit(jax.value_and_grad(loss))
    n = jnp.asarray(float(n0))
    history = []
    for _ in range(steps):
        v, g = vg(n)
        history.append((float(n), float(v)))
        step = jnp.clip(lr * g, -2e-3, 2e-3)  # trust-region cap on the n step
        n = jnp.clip(n - step, bounds[0], bounds[1])
    return float(n), history
