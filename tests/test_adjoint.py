"""Adjoint (IFT) gradients through the solver (ops/adjoint.py, round 5).

Oracles:
* the legacy unrolled-autodiff path (``newton="fixed"``), which converges to
  the IFT gradient as tolerance -> 0;
* central finite differences of the (non-differentiable) while-Newton path;
* a dense-matrix check of the transposed block-tridiagonal solve.

Also covers the storage.mass_balance custom_vjp (the bisection's raw
autodiff gradient is identically zero — a silent-wrong-gradient defect the
IFT rule fixes) and the two-phase value_and_grad driver.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flowsim_tpu.models.calibrate import set_main_roughness, upstream_stage_at
from flowsim_tpu.ops import adjoint
from flowsim_tpu.ops import preissmann as prs
from flowsim_tpu.ops import storage as stg

pytestmark = pytest.mark.fast


def _akbari(nt=9, tol=1e-10):
    from flowsim_tpu.models import akbari_firoozi as ak

    solver, _ = ak.build()
    sset = dataclasses.replace(
        solver.settings(tolerance=tol, max_iter=100),
        n_time_levels=nt, linear_solver="thomas")
    return solver, sset


_QT = np.array([150.0, 250.0])
_HT = np.array([3.0, 4.0])


def _loss_fn(solver, sset, newton):
    ss = dataclasses.replace(sset, newton=newton)
    geo = solver.channel.geometry

    def f(n_main):
        g = set_main_roughness(geo, n_main)
        out = prs.simulate(g, solver.us_params, solver.ds_params,
                           solver.h0, solver.Q0, ss)
        H = upstream_stage_at(out, g.z_bed[0], jnp.asarray(_QT))
        return jnp.sum((H - jnp.asarray(_HT)) ** 2)

    return f


def test_implicit_matches_fixed_and_fd():
    solver, sset = _akbari()
    n0 = jnp.asarray(0.023)
    g_fixed = float(jax.grad(_loss_fn(solver, sset, "fixed"))(n0))
    g_impl = float(jax.grad(_loss_fn(solver, sset, "implicit"))(n0))
    assert abs(g_impl - g_fixed) < 1e-8 * abs(g_fixed)
    eps = 1e-6
    f = _loss_fn(solver, sset, "while")
    fd = (float(f(n0 + eps)) - float(f(n0 - eps))) / (2 * eps)
    assert abs(g_impl - fd) < 1e-6 * abs(fd)


def test_implicit_under_jit_and_vmap():
    solver, sset = _akbari()
    f = _loss_fn(solver, sset, "implicit")
    ns = jnp.asarray([0.022, 0.023, 0.025])
    gv = jax.jit(jax.vmap(jax.grad(f)))(ns)
    g_each = [float(jax.grad(f)(n)) for n in ns]
    np.testing.assert_allclose(np.asarray(gv), g_each, rtol=1e-9)


def test_gradients_wrt_forcing_initial_state_and_qlat():
    solver, sset = _akbari()
    geo = solver.channel.geometry
    n = solver.h0.shape[0]
    qlat0 = jnp.full((n,), 5e-5, dtype=solver.h0.dtype)

    def make(newton):
        ss = dataclasses.replace(sset, newton=newton)

        def f(scale, h0s, q):
            us = dataclasses.replace(
                solver.us_params,
                target_series=solver.us_params.target_series * scale)
            out = prs.simulate(geo, us, solver.ds_params, solver.h0 + h0s,
                               solver.Q0, ss, lateral_inflow=q)
            return jnp.sum(out.depth[-1] ** 2) + jnp.sum(out.flow[3] ** 2)

        return f

    args = (jnp.asarray(1.0), jnp.asarray(0.01), qlat0)
    g_imp = jax.grad(make("implicit"), argnums=(0, 1, 2))(*args)
    g_fix = jax.grad(make("fixed"), argnums=(0, 1, 2))(*args)
    for gi, gf in zip(g_imp, g_fix):
        np.testing.assert_allclose(np.asarray(gi), np.asarray(gf),
                                   rtol=1e-7, atol=1e-12)


def test_storage_bc_gradient_matches_fd():
    """Downstream lumped storage: the stage chain rides the adjoint state.

    Also regression-pins the mass_balance custom_vjp: before round 5 the
    bisection's autodiff gradient was identically zero, so the fixed path
    silently dropped the reservoir feedback term.
    """
    from flowsim_tpu.models import example as ex

    solver, _ = ex.build()
    sset = dataclasses.replace(
        solver.settings(tolerance=1e-10, max_iter=100),
        n_time_levels=8, linear_solver="thomas")
    geo = solver.channel.geometry

    def make(newton):
        ss = dataclasses.replace(sset, newton=newton)

        def f(n_main):
            g = set_main_roughness(geo, n_main)
            out = prs.simulate(g, solver.us_params, solver.ds_params,
                               solver.h0, solver.Q0, ss)
            return (jnp.sum(out.depth[-1] ** 2)
                    + jnp.sum(out.reservoir_stage[1:] ** 2))

        return f

    n0 = jnp.asarray(0.027)
    g_impl = float(jax.grad(make("implicit"))(n0))
    g_fixed = float(jax.grad(make("fixed"))(n0))
    eps = 1e-6
    f = make("while")
    fd = (float(f(n0 + eps)) - float(f(n0 - eps))) / (2 * eps)
    assert abs(g_impl - fd) < 1e-5 * abs(fd)
    assert abs(g_fixed - fd) < 1e-5 * abs(fd)


def test_mass_balance_ift_gradient():
    sp = stg.make_storage(surface_area=1e6, min_stage=-jnp.inf,
                          solution_boundaries=(0.0, 100.0))
    dt, vol_in, Y_old = 3600.0, 2.5e6, 50.0
    g = jax.grad(stg.mass_balance, argnums=(2, 3))(sp, dt, jnp.asarray(vol_in),
                                                   jnp.asarray(Y_old))
    # constant area, no rating: Y = Y_old + vol_in/SA exactly
    np.testing.assert_allclose(float(g[0]), 1e-6, rtol=1e-10)
    np.testing.assert_allclose(float(g[1]), 1.0, rtol=1e-10)

    # rated outlet: check against central differences
    from flowsim_tpu.ops import rating_curve as rc

    sp2 = stg.make_storage(surface_area=5e5, min_stage=-jnp.inf,
                           solution_boundaries=(0.0, 100.0),
                           rating=rc.make_polynomial(0.5, 10.0, 0.0))
    f = lambda v, y: stg.mass_balance(sp2, dt, v, y)
    gv, gy = jax.grad(f, argnums=(0, 1))(jnp.asarray(vol_in), jnp.asarray(Y_old))
    eps = 1e2
    fd_v = (float(f(vol_in + eps, Y_old)) - float(f(vol_in - eps, Y_old))) / (2 * eps)
    eps = 1e-4
    fd_y = (float(f(vol_in, Y_old + eps)) - float(f(vol_in, Y_old - eps))) / (2 * eps)
    np.testing.assert_allclose(float(gv), fd_v, rtol=1e-5)
    np.testing.assert_allclose(float(gy), fd_y, rtol=1e-5)


def test_transposed_solve_dense_check(rng):
    N = 17
    L = rng.normal(size=(N, 2, 2)) * 0.1
    U = rng.normal(size=(N, 2, 2)) * 0.1
    D = rng.normal(size=(N, 2, 2)) + 3.0 * np.eye(2)
    L[0] = 0.0
    U[-1] = 0.0
    rhs = rng.normal(size=(N, 2))
    x = np.asarray(adjoint._transposed_solve(
        jnp.asarray(L), jnp.asarray(D), jnp.asarray(U), jnp.asarray(rhs),
        "thomas"))
    # dense J, solve J^T x = rhs
    J = np.zeros((2 * N, 2 * N))
    for i in range(N):
        J[2 * i:2 * i + 2, 2 * i:2 * i + 2] = D[i]
        if i > 0:
            J[2 * i:2 * i + 2, 2 * i - 2:2 * i] = L[i]
        if i < N - 1:
            J[2 * i:2 * i + 2, 2 * i + 2:2 * i + 4] = U[i]
    x_dense = np.linalg.solve(J.T, rhs.reshape(-1)).reshape(N, 2)
    np.testing.assert_allclose(x, x_dense, rtol=1e-9, atol=1e-12)


def test_value_and_grad_two_phase():
    """Eager XLA forward + adjoint backward == implicit grad."""
    solver, sset = _akbari(tol=1e-8)
    geo = solver.channel.geometry
    sset_w = dataclasses.replace(sset, newton="while", linear_solver="pcr")

    def loss_fn(out):
        H = upstream_stage_at(out, geo.z_bed[0], jnp.asarray(_QT))
        return jnp.sum((H - jnp.asarray(_HT)) ** 2)

    n0 = 0.023
    g0 = set_main_roughness(geo, n0)
    v, grads, out = adjoint.simulate_value_and_grad(
        loss_fn, g0, solver.us_params, solver.ds_params,
        solver.h0, solver.Q0, sset_w)
    g_n = float(jnp.sum(grads[0].n_main))

    f = _loss_fn(solver, dataclasses.replace(sset, linear_solver="pcr",
                                             tolerance=1e-8), "implicit")
    v_ref = float(f(jnp.asarray(n0)))
    g_ref = float(jax.grad(f)(jnp.asarray(n0)))
    assert abs(float(v) - v_ref) < 1e-6 * max(1.0, abs(v_ref))
    assert abs(g_n - g_ref) < 1e-6 * abs(g_ref)


def test_gated_blend_raises():
    from flowsim_tpu.models.gerd_roseires import model

    solver, _ = model.build(smooth=False)
    sset = dataclasses.replace(
        solver.settings(tolerance=1e-6, max_iter=100),
        n_time_levels=5, newton="implicit")
    with pytest.raises(ValueError, match="gated_blend"):
        prs.simulate(solver.channel.geometry, solver.us_params,
                     solver.ds_params, solver.h0, solver.Q0, sset)


def test_gradient_calibrate_implicit_descends():
    solver, sset = _akbari(nt=7, tol=1e-8)
    from flowsim_tpu.models.calibrate import gradient_calibrate

    geo = solver.channel.geometry
    n_opt, hist = gradient_calibrate(
        geo, solver.us_params, solver.ds_params, solver.h0, solver.Q0,
        sset, _QT, _HT, n0=0.028, lr=1e-7, steps=3)
    assert hist[-1][1] <= hist[0][1] + 1e-9
    assert np.isfinite(n_opt)


def test_bfgs_calibrate_recovers_roughness():
    """BFGS calibration (the reference's abandoned L-BFGS-B scaffold, ref
    n_calibrate.py:33-52, realized with exact adjoint gradients): recover
    the known roughness from stages the model itself produced."""
    from flowsim_tpu.models.calibrate import (bfgs_calibrate,
                                              set_main_roughness,
                                              upstream_stage_at)

    solver, sset = _akbari(nt=7, tol=1e-8)
    geo = solver.channel.geometry
    n_true = 0.026
    out = prs.simulate(set_main_roughness(geo, n_true), solver.us_params,
                       solver.ds_params, solver.h0, solver.Q0,
                       dataclasses.replace(sset, newton="while"))
    Qt = np.array([150.0, 250.0])
    Ht = np.asarray(upstream_stage_at(out, geo.z_bed[0], jnp.asarray(Qt)))
    n_opt, rmse, res = bfgs_calibrate(
        geo, solver.us_params, solver.ds_params, solver.h0, solver.Q0,
        sset, Qt, Ht, n0=0.032, maxiter=25)
    # BFGS with default line-search tolerances lands within ~1e-3 of the
    # generating roughness on this shallow 2-target objective
    assert abs(n_opt - n_true) < 1e-3, (n_opt, rmse)
    assert rmse < 0.05
