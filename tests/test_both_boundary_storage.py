"""Lumped storage on BOTH boundaries simultaneously.

The reference keeps per-boundary state inside each LumpedStorage
(``stage_hydrograph``, ref boundary.py:104-131), so a reservoir at each end
works there implicitly; flowsim_tpu carries the two stages explicitly in
``BCState.reservoir_stage`` (downstream) and ``BCState.reservoir_stage_us``
(upstream).  These tests pin:

* independent evolution + exact per-level mass balance at BOTH ends
  (upstream drains, downstream fills, each against its own surface area);
* the sharded (domain-decomposed) run matching the single-device run;
* ``single_step`` chunked advancement (the checkpoint path) matching
  ``simulate`` bitwise;
* the Lax solver's dual-stage scan carry.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np

from flowsim_tpu.geometry import TrapezoidGeometry
from flowsim_tpu.ops import boundary as bnd
from flowsim_tpu.ops import preissmann as prs
from flowsim_tpu.ops import storage as stg

# SA_DS/dt sized like the example case: the downstream level-1 trial-stage
# bootstrap (ref boundary.py:104-108) claims df_dh=1 for an h-independent
# residual, so level 1 converges only linearly at a rate ~ dt/SA_ds — a
# faithful reference quirk, not a solver defect (SA=5e6 at dt=1800 stalls
# past 100 iterations in the reference semantics too).
SA_US, SA_DS = 3.0e6, 1.25e6
DT, NT, DX = 3600.0, 13, 1000.0


def build(n=16, slope=6e-4):
    z = np.linspace(slope * (n - 1) * DX, 0.0, n)
    ones, zeros = np.ones(n), np.zeros(n)
    geo = TrapezoidGeometry(
        z_bed=jnp.asarray(z), b_main=jnp.asarray(120.0 * ones),
        m_main=jnp.asarray(zeros), n_main=jnp.asarray(0.025 * ones),
        compound=jnp.asarray(np.zeros(n, bool)), h_bank=jnp.asarray(1e30 * ones),
        b_fp_left=jnp.asarray(zeros), b_fp_right=jnp.asarray(zeros),
        m_fp=jnp.asarray(zeros), n_left=jnp.asarray(0.025 * ones),
        n_right=jnp.asarray(0.025 * ones), bed_slope=jnp.asarray(slope * ones),
        curvature=jnp.asarray(zeros))
    bed_us, bed_ds = float(z[0]), float(z[-1])
    from flowsim_tpu.ops import initial_conditions as ic

    h0, Q0 = ic.initial_conditions(geo, "steady-state", 150.0, DX)
    us = bnd.make_boundary(
        "fixed_depth", bed_level=bed_us,
        storage=stg.make_storage(surface_area=SA_US, min_stage=bed_us - 5.0,
                                 solution_boundaries=(0.0, 100.0)))
    # ds min_stage at the initial surface, like the example case (ref
    # main.py:37 min_stage=5 = initial depth): the level-1 trial-stage
    # bootstrap (ref boundary.py:104-108) is otherwise an h-independent
    # residual whose claimed df_dh=1 stalls Newton at level 1 — with the
    # clamp active at t=0 the first level is a clean fixed-stage row.
    ds = bnd.make_boundary(
        "fixed_depth", bed_level=bed_ds,
        storage=stg.make_storage(surface_area=SA_DS,
                                 min_stage=bed_ds + float(np.asarray(h0)[-1]),
                                 solution_boundaries=(0.0, 100.0)))
    return geo, us, ds, h0, Q0


def settings(**kw):
    base = dict(theta=0.6, time_step=DT, spatial_step=DX, n_time_levels=NT,
                tolerance=1e-8, max_iter=100)
    base.update(kw)
    return prs.PreissmannSettings(**base)


def test_both_ends_storage_mass_balance():
    geo, us, ds, h0, Q0 = build()
    out = prs.simulate(geo, us, ds, h0, Q0, settings())
    assert bool(np.asarray(out.converged).all())
    y_us = np.asarray(out.reservoir_stage_us)
    y_ds = np.asarray(out.reservoir_stage)
    q_us = np.asarray(out.flow)[:, 0]
    q_ds = np.asarray(out.flow)[:, -1]
    assert np.isfinite(y_us[1:]).all() and np.isfinite(y_ds[1:]).all()
    # the two stages evolve independently: upstream drains, downstream fills
    assert (np.diff(y_us[1:]) < 0).all(), y_us
    assert (np.diff(y_ds[1:]) > 0).all(), y_ds
    # per-level mass balance at EACH end against its own surface area
    vol_out_us = 0.5 * (q_us[1:-1] + q_us[2:]) * DT
    vol_in_ds = 0.5 * (q_ds[1:-1] + q_ds[2:]) * DT
    np.testing.assert_allclose(SA_US * -np.diff(y_us[1:]), vol_out_us, rtol=1e-8)
    np.testing.assert_allclose(SA_DS * np.diff(y_ds[1:]), vol_in_ds, rtol=1e-8)
    # merged output keeps ds precedence when both ends have storage
    np.testing.assert_array_equal(y_ds[1:], np.asarray(out.reservoir_stage)[1:])


def test_single_storage_series_unchanged():
    """ds-only storage still reports the same merged reservoir_stage and a
    NaN upstream series (back-compat for the single-storage surface)."""
    geo, us, ds, h0, Q0 = build()
    us_plain = bnd.make_boundary("stage_hydrograph", bed_level=float(np.asarray(geo.z_bed)[0]),
                                 target_series=np.full(NT, float(np.asarray(geo.z_bed)[0]) + 4.0))
    out = prs.simulate(geo, us_plain, ds, h0, Q0, settings())
    assert bool(np.asarray(out.converged).all())
    assert np.isfinite(np.asarray(out.reservoir_stage)[1:]).all()
    assert np.isnan(np.asarray(out.reservoir_stage_us)[1:]).all()


def test_both_ends_storage_sharded_matches_single_device():
    from flowsim_tpu.parallel.domain import simulate_sharded
    from flowsim_tpu.parallel.mesh import make_mesh

    geo, us, ds, h0, Q0 = build()
    sset = settings(tolerance=1e-9)
    ref = prs.simulate(geo, us, ds, h0, Q0, sset)
    mesh = make_mesh(n_ensemble=1, n_space=8)
    out = simulate_sharded(geo, us, ds, h0, Q0, sset, mesh)
    np.testing.assert_allclose(np.asarray(out.depth), np.asarray(ref.depth),
                               rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(np.asarray(out.reservoir_stage[1:]),
                               np.asarray(ref.reservoir_stage[1:]), rtol=1e-9)
    np.testing.assert_allclose(np.asarray(out.reservoir_stage_us[1:]),
                               np.asarray(ref.reservoir_stage_us[1:]), rtol=1e-9)


def test_both_ends_storage_single_step_matches_simulate():
    """Chunked advancement (the checkpoint/resume path) carries BOTH stages
    through BCState and tracks ``simulate`` to fusion roundoff."""
    geo, us, ds, h0, Q0 = build()
    sset = settings()
    ref = prs.simulate(geo, us, ds, h0, Q0, sset)
    h, Q = h0, Q0
    bc_state = None
    for k in range(1, NT):
        h, Q, err, iters, bc_state = prs.single_step(
            geo, us, ds, h, Q, k, jnp.nan, sset, bc_state=bc_state)
        # eager single_step vs the jitted scan differ only by XLA fusion
        # roundoff; the carried stages must track to ~ULP
        np.testing.assert_allclose(np.asarray(h), np.asarray(ref.depth)[k], rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(np.asarray(Q), np.asarray(ref.flow)[k], rtol=1e-11)
        np.testing.assert_allclose(np.asarray(bc_state.reservoir_stage),
                                   np.asarray(ref.reservoir_stage)[k], rtol=1e-12)
        np.testing.assert_allclose(np.asarray(bc_state.reservoir_stage_us),
                                   np.asarray(ref.reservoir_stage_us)[k], rtol=1e-12)


def test_both_ends_storage_lax_runs():
    from flowsim_tpu.ops import lax_friedrichs as lfx

    geo, us, ds, h0, Q0 = build()
    sset = lfx.LaxSettings(time_step=60.0, spatial_step=DX, n_time_levels=31)
    out = lfx.simulate(geo, us, ds, h0, Q0, sset)
    assert not bool(np.asarray(out.cfl_violated).any())
    assert np.isfinite(np.asarray(out.depth)).all()
    y_us = np.asarray(out.reservoir_stage_us)
    y_ds = np.asarray(out.reservoir_stage)
    assert np.isfinite(y_us[1:]).all() and np.isfinite(y_ds[1:]).all()
    # upstream pool releases (stage falls), downstream pool fills (rises)
    assert y_us[-1] < y_us[2]
    assert y_ds[-1] > y_ds[2]


def _assert_solvers_agree(geo, us, ds, h0, Q0, sset):
    """thomas vs pcr: identical iteration counts, both stage trajectories."""
    ref = prs.simulate(geo, us, ds, h0, Q0,
                       dataclasses.replace(sset, linear_solver="thomas"))
    out = prs.simulate(geo, us, ds, h0, Q0,
                       dataclasses.replace(sset, linear_solver="pcr"))
    assert bool(np.asarray(out.converged).all())
    np.testing.assert_array_equal(np.asarray(out.iterations),
                                  np.asarray(ref.iterations))
    assert np.abs(np.asarray(out.depth) - np.asarray(ref.depth)).max() < 1e-9
    assert np.abs(np.asarray(out.reservoir_stage[1:])
                  - np.asarray(ref.reservoir_stage[1:])).max() < 1e-9
    assert np.abs(np.asarray(out.reservoir_stage_us[1:])
                  - np.asarray(ref.reservoir_stage_us[1:])).max() < 1e-9


def test_both_ends_storage_thomas_vs_pcr():
    """Storage on BOTH boundaries: the two linear solvers give identical
    iteration counts and matching stage trajectories."""
    geo, us, ds, h0, Q0 = build()
    _assert_solvers_agree(geo, us, ds, h0, Q0, settings(tolerance=1e-6))


def test_both_ends_curve_storage_thomas_vs_pcr():
    """Both-ends with stage-AREA-CURVE reservoirs at both ends."""
    geo, us, ds, h0, Q0 = build()
    bed_ds = float(np.asarray(geo.z_bed)[-1])
    y0 = bed_ds + float(np.asarray(h0)[-1])
    stages = np.linspace(0.0, 100.0, 33)
    areas = SA_DS * (1.0 + 0.01 * (stages - y0))
    ds_curve = bnd.make_boundary(
        "fixed_depth", bed_level=bed_ds,
        storage=stg.make_storage(area_curve=np.stack([stages, areas], 1),
                                 min_stage=y0,
                                 solution_boundaries=(0.0, 100.0)))
    bed_us = float(np.asarray(geo.z_bed)[0])
    us_curve = bnd.make_boundary(
        "fixed_depth", bed_level=bed_us,
        storage=stg.make_storage(
            area_curve=np.stack([stages, SA_US * (1.0 + 0.02 * (stages - y0) ** 0 )], 1),
            min_stage=bed_us - 5.0, solution_boundaries=(0.0, 100.0)))
    _assert_solvers_agree(geo, us_curve, ds_curve, h0, Q0,
                          settings(tolerance=1e-6))
