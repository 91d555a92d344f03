"""Parity for the remaining BC / forcing variants:

* stage_hydrograph boundary
* fixed_depth + lumped storage with entrance losses (capture_losses)
* polynomial & power rating curves incl. fit and Newton stage inverse
* lumped storage with a stage-area curve
"""

import math

import numpy as np
import pytest

from tests.oracle import import_reference, reference_available

pytestmark = pytest.mark.skipif(not reference_available(), reason="reference not mounted")


def stage_hyd_fn(t):
    return 5.0 + 1.5 * math.sin(t / (4 * 3600.0))


def _ref_stage_case(tol):
    import_reference()
    from src.hydromodel.boundary import Boundary
    from src.hydromodel.channel import Channel
    from src.hydromodel.hydrograph import Hydrograph
    from src.hydromodel.preissmann import PreissmannSolver

    us = Boundary(condition="flow_hydrograph", bed_level=4.0, chainage=0,
                  hydrograph=Hydrograph(function=lambda t: 800 + t / 100.0))
    ds = Boundary(condition="stage_hydrograph", bed_level=0.0, chainage=16000,
                  hydrograph=Hydrograph(function=stage_hyd_fn))
    ch = Channel(width=180, initial_flow=800, roughness=0.03,
                 upstream_boundary=us, downstream_boundary=ds,
                 interpolation_method="steady-state")
    s = PreissmannSolver(channel=ch, theta=0.7, time_step=1800,
                         spatial_step=1000, simulation_time=10 * 3600)
    s.run(verbose=0, tolerance=tol)
    return s


def _our_stage_case(tol):
    from flowsim_tpu.api import Boundary, Channel, Hydrograph, PreissmannSolver

    us = Boundary(condition="flow_hydrograph", bed_level=4.0, chainage=0,
                  hydrograph=Hydrograph(function=lambda t: 800 + t / 100.0))
    ds = Boundary(condition="stage_hydrograph", bed_level=0.0, chainage=16000,
                  hydrograph=Hydrograph(function=stage_hyd_fn))
    ch = Channel(width=180, initial_flow=800, roughness=0.03,
                 upstream_boundary=us, downstream_boundary=ds,
                 interpolation_method="steady-state")
    s = PreissmannSolver(channel=ch, theta=0.7, time_step=1800,
                         spatial_step=1000, simulation_time=10 * 3600)
    s.run(verbose=0, tolerance=tol)
    return s


def test_stage_hydrograph_bc_matches():
    ref = _ref_stage_case(1e-9)
    ours = _our_stage_case(1e-9)
    np.testing.assert_allclose(ours.depth, ref.depth, rtol=1e-7, atol=1e-8)
    np.testing.assert_allclose(ours.flow, ref.flow, rtol=1e-7, atol=1e-5)


def test_storage_with_losses_matches():
    import_reference()
    from src.hydromodel.boundary import Boundary as RB
    from src.hydromodel.channel import Channel as RC
    from src.hydromodel.hydrograph import Hydrograph as RH
    from src.hydromodel.lumped_storage import LumpedStorage as RLS
    from src.hydromodel.preissmann import PreissmannSolver as RP

    def hyd(t):
        return 1000 + 4000 * min(t / (4 * 3600.0), 1.0)

    def build_ref():
        us = RB(condition="flow_hydrograph", bed_level=5, chainage=0, hydrograph=RH(function=hyd))
        ds = RB(condition="fixed_depth", initial_depth=5, bed_level=0, chainage=20000)
        ss = RLS(surface_area=4000 * 300, min_stage=5, solution_boundaries=(0, 200))
        ss.capture_losses = True
        ss.reservoir_length = 800.0
        ss.K_q = 0.3
        ds.set_lumped_storage(ss)
        ch = RC(width=250, initial_flow=1000, roughness=0.027,
                upstream_boundary=us, downstream_boundary=ds)
        return RP(channel=ch, theta=0.8, time_step=3600, spatial_step=1000,
                  simulation_time=12 * 3600)

    rs = build_ref()
    rs.run(verbose=0, tolerance=1e-9)

    from flowsim_tpu.api import Boundary, Channel, Hydrograph, LumpedStorage, PreissmannSolver

    us = Boundary(condition="flow_hydrograph", bed_level=5, chainage=0,
                  hydrograph=Hydrograph(function=hyd))
    ds = Boundary(condition="fixed_depth", initial_depth=5, bed_level=0, chainage=20000)
    ss = LumpedStorage(surface_area=4000 * 300, min_stage=5, solution_boundaries=(0, 200))
    ss.capture_losses = True
    ss.reservoir_length = 800.0
    ss.K_q = 0.3
    ds.set_lumped_storage(ss)
    ch = Channel(width=250, initial_flow=1000, roughness=0.027,
                 upstream_boundary=us, downstream_boundary=ds)
    s = PreissmannSolver(channel=ch, theta=0.8, time_step=3600, spatial_step=1000,
                         simulation_time=12 * 3600)
    s.run(verbose=0, tolerance=1e-9)

    np.testing.assert_allclose(s.depth, rs.depth, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(s.flow, rs.flow, rtol=1e-6, atol=1e-3)


def test_storage_area_curve_mass_balance_close():
    """Stage-area-curve storage: dense cumulative-volume table vs the
    reference's per-call trapezoid integration (same physics, fixed shapes;
    tolerances reflect the different quadratures)."""
    import_reference()
    import jax.numpy as jnp
    from src.hydromodel.lumped_storage import LumpedStorage as RLS

    from flowsim_tpu.ops import storage as stmod

    curve = np.column_stack([np.linspace(480, 520, 21),
                             1e6 * (1.0 + 0.05 * np.arange(21))])
    ref = RLS(solution_boundaries=None, min_stage=480)
    ref.set_area_curve(curve)
    sp = stmod.make_storage(area_curve=curve, min_stage=480)

    for Y_old, vol_in in [(490.0, 5e6), (500.0, -2e6), (485.0, 2.4e7)]:
        y_ref = ref.mass_balance(duration=3600.0, vol_in=vol_in, Y_old=Y_old)
        y_ours = float(stmod.mass_balance(sp, 3600.0, jnp.asarray(vol_in), jnp.asarray(Y_old)))
        assert abs(y_ref - y_ours) < 2e-3, (Y_old, vol_in, y_ref, y_ours)


def test_rating_curve_fit_and_inverse_match():
    import_reference()
    from src.hydromodel.rating_curve import RatingCurve as RRC

    from flowsim_tpu.api import RatingCurve

    stages = np.linspace(480, 492, 13)
    discharges = 2.0 * (stages - 470) ** 2 + 30 * (stages - 470) + 100 + np.random.default_rng(0).normal(0, 5, 13)

    # NOTE: the reference's scale=True fit path stores a numpy Polynomial and
    # evaluates it at the *unshifted* stage (ref rating_curve.py:51-52,101-104)
    # so a nonzero stage_shift produces garbage there; flowsim_tpu applies the
    # shift consistently.  Compare the scaled path at shift 0 (well-defined)
    # and the unscaled coefficient path with a shift (also well-defined).
    ref = RRC()
    ref.fit(discharges=discharges, stages=stages, stage_shift=0, type="polynomial", scale=True)
    ours = RatingCurve()
    ours.fit(discharges=discharges, stages=stages, stage_shift=0, type="polynomial")
    for s in [481.0, 486.5, 491.0]:
        np.testing.assert_allclose(ours.discharge(s), ref.discharge(s), rtol=1e-8)
        np.testing.assert_allclose(ours.dQ_dz(s), ref.dQ_dz(s), rtol=1e-6)

    ref_u = RRC()
    ref_u.fit(discharges=discharges, stages=stages, stage_shift=-470, type="polynomial", scale=False)
    ours_u = RatingCurve()
    ours_u.fit(discharges=discharges, stages=stages, stage_shift=-470, type="polynomial")
    for s in [481.0, 486.5, 491.0]:
        np.testing.assert_allclose(ours_u.discharge(s), ref_u.discharge(s), rtol=1e-8)

    refp = RRC()
    refp.fit(discharges=discharges, stages=stages, stage_shift=-470, type="power")
    oursp = RatingCurve()
    oursp.fit(discharges=discharges, stages=stages, stage_shift=-470, type="power")
    for s in [481.0, 486.5, 491.0]:
        np.testing.assert_allclose(oursp.discharge(s), refp.discharge(s), rtol=1e-9)
        np.testing.assert_allclose(oursp.dQ_dz(s), refp.dQ_dz(s), rtol=1e-9)

    # Newton stage inverse (ref rating_curve.py:65-82)
    q = oursp.discharge(486.5)
    s_back = oursp.stage(q, trial_stage=480.0, tolerance=1e-6)
    np.testing.assert_allclose(s_back, 486.5, atol=1e-4)

    # set() API with explicit coefficients (ref :11-30)
    rc = RatingCurve()
    rc.set("polynomial", a=2.0, b=30.0, c=100.0, stage_shift=-470)
    ref2 = RRC()
    ref2.set("polynomial", a=2.0, b=30.0, c=100.0)
    ref2.stage_shift = -470
    np.testing.assert_allclose(rc.discharge(486.0), ref2.discharge(486.0), rtol=1e-12)


def test_upstream_storage_physics():
    """Upstream reservoir orientation (flowsim_tpu extension — no reference
    counterpart): positive Q at node 0 DRAINS the reservoir, the channel
    surface sits BELOW the stage by the entrance loss, and the stage drop
    times the surface area equals the released volume."""
    import jax.numpy as jnp

    from flowsim_tpu.geometry import TrapezoidGeometry
    from flowsim_tpu.ops import boundary as bnd
    from flowsim_tpu.ops import initial_conditions as ic
    from flowsim_tpu.ops import preissmann as prs
    from flowsim_tpu.ops import storage as stg

    n, slope, dx, dt, nt = 16, 6e-4, 1000.0, 1800.0, 13
    z = np.linspace(slope * (n - 1) * dx, 0.0, n)
    ones, zeros = np.ones(n), np.zeros(n)
    geo = TrapezoidGeometry(
        z_bed=jnp.asarray(z), b_main=jnp.asarray(120.0 * ones),
        m_main=jnp.asarray(zeros), n_main=jnp.asarray(0.025 * ones),
        compound=jnp.asarray(np.zeros(n, bool)), h_bank=jnp.asarray(1e30 * ones),
        b_fp_left=jnp.asarray(zeros), b_fp_right=jnp.asarray(zeros),
        m_fp=jnp.asarray(zeros), n_left=jnp.asarray(0.025 * ones),
        n_right=jnp.asarray(0.025 * ones), bed_slope=jnp.asarray(slope * ones),
        curvature=jnp.asarray(zeros))
    SA = 4.0e6
    us = bnd.make_boundary(
        "fixed_depth", bed_level=float(z[0]),
        storage=stg.make_storage(surface_area=SA, min_stage=float(z[0]) - 5.0,
                                 solution_boundaries=(0.0, 100.0)))
    # downstream normal depth lets the channel drain freely -> Q > 0
    ds = bnd.make_boundary("normal_depth", bed_level=float(z[-1]),
                           bed_slope=slope)
    h0, Q0 = ic.initial_conditions(geo, "steady-state", 150.0, dx)
    sset = prs.PreissmannSettings(theta=0.6, time_step=dt, spatial_step=dx,
                                  n_time_levels=nt, tolerance=1e-10, max_iter=100)
    out = prs.simulate(geo, us, ds, h0, Q0, sset)
    assert bool(np.asarray(out.converged).all())
    stages = np.asarray(out.reservoir_stage)
    flow0 = np.asarray(out.flow)[:, 0]
    assert (flow0[1:] > 0).all()
    # draining: stage strictly decreases after the bootstrap level
    assert (np.diff(stages[1:]) < 0).all(), stages[1:]
    # mass conservation: SA * dY == -avg outflow volume per level (k >= 2)
    vol = 0.5 * (flow0[1:-1] + flow0[2:]) * dt
    np.testing.assert_allclose(SA * -np.diff(stages[1:]), vol, rtol=1e-8)
    # entrance-loss sign: channel surface at node 0 <= reservoir stage
    surf0 = np.asarray(out.depth)[1:, 0] + float(z[0])
    assert (surf0 <= stages[1:] + 1e-9).all()


def test_storage_bracket_saturation_raises():
    """mass_balance clamps to solution_boundaries in-graph; the solver
    surface must raise like the reference's brentq when the stage hits the
    bracket (ValueError 'f(a) and f(b) must have different signs')."""
    from flowsim_tpu.api import (Boundary, Channel, Hydrograph, LumpedStorage,
                                 PreissmannSolver)

    us = Boundary(condition="flow_hydrograph", bed_level=5, chainage=0,
                  hydrograph=Hydrograph(function=lambda t: 5000.0))
    ds = Boundary(condition="fixed_depth", initial_depth=5, bed_level=0,
                  chainage=20000)
    # tiny reservoir + bracket: 5000 m3/s into 1e4 m2 = +0.5 m stage/s —
    # blows past y_max = 9 within the first level
    ds.set_lumped_storage(LumpedStorage(surface_area=1e4, min_stage=0.0,
                                        solution_boundaries=(0.0, 9.0)))
    channel = Channel(width=250, initial_flow=5000.0, roughness=0.027,
                      upstream_boundary=us, downstream_boundary=ds)
    solver = PreissmannSolver(channel=channel, theta=0.8, time_step=3600,
                              spatial_step=1000, simulation_time=4 * 3600)
    with pytest.raises(ValueError, match="solution_boundaries"):
        solver.run(verbose=0, tolerance=1e-6)


def test_rating_curve_general_degree_fit():
    """degree != 2 polynomial fits (the reference's scale=True path accepts
    any degree, ref rating_curve.py:84,101-105) evaluate on device via the
    poly_n kind: discharge/dQ_dz/inverse parity vs the live reference."""
    import_reference()
    from src.hydromodel.rating_curve import RatingCurve as RRC

    from flowsim_tpu.api import RatingCurve

    rng = np.random.default_rng(1)
    stages = np.linspace(480, 492, 17)
    x = stages - 470
    discharges = 0.08 * x**3 + 1.1 * x**2 + 20 * x + 150 + rng.normal(0, 3, 17)

    for deg in (3, 4):
        ref = RRC()
        ref.fit(discharges=discharges, stages=stages, stage_shift=0,
                type="polynomial", scale=True, degree=deg)
        ours = RatingCurve()
        ours.fit(discharges=discharges, stages=stages, stage_shift=0,
                 type="polynomial", degree=deg)
        assert ours.params.kind == "poly_n"
        for s in (481.0, 486.5, 491.0):
            np.testing.assert_allclose(ours.discharge(s), ref.discharge(s),
                                       rtol=1e-8)
            np.testing.assert_allclose(ours.dQ_dz(s), ref.dQ_dz(s), rtol=1e-6)
        # Newton inverse round-trips through the general evaluation
        q = ref.discharge(487.0)
        np.testing.assert_allclose(ours.stage(q, trial_stage=485.0), 487.0,
                                   atol=1e-4)


def test_poly_n_downstream_bc_runs():
    """A cubic rating curve as the downstream BC: the XLA solver consumes
    the poly_n kind through the generic discharge/dQ_dz path."""
    import jax
    import jax.numpy as jnp

    from flowsim_tpu.geometry import TrapezoidGeometry
    from flowsim_tpu.ops import boundary as bnd
    from flowsim_tpu.ops import initial_conditions as ic
    from flowsim_tpu.ops import preissmann as prs
    from flowsim_tpu.ops import rating_curve as rcurve
    from flowsim_tpu.ops import sections as sec

    n, slope, dx = 16, 6e-4, 1000.0
    z = np.linspace(slope * (n - 1) * dx, 0.0, n)
    ones, zeros = np.ones(n), np.zeros(n)
    geo = TrapezoidGeometry(
        z_bed=jnp.asarray(z), b_main=jnp.asarray(100.0 * ones),
        m_main=jnp.asarray(zeros), n_main=jnp.asarray(0.025 * ones),
        compound=jnp.asarray(np.zeros(n, bool)), h_bank=jnp.asarray(1e30 * ones),
        b_fp_left=jnp.asarray(zeros), b_fp_right=jnp.asarray(zeros),
        m_fp=jnp.asarray(zeros), n_left=jnp.asarray(0.025 * ones),
        n_right=jnp.asarray(0.025 * ones), bed_slope=jnp.asarray(slope * ones),
        curvature=jnp.asarray(zeros))
    h0, Q0 = ic.initial_conditions(geo, "steady-state", 300.0, dx)
    # cubic through the section's own normal-flow curve -> consistent BC
    geo_ds = jax.tree_util.tree_map(lambda a: a[-1:], geo)
    depths = np.array([1.0, 2.0, 4.0, 6.0])
    qn = np.array([float(sec.normal_flow(geo_ds, jnp.asarray([d]))[0]) for d in depths])
    coef = np.polynomial.polynomial.polyfit(depths, qn, 3)
    rc = rcurve.make_polynomial_general(coef, stage_shift=-float(z[-1]))
    nt = 9
    us = bnd.make_boundary("flow_hydrograph", bed_level=float(z[0]),
                           target_series=np.full(nt, 300.0))
    ds = bnd.make_boundary("rating_curve", bed_level=float(z[-1]), rating=rc)
    sset = prs.PreissmannSettings(theta=0.6, time_step=1800.0, spatial_step=dx,
                                  n_time_levels=nt, tolerance=1e-9, max_iter=60)
    out = prs.simulate(geo, us, ds, h0, Q0, sset)
    assert bool(np.asarray(out.converged).all())
    # the converged ds node satisfies Q = rc(stage)
    hN = np.asarray(out.depth)[-1, -1]
    qN = np.asarray(out.flow)[-1, -1]
    q_rc = float(rcurve.discharge(rc, jnp.asarray(float(z[-1]) + hN)))
    np.testing.assert_allclose(qN, q_rc, rtol=1e-7)
