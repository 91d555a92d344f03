"""Channel-axis domain decomposition: sharded == single-device to roundoff."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from flowsim_tpu.api import Boundary, Channel, Hydrograph, PreissmannSolver
from flowsim_tpu.ops import preissmann as prs
from flowsim_tpu.parallel.domain import simulate_sharded
from flowsim_tpu.parallel.mesh import SPACE_AXIS, make_mesh


def build_case(n_nodes=64, simulation_hours=12, storage=False):
    """Prismatic test reach sized so n_nodes divides the 8-device mesh."""
    length = (n_nodes - 1) * 1000.0

    def hyd_fn(t):
        peak_t = 4 * 3600.0
        base, peak = 300.0, 3000.0
        if t <= 0:
            return base
        if t < peak_t:
            return base + (peak - base) * t / peak_t
        if t < 2 * peak_t:
            return peak - (peak - base) * (t - peak_t) / peak_t
        return base

    us = Boundary(condition="flow_hydrograph", bed_level=length * 2e-4, chainage=0,
                  hydrograph=Hydrograph(function=hyd_fn))
    if storage:
        from flowsim_tpu.api import LumpedStorage

        ds = Boundary(condition="fixed_depth", initial_depth=4.0, bed_level=0.0, chainage=length)
        ds.set_lumped_storage(LumpedStorage(surface_area=4000 * 200, min_stage=3,
                                            solution_boundaries=(0, 200)))
        method = "GVF_equation"
    else:
        ds = Boundary(condition="normal_depth", bed_level=0.0, chainage=length)
        method = "steady-state"
    channel = Channel(width=200.0, initial_flow=300.0, roughness=0.03,
                      upstream_boundary=us, downstream_boundary=ds,
                      interpolation_method=method)
    solver = PreissmannSolver(channel=channel, theta=0.7, time_step=900,
                              spatial_step=1000, simulation_time=simulation_hours * 3600)
    assert solver.number_of_nodes == n_nodes
    return solver


@pytest.mark.parametrize("storage", [False, True])
def test_sharded_matches_single_device(storage):
    solver = build_case(n_nodes=64, storage=storage)
    sset = solver.settings(tolerance=1e-10, max_iter=100)
    geo = solver.channel.geometry

    ref = prs.simulate(geo, solver.us_params, solver.ds_params, solver.h0, solver.Q0, sset)

    mesh = make_mesh(n_ensemble=1, n_space=8)
    out = simulate_sharded(geo, solver.us_params, solver.ds_params,
                           solver.h0, solver.Q0, sset, mesh)

    assert bool(out.converged.all())
    np.testing.assert_allclose(np.asarray(out.depth), np.asarray(ref.depth), rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(np.asarray(out.flow), np.asarray(ref.flow), rtol=1e-9, atol=1e-8)
    np.testing.assert_array_equal(np.asarray(out.iterations), np.asarray(ref.iterations))
    if storage:
        np.testing.assert_allclose(np.asarray(out.reservoir_stage[1:]),
                                   np.asarray(ref.reservoir_stage[1:]), rtol=1e-9)


@pytest.mark.parametrize("n_space", [2, 4])
def test_various_shard_counts(n_space):
    solver = build_case(n_nodes=64)
    sset = solver.settings(tolerance=1e-8, max_iter=100)
    geo = solver.channel.geometry
    ref = prs.simulate(geo, solver.us_params, solver.ds_params, solver.h0, solver.Q0, sset)
    mesh = make_mesh(n_ensemble=8 // n_space, n_space=n_space)
    out = simulate_sharded(geo, solver.us_params, solver.ds_params,
                           solver.h0, solver.Q0, sset, mesh)
    np.testing.assert_allclose(np.asarray(out.depth), np.asarray(ref.depth), rtol=1e-8, atol=1e-10)


def test_sharded_upstream_storage_matches_single_device():
    """Upstream fixed_depth + lumped storage: the sharded assemble must fall
    back to the FIRST shard's reservoir stage (the single-device assemble
    uses us.reservoir_stage when ds has none) — without it the run is NaN
    from level 2."""
    from flowsim_tpu.ops import boundary as bnd
    from flowsim_tpu.ops import initial_conditions as ic
    from flowsim_tpu.ops import storage as stg

    n, slope, dx, dt, nt = 64, 6e-4, 1000.0, 3600.0, 13
    z = np.linspace(slope * (n - 1) * dx, 0.0, n)
    from flowsim_tpu.geometry import TrapezoidGeometry
    ones, zeros = np.ones(n), np.zeros(n)
    geo = TrapezoidGeometry(
        z_bed=jnp.asarray(z), b_main=jnp.asarray(150.0 * ones),
        m_main=jnp.asarray(zeros), n_main=jnp.asarray(0.025 * ones),
        compound=jnp.asarray(np.zeros(n, bool)), h_bank=jnp.asarray(1e30 * ones),
        b_fp_left=jnp.asarray(zeros), b_fp_right=jnp.asarray(zeros),
        m_fp=jnp.asarray(zeros), n_left=jnp.asarray(0.025 * ones),
        n_right=jnp.asarray(0.025 * ones), bed_slope=jnp.asarray(slope * ones),
        curvature=jnp.asarray(zeros))
    bed_us, bed_ds = float(z[0]), float(z[-1])
    stage_pool = bed_us + 3.0
    h0 = jnp.asarray(stage_pool - z)
    Q0 = jnp.zeros(n, h0.dtype)
    us = bnd.make_boundary(
        "fixed_depth", bed_level=bed_us,
        storage=stg.make_storage(surface_area=6.0e6, min_stage=bed_us - 1.0))
    ds = bnd.make_boundary(
        "stage_hydrograph", bed_level=bed_ds,
        target_series=stage_pool + 0.05 * np.sin(np.linspace(0, np.pi, nt)))
    sset = prs.PreissmannSettings(theta=0.6, time_step=dt, spatial_step=dx,
                                  n_time_levels=nt, tolerance=1e-9, max_iter=100)

    ref = prs.simulate(geo, us, ds, h0, Q0, sset)
    assert np.isfinite(np.asarray(ref.depth)).all()

    mesh = make_mesh(n_ensemble=1, n_space=8)
    out = simulate_sharded(geo, us, ds, h0, Q0, sset, mesh)
    assert np.isfinite(np.asarray(out.depth)).all()
    np.testing.assert_allclose(np.asarray(out.depth), np.asarray(ref.depth),
                               rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(np.asarray(out.reservoir_stage[1:]),
                               np.asarray(ref.reservoir_stage[1:]), rtol=1e-9)


def test_sharded_store_boundaries():
    """settings.store='boundaries' is honored by the sharded paths: outputs
    come back [nt, 2] ([B, nt, 2] for the ensemble) matching the full run's
    boundary columns."""
    import dataclasses

    from flowsim_tpu.parallel.domain import simulate_sharded_ensemble
    from flowsim_tpu.parallel.ensemble import roughness_ensemble

    solver = build_case(n_nodes=64)
    sset = solver.settings(tolerance=1e-9, max_iter=100)
    sset_b = dataclasses.replace(sset, store="boundaries")
    geo = solver.channel.geometry
    nt = sset.n_time_levels

    mesh = make_mesh(n_ensemble=1, n_space=8)
    full = simulate_sharded(geo, solver.us_params, solver.ds_params,
                            solver.h0, solver.Q0, sset, mesh)
    out = simulate_sharded(geo, solver.us_params, solver.ds_params,
                           solver.h0, solver.Q0, sset_b, mesh)
    assert out.depth.shape == (nt, 2)
    np.testing.assert_array_equal(np.asarray(out.depth),
                                  np.asarray(full.depth)[:, [0, -1]])
    np.testing.assert_array_equal(np.asarray(out.flow),
                                  np.asarray(full.flow)[:, [0, -1]])

    n_vals = np.array([0.026, 0.034])
    geo_b = roughness_ensemble(geo, n_vals)
    B = len(n_vals)
    h0b = jnp.broadcast_to(solver.h0, (B,) + solver.h0.shape)
    Q0b = jnp.broadcast_to(solver.Q0, (B,) + solver.Q0.shape)
    mesh2 = make_mesh(n_ensemble=2, n_space=4)
    oute = simulate_sharded_ensemble(geo_b, solver.us_params, solver.ds_params,
                                     h0b, Q0b, sset_b, mesh2)
    assert oute.depth.shape == (B, nt, 2)
    fulle = simulate_sharded_ensemble(geo_b, solver.us_params, solver.ds_params,
                                      h0b, Q0b, sset, mesh2)
    np.testing.assert_array_equal(np.asarray(oute.depth),
                                  np.asarray(fulle.depth)[:, :, [0, -1]])
    # gate_open is the real carried series, not fabricated zeros: with no
    # gated curve and gate_initially_open defaulting False it is all zeros
    # here, but it must be the scan's state (same dtype/shape as single-run)
    assert oute.gate_open.shape == (B, nt)


def test_indivisible_raises():
    solver = build_case(n_nodes=64)
    sset = solver.settings(tolerance=1e-8, max_iter=50)
    mesh = make_mesh(n_ensemble=1, n_space=8)
    geo = jax.tree_util.tree_map(lambda a: a[:63], solver.channel.geometry)
    with pytest.raises(ValueError, match="divisible"):
        simulate_sharded(geo, solver.us_params, solver.ds_params,
                         solver.h0[:63], solver.Q0[:63], sset, mesh)


def test_ensemble_times_space_mesh():
    """Scenario batch on the ensemble axis x domain decomposition on the
    space axis (full 2-D mesh) == serial per-member simulation."""
    from flowsim_tpu.parallel.domain import simulate_sharded_ensemble
    from flowsim_tpu.parallel.ensemble import roughness_ensemble

    solver = build_case(n_nodes=64)
    sset = solver.settings(tolerance=1e-9, max_iter=100)
    geo = solver.channel.geometry
    n_vals = np.array([0.024, 0.028, 0.032, 0.036])
    geo_b = roughness_ensemble(geo, n_vals)
    B = len(n_vals)
    h0b = jnp.broadcast_to(solver.h0, (B,) + solver.h0.shape)
    Q0b = jnp.broadcast_to(solver.Q0, (B,) + solver.Q0.shape)

    mesh = make_mesh(n_ensemble=2, n_space=4)
    out = simulate_sharded_ensemble(geo_b, solver.us_params, solver.ds_params,
                                    h0b, Q0b, sset, mesh)
    assert bool(np.asarray(out.converged).all())

    import dataclasses
    for j, n in enumerate(n_vals):
        g = dataclasses.replace(geo, n_main=jnp.full_like(geo.n_main, n))
        ref = prs.simulate(g, solver.us_params, solver.ds_params, solver.h0, solver.Q0, sset)
        np.testing.assert_allclose(np.asarray(out.depth[j]), np.asarray(ref.depth),
                                   rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(np.asarray(out.flow[j]), np.asarray(ref.flow),
                                   rtol=1e-8, atol=1e-7)


def test_network_sharded_long_branch():
    """Space-sharded NETWORK (parallel/network_domain.py): a long main stem
    with a short tributary, main stem decomposed over the space axis, must
    match the single-device loop engine to solver roundoff — including the
    junction trajectory."""
    import dataclasses

    from flowsim_tpu.ops import boundary as bnd_m
    from flowsim_tpu.ops import initial_conditions as ic
    from flowsim_tpu.ops.network import BranchDef, simulate_network
    from flowsim_tpu.parallel.network_domain import simulate_network_sharded
    from tests.helpers import prismatic as _prismatic

    slope, dx, dt, nt = 6e-4, 1000.0, 1800.0, 9
    main = _prismatic(n=48, slope=slope)      # split 17 + 32 (shared node)
    z = np.asarray(main.z_bed)
    sl = lambda s: jax.tree_util.tree_map(lambda x: x[s], main)
    h0, Q0 = ic.initial_conditions(main, "steady-state", 150.0, dx)
    times = np.arange(nt, dtype=np.float64)
    flood = 150.0 + 60.0 * np.exp(-((times - 3.0) / 2.0) ** 2)
    us_q = bnd_m.make_boundary("flow_hydrograph", bed_level=float(z[0]),
                               target_series=flood)
    ds_n = bnd_m.make_boundary("normal_depth", bed_level=float(z[-1]),
                               bed_slope=slope)
    trib = _prismatic(n=9, slope=slope, width=60.0)
    # tributary joins at the stem's node 16: shift its bed to match
    zt = np.asarray(trib.z_bed) - np.asarray(trib.z_bed)[-1] + z[16]
    trib = dataclasses.replace(trib, z_bed=jnp.asarray(zt))
    ht, Qt = ic.initial_conditions(trib, "steady-state", 40.0, dx)
    us_t = bnd_m.make_boundary(
        "flow_hydrograph", bed_level=float(zt[0]),
        target_series=np.full(nt, 40.0))
    sset = prs.PreissmannSettings(theta=0.6, time_step=dt, spatial_step=dx,
                                  n_time_levels=nt, tolerance=1e-8,
                                  max_iter=100)
    branches = [
        BranchDef(geo=sl(slice(0, 17)), dx=dx, us=us_q, ds=0,
                  h0=h0[:17], Q0=Q0[:17]),
        BranchDef(geo=trib, dx=dx, us=us_t, ds=0, h0=ht, Q0=Qt),
        # the long lower stem: 32 nodes, sharded over space
        BranchDef(geo=sl(slice(16, None)), dx=dx, us=0, ds=ds_n,
                  h0=h0[16:], Q0=Q0[16:]),
    ]
    ref = simulate_network(branches, 1, sset, engine="loop")
    for n_space in (2, 4):
        mesh = make_mesh(n_ensemble=8 // n_space, n_space=n_space)
        out = simulate_network_sharded(branches, 1, sset, mesh,
                                       long_branch=2)
        assert bool(np.asarray(out.converged).all())
        np.testing.assert_array_equal(np.asarray(out.iterations),
                                      np.asarray(ref.iterations))
        for b in range(3):
            assert np.abs(np.asarray(out.depth[b])
                          - np.asarray(ref.depth[b])).max() < 1e-9
        assert np.abs(np.asarray(out.junction_stage)
                      - np.asarray(ref.junction_stage)).max() < 1e-9


def test_network_sharded_dam_junction():
    """Space-sharded network with a junction RESERVOIR + rated outflow
    (the [J]-scalar junction physics is replicated per shard)."""
    import dataclasses

    from flowsim_tpu.ops import boundary as bnd_m
    from flowsim_tpu.ops import initial_conditions as ic
    from flowsim_tpu.ops import rating_curve as rcurve
    from flowsim_tpu.ops.network import BranchDef, simulate_network
    from flowsim_tpu.parallel.network_domain import simulate_network_sharded
    from tests.helpers import prismatic as _prismatic

    slope, dx, dt, nt = 6e-4, 1000.0, 1800.0, 7
    main = _prismatic(n=40, slope=slope)
    z = np.asarray(main.z_bed)
    sl = lambda s: jax.tree_util.tree_map(lambda x: x[s], main)
    h0, Q0 = ic.initial_conditions(main, "steady-state", 150.0, dx)
    times = np.arange(nt, dtype=np.float64)
    flood = 150.0 + 60.0 * np.exp(-((times - 3.0) / 2.0) ** 2)
    us_q = bnd_m.make_boundary("flow_hydrograph", bed_level=float(z[0]),
                               target_series=flood)
    ds_n = bnd_m.make_boundary("normal_depth", bed_level=float(z[-1]),
                               bed_slope=slope)
    sset = prs.PreissmannSettings(theta=0.6, time_step=dt, spatial_step=dx,
                                  n_time_levels=nt, tolerance=1e-8,
                                  max_iter=100)
    branches = [
        BranchDef(geo=sl(slice(0, 9)), dx=dx, us=us_q, ds=0,
                  h0=h0[:9], Q0=Q0[:9]),
        BranchDef(geo=sl(slice(8, None)), dx=dx, us=0, ds=ds_n,
                  h0=h0[8:], Q0=Q0[8:]),  # 32 nodes, sharded
    ]
    Yj = float(z[8] + h0[8])
    rc = rcurve.make_polynomial(0.0, 30.0, -30.0 * Yj + 15.0)
    kw = dict(junction_area=[5e5], junction_rating=[rc])
    ref = simulate_network(branches, 1, sset, engine="loop", **kw)
    mesh = make_mesh(n_ensemble=4, n_space=2)
    out = simulate_network_sharded(branches, 1, sset, mesh, long_branch=1,
                                   **kw)
    assert bool(np.asarray(out.converged).all())
    np.testing.assert_array_equal(np.asarray(out.iterations),
                                  np.asarray(ref.iterations))
    assert np.abs(np.asarray(out.junction_stage)
                  - np.asarray(ref.junction_stage)).max() < 1e-9
    np.testing.assert_allclose(np.asarray(out.junction_outflow),
                               np.asarray(ref.junction_outflow), atol=1e-7)


def test_network_sharded_multiple_branches():
    """Round-5: SEVERAL branches sharded over one space axis
    (sharded_branches=[0, 1]) — a Y-network whose two long arms are both
    domain-decomposed must match the single-device loop engine to solver
    roundoff."""
    import dataclasses

    from flowsim_tpu.ops import boundary as bnd_m
    from flowsim_tpu.ops import initial_conditions as ic
    from flowsim_tpu.ops.network import BranchDef, simulate_network
    from flowsim_tpu.parallel.network_domain import simulate_network_sharded
    from tests.helpers import prismatic as _prismatic

    slope, dx, dt, nt = 6e-4, 1000.0, 1800.0, 7
    arm = _prismatic(n=32, slope=slope)
    z_a = np.asarray(arm.z_bed)
    h0a, Q0a = ic.initial_conditions(arm, "steady-state", 150.0, dx)
    times = np.arange(nt, dtype=np.float64)
    flood = 150.0 + 60.0 * np.exp(-((times - 3.0) / 2.0) ** 2)
    us_q = bnd_m.make_boundary("flow_hydrograph", bed_level=float(z_a[0]),
                               target_series=flood)
    arm2 = _prismatic(n=32, slope=slope, width=90.0)
    z2 = np.asarray(arm2.z_bed) - np.asarray(arm2.z_bed)[-1] + z_a[-1]
    arm2 = dataclasses.replace(arm2, z_bed=jnp.asarray(z2))
    h0b, Q0b = ic.initial_conditions(arm2, "steady-state", 80.0, dx)
    us_b = bnd_m.make_boundary("flow_hydrograph", bed_level=float(z2[0]),
                               target_series=np.full(nt, 80.0))
    outlet = _prismatic(n=16, slope=slope, width=150.0)
    z_o = np.asarray(outlet.z_bed) - np.asarray(outlet.z_bed)[0] + z_a[-1]
    outlet = dataclasses.replace(outlet, z_bed=jnp.asarray(z_o))
    h0o, Q0o = ic.initial_conditions(outlet, "steady-state", 230.0, dx)
    ds_n = bnd_m.make_boundary("normal_depth", bed_level=float(z_o[-1]),
                               bed_slope=slope)
    sset = prs.PreissmannSettings(theta=0.6, time_step=dt, spatial_step=dx,
                                  n_time_levels=nt, tolerance=1e-8,
                                  max_iter=100)
    branches = [
        BranchDef(geo=arm, dx=dx, us=us_q, ds=0, h0=h0a, Q0=Q0a),
        BranchDef(geo=arm2, dx=dx, us=us_b, ds=0, h0=h0b, Q0=Q0b),
        BranchDef(geo=outlet, dx=dx, us=0, ds=ds_n, h0=h0o, Q0=Q0o),
    ]
    ref = simulate_network(branches, 1, sset, engine="loop")
    for n_space in (2, 4):
        mesh = make_mesh(n_ensemble=8 // n_space, n_space=n_space)
        out = simulate_network_sharded(branches, 1, sset, mesh,
                                       sharded_branches=[0, 1])
        assert bool(np.asarray(out.converged).all())
        np.testing.assert_array_equal(np.asarray(out.iterations),
                                      np.asarray(ref.iterations))
        for b in range(3):
            assert np.abs(np.asarray(out.depth[b])
                          - np.asarray(ref.depth[b])).max() < 1e-9
        assert np.abs(np.asarray(out.junction_stage)
                      - np.asarray(ref.junction_stage)).max() < 1e-9
