"""Per-member boundary forcing in ensembles (round-1 VERDICT gap #3).

BASELINE.md's Monte-Carlo target is "10^4 roughness/inflow scenarios": members
must be able to differ in inflow hydrograph and rating/storage parameters,
not just geometry.  The reference runs these serially, one full re-simulation
per member (ref n_calibrate.py:58-62).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from flowsim_tpu.api import Boundary, Channel, Hydrograph, PreissmannSolver, RatingCurve
from flowsim_tpu.ops import preissmann as prs
from flowsim_tpu.ops import rating_curve as rcurve
from flowsim_tpu.parallel.ensemble import (
    batch_boundaries,
    batched_simulate,
    roughness_ensemble,
)
from flowsim_tpu.parallel.mesh import make_mesh


def _build(n_nodes=32, hours=8, peak=2500.0, rc_b=150.0):
    length = (n_nodes - 1) * 1000.0
    bed_ds = 0.0
    pivot = bed_ds + 4.0

    def hyd_fn(t):
        return 500.0 + (peak - 500.0) * min(t / (4 * 3600.0), 1.0)

    us = Boundary(condition="flow_hydrograph", bed_level=length * 2e-4, chainage=0,
                  hydrograph=Hydrograph(function=hyd_fn))
    rc = RatingCurve(rcurve.make_polynomial(0.0, rc_b, 500.0 - rc_b * pivot))
    ds = Boundary(condition="rating_curve", bed_level=bed_ds, chainage=length,
                  initial_depth=4.0, rating_curve=rc)
    ch = Channel(width=200.0, initial_flow=500.0, roughness=0.03,
                 upstream_boundary=us, downstream_boundary=ds,
                 interpolation_method="GVF_equation")
    return PreissmannSolver(channel=ch, theta=0.7, time_step=900,
                            spatial_step=1000, simulation_time=hours * 3600)


def test_per_member_inflow_and_rating_matches_serial():
    peaks = [1800.0, 2500.0, 3200.0, 4000.0]
    rc_bs = [120.0, 150.0, 180.0, 210.0]
    ns = [0.026, 0.030, 0.034, 0.038]
    solvers = [_build(peak=p, rc_b=b) for p, b in zip(peaks, rc_bs)]
    sset = solvers[0].settings(tolerance=1e-8, max_iter=100)

    # serial truth: one full simulation per member with its own n
    serial = []
    for s, n in zip(solvers, ns):
        import dataclasses

        geo = dataclasses.replace(
            s.channel.geometry,
            n_main=jnp.full_like(s.channel.geometry.n_main, n),
        )
        serial.append(prs.simulate(geo, s.us_params, s.ds_params, s.h0, s.Q0, sset))

    # batched: stacked geometry + per-member us/ds params
    geo_b = roughness_ensemble(solvers[0].channel.geometry, ns)
    us_b, us_ax = batch_boundaries([s.us_params for s in solvers])
    ds_b, ds_ax = batch_boundaries([s.ds_params for s in solvers])
    h0 = jnp.stack([s.h0 for s in solvers])
    Q0 = jnp.stack([s.Q0 for s in solvers])
    out = batched_simulate(geo_b, us_b, ds_b, h0, Q0, sset,
                           shard=False, us_axes=us_ax, ds_axes=ds_ax)

    for i, ref in enumerate(serial):
        np.testing.assert_allclose(np.asarray(out.depth[i]), np.asarray(ref.depth),
                                   rtol=1e-10, atol=1e-12, err_msg=f"member {i}")
        np.testing.assert_allclose(np.asarray(out.flow[i]), np.asarray(ref.flow),
                                   rtol=1e-10, atol=1e-9, err_msg=f"member {i}")


def test_per_member_storage_matches_serial():
    """fixed_depth + lumped storage with per-member surface areas."""
    from flowsim_tpu.api import LumpedStorage

    def build(area):
        length = 20000.0

        def hyd_fn(t):
            return 1000.0 + 9000.0 * min(t / (4 * 3600.0), 1.0)

        us = Boundary(condition="flow_hydrograph", bed_level=5, chainage=0,
                      hydrograph=Hydrograph(function=hyd_fn))
        ds = Boundary(condition="fixed_depth", initial_depth=5, bed_level=0, chainage=length)
        ds.set_lumped_storage(LumpedStorage(surface_area=area, min_stage=5,
                                            solution_boundaries=(0, 200)))
        ch = Channel(width=250, initial_flow=1000.0, roughness=0.027,
                     upstream_boundary=us, downstream_boundary=ds)
        return PreissmannSolver(channel=ch, theta=0.8, time_step=3600,
                                spatial_step=1000, simulation_time=12 * 3600)

    areas = [4000 * 250.0, 5000 * 250.0, 8000 * 250.0]
    solvers = [build(a) for a in areas]
    sset = solvers[0].settings(tolerance=1e-8, max_iter=100)

    serial = [prs.simulate(s.channel.geometry, s.us_params, s.ds_params,
                           s.h0, s.Q0, sset) for s in solvers]

    from flowsim_tpu.parallel.ensemble import stack_geometries

    geo_b = stack_geometries([s.channel.geometry for s in solvers])
    us_b, us_ax = batch_boundaries([s.us_params for s in solvers])
    ds_b, ds_ax = batch_boundaries([s.ds_params for s in solvers])
    h0 = jnp.stack([s.h0 for s in solvers])
    Q0 = jnp.stack([s.Q0 for s in solvers])
    out = batched_simulate(geo_b, us_b, ds_b, h0, Q0, sset,
                           shard=False, us_axes=us_ax, ds_axes=ds_ax)

    for i, ref in enumerate(serial):
        np.testing.assert_allclose(np.asarray(out.reservoir_stage[i]),
                                   np.asarray(ref.reservoir_stage),
                                   rtol=1e-10, err_msg=f"member {i}")
        np.testing.assert_allclose(np.asarray(out.flow[i]), np.asarray(ref.flow),
                                   rtol=1e-9, atol=1e-7, err_msg=f"member {i}")


def test_table_geometry_ensemble_matches_serial():
    """Batched irregular (TableGeometry) members: per-member roughness via the
    exact conveyance rescale + per-member inflow, vs one serial run each."""
    from flowsim_tpu.geometry_tables import IrregularStation, build_table_geometry
    from flowsim_tpu.ops import boundary as bnd
    from flowsim_tpu.ops import initial_conditions as ic
    from flowsim_tpu.parallel.ensemble import table_roughness_ensemble

    length = 6000.0
    slope = 2e-4
    rng = np.random.default_rng(7)
    x = np.linspace(0, 240, 19)

    def station(z0):
        z = z0 + 7.0 * ((x - 120) / 120) ** 2 + rng.uniform(0, 0.4, x.size)
        return IrregularStation(x=x, z=z, n_main=0.03, bed_slope=slope)

    sts = [station(slope * length), station(0.0)]
    node_ch = np.linspace(0, length, 7)
    geo = build_table_geometry(sts, [0.0, length], node_ch, samples=800)

    n_levels = 9
    times = np.arange(n_levels) * 1800.0
    sset = prs.PreissmannSettings(theta=0.7, time_step=1800.0, spatial_step=1000.0,
                                  n_time_levels=n_levels, tolerance=1e-8, max_iter=100)
    h0, Q0 = ic.initial_conditions(geo, "steady-state", 400.0, 1000.0)
    ds_p = bnd.make_boundary("normal_depth", bed_level=float(geo.z_bed[-1]),
                             bed_slope=float(geo.bed_slope[-1]))

    ns = [0.024, 0.030, 0.037]
    peaks = [800.0, 1000.0, 1300.0]
    us_list = [
        bnd.make_boundary(
            "flow_hydrograph", bed_level=float(geo.z_bed[0]),
            target_series=[400.0 + (p - 400.0) * min(t / (3 * 3600.0), 1.0) for t in times])
        for p in peaks
    ]

    # serial truth: rescaled tables per member (same transform, unbatched)
    serial = []
    for n, us_p in zip(ns, us_list):
        geo_n = jax.tree_util.tree_map(
            lambda a: a[0], table_roughness_ensemble(geo, [n], 0.03))
        serial.append(prs.simulate(geo_n, us_p, ds_p, h0, Q0, sset))

    geo_b = table_roughness_ensemble(geo, ns, 0.03)
    us_b, us_ax = batch_boundaries(us_list)
    out = batched_simulate(geo_b, us_b, ds_p, h0, Q0, sset,
                           shard=False, us_axes=us_ax)

    assert bool(np.asarray(out.converged).all())
    for i, ref in enumerate(serial):
        np.testing.assert_allclose(np.asarray(out.depth[i]), np.asarray(ref.depth),
                                   rtol=1e-10, atol=1e-12, err_msg=f"member {i}")
        np.testing.assert_allclose(np.asarray(out.flow[i]), np.asarray(ref.flow),
                                   rtol=1e-10, atol=1e-9, err_msg=f"member {i}")
    # members genuinely differ (roughness moves the steady profile)
    assert np.abs(np.asarray(out.depth[0]) - np.asarray(out.depth[2])).max() > 1e-3


def test_table_roughness_ensemble_n_ref_anchor():
    """build_table_geometry records the baked Manning n; the ensemble
    rescale defaults to it and rejects a mismatched explicit n_base."""
    import pytest
    from flowsim_tpu.geometry_tables import IrregularStation, build_table_geometry
    from flowsim_tpu.parallel.ensemble import table_roughness_ensemble

    x = np.linspace(0, 100, 9)
    z = 5.0 * ((x - 50) / 50) ** 2
    sts = [IrregularStation(x=x, z=z + 1.0, n_main=0.03, bed_slope=1e-4),
           IrregularStation(x=x, z=z, n_main=0.03, bed_slope=1e-4)]
    geo = build_table_geometry(sts, [0.0, 1e4], np.linspace(0, 1e4, 5),
                               samples=64)
    assert geo.n_ref == 0.03

    # default anchor == explicit correct anchor
    a = table_roughness_ensemble(geo, [0.024, 0.036])
    b = table_roughness_ensemble(geo, [0.024, 0.036], 0.03)
    for la, lb in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        assert np.array_equal(np.asarray(la), np.asarray(lb))
    # rescaled batch has no single baked n — anchor cleared
    assert a.n_ref is None

    with pytest.raises(ValueError, match="does not match"):
        table_roughness_ensemble(geo, [0.024], 0.035)

    # stations with differing n_main: no recorded anchor, explicit required
    sts2 = [IrregularStation(x=x, z=z + 1.0, n_main=0.03, bed_slope=1e-4),
            IrregularStation(x=x, z=z, n_main=0.04, bed_slope=1e-4)]
    geo2 = build_table_geometry(sts2, [0.0, 1e4], np.linspace(0, 1e4, 5),
                                samples=64)
    assert geo2.n_ref is None
    with pytest.raises(ValueError, match="pass n_base"):
        table_roughness_ensemble(geo2, [0.024])


def test_sharded_ensemble_per_member_inflow():
    """Per-member BCs through the 2-D ensemble x space mesh."""
    from flowsim_tpu.parallel.domain import simulate_sharded_ensemble

    peaks = [1800.0, 2500.0, 3200.0, 4000.0]
    solvers = [_build(peak=p) for p in peaks]
    sset = solvers[0].settings(tolerance=1e-8, max_iter=100)

    geo0 = solvers[0].channel.geometry
    from flowsim_tpu.parallel.ensemble import stack_geometries

    geo_b = stack_geometries([geo0] * len(peaks))
    us_b, us_ax = batch_boundaries([s.us_params for s in solvers])
    ds_b, ds_ax = batch_boundaries([s.ds_params for s in solvers])
    h0 = jnp.stack([s.h0 for s in solvers])
    Q0 = jnp.stack([s.Q0 for s in solvers])

    ref = batched_simulate(geo_b, us_b, ds_b, h0, Q0, sset,
                           shard=False, us_axes=us_ax, ds_axes=ds_ax)

    mesh = make_mesh(n_ensemble=2, n_space=4)
    out = simulate_sharded_ensemble(geo_b, us_b, ds_b, h0, Q0, sset, mesh,
                                    us_axes=us_ax, ds_axes=ds_ax)
    np.testing.assert_allclose(np.asarray(out.depth), np.asarray(ref.depth),
                               rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(np.asarray(out.flow), np.asarray(ref.flow),
                               rtol=1e-8, atol=1e-6)


def test_chunked_batch_matches_monolithic():
    """chunk_size splits the batch into sequential vmapped chunks inside one
    jit (lax.map); results must be bitwise identical to the monolithic vmap."""
    from flowsim_tpu.models import long_reach
    from flowsim_tpu.parallel.ensemble import batched_simulate, roughness_ensemble

    geo, us, ds, h0, Q0, sset = long_reach.build(64, levels=4, dtype=np.float32,
                                                 linear_solver="pcr")
    n_vals = np.linspace(0.02, 0.06, 32).astype(np.float32)
    gb = roughness_ensemble(geo, n_vals)
    full = batched_simulate(gb, us, ds, h0, Q0, sset, shard=False)
    chunked = batched_simulate(gb, us, ds, h0, Q0, sset, shard=False, chunk_size=8)
    assert np.abs(np.asarray(full.depth) - np.asarray(chunked.depth)).max() == 0.0
    assert np.abs(np.asarray(full.flow) - np.asarray(chunked.flow)).max() == 0.0
    assert (np.asarray(full.iterations) == np.asarray(chunked.iterations)).all()

    with pytest.raises(ValueError, match="not divisible"):
        batched_simulate(gb, us, ds, h0, Q0, sset, shard=False, chunk_size=7)


def test_store_boundaries_matches_full():
    """settings.store='boundaries' keeps only the two boundary nodes of the
    stacked (h, Q) outputs — bitwise equal to the full run's boundary
    columns (same scan carry, only the stacked ys shrink), including under
    vmap.  This is the Monte-Carlo output mode (it shrinks the stacked-output
    working set of a large batch by N/2)."""
    import dataclasses

    from flowsim_tpu.models import long_reach
    from flowsim_tpu.ops import preissmann as prs
    from flowsim_tpu.parallel.ensemble import batched_simulate, roughness_ensemble

    geo, us, ds, h0, Q0, sset = long_reach.build(64, levels=4, dtype=np.float32,
                                                 linear_solver="pcr")
    sset_b = dataclasses.replace(sset, store="boundaries")

    full = prs.simulate(geo, us, ds, h0, Q0, sset)
    bnd_only = prs.simulate(geo, us, ds, h0, Q0, sset_b)
    assert bnd_only.depth.shape == (sset.n_time_levels, 2)
    cols = np.asarray(full.depth)[:, [0, -1]]
    assert (np.asarray(bnd_only.depth) == cols).all()
    assert (np.asarray(bnd_only.flow) == np.asarray(full.flow)[:, [0, -1]]).all()
    assert (np.asarray(bnd_only.iterations) == np.asarray(full.iterations)).all()

    n_vals = np.linspace(0.02, 0.06, 8).astype(np.float32)
    gb = roughness_ensemble(geo, n_vals)
    fb = batched_simulate(gb, us, ds, h0, Q0, sset, shard=False)
    bb = batched_simulate(gb, us, ds, h0, Q0, sset_b, shard=False)
    assert bb.depth.shape == (8, sset.n_time_levels, 2)
    assert (np.asarray(bb.depth) == np.asarray(fb.depth)[:, :, [0, -1]]).all()
    assert (np.asarray(bb.flow) == np.asarray(fb.flow)[:, :, [0, -1]]).all()
