"""Shared builders for the engine/solver parity tests.

Each reach builder returns ``(geo, us_bc, ds_bc, h0, Q0, settings, qlat)``;
each network builder returns ``(branches, n_junctions, settings, kw)`` with
``kw`` the junction options of :func:`simulate_network`.  All are small
(tens of nodes, a few levels) so that a CPU run takes well under a second.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from flowsim_tpu.ops import boundary as bnd
from flowsim_tpu.ops import initial_conditions as ic
from flowsim_tpu.ops import preissmann as prs
from flowsim_tpu.ops import rating_curve as rcurve
from flowsim_tpu.ops import storage as stg
from flowsim_tpu.ops.network import BranchDef


def prismatic(n=16, slope=6e-4, width=120.0, roughness=0.025):
    """Rectangular prismatic reach at 1 km node spacing."""
    from flowsim_tpu.geometry import TrapezoidGeometry

    z = np.linspace(slope * (n - 1) * 1000.0, 0.0, n)
    ones, zeros = np.ones(n), np.zeros(n)
    return TrapezoidGeometry(
        z_bed=jnp.asarray(z), b_main=jnp.asarray(width * ones),
        m_main=jnp.asarray(zeros), n_main=jnp.asarray(roughness * ones),
        compound=jnp.asarray(np.zeros(n, bool)),
        h_bank=jnp.asarray(1e30 * ones),
        b_fp_left=jnp.asarray(zeros), b_fp_right=jnp.asarray(zeros),
        m_fp=jnp.asarray(zeros), n_left=jnp.asarray(roughness * ones),
        n_right=jnp.asarray(roughness * ones),
        bed_slope=jnp.asarray(slope * ones), curvature=jnp.asarray(zeros))


def _settings(nt, dt=3600.0, dx=1000.0, theta=0.6, tol=1e-8):
    return prs.PreissmannSettings(theta=theta, time_step=dt, spatial_step=dx,
                                  n_time_levels=nt, tolerance=tol,
                                  max_iter=100)


# -- single reaches -----------------------------------------------------------


def _rect(us_kind, ds_kind, nt=13):
    slope, dx, dt = 0.00061, 1000.0, 3600.0
    geo = prismatic(n=30, slope=slope, roughness=0.023)
    z = np.asarray(geo.z_bed)
    h0, Q0 = ic.initial_conditions(geo, "steady-state", 100.0, dx)
    times = np.arange(nt) * dt
    inflow = [100.0 + 200.0 * np.sin(np.pi * min(t / (12 * 3600), 1.0))
              for t in times]
    bed_us, bed_ds = float(z[0]), float(z[-1])
    stage = (bed_ds + float(np.asarray(h0)[-1])
             + 0.2 * np.sin(np.linspace(0, np.pi, nt)))
    us = {"flow": lambda: bnd.make_boundary(
              "flow_hydrograph", bed_level=bed_us, target_series=inflow),
          "fixed": lambda: bnd.make_boundary(
              "fixed_depth", bed_level=bed_us,
              initial_depth=float(np.asarray(h0)[0])),
          "normal": lambda: bnd.make_boundary(
              "normal_depth", bed_level=bed_us, bed_slope=slope)}[us_kind]()
    ds = {"fixed": lambda: bnd.make_boundary(
              "fixed_depth", bed_level=bed_ds,
              initial_depth=float(np.asarray(h0)[-1])),
          "stage": lambda: bnd.make_boundary(
              "stage_hydrograph", bed_level=bed_ds, target_series=stage),
          "normal": lambda: bnd.make_boundary(
              "normal_depth", bed_level=bed_ds, bed_slope=slope)}[ds_kind]()
    return geo, us, ds, h0, Q0, _settings(nt, tol=1e-6), None


def _storage_reach(ends, curve=False, nt=13):
    """Prismatic reach with lumped storage on ``ends`` ('us', 'ds', both)."""
    from tests.test_both_boundary_storage import build

    geo, us_s, ds_s, h0, Q0 = build()
    z = np.asarray(geo.z_bed)
    if curve:
        y0 = float(z[-1] + np.asarray(h0)[-1])
        stages = np.linspace(0.0, 100.0, 33)
        ds_s = bnd.make_boundary(
            "fixed_depth", bed_level=float(z[-1]),
            storage=stg.make_storage(
                area_curve=np.stack([stages, 1.25e6 * (1.0 + 0.01 * (stages - y0))], 1),
                min_stage=y0, solution_boundaries=(0.0, 100.0)))
    us = us_s if "us" in ends else bnd.make_boundary(
        "flow_hydrograph", bed_level=float(z[0]),
        target_series=150.0 + 50.0 * np.sin(np.linspace(0, np.pi, nt)))
    ds = ds_s if "ds" in ends else bnd.make_boundary(
        "normal_depth", bed_level=float(z[-1]), bed_slope=6e-4)
    return geo, us, ds, h0, Q0, _settings(nt), None


def _example():
    from flowsim_tpu.models import example

    solver, _ = example.build()
    sset = dataclasses.replace(solver.settings(tolerance=1e-8, max_iter=100),
                               n_time_levels=25)
    return (solver.channel.geometry, solver.us_params, solver.ds_params,
            solver.h0, solver.Q0, sset, None)


def _gerd(smooth, hours=12):
    from flowsim_tpu.models.gerd_roseires import model

    solver, _ = model.build(sim_duration=3600 * hours, smooth=smooth)
    return (solver.channel.geometry, solver.us_params, solver.ds_params,
            solver.h0, solver.Q0, solver.settings(1e-6, 100), None)


def _long(n=128, levels=12):
    from flowsim_tpu.models import long_reach

    geo, us, ds, h0, Q0, sset = long_reach.build(n, levels=levels)
    return geo, us, ds, h0, Q0, sset, None


def table_reach(samples=48, n_nodes=9, nt=17):
    """Irregular-section (TableGeometry) reach with a ramped inflow."""
    from flowsim_tpu.geometry_tables import IrregularStation, build_table_geometry

    length, slope = 8000.0, 2e-4

    def section_pts(seed, z0):
        rng = np.random.default_rng(seed)
        x = np.linspace(0, 220, 21)
        z = z0 + 8.0 * ((x - 110) / 110) ** 2 + rng.uniform(0, 0.5, x.size)
        return x, z

    x1, z1 = section_pts(1, slope * length)
    x2, z2 = section_pts(2, 0.0)
    sts = [IrregularStation(x=x1, z=z1, n_main=0.03, bed_slope=slope),
           IrregularStation(x=x2, z=z2, n_main=0.03, bed_slope=slope)]
    geo = build_table_geometry(sts, [0.0, length],
                               np.linspace(0, length, n_nodes), samples=samples)
    h0, Q0 = ic.initial_conditions(geo, "steady-state", 400.0, 1000.0)
    times = np.arange(nt) * 1800.0
    us = bnd.make_boundary(
        "flow_hydrograph", bed_level=float(geo.z_bed[0]),
        target_series=[400.0 + 600.0 * min(t / (4 * 3600.0), 1.0) for t in times])
    ds = bnd.make_boundary("normal_depth", bed_level=float(geo.z_bed[-1]),
                           bed_slope=float(geo.bed_slope[-1]))
    sset = _settings(nt, dt=1800.0, theta=0.7)
    return geo, us, ds, h0, Q0, sset, None


def _gated():
    from tests.test_gated_curve import _build_gated_solver

    solver = _build_gated_solver()
    return (solver.channel.geometry, solver.us_params, solver.ds_params,
            solver.h0, solver.Q0, solver.settings(1e-6, 100), None)


def _qlat(time_varying):
    geo, us, ds, h0, Q0, sset, _ = _rect("flow", "normal")
    n, nt = int(np.asarray(h0).shape[0]), sset.n_time_levels
    q = 0.004 * (1.0 + np.linspace(0.0, 1.0, n))
    if time_varying:
        t = np.linspace(0.0, 1.0, nt)[:, None]
        q = 0.02 * np.exp(-((t - 0.4) / 0.2) ** 2) * np.ones((1, n))
    return geo, us, ds, h0, Q0, sset, q


def _boundaries_store():
    geo, us, ds, h0, Q0, sset, q = _example()
    return geo, us, ds, h0, Q0, dataclasses.replace(sset, store="boundaries"), q


REACHES = {
    "example_storage": _example,
    "long_reach_normal_depth": _long,
    "gerd_blended": lambda: _gerd(True),
    "gerd_gated": lambda: _gerd(False, hours=24),
    "gated_controller": _gated,
    "table_geometry": table_reach,
    "ds_fixed_plain": lambda: _rect("flow", "fixed"),
    "ds_stage_hydrograph": lambda: _rect("flow", "stage"),
    "us_fixed_depth": lambda: _rect("fixed", "normal"),
    "us_normal_stage_ds": lambda: _rect("normal", "stage"),
    "storage_us": lambda: _storage_reach(("us",)),
    "storage_ds": lambda: _storage_reach(("ds",)),
    "storage_both_ends": lambda: _storage_reach(("us", "ds")),
    "curve_storage_ds": lambda: _storage_reach(("ds",), curve=True),
    "qlat_constant": lambda: _qlat(False),
    "qlat_time_varying": lambda: _qlat(True),
    "store_boundaries": _boundaries_store,
}


def roughness_batch(geo, scales):
    """Batched geometry with the roughness scaled per member."""
    from flowsim_tpu.geometry_tables import TableGeometry
    from flowsim_tpu.parallel.ensemble import (roughness_ensemble,
                                               table_roughness_ensemble)

    if isinstance(geo, TableGeometry):
        return table_roughness_ensemble(geo, geo.n_ref * np.asarray(scales))
    n0 = float(np.asarray(geo.n_main)[0])
    return roughness_ensemble(geo, n0 * np.asarray(scales))


# -- networks -----------------------------------------------------------------


def split_akbari(cut=15, nt=9, tol=1e-6):
    """The akbari reach split into two branches at node ``cut``."""
    from flowsim_tpu.models import akbari_firoozi as ak

    solver, _ = ak.build()
    sset = dataclasses.replace(
        solver.settings(tolerance=tol, max_iter=100), n_time_levels=nt)
    geo = solver.channel.geometry
    sl = lambda s: jax.tree_util.tree_map(lambda x: x[s], geo)
    br1 = BranchDef(geo=sl(slice(0, cut + 1)), dx=solver.spatial_step,
                    us=solver.us_params, ds=0,
                    h0=solver.h0[: cut + 1], Q0=solver.Q0[: cut + 1])
    br2 = BranchDef(geo=sl(slice(cut, None)), dx=solver.spatial_step,
                    us=0, ds=solver.ds_params,
                    h0=solver.h0[cut:], Q0=solver.Q0[cut:])
    return [br1, br2], sset


def _junction_stage0(branches):
    z_conf = float(np.asarray(branches[0].geo.z_bed)[-1])
    return z_conf + float(np.asarray(branches[0].h0)[-1])


def _split(**kw):
    branches, sset = split_akbari(nt=9)
    return branches, 1, sset, kw


def _split_rated(kind):
    branches, sset = split_akbari(nt=9)
    Y = _junction_stage0(branches)
    area = [5.0e5]
    if kind == "dam":
        rc = rcurve.make_polynomial(0.0, 40.0, -40.0 * Y + 20.0)
    elif kind == "withdrawal":
        rc, area = rcurve.make_polynomial(0.0, 10.0, -10.0 * Y + 5.0), None
    elif kind == "blended":
        rc = rcurve.make_blended_poly([0.0, 20.0, -20.0 * Y + 10.0],
                                      [0.0, 60.0, -60.0 * Y + 30.0],
                                      pivot_stage=Y + 0.05, buffer=0.5)
    elif kind == "poly_n":
        rc = rcurve.make_polynomial_general(
            np.array([5.0, 20.0, 6.0, 1.5, 0.25]), stage_shift=-(Y - 1.0))
    elif kind == "table":
        rc = rcurve.make_table(Y + np.array([-2.0, -0.5, 0.0, 0.4, 1.1, 2.5, 6.0]),
                               np.array([0.0, 40.0, 100.0, 180.0, 420.0, 900.0, 2500.0]))
    else:  # power
        rc = rcurve.make_power(a=15.0 / 3.0 ** 1.6, b=1.6, stage_shift=-(Y - 3.0))
    kw = dict(junction_rating=[rc])
    if area is not None:
        kw["junction_area"] = area
    return branches, 1, sset, kw


def _prismatic_split(us_storage, ds_storage):
    dx, nt = 1000.0, 13
    geo = prismatic()
    z = np.asarray(geo.z_bed)

    h0, Q0 = ic.initial_conditions(geo, "steady-state", 150.0, dx)

    def pool(bed, area, min_stage):
        return bnd.make_boundary(
            "fixed_depth", bed_level=bed,
            storage=stg.make_storage(surface_area=area, min_stage=min_stage,
                                     solution_boundaries=(0.0, 100.0)))

    us = pool(float(z[0]), 4.0e6, float(z[0]) - 5.0) if us_storage else \
        bnd.make_boundary(
            "flow_hydrograph", bed_level=float(z[0]),
            target_series=150.0 + 60.0 * np.sin(np.linspace(0, np.pi, nt)))
    # a downstream pool starts at its minimum stage (the initial surface),
    # as in tests/test_both_boundary_storage.py: the level-1 trial-stage
    # bootstrap otherwise converges only linearly at a rate ~ dt/area
    ds = pool(float(z[-1]), 1.25e6, float(z[-1] + np.asarray(h0)[-1])) \
        if ds_storage else bnd.make_boundary(
            "normal_depth", bed_level=float(z[-1]), bed_slope=6e-4)
    cut = 8
    sl = lambda s: jax.tree_util.tree_map(lambda x: x[s], geo)
    branches = [BranchDef(geo=sl(slice(0, cut + 1)), dx=dx, us=us, ds=0,
                          h0=h0[: cut + 1], Q0=Q0[: cut + 1]),
                BranchDef(geo=sl(slice(cut, None)), dx=dx, us=0, ds=ds,
                          h0=h0[cut:], Q0=Q0[cut:])]
    return branches, 1, _settings(nt, dt=1800.0), {}


def _mixed_ends():
    slope, dx, nt = 6e-4, 1000.0, 11
    geo = prismatic(n=31)
    h0, Q0 = ic.initial_conditions(geo, "steady-state", 150.0, dx)
    z = np.asarray(geo.z_bed)
    sl = lambda s: jax.tree_util.tree_map(lambda x: x[s], geo)
    times = np.arange(nt, dtype=np.float64)
    us_q = bnd.make_boundary("flow_hydrograph", bed_level=float(z[0]),
                             target_series=150.0 + 80.0 * np.exp(-((times - 4.0) / 2.5) ** 2))
    us_h = bnd.make_boundary("stage_hydrograph", bed_level=float(z[0]),
                             target_series=np.full(nt, float(z[0] + h0[0])))
    ds_n = bnd.make_boundary("normal_depth", bed_level=float(z[-1]), bed_slope=slope)
    ds_h = bnd.make_boundary("fixed_depth", bed_level=float(z[-1]),
                             initial_depth=float(h0[-1]))
    mk = lambda s, us, ds: BranchDef(geo=sl(s), dx=dx, us=us, ds=ds,
                                     h0=h0[s], Q0=Q0[s])
    branches = [mk(slice(0, 11), us_q, 0), mk(slice(0, 11), us_h, 0),
                mk(slice(10, 21), 0, ds_n), mk(slice(10, 21), 0, ds_h)]
    return branches, 1, _settings(nt, dt=1800.0), {}


def _qlat_split(time_varying):
    branches, sset = split_akbari(nt=9)
    n0, n1 = (int(np.asarray(b.h0).shape[0]) for b in branches)
    if time_varying:
        t = np.linspace(0.0, 1.0, sset.n_time_levels)[:, None]
        q0 = 0.02 * np.exp(-((t - 0.4) / 0.2) ** 2) * (1.0 + np.linspace(0.0, 1.0, n0))[None, :]
        q1 = np.full(n1, 0.003)
    else:
        q0 = 0.004 * (1.0 + np.linspace(0.0, 1.0, n0))
        q1 = 0.004 * (1.0 + np.linspace(0.0, 1.0, n1))
    branches = [dataclasses.replace(branches[0], qlat=jnp.asarray(q0)),
                dataclasses.replace(branches[1], qlat=jnp.asarray(q1))]
    return branches, 1, sset, {}


def _table_split(mixed):
    from flowsim_tpu.geometry import interpolate_stations, trapezoid_station

    geo, us_p, ds_p, h0, Q0, sset, _ = table_reach()
    sl = lambda s: jax.tree_util.tree_map(lambda x: x[s], geo)
    upper = BranchDef(geo=sl(slice(0, 5)), dx=1000.0, us=us_p, ds=0,
                      h0=h0[:5], Q0=Q0[:5])
    if not mixed:
        return [upper, BranchDef(geo=sl(slice(4, None)), dx=1000.0, us=0,
                                 ds=ds_p, h0=h0[4:], Q0=Q0[4:])], 1, sset, {}
    slope = 2e-4
    z_conf = float(np.asarray(geo.z_bed)[4])
    st = lambda z: trapezoid_station(z_bed=z, b_main=40.0, m_main=2.0,
                                     n_main=0.03, bed_slope=slope)
    gT = interpolate_stations([st(z_conf + 4000.0 * slope), st(z_conf)],
                              [0.0, 4000.0], np.linspace(0.0, 4000.0, 5))
    hT, QT = ic.initial_conditions(gT, "steady-state", 150.0, 1000.0)
    times = np.arange(sset.n_time_levels) * 1800.0
    us_t = bnd.make_boundary(
        "flow_hydrograph", bed_level=float(gT.z_bed[0]),
        target_series=[150.0 + 150.0 * min(t / (4 * 3600.0), 1.0) for t in times])
    return [upper, BranchDef(geo=gT, dx=1000.0, us=us_t, ds=0, h0=hT, Q0=QT),
            BranchDef(geo=sl(slice(4, None)), dx=1000.0, us=0, ds=ds_p,
                      h0=h0[4:], Q0=Q0[4:] + 150.0)], 1, sset, {}


def _storage_curve_split():
    branches, sset = split_akbari(nt=9)
    bed_ds = float(np.asarray(branches[1].geo.z_bed)[-1])
    ac = bed_ds + np.linspace(-2.0, 25.0, 12)
    sp = stg.make_storage(
        area_curve=np.stack([ac, 4.0e5 * (1.0 + 0.08 * np.arange(12))], axis=1),
        min_stage=bed_ds - 1.0,
        rating=rcurve.make_polynomial(0.0, 30.0, -30.0 * (bed_ds - 1.0)),
        capture_losses=True, reservoir_length=1500.0, K_q=0.2)
    ds_new = dataclasses.replace(branches[1].ds, kind="fixed_depth", storage=sp)
    return [branches[0], dataclasses.replace(branches[1], ds=ds_new)], 1, sset, {}


def _gated_split():
    from tests.test_gated_curve import _build_gated_solver

    solver = _build_gated_solver()
    geo = solver.channel.geometry
    sl = lambda s: jax.tree_util.tree_map(lambda x: x[s], geo)
    cut = 10
    return [BranchDef(geo=sl(slice(0, cut + 1)), dx=solver.spatial_step,
                      us=solver.us_params, ds=0,
                      h0=solver.h0[: cut + 1], Q0=solver.Q0[: cut + 1]),
            BranchDef(geo=sl(slice(cut, None)), dx=solver.spatial_step,
                      us=0, ds=solver.ds_params,
                      h0=solver.h0[cut:], Q0=solver.Q0[cut:])], \
        1, solver.settings(tolerance=1e-6, max_iter=100), {}


def _tributary():
    from flowsim_tpu.models import gerd_tributary

    branches, nj, sset, _ = gerd_tributary.build(sim_duration=3600 * 12)
    return branches, nj, sset, {}


def _basin():
    from flowsim_tpu.models import basin

    branches, nj, sset = basin.build(levels=3, sim_hours=6)
    return branches, nj, sset, {}


NETWORKS = {
    "serial_split": _split,
    "gerd_tributary": _tributary,
    "basin_7_branches": _basin,
    "gated_end": _gated_split,
    "junction_reservoir": lambda: _split(junction_area=[5.0e5]),
    "junction_dam_rated": lambda: _split_rated("dam"),
    "plain_withdrawal": lambda: _split_rated("withdrawal"),
    "junction_blended_rating": lambda: _split_rated("blended"),
    "junction_poly_n_rating": lambda: _split_rated("poly_n"),
    "junction_table_rating": lambda: _split_rated("table"),
    "junction_power_rating": lambda: _split_rated("power"),
    "storage_us_end": lambda: _prismatic_split(True, False),
    "storage_ds_end": lambda: _prismatic_split(False, True),
    "storage_cross_branch_ends": lambda: _prismatic_split(True, True),
    "storage_curve_end": _storage_curve_split,
    "mixed_end_kinds": _mixed_ends,
    "branch_qlat": lambda: _qlat_split(False),
    "branch_qlat_time_varying": lambda: _qlat_split(True),
    "table_geometry": lambda: _table_split(False),
    "mixed_table_trapezoid": lambda: _table_split(True),
}


def assert_network_close(out, ref, dh=1e-8, dY=1e-8):
    """Identical per-level iteration counts, fields and stages within
    ``dh`` / ``dY`` (both engines solve the same f64 system)."""
    assert bool(np.asarray(out.converged).all())
    np.testing.assert_array_equal(np.asarray(out.iterations),
                                  np.asarray(ref.iterations))
    for a, b in zip(out.depth, ref.depth):
        assert np.abs(np.asarray(a) - np.asarray(b)).max() < dh
    assert np.abs(np.asarray(out.junction_stage)
                  - np.asarray(ref.junction_stage)).max() < dY
