"""GERD flood routing with a tributary confluence — network demo model.

Extends the flagship GERD -> Roseires case (ref cases/gerd_roseires — the
reference can only route the single main stem) to a 3-branch river
network using :mod:`flowsim_tpu.ops.network`:

    GERD release --[upper main stem]--+
                                      | junction (confluence)
    tributary hydrograph --[trib]-----+
                                      +--[lower main stem]-- Roseires
                                                              rating curve

The main stem keeps the surveyed fitted compound-trapezoid geometry and
planform curvature of the flagship case, split at a confluence chainage;
the tributary is a synthetic simple trapezoid joining at the junction
with a scaled copy of the inflow wave.  The downstream boundary is the
(smooth blended) Roseires rating curve; the GERD reservoir routing
provides the upstream hydrograph — i.e. everything from the flagship
model, plus a confluence the reference cannot express.

Run: ``python -m flowsim_tpu.models.gerd_tributary``
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from flowsim_tpu.geometry import interpolate_stations, trapezoid_station
from flowsim_tpu.models.gerd_roseires import model as gerd_model
from flowsim_tpu.models.gerd_roseires import settings as gsettings
from flowsim_tpu.ops import initial_conditions as ic
from flowsim_tpu.ops.network import BranchDef, simulate_network


def build(split_node=60, trib_scale=0.2, trib_length=10_000.0,
          sim_duration=gsettings.sim_duration, **model_kw):
    """Returns (branches, n_junctions, settings, solver) ready for
    :func:`flowsim_tpu.ops.network.simulate_network`.

    ``split_node``: main-stem node index of the confluence.
    ``trib_scale``: tributary hydrograph = main inflow x this factor.
    """
    solver, channel = gerd_model.build(sim_duration=sim_duration,
                                       smooth=True, **model_kw)
    sset = solver.settings(tolerance=gsettings.tolerance, max_iter=100)
    geo = solver.channel.geometry
    dx = solver.spatial_step

    sl = lambda s: jax.tree_util.tree_map(lambda x: x[s], geo)
    upper_geo = sl(slice(0, split_node + 1))
    lower_geo = sl(slice(split_node, None))

    # tributary: simple trapezoid falling to the confluence bed level, a
    # scaled copy of the (already routed) GERD release as its inflow
    z_conf = float(np.asarray(geo.z_bed)[split_node])
    n_trib = int(trib_length // dx) + 1
    trib_slope = 2e-4
    trib_station = lambda z: trapezoid_station(
        z_bed=z, b_main=120.0, m_main=2.0, n_main=0.032,
        bed_slope=trib_slope)
    trib_geo = interpolate_stations(
        [trib_station(z_conf + trib_slope * trib_length),
         trib_station(z_conf)],
        np.array([0.0, trib_length]), np.linspace(0.0, trib_length, n_trib))
    # the tributary ramps up from a trickle: at t=0 the network state is
    # exactly the single-reach flagship state (main stem slices) plus a
    # small backwater-consistent tributary, so level 1 starts from a
    # consistent junction stage instead of a stage discontinuity
    q_eps = 50.0
    base = np.asarray(solver.us_params.target_series)
    trib_series = jnp.asarray((base - base[0]) * trib_scale + q_eps)
    trib_us = dataclasses.replace(solver.us_params,
                                  target_series=trib_series,
                                  bed_level=jnp.asarray(
                                      z_conf + trib_slope * trib_length))
    # junction stage at t=0 = the flagship water level at the confluence;
    # GVF backwater from it gives the tributary a consistent t=0 profile
    Y0 = float(np.asarray(solver.h0)[split_node]) + z_conf
    h_trib, Q_trib = ic.initial_conditions(trib_geo, "GVF_equation", q_eps,
                                           dx, h_ds=Y0 - z_conf)

    branches = [
        BranchDef(geo=upper_geo, dx=dx, us=solver.us_params, ds=0,
                  h0=solver.h0[: split_node + 1],
                  Q0=solver.Q0[: split_node + 1]),
        BranchDef(geo=trib_geo, dx=dx, us=trib_us, ds=0,
                  h0=h_trib, Q0=Q_trib),
        BranchDef(geo=lower_geo, dx=dx, us=0, ds=solver.ds_params,
                  h0=solver.h0[split_node:], Q0=solver.Q0[split_node:]),
    ]
    return branches, 1, sset, solver


def main(sim_hours=96):
    out_branches = build(sim_duration=3600 * sim_hours)
    branches, n_junctions, sset, _ = out_branches
    out = simulate_network(branches, n_junctions, sset)
    q_up = np.asarray(out.flow[0])[:, -1]
    q_tr = np.asarray(out.flow[1])[:, -1]
    q_dn = np.asarray(out.flow[2])
    print(f"converged: {bool(np.asarray(out.converged).all())}  "
          f"total Newton iterations: {int(np.asarray(out.iterations).sum())}")
    print(f"main-stem peak at confluence: {q_up.max():,.0f} m3/s")
    print(f"tributary peak at confluence: {q_tr.max():,.0f} m3/s")
    print(f"combined peak entering Roseires reach: {q_dn[:, 0].max():,.0f} m3/s")
    print(f"peak at Roseires: {q_dn[:, -1].max():,.0f} m3/s")
    # level 0 is the (deliberately) tributary-free initial state; the
    # solver enforces the balance from level 1 on
    imbalance = np.abs(q_up[1:] + q_tr[1:] - q_dn[1:, 0]).max()
    print(f"max junction imbalance (levels 1+): {imbalance:.2e} m3/s")
    return out


if __name__ == "__main__":
    main()
