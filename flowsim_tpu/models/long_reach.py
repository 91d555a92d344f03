"""Long prismatic reach: the channel-axis stress configuration.

A straight trapezoidal reach of ``n_nodes`` nodes at 200 m spacing (so
10^5 nodes is a 20,000 km channel, far beyond any single surveyed river but
the size at which the block-tridiagonal solve, not the Newton loop, sets the
cost), gerd-like magnitudes: 80 m bed, 1:10 banks, Manning n 0.03, slope
2e-4, a steady 1,500 m^3/s initial state and a one-hour ramp to 3,000 m^3/s
upstream, normal depth downstream.  It is the workload of the long-reach
scaling bench and of the domain-decomposition (``simulate_sharded``) checks.
"""

from __future__ import annotations

import jax
import numpy as np

from flowsim_tpu.geometry import TrapezoidStation, interpolate_stations
from flowsim_tpu.ops import boundary as bnd
from flowsim_tpu.ops import initial_conditions as ic
from flowsim_tpu.ops import preissmann as prs
from flowsim_tpu.ops.tridiag import default_linear_solver

DX = 200.0
DT = 600.0
SLOPE = 2e-4


def build(n_nodes: int, levels: int = 8, dtype=np.float64,
          linear_solver: str | None = None):
    """``(geo, us_bc, ds_bc, h0, Q0, settings)`` for ``levels`` time levels
    of 600 s after the initial state; Newton tolerance 1e-6 in float64,
    1e-2 in float32."""
    length = (n_nodes - 1) * DX
    stations = [
        TrapezoidStation(z_bed=length * SLOPE, b_main=80.0, m_main=10.0,
                         n_main=0.03, bed_slope=SLOPE),
        TrapezoidStation(z_bed=0.0, b_main=80.0, m_main=10.0, n_main=0.03,
                         bed_slope=SLOPE),
    ]
    geo = interpolate_stations(stations, [0.0, length],
                               np.linspace(0.0, length, n_nodes), dtype=dtype)
    h0, Q0 = ic.initial_conditions(geo, "steady-state", 1500.0, DX)

    nt = levels + 1
    times = np.arange(nt) * DT
    series = 1500.0 + 1500.0 * np.minimum(times / 3600.0, 1.0)
    us = bnd.make_boundary("flow_hydrograph", bed_level=float(geo.z_bed[0]),
                           target_series=series)
    ds = bnd.make_boundary("normal_depth", bed_level=0.0, bed_slope=SLOPE)
    # make_boundary builds leaves in the default dtype; cast to the state
    # dtype so float32 runs stay float32 throughout
    cast = lambda t: jax.tree_util.tree_map(
        lambda a: a.astype(dtype) if hasattr(a, "astype") else a, t)
    sset = prs.PreissmannSettings(
        theta=0.7, time_step=DT, spatial_step=DX, n_time_levels=nt,
        tolerance=1e-2 if np.dtype(dtype) == np.float32 else 1e-6, max_iter=30,
        linear_solver=linear_solver or default_linear_solver(),
    )
    return geo, cast(us), cast(ds), h0.astype(dtype), Q0.astype(dtype), sset
