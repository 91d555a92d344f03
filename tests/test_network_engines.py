"""Networks: the stacked engine against the per-branch loop engine.

Every junction, end-kind, storage, rating, geometry and lateral-inflow
configuration the network solver supports runs through ``engine="loop"``
with the block-Thomas solve and ``engine="stacked"`` with f64 PCR (the GPU
default).  Both solve the same f64 arrowhead system each Newton
iteration, so the per-level iteration counts must be identical and the
fields, junction stages, reservoir stages, gate states and junction
outflows agree to roundoff.
"""

import dataclasses

import numpy as np
import pytest

from flowsim_tpu.ops.network import simulate_network
from tests.helpers import NETWORKS, assert_network_close


# the stacked engine pads branches into one pytree, so every branch must
# share one geometry kind; mixed networks run the loop engine with both
# linear solvers instead
LOOP_ONLY = {"mixed_table_trapezoid"}


@pytest.mark.parametrize("name", sorted(NETWORKS))
def test_stacked_matches_loop(name):
    branches, nj, sset, kw = NETWORKS[name]()
    ref = simulate_network(branches, nj,
                           dataclasses.replace(sset, linear_solver="thomas"),
                           engine="loop", **kw)
    out = simulate_network(branches, nj,
                           dataclasses.replace(sset, linear_solver="pcr"),
                           engine="loop" if name in LOOP_ONLY else "stacked",
                           **kw)
    assert bool(np.asarray(ref.converged).all())
    assert_network_close(out, ref)
    for a, b in zip(out.flow, ref.flow):
        assert np.abs(np.asarray(a) - np.asarray(b)).max() < 1e-6
    rs, rs_ref = np.asarray(out.reservoir_stage), np.asarray(ref.reservoir_stage)
    np.testing.assert_array_equal(np.isnan(rs), np.isnan(rs_ref))
    assert np.nan_to_num(np.abs(rs - rs_ref)).max() < 1e-8
    np.testing.assert_array_equal(np.asarray(out.gate_open),
                                  np.asarray(ref.gate_open))
    assert np.abs(np.asarray(out.junction_outflow)
                  - np.asarray(ref.junction_outflow)).max() < 1e-6
