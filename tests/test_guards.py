"""User-facing input guards.

Covers:
* the per-backend linear-solver default and the unknown-solver rejection;
* the ambiguous 2-D lateral_inflow rejection when member count == level
  count (member-major [B, N] vs shared time-varying [nt, N]);
* branch-qlat shape validation and junction config length validation in
  the network solver.
"""

import dataclasses

import jax
import numpy as np
import pytest

from flowsim_tpu.ops import preissmann as prs
from flowsim_tpu.ops import tridiag
from flowsim_tpu.ops.network import BranchDef, simulate_network

pytestmark = pytest.mark.fast


def _settings(**kw):
    base = dict(theta=0.6, time_step=3600.0, spatial_step=1000.0,
                n_time_levels=5, tolerance=1e-6, max_iter=50)
    base.update(kw)
    return prs.PreissmannSettings(**base)


@pytest.mark.parametrize("platform,expected", [
    ("cpu", "thomas"), ("gpu", "pcr"), ("cuda", "pcr")])
def test_default_linear_solver_per_backend(platform, expected):
    assert tridiag.default_linear_solver(platform) == expected
    assert expected in tridiag.LINEAR_SOLVERS


def test_default_linear_solver_follows_the_backend():
    assert tridiag.default_linear_solver() == tridiag.default_linear_solver(
        jax.default_backend())


def test_solver_entry_uses_backend_default(monkeypatch):
    from flowsim_tpu.models import akbari_firoozi as ak

    solver, _ = ak.build()
    assert solver.linear_solver is None
    assert solver.settings(tolerance=1e-6, max_iter=50).linear_solver == "thomas"
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert solver.settings(tolerance=1e-6, max_iter=50).linear_solver == "pcr"
    # an explicit choice is kept on every backend
    solver.linear_solver = "thomas"
    assert solver.settings(tolerance=1e-6, max_iter=50).linear_solver == "thomas"


def test_basin_uses_backend_default(monkeypatch):
    from flowsim_tpu.models import basin

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    _, _, sset = basin.build(levels=2, sim_hours=1)
    assert sset.linear_solver == "pcr"


def test_unknown_linear_solver_raises():
    L = np.zeros((4, 2, 2))
    D = np.broadcast_to(np.eye(2), (4, 2, 2))
    with pytest.raises(ValueError, match="unknown method"):
        tridiag.solve_block_tridiag(L, D, L, np.ones((4, 2)),
                                    method="pallas_pcr")


def test_ambiguous_2d_lateral_inflow_raises():
    from flowsim_tpu.models import akbari_firoozi as ak
    from flowsim_tpu.parallel.ensemble import batched_simulate

    solver, _ = ak.build()
    geo = solver.channel.geometry
    nt = 6
    sset = dataclasses.replace(
        solver.settings(tolerance=1e-6, max_iter=50), n_time_levels=nt)
    B = nt  # the ambiguous case
    n = solver.h0.shape[0]
    geo_b = jax.tree_util.tree_map(
        lambda x: np.broadcast_to(np.asarray(x), (B,) + np.shape(x)), geo)
    q2d = np.full((B, n), 1e-4)
    with pytest.raises(ValueError, match="ambiguous"):
        batched_simulate(geo_b, solver.us_params, solver.ds_params,
                         solver.h0, solver.Q0, sset, shard=False,
                         lateral_inflow=q2d)
    with pytest.raises(ValueError, match="ambiguous"):
        batched_simulate(geo_b, solver.us_params, solver.ds_params,
                         solver.h0, solver.Q0, sset, shard=False,
                         chunk_size=2, lateral_inflow=q2d)


def _tiny_network(nt=5):
    """A 2-branch serial split of the akbari reach for guard checks —
    never actually run."""
    from flowsim_tpu.models import akbari_firoozi as ak

    solver, _ = ak.build()
    sset = dataclasses.replace(
        solver.settings(tolerance=1e-6, max_iter=50), n_time_levels=nt)
    geo = solver.channel.geometry
    cut = 15
    sl = lambda s: jax.tree_util.tree_map(lambda x: x[s], geo)
    br1 = BranchDef(geo=sl(slice(0, cut + 1)), dx=solver.spatial_step,
                    us=solver.us_params, ds=0,
                    h0=solver.h0[: cut + 1], Q0=solver.Q0[: cut + 1])
    br2 = BranchDef(geo=sl(slice(cut, None)), dx=solver.spatial_step,
                    us=0, ds=solver.ds_params,
                    h0=solver.h0[cut:], Q0=solver.Q0[cut:])
    return [br1, br2], sset


def test_network_branch_qlat_shape_validated():
    branches, sset = _tiny_network()
    n_b = int(np.asarray(branches[0].h0).shape[0])
    # transposed [n_b, nt] (wrong) and off-by-one node count both raise
    for bad in (np.zeros((n_b, sset.n_time_levels)),
                np.zeros((sset.n_time_levels, n_b + 1)),
                np.zeros(n_b - 1)):
        brs = [dataclasses.replace(branches[0], qlat=bad), branches[1]]
        with pytest.raises(ValueError, match="qlat"):
            simulate_network(brs, 1, sset)


def test_network_junction_config_lengths_validated():
    branches, sset = _tiny_network()
    with pytest.raises(ValueError, match="junction_area"):
        simulate_network(branches, 1, sset, junction_area=[100.0, 200.0])
    from flowsim_tpu.ops import rating_curve as rc
    curve = rc.make_polynomial(0.0, 1.0, 0.0)
    with pytest.raises(ValueError, match="junction_rating"):
        simulate_network(branches, 1, sset, junction_rating=[curve, None])
