"""Network ensembles: ``batched_simulate_network`` members against serial runs.

Per-member inflow hydrographs (and, where a configuration has one, lateral
inflow) on a network; each member must match its own serial
``simulate_network`` run with identical per-level iteration counts, for
both the loop and the stacked engine.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flowsim_tpu.ops.network import simulate_network
from flowsim_tpu.parallel.ensemble import batched_simulate_network
from tests.helpers import NETWORKS, assert_network_close

SCALES = np.array([0.9, 1.0, 1.1])
CONFIGS = ["serial_split", "junction_dam_rated", "junction_poly_n_rating",
           "storage_curve_end", "branch_qlat_time_varying",
           "junction_table_rating"]


def _member_overrides(branches):
    """Per-member upstream inflow on branch 0; qlat scaled where present."""
    us = branches[0].us
    series = np.asarray(us.target_series, np.float64)
    members = [dict(us=dataclasses.replace(
        us, target_series=jnp.asarray(series * s))) for s in SCALES]
    if branches[0].qlat is not None:
        for d, s in zip(members, SCALES):
            d["qlat"] = jnp.asarray(np.asarray(branches[0].qlat) * s)
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *members)
    return members, [stacked] + [dict() for _ in branches[1:]]


@pytest.mark.parametrize("engine", ["loop", "stacked"])
@pytest.mark.parametrize("name", CONFIGS)
def test_batched_network_matches_serial(name, engine):
    branches, nj, sset, kw = NETWORKS[name]()
    members, batch = _member_overrides(branches)
    out = batched_simulate_network(branches, nj, sset, batch, engine=engine,
                                   **kw)
    for m, over in enumerate(members):
        brs = [dataclasses.replace(branches[0], **over)] + branches[1:]
        ref = simulate_network(brs, nj, sset, engine=engine, **kw)
        member = jax.tree_util.tree_map(lambda a: np.asarray(a)[m], out)
        assert_network_close(member, ref, dh=1e-9, dY=1e-9)
    # the members genuinely differ
    q = np.asarray(out.flow[0])[:, -1, -1]
    assert q[-1] > q[0]
