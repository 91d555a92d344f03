"""Ensembles: vmapped ``batched_simulate`` members against serial runs.

Each reach configuration runs as a 3-member roughness ensemble (lateral
inflow, where the configuration has one, scaled per member too); every
member must match its own serial ``prs.simulate`` run with identical
per-level iteration counts — the batched while-loop freezes each member
at its own convergence.  Chunked runs (``chunk_size``) must match the
unchunked batch.
"""

import jax
import numpy as np
import pytest

from flowsim_tpu.models.calibrate import set_main_roughness
from flowsim_tpu.ops import preissmann as prs
from flowsim_tpu.parallel.ensemble import batched_simulate
from tests.helpers import REACHES, roughness_batch

SCALES = np.array([0.95, 1.0, 1.05])


def _member_qlat(qlat, scales):
    return None if qlat is None else np.stack([qlat * s for s in scales])


def _assert_member(out, m, ref):
    np.testing.assert_array_equal(np.asarray(out.iterations)[m],
                                  np.asarray(ref.iterations))
    assert np.abs(np.asarray(out.depth)[m] - np.asarray(ref.depth)).max() < 1e-9
    assert np.abs(np.asarray(out.flow)[m] - np.asarray(ref.flow)).max() < 1e-7
    np.testing.assert_array_equal(np.asarray(out.gate_open)[m],
                                  np.asarray(ref.gate_open))


@pytest.mark.parametrize("name", sorted(REACHES))
def test_batched_matches_serial(name):
    geo, us, ds, h0, Q0, sset, qlat = REACHES[name]()
    geo_b = roughness_batch(geo, SCALES)
    out = batched_simulate(geo_b, us, ds, h0, Q0, sset, shard=False,
                           lateral_inflow=_member_qlat(qlat, SCALES))
    assert bool(np.asarray(out.converged).all())
    for m, s in enumerate(SCALES):
        geo_m = jax.tree_util.tree_map(lambda a: a[m], geo_b)
        ref = prs.simulate(geo_m, us, ds, h0, Q0, sset,
                           lateral_inflow=None if qlat is None else qlat * s)
        _assert_member(out, m, ref)


@pytest.mark.parametrize("name", ["example_storage", "gated_controller",
                                  "table_geometry", "qlat_time_varying",
                                  "store_boundaries"])
def test_chunked_matches_unchunked(name):
    geo, us, ds, h0, Q0, sset, qlat = REACHES[name]()
    scales = np.array([0.95, 0.98, 1.02, 1.05])
    geo_b = roughness_batch(geo, scales)
    q = _member_qlat(qlat, scales)
    whole = batched_simulate(geo_b, us, ds, h0, Q0, sset, shard=False,
                             lateral_inflow=q)
    chunked = batched_simulate(geo_b, us, ds, h0, Q0, sset, shard=False,
                               chunk_size=2, lateral_inflow=q)
    for a, b in zip(jax.tree_util.tree_leaves(chunked),
                    jax.tree_util.tree_leaves(whole)):
        assert np.asarray(a).shape == np.asarray(b).shape
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=0, atol=1e-9)


def test_per_member_boundaries_match_serial():
    """Per-member inflow hydrographs (batch_boundaries) plus roughness."""
    import dataclasses

    from flowsim_tpu.parallel.ensemble import batch_boundaries

    geo, us, ds, h0, Q0, sset, _ = REACHES["ds_stage_hydrograph"]()
    series = np.asarray(us.target_series)
    members = [dataclasses.replace(us, target_series=series * s) for s in SCALES]
    us_b, us_axes = batch_boundaries(members)
    geo_b = roughness_batch(geo, SCALES)
    out = batched_simulate(geo_b, us_b, ds, h0, Q0, sset, shard=False,
                           us_axes=us_axes)
    for m in range(len(SCALES)):
        ref = prs.simulate(set_main_roughness(geo, geo_b.n_main[m]),
                           members[m], ds, h0, Q0, sset)
        _assert_member(out, m, ref)
