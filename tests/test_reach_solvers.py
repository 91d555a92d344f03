"""Single reach: the block-Thomas and f64 PCR solves agree level by level.

Every boundary, storage, geometry and lateral-inflow configuration the
solver supports runs with ``linear_solver="thomas"`` (the CPU default) and
``"pcr"`` (the GPU default).  Both solve the same f64 Newton systems, so
the per-level iteration counts must be identical and the fields agree to
roundoff.
"""

import dataclasses

import numpy as np
import pytest

from flowsim_tpu.ops import preissmann as prs
from tests.helpers import REACHES


def _run(config, solver):
    geo, us, ds, h0, Q0, sset, qlat = config
    return prs.simulate(geo, us, ds, h0, Q0,
                        dataclasses.replace(sset, linear_solver=solver),
                        lateral_inflow=qlat)


@pytest.mark.parametrize("name", sorted(REACHES))
def test_thomas_matches_pcr(name):
    config = REACHES[name]()
    ref = _run(config, "thomas")
    out = _run(config, "pcr")
    assert bool(np.asarray(ref.converged).all())
    assert bool(np.asarray(out.converged).all())
    np.testing.assert_array_equal(np.asarray(out.iterations),
                                  np.asarray(ref.iterations))
    assert np.abs(np.asarray(out.depth) - np.asarray(ref.depth)).max() < 1e-8
    assert np.abs(np.asarray(out.flow) - np.asarray(ref.flow)).max() < 1e-6
    np.testing.assert_array_equal(np.asarray(out.gate_open),
                                  np.asarray(ref.gate_open))
    for a, b in ((out.reservoir_stage, ref.reservoir_stage),
                 (out.reservoir_stage_us, ref.reservoir_stage_us)):
        a, b = np.asarray(a), np.asarray(b)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        assert np.nan_to_num(np.abs(a - b)).max() < 1e-8
