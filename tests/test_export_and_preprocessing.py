"""Geometry export (centerline/banks/shapefile) + section approximator."""

import os
import struct

import numpy as np
import pytest

from flowsim_tpu.models.gerd_roseires.section_approximator import (
    approximate_folder,
    fit_compound_trapezoid,
)
from flowsim_tpu.utils.geometry_export import draw_channel, reconstruct_centerline
from flowsim_tpu.utils.shapefile import write_polylines
from tests.oracle import REFERENCE_ROOT, reference_available

pytestmark = pytest.mark.fast


def test_centerline_matches_reference():
    if not reference_available():
        pytest.skip("reference not mounted")
    import sys

    if REFERENCE_ROOT not in sys.path:
        sys.path.insert(0, REFERENCE_ROOT)
    import importlib

    # reference module imports matplotlib at top level; fine headless
    from cases.gerd_roseires.custom_functions import reconstruct_centerline as ref_rc

    ch = np.linspace(0, 10000, 33)
    curv = 1e-4 * np.sin(ch / 2000.0)
    x, y, th = reconstruct_centerline(ch, curv, 100.0, 200.0, 0.3)
    xr, yr, thr = ref_rc(ch, curv, 100.0, 200.0, 0.3)
    np.testing.assert_allclose(x, xr, rtol=1e-12)
    np.testing.assert_allclose(y, yr, rtol=1e-12)
    np.testing.assert_allclose(th, thr, rtol=1e-12)


def test_shapefile_writer_roundtrip(tmp_path):
    lines = [[(0.0, 0.0), (10.0, 5.0), (20.0, 3.0)], [(0.0, 10.0), (20.0, 13.0)]]
    path = write_polylines(str(tmp_path / "banks.shp"), lines, attributes=["left", "right"])
    for ext in [".shp", ".shx", ".dbf", ".prj", ".cpg"]:
        assert os.path.exists(path[:-4] + ext)
    with open(path, "rb") as f:
        data = f.read()
    assert struct.unpack(">i", data[:4])[0] == 9994          # shapefile magic
    assert struct.unpack("<i", data[32:36])[0] == 3          # polyline type
    # first record: shape type polyline, 3 points
    rec = data[100:]
    assert struct.unpack("<i", rec[8:12])[0] == 3
    npoints = struct.unpack("<i", rec[48:52])[0]
    assert npoints == 3
    x0, y0 = struct.unpack("<2d", rec[56:72])
    assert (x0, y0) == (0.0, 0.0)


def test_draw_channel_exports(tmp_path):
    ch = np.linspace(0, 5000, 21)
    widths = np.full(21, 120.0)
    curv = np.zeros(21)
    out = str(tmp_path / "banks.shp")
    x, y, th, left, right = draw_channel(ch, widths, curv, 0.0, 0.0, 0.0, outfile=out)
    assert os.path.exists(out)
    # straight channel: banks parallel at +-60 m
    np.testing.assert_allclose(left[:, 1], 60.0)
    np.testing.assert_allclose(right[:, 1], -60.0)


def test_fit_compound_trapezoid_recovers_known_shape():
    """Fitting an exact compound trapezoid recovers its parameters."""
    b, m, hbf = 40.0, 2.0, 4.0
    bfp = 60.0
    xs = []
    zs = []
    # construct the polyline of a symmetric compound trapezoid
    T_bank = b + 2 * m * hbf
    pts = [
        (-T_bank / 2 - bfp / 2, hbf + 6.0),
        (-T_bank / 2 - bfp / 2, hbf),
        (-T_bank / 2, hbf),
        (-b / 2, 0.0),
        (b / 2, 0.0),
        (T_bank / 2, hbf),
        (T_bank / 2 + bfp / 2, hbf),
        (T_bank / 2 + bfp / 2, hbf + 6.0),
    ]
    x = np.array([p[0] for p in pts])
    z = np.array([p[1] for p in pts])
    # densify for the area sampling
    xd = np.linspace(x.min(), x.max(), 400)
    zd = np.interp(xd, x, z)
    h = np.linspace(0.5, 9.0, 60)
    rec = fit_compound_trapezoid(xd, zd, h, bank_z=hbf)
    assert abs(rec["h_bankfull"] - hbf) < 1e-9
    assert abs(rec["b_main"] - b) < 2.5
    assert abs(rec["m_main"] - m) < 0.5


def test_approximate_folder_on_reference_raw_sections(tmp_path):
    if not reference_available():
        pytest.skip("reference not mounted")
    folder = os.path.join(REFERENCE_ROOT, "cases", "gerd_roseires", "data", "raw", "cross_sections")
    recs = approximate_folder(folder, output_csv=str(tmp_path / "fits.csv"))
    assert len(recs) == 22
    assert os.path.exists(tmp_path / "fits.csv")
    assert np.isfinite([float(r["b_main"]) for r in recs]).sum() >= 20
