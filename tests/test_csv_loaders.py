"""The standard-library CSV loaders against the pandas reads they replace.

Every flagship data file is read both ways and must give bit-identical
values; the model must build with pandas unavailable.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from flowsim_tpu.models.gerd_roseires import roseires_rating_curve as rrc
from flowsim_tpu.models.gerd_roseires.settings import DATA_DIR
from flowsim_tpu.utils import io

pd = pytest.importorskip("pandas")

pytestmark = pytest.mark.fast

RAW = os.path.join(DATA_DIR, "raw", "cross_sections")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.array_equal(a, b, equal_nan=True)


def test_centerline_coords():
    path = os.path.join(DATA_DIR, "centerline_coords.csv")
    ref = (pd.read_csv(path).dropna(axis=1, how="all").dropna()
           .astype(np.float64).sort_values(by="chainage").to_numpy())
    _same(io.import_table(path, sort_by="chainage"), ref)


def test_gerd_volume_curve_headerless():
    path = os.path.join(DATA_DIR, "gerd_vol_curve.csv")
    ref = (pd.read_csv(path, header=None).dropna(axis=1, how="all").dropna()
           .to_numpy(dtype=np.float64))
    _same(io.import_table(path, header=False), ref)


@pytest.mark.parametrize("name", ["inflow_hydrograph.csv",
                                  "inflow_hydrograph_small.csv"])
def test_hydrographs(name):
    path = os.path.join(DATA_DIR, name)
    ref = (pd.read_csv(path, skiprows=[1]).astype(np.float64)
           .sort_values(by="time").to_numpy())
    ref[:, 0] *= 3600.0
    _same(io.import_hydrograph(path), ref)


def test_area_curve(tmp_path):
    path = tmp_path / "area.csv"
    path.write_text("stage,area\nm,km^2\n482.5,10.25\n480,8.5\n486.125,13\n")
    ref = (pd.read_csv(path, skiprows=[1]).astype(np.float64)
           .sort_values(by="stage").to_numpy()[:, :2])
    ref[:, 1] *= 1e6
    _same(io.import_area_curve(str(path)), ref)


def test_composite_trapezoid_stations():
    path = os.path.join(DATA_DIR, "composite_trapezoids.csv")
    ch, sts = io.load_trapezoid_stations(path)
    table = pd.read_csv(path)
    table = table[table["file"] != "53.csv"]
    _same(ch, table["chainage"].to_numpy(np.float64))
    cols = dict(z_bed="z_min", b_main="b_main", m_main="m_main",
                n_main="n_main", h_bank="h_bankfull", b_fp_left="b_fp_left",
                b_fp_right="b_fp_right", m_fp="m_fp", n_left="n_left",
                n_right="n_right")
    for attr, col in cols.items():
        _same([getattr(s, attr) for s in sts], table[col].to_numpy(np.float64))


@pytest.mark.parametrize("name", ["roseires_spillway_releases.csv",
                                  "roseires_deep_sluice_releases.csv"])
def test_release_table_fit(name):
    path = os.path.join(DATA_DIR, name)
    df = pd.read_csv(path, index_col=0)
    X, y = [], []
    for i, r in enumerate(df.index.to_numpy(dtype=float)):
        for j, c in enumerate(df.columns.to_numpy(dtype=float)):
            v = df.iloc[i, j]
            if not np.isnan(v):
                X.append([r, c])
                y.append(v)
    from flowsim_tpu.ops import rating_curve as rcurve

    ref = rcurve.fit_quadratic_bivariate(np.array(X), np.array(y))
    got = rrc._fit_table(path)
    for a, b in zip(np.atleast_1d(got), np.atleast_1d(ref)):
        _same(a, b)


@pytest.mark.parametrize("name", sorted(os.listdir(RAW)))
def test_raw_cross_section(name):
    path = os.path.join(RAW, name)
    ref = pd.read_csv(path)
    got = io.to_float_matrix(io.read_rows(path)[1:])
    _same(got[:, 0], ref.iloc[:, 0].to_numpy(np.float64))
    _same(got[:, 1], ref.iloc[:, 1].to_numpy(np.float64))


def test_model_builds_without_pandas():
    code = (
        "import sys\n"
        "sys.modules['pandas'] = None\n"
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "jax.config.update('jax_enable_x64', True)\n"
        "from flowsim_tpu.models.gerd_roseires import model\n"
        "solver, _ = model.build(sim_duration=3600 * 3)\n"
        "out = solver.run(tolerance=1e-6, verbose=0)\n"
        "assert bool(out.converged.all())\n"
        "print('OK', solver.number_of_nodes)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "OK 121" in r.stdout


def test_save_results_names_pandas_when_missing(monkeypatch, tmp_path):
    from flowsim_tpu.utils import results

    monkeypatch.setitem(sys.modules, "pandas", None)
    with pytest.raises(ImportError, match="pandas is required"):
        results.save_results(object(), str(tmp_path))


def test_sharded_checkpoint_names_orbax_when_missing(monkeypatch):
    from flowsim_tpu.utils import checkpoint

    monkeypatch.setitem(sys.modules, "orbax", None)
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    with pytest.raises(ImportError, match="orbax-checkpoint is required"):
        checkpoint._ocp()
