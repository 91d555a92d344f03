"""CSV loaders for case data.

Functional equivalents of the reference's
``cases/gerd_roseires/custom_functions.py:100-157`` loaders, returning
NumPy arrays / station lists for the geometry builders.  They read with the
standard library's ``csv`` module (no pandas on the solver's import path):
cells parse with Python's correctly rounded ``float``, empty cells become
NaN, blank lines are skipped and a UTF-8 byte-order mark is dropped.
"""

from __future__ import annotations

import csv

import numpy as np

from flowsim_tpu.geometry import TrapezoidStation


def read_rows(path: str, skip_rows=()) -> list:
    """Non-blank CSV rows as lists of strings; ``skip_rows`` are 0-based
    line indices dropped before parsing (e.g. a units line)."""
    with open(path, newline="", encoding="utf-8-sig") as f:
        return [row for i, row in enumerate(csv.reader(f))
                if i not in skip_rows and any(c.strip() for c in row)]


def to_float_matrix(rows) -> np.ndarray:
    """Rows of strings -> float64 matrix; short rows pad and empty cells
    read as NaN."""
    width = max((len(r) for r in rows), default=0)
    return np.array([[float(c) if c.strip() else np.nan for c in r]
                     + [np.nan] * (width - len(r)) for r in rows],
                    dtype=np.float64).reshape(len(rows), width)


def _sorted_by(table: np.ndarray, names, column: str) -> np.ndarray:
    j = list(names).index(column)
    return table[np.argsort(table[:, j], kind="stable")]


def import_table(path: str, header: bool = True, sort_by: str = None) -> np.ndarray:
    """Generic CSV -> float array (ref custom_functions.py:120-126): drops
    all-NaN columns, then rows holding any NaN."""
    rows = read_rows(path)
    names = rows.pop(0) if header else None
    table = to_float_matrix(rows)
    keep = ~np.isnan(table).all(axis=0)
    table, names = table[:, keep], (None if names is None else
                                    [n for n, k in zip(names, keep) if k])
    table = table[~np.isnan(table).any(axis=1)]
    if sort_by is not None:
        table = _sorted_by(table, names, sort_by)
    return table


def import_hydrograph(path: str, hr_to_s_conversion: bool = True) -> np.ndarray:
    """(time, flow) table, hours -> seconds (ref custom_functions.py:109-118)."""
    rows = read_rows(path, skip_rows=(1,))
    arr = _sorted_by(to_float_matrix(rows[1:]), rows[0], "time")
    if hr_to_s_conversion:
        arr[:, 0] *= 3600.0
    return arr


def import_area_curve(path: str) -> np.ndarray:
    """(stage, area) curve with km^2 -> m^2 (ref custom_functions.py:100-107)."""
    rows = read_rows(path, skip_rows=(1,))
    arr = _sorted_by(to_float_matrix(rows[1:]), rows[0], "stage")[:, :2]
    arr[:, 1] *= 1e6
    return arr


def load_trapezoid_stations(file_path: str, n_main=None, n_fp=None, skip_files=("53.csv",)):
    """Fitted compound-trapezoid stations from composite_trapezoids.csv.

    Mirrors ref custom_functions.py:128-157 (including the hard-coded skip of
    cross-section 53, ref :137-139) but returns TrapezoidStation configs for
    the struct-of-arrays geometry builder.
    """
    with open(file_path, newline="", encoding="utf-8-sig") as f:
        table = list(csv.DictReader(f))
    chainages, stations = [], []
    for row in table:
        if row["file"] in skip_files:
            continue
        chainages.append(float(row["chainage"]))
        stations.append(
            TrapezoidStation(
                z_bed=float(row["z_min"]),
                b_main=float(row["b_main"]),
                m_main=float(row["m_main"]),
                n_main=float(row["n_main"]) if n_main is None else float(n_main),
                h_bank=float(row["h_bankfull"]),
                b_fp_left=float(row["b_fp_left"]),
                b_fp_right=float(row["b_fp_right"]),
                m_fp=float(row["m_fp"]),
                n_left=float(row["n_left"]) if n_fp is None else float(n_fp),
                n_right=float(row["n_right"]) if n_fp is None else float(n_fp),
            )
        )
    return chainages, stations
