"""Matplotlib visualizations (optional dependency).

Counterparts of the reference's plot modules:

* :func:`plot_cross_section_approximation` — surveyed polyline overlaid with
  its fitted compound-trapezoid approximation from composite_trapezoids.csv
  (ref cases/gerd_roseires/visual.py:6-124).
* :func:`plot_channel_top` — plan view of the reconstructed centerline and
  bank outlines (ref cases/gerd_roseires/visual_channel_top.py, display part;
  the shapefile export lives in utils.geometry_export).

matplotlib is imported lazily; every function raises a clear ImportError if
it is unavailable so the core library carries no hard dependency on it.
"""

from __future__ import annotations

import csv
import os
from typing import Optional

import numpy as np

_GERD_DATA = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                          "models", "gerd_roseires", "data")


def _plt():
    try:
        import matplotlib
        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt
        return plt
    except ImportError as e:
        raise ImportError("matplotlib is required for flowsim_tpu.utils.plots") from e


def _read_trapezoid_rows(results_csv: str):
    with open(results_csv, newline="") as f:
        return list(csv.DictReader(f))


def _trapezoid_outline(b, m, zb, hb, center):
    """Breakpoint polyline of one trapezoid, as the reference draws it
    (ref visual.py:70-100)."""
    left = center - 0.5 * b - m * hb
    xs = np.array([left, left + m * hb, left + m * hb + b, left + b + 2 * m * hb])
    zs = np.array([zb + hb, zb, zb, zb + hb])
    return xs, zs


def plot_cross_section_approximation(index: int, folder: Optional[str] = None,
                                     results_csv: Optional[str] = None,
                                     overlay: bool = True, save: bool = False,
                                     show: bool = False, out_dir: Optional[str] = None):
    """Plot surveyed cross-section ``index`` with its fitted trapezoids.

    Mirrors ref visual.py:6-124: floodplain + main-channel trapezoids from
    composite_trapezoids.csv drawn over the raw (x, z) polyline, with the
    bankfull elevation line.  Returns the matplotlib Figure.
    """
    plt = _plt()
    folder = folder or os.path.join(_GERD_DATA, "raw", "cross_sections")
    results_csv = results_csv or os.path.join(_GERD_DATA, "composite_trapezoids.csv")

    rows = _read_trapezoid_rows(results_csv)
    if not 0 <= index < len(rows):
        raise ValueError(f"No cross-section found for index {index}")
    row = rows[index]

    xs_file = os.path.join(folder, row["file"])
    xs_number = row["file"][:2]
    data = np.genfromtxt(xs_file, delimiter=",", skip_header=1)
    x, z = data[:, 0], data[:, 1]
    z_min = float(z.min())

    b_main = float(row["b_main"])
    m_main = float(row["m_main"])
    h_bankfull = float(row["h_bankfull"])
    T_bf = b_main + 2 * m_main * h_bankfull
    b_left = float(row["b_fp_left"])
    b_fp = b_left + float(row["b_fp_right"]) + T_bf
    m_fp = float(row["m_fp"])
    h_max = float(row["h_max"])

    fig, ax = plt.subplots(figsize=(8, 4))
    if overlay:
        ax.plot(x, z, "k-", lw=1.5, label="Original cross-section")

    center = x[0] + 0.5 * (x[-1] - x[0])
    # floodplain trapezoid (ref visual.py:72-84)
    fp_x, fp_z = _trapezoid_outline(b_fp, m_fp, z_min + h_bankfull,
                                    h_max - h_bankfull, center)
    ax.plot(fp_x, fp_z, color="tab:orange", lw=2, label="Floodplain")
    ax.fill_between(fp_x, fp_z, z_min + h_bankfull, color="tab:orange", alpha=0.25)

    # main channel, positioned after the left floodplain (ref visual.py:86-100)
    mc_left = fp_x[0] + m_fp * (h_max - h_bankfull) + b_left
    mc_x = np.array([mc_left, mc_left + m_main * h_bankfull,
                     mc_left + m_main * h_bankfull + b_main,
                     mc_left + b_main + 2 * m_main * h_bankfull])
    mc_z = np.array([z_min + h_bankfull, z_min, z_min, z_min + h_bankfull])
    ax.plot(mc_x, mc_z, color="tab:blue", lw=2, label="Main channel")
    ax.fill_between(mc_x, mc_z, z_min - 0.3 * h_bankfull, color="tab:blue", alpha=0.25)

    ax.axhline(z_min + h_bankfull, color="gray", ls="--", lw=1, label="Bankfull elevation")
    ax.set_xlabel("Horizontal distance (m)")
    ax.set_ylabel("Elevation (m)")
    ax.set_title(f"Cross-section {xs_number} — Trapezoidal approximation")
    ax.legend()
    ax.grid(True, linestyle=":", alpha=0.6)
    fig.tight_layout()

    if save:
        base = os.path.splitext(os.path.basename(xs_file))[0] + "_approx.png"
        target_dir = out_dir or os.path.dirname(xs_file)
        os.makedirs(target_dir, exist_ok=True)
        fig.savefig(os.path.join(target_dir, base), dpi=150)
    if show:  # pragma: no cover
        plt.show()
    else:
        plt.close(fig)
    return fig


def plot_all_section_approximations(out_dir: str, folder: Optional[str] = None,
                                    results_csv: Optional[str] = None):
    """Save every fitted section plot (ref visual.py:123-124 loop).
    Returns the list of figure paths written."""
    results_csv = results_csv or os.path.join(_GERD_DATA, "composite_trapezoids.csv")
    rows = _read_trapezoid_rows(results_csv)
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, row in enumerate(rows):
        plot_cross_section_approximation(i, folder=folder, results_csv=results_csv,
                                         save=True, show=False, out_dir=out_dir)
        # the exact file the save branch writes (listdir would also pick up
        # unrelated pre-existing files in out_dir)
        base = os.path.splitext(os.path.basename(row["file"]))[0] + "_approx.png"
        paths.append(os.path.join(out_dir, base))
    return paths


def plot_channel_top(chainages, widths, curvature, x0=726833.0, y0=1240801.0,
                     theta0=np.pi - 0.2, save_path: Optional[str] = None,
                     show: bool = False):
    """Plan view: centerline + left/right bank outlines reconstructed from
    curvature and top widths (ref visual_channel_top.py:83-98 + the draw()
    display in custom_functions.py:41-66).  Returns the Figure.
    """
    plt = _plt()
    from flowsim_tpu.utils.geometry_export import bank_outlines, reconstruct_centerline

    x, y, theta = reconstruct_centerline(chainages, curvature, x0, y0, theta0)
    left, right = bank_outlines(x, y, theta, widths)

    fig, ax = plt.subplots(figsize=(8, 8))
    ax.plot(x, y, "k--", lw=1, label="Centerline")
    ax.plot(left[:, 0], left[:, 1], "b-", lw=1.5, label="Left bank")
    ax.plot(right[:, 0], right[:, 1], "g-", lw=1.5, label="Right bank")
    ax.set_aspect("equal")
    ax.set_xlabel("Easting (m)")
    ax.set_ylabel("Northing (m)")
    ax.set_title("Channel plan view")
    ax.legend()
    ax.grid(True, linestyle=":", alpha=0.6)
    fig.tight_layout()

    if save_path:
        fig.savefig(save_path, dpi=150)
    if show:  # pragma: no cover
        plt.show()
    else:
        plt.close(fig)
    return fig
