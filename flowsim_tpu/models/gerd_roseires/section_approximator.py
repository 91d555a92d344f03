"""Compound-trapezoid fitting of surveyed cross-sections (preprocessing).

Replicates the reference's section approximator
(ref: cases/gerd_roseires/section_approximator.py): sample A(h) from each raw
(x, z) polyline, find the bankfull depth at the knee of the area-depth curve
(peak of the smoothed second derivative), least-squares fit (b, m) trapezoid
parameters separately for the main channel and the floodplain annulus, and
apportion the floodplain bottom width left/right by the available widths.
Output rows match the columns of composite_trapezoids.csv consumed by the
flagship model.

This is a host-side tool (NumPy/SciPy); it runs once per dataset.
"""

from __future__ import annotations

import csv
import os

import numpy as np
from scipy.optimize import least_squares

from flowsim_tpu.geometry_tables import polyline_properties
from flowsim_tpu.utils.io import read_rows, to_float_matrix

OUTPUT_COLUMNS = ("z_min", "file", "b_main", "m_main", "err_main", "b_fp_left",
                  "b_fp_right", "m_fp", "err_fp", "h_bankfull", "h_max")


def area_curve(x, z, h_values):
    """A(h) for an irregular section (ref section_approximator.py:10-48)."""
    zmin = float(np.min(z))
    return np.array(
        [0.0 if h < 1e-9 else polyline_properties(np.asarray(x, float), np.asarray(z, float), zmin + h)[0]
         for h in h_values]
    )


def segments_at_level(x, z, level):
    """(x_start, x_end) spans below a z level (ref :50-79)."""
    segs = []
    n = len(z)
    i = 0
    while i < n:
        if z[i] < level:
            s = i
            while i < n and z[i] < level:
                i += 1
            e = i - 1
            xs = x[s]
            if s > 0 and z[s - 1] >= level:
                xs = x[s - 1] + (x[s] - x[s - 1]) * (level - z[s - 1]) / (z[s] - z[s - 1])
            xe = x[e]
            if e < n - 1 and z[e + 1] >= level:
                xe = x[e] + (x[e + 1] - x[e]) * (level - z[e]) / (z[e + 1] - z[e])
            segs.append((xs, xe))
        else:
            i += 1
    return segs


def fit_trapezoid(h_vals, A_targets, bounds, b0=None, m0=None):
    """Least-squares (b, m) to the area samples (ref :81-110)."""
    b0 = np.max(A_targets) / np.max(h_vals) if b0 is None else b0
    m0 = 1.0 if m0 is None else m0

    def resid(params):
        b, m = params
        A_model = h_vals * (b + m * h_vals)
        return (A_model - A_targets) / np.clip(A_targets, 1e-6, None)

    res = least_squares(resid, [b0, m0], bounds=bounds)
    return res.x[0], res.x[1], res.cost


def determine_bankfull_depth(h, A, window_size=5):
    """Knee of A(h): peak of the smoothed d2A/dh2 (ref :112-136)."""
    if window_size % 2 == 0:
        window_size += 1
    dA = np.gradient(A, h, edge_order=2)
    dA_s = np.convolve(dA, np.ones(window_size) / window_size, mode="valid")
    h_t = h[window_size // 2 : -(window_size // 2)]
    if len(h_t) == 0:
        return float(np.max(h))
    d2 = np.gradient(dA_s, h_t)
    try:
        return float(h_t[int(np.argmax(d2))])
    except (ValueError, IndexError):
        return float(np.max(h))


def fit_compound_trapezoid(x, z, h, bank_z=None):
    """Main + floodplain compound fit (ref :138-216)."""
    x = np.asarray(x, float)
    z = np.asarray(z, float)
    A = area_curve(x, z, h)
    z_min = float(np.min(z))
    h_bf = determine_bankfull_depth(h, A) if bank_z is None else bank_z - z_min
    z_bank = z_min + h_bf

    segs = segments_at_level(x, z, z_bank)
    if not segs:
        x_bl, x_br = float(np.min(x)), float(np.max(x))
    else:
        x_bl, x_br = max(segs, key=lambda s: s[1] - s[0])
    T_bf = x_br - x_bl
    T_max = float(x[-1] - x[0])

    mask_main = h <= h_bf
    if np.sum(mask_main) < 3:
        return dict(z_min=z_min, b_main=np.nan, m_main=np.nan, err_main=np.nan,
                    b_fp_left=np.nan, b_fp_right=np.nan, m_fp=np.nan, err_fp=np.nan,
                    h_bankfull=h_bf, h_max=float(np.max(h)))

    max_T = 0.25 * (3 * T_bf + T_max)
    b_c, m_c, err_c = fit_trapezoid(h[mask_main], A[mask_main],
                                    bounds=([0.0, 0.0], [max_T, (max_T) / (2 * h_bf)]))
    T_bf = b_c + 2 * m_c * h_bf

    w_left = x_bl - float(np.min(x))
    w_right = float(np.max(x)) - x_br
    w_total = w_left + w_right

    mask_fp = h > h_bf
    if np.sum(mask_fp) >= 3:
        A_bf = np.interp(h_bf, h, A)
        b_f, m_f, err_f = fit_trapezoid(h[mask_fp] - h_bf, A[mask_fp] - A_bf,
                                        b0=T_bf + 0.01,
                                        bounds=([T_bf, 0.0], [1e6, 1e4]))
    else:
        b_f, m_f, err_f = np.nan, np.nan, np.nan

    b_f_left = b_f_right = np.nan
    if not np.isnan(b_f - T_bf):
        if w_total > 1e-6:
            frac = w_left / w_total
            b_f_left = (b_f - T_bf) * frac
            b_f_right = (b_f - T_bf) * (1.0 - frac)
        else:
            b_f_left = b_f_right = 0.0

    return dict(z_min=z_min, b_main=b_c, m_main=m_c, err_main=err_c,
                b_fp_left=b_f_left, b_fp_right=b_f_right, m_fp=m_f, err_fp=err_f,
                h_bankfull=h_bf, h_max=float(np.max(h)))


def approximate_folder(folder, output_csv=None, bank_z_by_index=None):
    """Fit every raw cross-section CSV in ``folder`` (ref :218-268).

    Returns one dict per fitted section, keyed by :data:`OUTPUT_COLUMNS`;
    ``output_csv`` also writes them as a CSV table."""
    records = []
    files = sorted(f for f in os.listdir(folder) if f.endswith(".csv"))
    for i, name in enumerate(files):
        # per-file isolation like the reference driver (ref :257-265):
        # one pathological section (e.g. a canyon whose slope bound falls
        # below the fit's initial guess) must not abort the whole batch
        try:
            data = to_float_matrix(read_rows(os.path.join(folder, name))[1:])
            x, z = data[:, 0], data[:, 1]
            if len(x) < 3:
                continue
            max_depth = float(z.max() - z.min())
            min_h = max_depth * 0.1 if max_depth < 3.0 else 2.01
            if min_h >= max_depth:
                max_depth = min_h + 1.0
            n_steps = int(max(20, (max_depth - min_h) * 10))
            depths = np.linspace(min_h, max_depth, n_steps)
            bank_z = None if bank_z_by_index is None else bank_z_by_index[i]
            rec = fit_compound_trapezoid(x, z, depths, bank_z)
            rec["file"] = name
            records.append(rec)
        except Exception as e:  # noqa: BLE001 — mirror ref's per-file catch
            print(f"Failed to process {name}: {e}")
    records = [{c: r[c] for c in OUTPUT_COLUMNS} for r in records]
    if output_csv:
        with open(output_csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=OUTPUT_COLUMNS)
            w.writeheader()
            w.writerows(records)
    return records
