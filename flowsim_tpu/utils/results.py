"""Results pipeline: derived fields, workbook export, summary metrics.

Replicates the reference solver's post-processing surface
(ref: src/hydromodel/solver.py:65-233):

* nine derived 2-D fields (level, flow, depth, velocity, area, top width,
  wave celerity, amplitude, Froude number) — here computed vectorized over
  [nt, N] in one shot instead of per-node Python loops (ref :77-91);
* reservoir stage / outflow reconstruction for storage boundaries (ref
  :100-127);
* an XLSX workbook with one sheet per field + peak amplitude + bed level
  (ref :129-185), falling back to per-sheet CSV files when no Excel engine
  is installed;
* a TXT summary with the reference's acceptance scalars: mass imbalance,
  peak attenuation, median-volume entry/arrival/travel times (ref :187-233).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from flowsim_tpu.config import GRAVITY as g
from flowsim_tpu.ops import hydraulics as hyd
from flowsim_tpu.ops import sections as sec
from flowsim_tpu.ops import storage as storage_mod


@dataclass
class Results:
    bed_profile: np.ndarray
    level: np.ndarray
    area: np.ndarray
    top_width: np.ndarray
    froude_number: np.ndarray
    velocity: np.ndarray
    wave_celerity: np.ndarray
    amplitude: np.ndarray
    peak_amplitude: np.ndarray
    storage_stage: Optional[np.ndarray] = None
    storage_outflow: Optional[np.ndarray] = None


def derived_fields(geo, depth, flow):
    """All derived fields in one vectorized evaluation (ref solver.py:65-98)."""
    depth = jnp.asarray(depth)
    flow = jnp.asarray(flow)
    st = jax.vmap(lambda h: sec.section_state(geo, h))(depth)
    area, top_width = st.A, st.T
    froude = hyd.froude(top_width, area, flow)
    velocity = flow / area
    celerity = velocity + jnp.sqrt(g * area / top_width)
    amplitude = depth - depth[0]
    return area, top_width, froude, velocity, celerity, amplitude


def prepare_results(solver) -> Results:
    geo = solver.channel.geometry
    depth = np.asarray(solver.depth)
    flow = np.asarray(solver.flow)
    area, top_width, froude, velocity, celerity, amplitude = map(
        np.asarray, derived_fields(geo, depth, flow)
    )
    bed = np.asarray(geo.z_bed)
    res = Results(
        bed_profile=bed,
        level=depth + bed,
        area=area,
        top_width=top_width,
        froude_number=froude,
        velocity=velocity,
        wave_celerity=celerity,
        amplitude=amplitude,
        peak_amplitude=amplitude.max(axis=0),
    )

    ds = solver.channel.downstream_boundary
    if getattr(ds, "lumped_storage", None) is not None and solver.output is not None:
        sp = ds.lumped_storage.build()
        nt = depth.shape[0]
        dt = solver.time_step
        # initial stage = initial boundary water level minus entrance losses
        # (ref solver.py:100-108)
        hw0 = depth[0, -1] + bed[-1]
        geo_ds = jax.tree_util.tree_map(lambda a: a[-1], geo)
        st0 = sec.section_state(geo_ds, jnp.asarray(depth[0, -1]))
        loss0 = float(storage_mod.energy_loss(sp, st0.A, jnp.asarray(flow[0, -1]), st0.n_eq, st0.R))
        stages = np.concatenate([[hw0 - loss0], np.asarray(solver.output.reservoir_stage[1:])])

        outflow = np.empty(nt)
        rc = ds.lumped_storage.rating_curve
        if rc is None:
            outflow[0] = 0.0
        else:
            outflow[0] = min(flow[0, -1], rc.discharge(stage=stages[0], time=0))
        # ref solver.py:121-127, vectorized: net_vol_change is elementwise in
        # (Y1, Y2), so one call covers all levels (nt eager per-step calls
        # each cost a dispatch + host sync)
        Q_bnd = flow[:, -1]
        avg_in = 0.5 * (Q_bnd[:-1] + Q_bnd[1:])
        dvol = np.asarray(storage_mod.net_vol_change(
            sp, jnp.asarray(stages[:-1]), jnp.asarray(stages[1:])))
        outflow[1:] = (avg_in - dvol / dt) * Q_bnd[1:] / avg_in
        res.storage_stage = stages
        res.storage_outflow = outflow
    return res


def _seconds_to_hms(seconds):
    if seconds < 0:
        return "0:00:00"
    total = int(seconds)
    return f"{total // 3600}:{(total % 3600) // 60:02d}:{total % 60:02d}"


def summary_metrics(flow: np.ndarray, dt: float) -> dict:
    """The reference's acceptance scalars (ref solver.py:203-233)."""
    Q_in = flow[:, 0]
    Q_out = flow[:, -1]
    mass_imbalance = float(np.sum(Q_in - Q_out) * dt)
    mass_imbalance_pct = float(mass_imbalance / dt / np.sum(Q_in)) * 100.0
    peak_in = float(np.max(Q_in))
    peak_out = float(np.max(Q_out))
    attenuation_pct = (peak_in - peak_out) / peak_in * 100.0

    def median_time(Q):
        cum = np.array([np.sum(Q[:i]) for i in range(Q.size)])
        idx = int(np.argmax(cum >= 0.5 * cum[-1]))
        return idx * dt

    entry = median_time(Q_in)
    arrival = median_time(Q_out)
    return dict(
        mass_imbalance=mass_imbalance,
        mass_imbalance_pct=mass_imbalance_pct,
        peak_inflow=peak_in,
        peak_outflow=peak_out,
        attenuation_pct=attenuation_pct,
        median_vol_entry_time=entry,
        median_vol_arrival_time=arrival,
        median_vol_travel_time=arrival - entry,
    )


def ensemble_summary(flow: np.ndarray, dt: float,
                     quantiles=(0.05, 0.5, 0.95)) -> dict:
    """Vectorized :func:`summary_metrics` over a member batch, plus
    cross-member quantiles — the Monte-Carlo reduction of the reference's
    per-run acceptance scalars (ref solver.py:203-233).

    ``flow``: ``[B, nt, N]`` (or ``[B, nt, 2]`` from
    ``settings.store="boundaries"``).  Returns ``{"members": {metric: [B]},
    "quantiles": {metric: {q: value}}}``; each member's row equals
    :func:`summary_metrics` on that member exactly.
    """
    flow = np.asarray(flow)
    Q_in = flow[:, :, 0]    # [B, nt]
    Q_out = flow[:, :, -1]
    mass_imbalance = np.sum(Q_in - Q_out, axis=1) * dt
    mass_imbalance_pct = mass_imbalance / dt / np.sum(Q_in, axis=1) * 100.0
    peak_in = np.max(Q_in, axis=1)
    peak_out = np.max(Q_out, axis=1)
    attenuation_pct = (peak_in - peak_out) / peak_in * 100.0

    def median_time(Q):
        # exclusive cumulative volume, as summary_metrics' sum(Q[:i])
        cum = np.concatenate(
            [np.zeros((Q.shape[0], 1)), np.cumsum(Q, axis=1)[:, :-1]], axis=1)
        idx = np.argmax(cum >= 0.5 * cum[:, -1:], axis=1)
        return idx * dt

    entry = median_time(Q_in)
    arrival = median_time(Q_out)
    members = dict(
        mass_imbalance=mass_imbalance,
        mass_imbalance_pct=mass_imbalance_pct,
        peak_inflow=peak_in,
        peak_outflow=peak_out,
        attenuation_pct=attenuation_pct,
        median_vol_entry_time=entry.astype(np.float64),
        median_vol_arrival_time=arrival.astype(np.float64),
        median_vol_travel_time=(arrival - entry).astype(np.float64),
    )
    qs = {name: {float(q): float(np.quantile(v, q)) for q in quantiles}
          for name, v in members.items()}
    return {"members": members, "quantiles": qs}


def network_summary(out, branches, dt: float, junction_area=None) -> dict:
    """Network-wide acceptance scalars (the network counterpart of
    :func:`summary_metrics`; beyond the reference, which is single-reach).

    ``out``: a :class:`~flowsim_tpu.ops.network.NetworkOutput`;
    ``branches``: the list of BranchDefs it was produced from.

    Volumes integrate the external boundary fluxes the same way the
    reference's TXT summary does (plain sum * dt, ref solver.py:203-233):
    inflow over external upstream ends, outflow over external downstream
    ends plus any rated junction outflow, and junction-reservoir storage
    change closes the balance.  ``max_junction_imbalance`` is the largest
    instantaneous discharge-continuity residual over plain junctions and
    levels 1+ (the quantity the solver drove below tolerance).
    """
    from flowsim_tpu.ops.network import _is_junction

    flows = [np.asarray(q) for q in out.flow]
    nt = flows[0].shape[0]
    Q_in = np.zeros(nt)
    Q_out = np.zeros(nt)
    for br, q in zip(branches, flows):
        if not _is_junction(br.us):
            Q_in = Q_in + q[:, 0]
        if not _is_junction(br.ds):
            Q_out = Q_out + q[:, -1]
    q_junc = (np.asarray(out.junction_outflow)
              if out.junction_outflow is not None
              else np.zeros((nt, 0)))
    Q_out_total = Q_out + q_junc.sum(axis=1)

    # junction-reservoir storage change (plain junctions have area 0)
    J = np.asarray(out.junction_stage).shape[1]
    area = np.zeros(J) if junction_area is None else np.asarray(
        junction_area, np.float64)
    # baseline is Y[0] (the true initial pool stage): the first trapezoidal
    # balance spans Y[0] -> Y[1], so anchoring on Y[1] would bias the
    # imbalance by area * (Y[1] - Y[0]) for junction-reservoir networks
    Y = np.asarray(out.junction_stage)
    stored = float(np.sum(area * (Y[-1] - Y[0] if nt > 1 else 0.0)))

    inflow_vol = float(np.sum(Q_in) * dt)
    outflow_vol = float(np.sum(Q_out_total) * dt)
    imbalance = inflow_vol - outflow_vol - stored

    # instantaneous continuity residual at plain junctions, levels 1+
    max_imb = 0.0
    if J and nt > 1:
        S = np.zeros((nt, J))
        for br, q in zip(branches, flows):
            if _is_junction(br.ds):
                S[:, int(br.ds)] += q[:, -1]
            if _is_junction(br.us):
                S[:, int(br.us)] -= q[:, 0]
        plain = area <= 0.0
        if plain.any():
            resid = S[1:, plain] - q_junc[1:, plain]
            max_imb = float(np.abs(resid).max())

    return dict(
        inflow_volume=inflow_vol,
        outflow_volume=outflow_vol,
        junction_storage_change=stored,
        mass_imbalance=imbalance,
        mass_imbalance_pct=(imbalance / inflow_vol * 100.0
                            if inflow_vol else 0.0),
        peak_inflow=float(Q_in.max()),
        peak_outflow=float(Q_out_total.max()),
        max_junction_imbalance=max_imb,
        total_newton_iterations=int(np.asarray(out.iterations).sum()),
        all_converged=bool(np.asarray(out.converged).all()),
    )


def save_results(solver, folder_path: str, file_name: str = None) -> None:
    """Workbook + TXT summary (ref solver.py:129-233).

    Uses pandas.ExcelWriter when an engine (openpyxl/xlsxwriter) is present;
    otherwise writes one CSV per sheet next to the TXT summary.
    """
    try:
        import pandas as pd
    except ImportError as e:
        raise ImportError("pandas is required for save_results (the "
                          "workbook export); the solver itself does not "
                          "need it") from e

    os.makedirs(folder_path, exist_ok=True)
    file_name = "results.xlsx" if file_name is None else file_name
    file_path = os.path.join(folder_path, file_name)

    res = solver.prepare_results()
    nt, nx = solver.flow.shape
    time = np.arange(nt) * solver.time_step
    distance = np.asarray(solver.channel.ch_at_node, dtype=np.float64)

    arrays_2d = {
        "Level": res.level,
        "Flow": solver.flow,
        "Depth": solver.depth,
        "Velocity": res.velocity,
        "Area": res.area,
        "Top width": res.top_width,
        "Wave celerity": res.wave_celerity,
        "Amplitude": res.amplitude,
        "Froude number": res.froude_number,
    }

    frames = {}
    for name, arr in arrays_2d.items():
        df = pd.DataFrame(arr, index=time, columns=distance)
        df.index.name = "Time"
        df.columns.name = "Distance"
        frames[name] = df
    if res.storage_outflow is not None:
        frames["Outflow"] = pd.DataFrame({"outflow": res.storage_outflow}, index=time)
        if getattr(solver, "_type", None) == "preissmann":
            frames["Reservoir stage"] = pd.DataFrame({"stage": res.storage_stage}, index=time)
    frames["Peak amplitude"] = pd.DataFrame([res.peak_amplitude], columns=distance, index=["Peak amplitude"])
    frames["Bed level"] = pd.DataFrame([res.bed_profile], columns=distance, index=["Bed level"])

    try:
        with pd.ExcelWriter(file_path) as writer:
            for name, df in frames.items():
                df.to_excel(writer, sheet_name=name)
    except (ImportError, ModuleNotFoundError, ValueError):
        # no Excel engine in this environment: CSV-per-sheet fallback
        base = file_path[:-5] if file_path.endswith(".xlsx") else file_path
        os.makedirs(base, exist_ok=True)
        for name, df in frames.items():
            df.to_csv(os.path.join(base, f"{name}.csv"))

    m = summary_metrics(np.asarray(solver.flow), solver.time_step)
    txt_path = (file_path[:-5] if file_path.endswith(".xlsx") else file_path) + ".txt"
    with open(txt_path, "w") as f:
        f.write(f"Spatial step = {solver.spatial_step} m\n")
        f.write(f"Time step = {solver.time_step} s\n")
        if getattr(solver, "_type", None) == "preissmann":
            f.write(f"Theta = {solver.theta}\n")
        f.write(f"Simulation duration = {_seconds_to_hms(solver.total_sim_duration)}\n")
        f.write(
            f"Mass imbalance (total inflow - total outflow) = {m['mass_imbalance']:.2f} m^3 "
            f"= {m['mass_imbalance_pct']:.4f}% of inflow.\n"
        )
        f.write(f"Peak inflow = {m['peak_inflow']:.2f} m^3/s\n")
        f.write(f"Peak outflow = {m['peak_outflow']:.2f} m^3/s\n")
        f.write(f"Attenuation = {m['attenuation_pct']:.2f}%\n")
        f.write(f"Median volume entry time = {_seconds_to_hms(m['median_vol_entry_time'])}\n")
        f.write(f"Median volume arrival time = {_seconds_to_hms(m['median_vol_arrival_time'])}\n")
        f.write(f"Median volume travel time = {_seconds_to_hms(m['median_vol_travel_time'])}\n")
