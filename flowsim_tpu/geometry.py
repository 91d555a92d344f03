"""Channel geometry as struct-of-arrays pytrees.

The reference represents geometry as one Python ``CrossSection`` object per
node with virtual dispatch and per-instance memo caches
(ref: src/hydromodel/cross_section.py:6-846, channel.py:213-241).  That is the
antithesis of accelerator style: every closure evaluation is a host-side
scalar call.

Here a channel reach is a **pytree of per-node parameter arrays**.  All
hydraulic closures (see :mod:`flowsim_tpu.ops.sections`) are vectorized pure
functions of ``(geometry, depth)`` that XLA fuses into the solver stencil.

Two representations:

* :class:`TrapezoidGeometry` — rectangular / simple-trapezoid /
  compound-trapezoid sections in closed form (covers every shipped reference
  case: ref cases/example (rectangle), cases/akbari_firoozi (rectangle),
  cases/gerd_roseires (compound trapezoids from composite_trapezoids.csv)).
* :class:`TableGeometry` — irregular surveyed (x, z) polyline sections,
  rasterized on the host into monotone per-node lookup tables A(h), P(h),
  T(h), K(h), n_eq(h) and interpolated on device
  (ref IrregularSection: cross_section.py:207-543 evaluates the polyline
  per call; rasterization preserves its values to table resolution).

Host-side construction (station interpolation, planform curvature) replicates
ref channel.py:213-294 with NumPy and runs once at setup.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp


# ---------------------------------------------------------------------------
# Station description (host side, scalar)
# ---------------------------------------------------------------------------


@dataclass
class TrapezoidStation:
    """Scalar parameters of one surveyed/fitted trapezoid section.

    Mirrors the constructor arguments of the reference's
    ``TrapezoidalSection`` (ref: cross_section.py:569-613).  ``h_bank`` is the
    bankfull depth ``z_bank - z_bed``; ``None`` means a simple (non-compound)
    section.
    """

    z_bed: float
    b_main: float
    m_main: float = 0.0
    n_main: float = 0.03
    h_bank: Optional[float] = None
    b_fp_left: float = 0.0
    b_fp_right: float = 0.0
    m_fp: float = 0.0
    n_left: float = 0.03
    n_right: float = 0.03
    bed_slope: Optional[float] = None
    curvature: float = 0.0


def trapezoid_station(**kwargs) -> TrapezoidStation:
    return TrapezoidStation(**kwargs)


# ---------------------------------------------------------------------------
# Device geometry pytrees
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class TrapezoidGeometry:
    """Per-node trapezoid parameters, shape [N] each.

    ``compound`` is a bool mask; where False the floodplain fields are unused
    (``h_bank`` holds a large sentinel so ``depth <= h_bank`` always holds).
    ``bed_slope`` is NaN where the reference would carry ``None``.
    """

    z_bed: jnp.ndarray
    b_main: jnp.ndarray
    m_main: jnp.ndarray
    n_main: jnp.ndarray
    compound: jnp.ndarray
    h_bank: jnp.ndarray
    b_fp_left: jnp.ndarray
    b_fp_right: jnp.ndarray
    m_fp: jnp.ndarray
    n_left: jnp.ndarray
    n_right: jnp.ndarray
    bed_slope: jnp.ndarray
    curvature: jnp.ndarray

    @property
    def n_nodes(self) -> int:
        return self.z_bed.shape[-1]

    def astype(self, dtype) -> "TrapezoidGeometry":
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            out[f.name] = v if v.dtype == jnp.bool_ else v.astype(dtype)
        return TrapezoidGeometry(**out)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class TableGeometry:
    """Per-node lookup tables over a uniform depth grid.

    ``depth_max[n]`` is the table span of node ``n``; tables hold M samples at
    depths ``j * depth_max / (M-1)``.  Values beyond the span extrapolate
    linearly using the last interval.
    """

    z_bed: jnp.ndarray       # [N]
    depth_max: jnp.ndarray   # [N]
    area: jnp.ndarray        # [N, M]
    perimeter: jnp.ndarray   # [N, M]
    top_width: jnp.ndarray   # [N, M]
    conveyance: jnp.ndarray  # [N, M]
    n_eq: jnp.ndarray        # [N, M]
    dK_dA: jnp.ndarray       # [N, M]
    dR_dA: jnp.ndarray       # [N, M]
    bed_slope: jnp.ndarray   # [N]
    curvature: jnp.ndarray   # [N]
    # Build-time main-channel Manning n baked into the conveyance columns
    # (None when the source stations disagree — None, not NaN: a static
    # pytree field participates in treedef equality and NaN != NaN would
    # make two identically built geometries structurally unequal).  Static
    # metadata, not a leaf: parallel.ensemble.table_roughness_ensemble uses
    # it to anchor its exact roughness rescale without the caller
    # re-threading the build-time value.
    n_ref: Optional[float] = dataclasses.field(
        default=None, metadata=dict(static=True))

    @property
    def n_nodes(self) -> int:
        # area is [..., N, M]; z_bed's second-to-last axis is the BATCH axis
        # when members are stacked, so derive N from the table shape
        return self.area.shape[-2]

    def astype(self, dtype) -> "TableGeometry":
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            out[f.name] = v.astype(dtype) if hasattr(v, "astype") else v
        return TableGeometry(**out)


# ---------------------------------------------------------------------------
# Host-side builders
# ---------------------------------------------------------------------------

_SIMPLE_H_BANK_SENTINEL = 1e30


def _station_to_arrays(st: TrapezoidStation) -> dict:
    compound = st.h_bank is not None
    return dict(
        z_bed=st.z_bed,
        b_main=st.b_main,
        m_main=st.m_main,
        n_main=st.n_main,
        compound=compound,
        h_bank=st.h_bank if compound else _SIMPLE_H_BANK_SENTINEL,
        b_fp_left=st.b_fp_left,
        b_fp_right=st.b_fp_right,
        m_fp=st.m_fp,
        n_left=st.n_left,
        n_right=st.n_right,
        bed_slope=np.nan if st.bed_slope is None else st.bed_slope,
        curvature=st.curvature,
    )


def planform_curvature(
    station_chainages: np.ndarray,
    coords_chainages: np.ndarray,
    coords: np.ndarray,
) -> np.ndarray:
    """Planform curvature per station from a centerline polyline.

    Three-point turning-angle formula applied to interior stations; end
    stations keep curvature 0 (ref: channel.py:243-277).
    """
    ch = np.asarray(station_chainages, dtype=float)
    curv = np.zeros_like(ch)
    for i in range(1, len(ch) - 1):
        chs = np.array([ch[i - 1], ch[i], ch[i + 1]])
        xys = np.column_stack(
            [
                np.interp(chs, coords_chainages, coords[:, 0]),
                np.interp(chs, coords_chainages, coords[:, 1]),
            ]
        )
        xy_left, xy, xy_right = xys
        v1 = xy - xy_left
        v2 = xy_right - xy
        if np.linalg.norm(v1) == 0 or np.linalg.norm(v2) == 0:
            curv[i] = 0.0
            continue
        dot = np.dot(v1, v2) / (np.linalg.norm(v1) * np.linalg.norm(v2))
        theta = np.arccos(np.clip(dot, -1.0, 1.0))
        L = 0.5 * (np.linalg.norm(v1) + np.linalg.norm(v2))
        curv[i] = 2.0 * np.sin(theta / 2.0) / L * np.sign(np.cross(v1, v2))
    return curv


def _blend_station(a: dict, b: dict, w1: float, w2: float) -> dict:
    """Distance-weighted blend of two trapezoid stations.

    Mirrors ``interpolate_cross_section`` for the trapezoid x trapezoid case
    (ref: cross_section.py:898-930): parameters blend linearly; bankfull depth
    blends through ``y_bank`` with simple sections contributing 0, and the
    result is simple again if the blended bank depth is <= 1e-6.
    """
    y_bank1 = a["h_bank"] if a["compound"] else 0.0
    y_bank2 = b["h_bank"] if b["compound"] else 0.0
    y_new = y_bank1 * w1 + y_bank2 * w2
    compound = y_new > 1e-6
    if np.isnan(a["bed_slope"]) or np.isnan(b["bed_slope"]):
        bed_slope = np.nan
    else:
        bed_slope = a["bed_slope"] * w1 + b["bed_slope"] * w2
    return dict(
        z_bed=a["z_bed"] * w1 + b["z_bed"] * w2,
        b_main=a["b_main"] * w1 + b["b_main"] * w2,
        m_main=a["m_main"] * w1 + b["m_main"] * w2,
        n_main=a["n_main"] * w1 + b["n_main"] * w2,
        compound=compound,
        h_bank=y_new if compound else _SIMPLE_H_BANK_SENTINEL,
        b_fp_left=a["b_fp_left"] * w1 + b["b_fp_left"] * w2,
        b_fp_right=a["b_fp_right"] * w1 + b["b_fp_right"] * w2,
        m_fp=a["m_fp"] * w1 + b["m_fp"] * w2,
        n_left=a["n_left"] * w1 + b["n_left"] * w2,
        n_right=a["n_right"] * w1 + b["n_right"] * w2,
        bed_slope=bed_slope,
        curvature=a["curvature"] * w1 + b["curvature"] * w2,
    )


def interpolate_stations(
    stations: list[TrapezoidStation],
    chainages: np.ndarray,
    node_chainages: np.ndarray,
    coords: Optional[np.ndarray] = None,
    coords_chainages: Optional[np.ndarray] = None,
    dtype=None,
) -> TrapezoidGeometry:
    """Build per-node geometry arrays by interpolating surveyed stations.

    Replicates ref channel.py:213-241 (node lookup, distance weights, clamping
    to end stations) and channel.py:243-277 (curvature assignment).
    """
    if dtype is None:
        from flowsim_tpu.config import default_dtype

        dtype = default_dtype()
    chainages = np.asarray(chainages, dtype=float)
    node_chainages = np.asarray(node_chainages, dtype=float)
    if not np.all(np.diff(chainages) > 0):
        raise ValueError("chainages must be strictly increasing")
    if len(chainages) != len(stations):
        raise ValueError("chainages and stations must have same length")

    sts = [_station_to_arrays(s) for s in stations]
    if coords is not None and coords_chainages is not None:
        curv = planform_curvature(chainages, np.asarray(coords_chainages, float), np.asarray(coords, float))
        # end stations keep their constructor curvature (0 by default),
        # interior stations get the planform value (ref: channel.py:244).
        for i in range(1, len(sts) - 1):
            sts[i]["curvature"] = curv[i]

    rows = []
    for s in node_chainages:
        if s <= chainages[0]:
            rows.append(sts[0])
            continue
        if s >= chainages[-1]:
            rows.append(sts[-1])
            continue
        j = int(np.searchsorted(chainages, s)) - 1
        dist1 = s - chainages[j]
        dist2 = chainages[j + 1] - s
        total = dist1 + dist2
        if total < 1e-9 or dist1 < 1e-9:
            rows.append(sts[j])
        elif dist2 < 1e-9:
            rows.append(sts[j + 1])
        else:
            rows.append(_blend_station(sts[j], sts[j + 1], dist2 / total, dist1 / total))

    def col(name, dt=dtype):
        return jnp.asarray(np.array([r[name] for r in rows]), dtype=dt)

    return TrapezoidGeometry(
        z_bed=col("z_bed"),
        b_main=col("b_main"),
        m_main=col("m_main"),
        n_main=col("n_main"),
        compound=jnp.asarray(np.array([r["compound"] for r in rows], dtype=bool)),
        h_bank=col("h_bank"),
        b_fp_left=col("b_fp_left"),
        b_fp_right=col("b_fp_right"),
        m_fp=col("m_fp"),
        n_left=col("n_left"),
        n_right=col("n_right"),
        bed_slope=col("bed_slope"),
        curvature=col("curvature"),
    )


def build_trapezoid_geometry(
    n_nodes: int,
    length: float,
    us_z_bed: float,
    ds_z_bed: float,
    width: float,
    roughness: float,
    dtype=None,
) -> TrapezoidGeometry:
    """Provisional prismatic rectangular reach (ref: channel.py:282-294).

    Both end sections are rectangles of the given width/roughness with a
    common bed slope ``(z_us - z_ds)/length``; nodes interpolate linearly.
    """
    bed_slope = (us_z_bed - ds_z_bed) / length
    us = TrapezoidStation(z_bed=us_z_bed, b_main=width, m_main=0.0, n_main=roughness, bed_slope=bed_slope)
    ds = TrapezoidStation(z_bed=ds_z_bed, b_main=width, m_main=0.0, n_main=roughness, bed_slope=bed_slope)
    node_ch = np.linspace(0.0, length, n_nodes)
    return interpolate_stations([us, ds], np.array([0.0, length]), node_ch, dtype=dtype)
