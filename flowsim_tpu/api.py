"""High-level user API.

Mirrors the ergonomics of the reference package (``Channel``/``Boundary``/
``Hydrograph``/``RatingCurve``/``LumpedStorage``/``PreissmannSolver``/
``LaxSolver``; ref: src/hydromodel/*) so a reference user can switch with
minimal edits, while compiling everything down to the pytree/functional core:

* host objects collect configuration;
* ``PreissmannSolver``/``LaxSolver`` lower them to (geometry pytree, boundary
  params, settings) and run the jitted scan;
* results and accessors match the reference solver surface
  (``depth``/``flow`` arrays, ``save_results``, per-node accessors).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import jax
import jax.numpy as jnp

from flowsim_tpu import geometry as geom
from flowsim_tpu.config import default_dtype
from flowsim_tpu.ops import boundary as bnd
from flowsim_tpu.ops import initial_conditions as ic
from flowsim_tpu.ops import preissmann as prs
from flowsim_tpu.ops import rating_curve as rcurve
from flowsim_tpu.ops import sections as sec
from flowsim_tpu.ops import storage as storage_mod
from flowsim_tpu.ops import tridiag


class Hydrograph:
    """Forcing time series Q(t) or stage(t) (ref: hydrograph.py:3-33).

    Either a table (linear interpolation) or an arbitrary Python function;
    solvers sample it on the host at the discrete times k*dt.
    """

    def __init__(self, function: Optional[Callable] = None, table=None):
        self.table = None if table is None else np.asarray(table, dtype=np.float64)
        self.function = function

    def get_at(self, time):
        if self.function is not None:
            return self.function(time)
        if self.table is None:
            raise ValueError("Hydrograph is not defined.")
        return float(np.interp(time, self.table[:, 0], self.table[:, 1]))

    def set_table(self, table):
        self.table = np.asarray(table, dtype=np.float64)

    def set_function(self, func):
        self.function = func

    def sample(self, times) -> np.ndarray:
        return np.asarray([self.get_at(t) for t in np.asarray(times)], dtype=np.float64)


class RatingCurve:
    """Host wrapper over :mod:`flowsim_tpu.ops.rating_curve` params
    (ref: rating_curve.py:3-162)."""

    def __init__(self, params: Optional[rcurve.RatingCurveParams] = None):
        self.params = params

    @property
    def defined(self):
        return self.params is not None

    def set(self, type, a, b, c=None, stage_shift=None):
        shift = 0.0 if stage_shift is None else stage_shift
        if type == "polynomial":
            if c is None:
                raise ValueError("Insufficient arguments. c must be specified.")
            self.params = rcurve.make_polynomial(a, b, c, stage_shift=shift)
        elif type == "power":
            self.params = rcurve.make_power(a, b, stage_shift=shift)
        else:
            raise ValueError("Invalid type.")

    def fit(self, discharges, stages, stage_shift=0.0, type="polynomial", degree=2):
        self.params = rcurve.fit(discharges, stages, stage_shift=stage_shift, type=type, degree=degree)

    def discharge(self, stage, time=None):
        return float(rcurve.discharge(self.params, jnp.asarray(stage)))

    def stage(self, discharge, trial_stage=None, time=None, tolerance=1e-2, rate=1.0):
        return float(
            rcurve.inverse_stage(self.params, discharge, trial_stage=trial_stage, tolerance=tolerance, rate=rate)
        )

    def dQ_dz(self, stage, time=None):
        return float(rcurve.dQ_dz(self.params, jnp.asarray(stage)))

    def tostring(self):
        """Human-readable equation (ref rating_curve.py:149-162 format)."""
        if not self.defined:
            raise ValueError("Rating curve is undefined.")
        p = self.params
        shift = float(np.asarray(p.stage_shift))
        if shift == int(shift):  # the reference stores the default as int 0
            shift = int(shift)
        c = [float(x) for x in np.asarray(p.coeffs)]
        y = f"(Y+{shift})"
        if p.kind == "polynomial":
            return f"{c[0]} {y}^2 + {c[1]} {y} + {c[2]}"
        if p.kind == "power":
            return f"{c[0]} {y}^{c[1]}"
        if p.kind == "poly_n":
            # ascending coefficient row (ops/rating_curve.py poly_n)
            return " + ".join(f"{a} {y}^{j}" if j > 1
                              else (f"{a} {y}" if j == 1 else f"{a}")
                              for j, a in reversed(list(enumerate(c))))
        return f"<{p.kind} rating curve>"


class LumpedStorage:
    """0-D reservoir config (ref: lumped_storage.py:7-23)."""

    def __init__(self, solution_boundaries=(0.0, 200.0), surface_area=None, min_stage=None, rating_curve: Optional[RatingCurve] = None):
        self.solution_boundaries = solution_boundaries
        self.surface_area = surface_area
        self.min_stage = -math.inf if min_stage is None else min_stage
        self.rating_curve = rating_curve
        self.area_curve = None
        self.alpha = 1.0
        self.beta = 0.0
        self.capture_losses = False
        self.reservoir_length = 0.0
        self.K_q = 0.0

    def set_area_curve(self, table, alpha=1.0, beta=0.0):
        self.area_curve = np.asarray(table, dtype=np.float64)
        self.alpha = alpha
        self.beta = beta

    def build(self) -> storage_mod.StorageParams:
        return storage_mod.make_storage(
            surface_area=self.surface_area,
            min_stage=self.min_stage,
            solution_boundaries=self.solution_boundaries,
            area_curve=self.area_curve,
            alpha=self.alpha,
            beta=self.beta,
            rating=None if self.rating_curve is None else self.rating_curve.params,
            capture_losses=self.capture_losses,
            reservoir_length=self.reservoir_length,
            K_q=self.K_q,
        )


class Boundary:
    """Channel boundary (ref: boundary.py:7-54)."""

    def __init__(
        self,
        condition: str,
        chainage,
        bed_level: Optional[float] = None,
        initial_depth: Optional[float] = None,
        rating_curve=None,
        hydrograph: Optional[Hydrograph] = None,
    ):
        if condition not in ("flow_hydrograph", "fixed_depth", "normal_depth", "rating_curve", "stage_hydrograph"):
            raise ValueError("Invalid boundary condition.")
        self.condition = condition
        self.chainage = chainage
        self.bed_level = bed_level
        self.initial_depth = initial_depth
        self.initial_stage = None if initial_depth is None or bed_level is None else bed_level + initial_depth
        self.rating_curve = rating_curve
        self.hydrograph = hydrograph
        self.lumped_storage: Optional[LumpedStorage] = None

    def set_lumped_storage(self, lumped_storage: LumpedStorage):
        self.lumped_storage = lumped_storage

    def condition_type(self) -> bool:
        return self.condition in bnd.Q_TYPE_KINDS

    def build(self, times, bed_level, bed_slope) -> bnd.BoundaryParams:
        """Lower to device params; hydrographs sampled at the solver times."""
        series = None
        if self.condition in ("flow_hydrograph", "stage_hydrograph"):
            if self.hydrograph is None:
                raise ValueError(f"{self.condition} boundary needs a hydrograph")
            series = self.hydrograph.sample(times)
        rating = None
        if self.condition == "rating_curve":
            if self.rating_curve is None:
                raise ValueError("rating_curve boundary needs a rating curve")
            rating = self.rating_curve.params if isinstance(self.rating_curve, RatingCurve) else self.rating_curve
        storage = None if self.lumped_storage is None else self.lumped_storage.build()
        return bnd.make_boundary(
            kind=self.condition,
            bed_level=bed_level,
            bed_slope=bed_slope,
            initial_depth=np.nan if self.initial_depth is None else self.initial_depth,
            target_series=series,
            rating=rating,
            storage=storage,
        )


class Channel:
    """Reach assembly (ref: channel.py:7-51)."""

    def __init__(
        self,
        upstream_boundary: Boundary,
        downstream_boundary: Boundary,
        initial_flow: float,
        roughness: Optional[float] = None,
        width: Optional[float] = None,
        interpolation_method: str = "GVF_equation",
    ):
        if interpolation_method not in ("linear", "GVF_equation", "steady-state"):
            raise ValueError("Invalid interpolation method.")
        self.upstream_boundary = upstream_boundary
        self.downstream_boundary = downstream_boundary
        self.initial_flow_rate = initial_flow
        self.roughness = roughness
        self.width = width
        self.interpolation_method = interpolation_method
        self.length = downstream_boundary.chainage - upstream_boundary.chainage
        self.xs_chainages = None
        self.input_stations = None
        self.coords = None
        self.coords_chainages = None
        # populated by a solver
        self.geometry: Optional[geom.TrapezoidGeometry] = None
        self.ch_at_node = None
        self.initial_conditions = None

    def set_cross_sections(self, chainages, sections):
        chainages = np.asarray(chainages, dtype=float)
        if len(chainages) != len(sections):
            raise ValueError("chainages and sections must have same length")
        if not np.all(np.diff(chainages) > 0):
            raise ValueError("chainages must be strictly increasing")
        self.xs_chainages = chainages
        self.input_stations = list(sections)

    def set_coords(self, coords, chainages):
        self.coords = np.asarray(coords, dtype=np.float64)
        self.coords_chainages = np.asarray(chainages, dtype=np.float64)

    # -- lowering ----------------------------------------------------------

    def build_geometry(self, n_nodes: int):
        self.ch_at_node = np.linspace(self.upstream_boundary.chainage, self.downstream_boundary.chainage, n_nodes)
        dtype = default_dtype()
        if self.xs_chainages is None:
            # provisional prismatic rectangle (ref channel.py:282-294)
            self.geometry = geom.build_trapezoid_geometry(
                n_nodes=n_nodes,
                length=self.length,
                us_z_bed=self.upstream_boundary.bed_level,
                ds_z_bed=self.downstream_boundary.bed_level,
                width=self.width,
                roughness=self.roughness,
                dtype=dtype,
            )
            return self.geometry

        from flowsim_tpu.geometry_tables import IrregularStation, build_table_geometry

        kinds = {type(s).__name__ for s in self.input_stations}
        if kinds == {"TrapezoidStation"}:
            self.geometry = geom.interpolate_stations(
                self.input_stations,
                self.xs_chainages,
                self.ch_at_node,
                coords=self.coords,
                coords_chainages=self.coords_chainages,
                dtype=dtype,
            )
        else:
            # irregular-only or mixed trapezoid/irregular lists both lower to
            # per-node lookup tables: trapezoid-bracketed nodes sample the
            # analytic closures, pairs involving an irregular station blend on
            # the union x grid (ref cross_section.py:852-968)
            stations = list(self.input_stations)
            if self.coords is not None and self.coords_chainages is not None:
                import copy

                curv = geom.planform_curvature(self.xs_chainages, self.coords_chainages, self.coords)
                # copy before stamping curvature: the station objects are
                # caller-owned and may be reused for another Channel (with
                # different or no coords) — mutating them would leak this
                # channel's curvature into the next build
                for i in range(1, len(stations) - 1):
                    stations[i] = copy.copy(stations[i])
                    stations[i].curvature = float(curv[i])
            self.geometry = build_table_geometry(
                stations, self.xs_chainages, self.ch_at_node, dtype=np.dtype(dtype)
            )
        return self.geometry

    def initialize_conditions(self, n_nodes: int, dx: float):
        g = self.geometry if self.geometry is not None and self.geometry.n_nodes == n_nodes else self.build_geometry(n_nodes)
        h, Q = ic.initial_conditions(
            g,
            self.interpolation_method,
            self.initial_flow_rate,
            dx,
            h_us=self.upstream_boundary.initial_depth,
            h_ds=self.downstream_boundary.initial_depth,
        )
        self.initial_conditions = np.stack([np.asarray(h), np.asarray(Q)], axis=1)
        return h, Q

    # per-node accessors matching the reference Channel surface
    def area_at(self, i, hw):
        g = jax.tree_util.tree_map(lambda a: a[i], self.geometry)
        return float(sec.section_state(g, jnp.asarray(hw) - g.z_bed).A)

    def top_width(self, i, hw):
        g = jax.tree_util.tree_map(lambda a: a[i], self.geometry)
        return float(sec.section_state(g, jnp.asarray(hw) - g.z_bed).T)

    def bed_level_at(self, i):
        return float(self.geometry.z_bed[i])

    def dA_dh(self, i, hw):
        """dA/dh (= top width) at node i (ref channel.py:186-190)."""
        g = jax.tree_util.tree_map(lambda a: a[i], self.geometry)
        return float(sec.section_state(g, jnp.asarray(hw) - g.z_bed).dA_dh)

    def Se(self, h, Q, i):
        """Energy slope Se = Sf + Sc at node i (ref channel.py:53-69)."""
        g = jax.tree_util.tree_map(lambda a: a[i], self.geometry)
        return float(sec.energy_slope(g, jnp.asarray(h), jnp.asarray(Q)).Se)

    def dSe_dA(self, h, Q, i):
        """d(Se)/dA at node i, with the reference's curvature-term dA/dh
        pre-multiplication (ref channel.py:71-87; see energy_slope note)."""
        g = jax.tree_util.tree_map(lambda a: a[i], self.geometry)
        return float(sec.energy_slope(g, jnp.asarray(h), jnp.asarray(Q)).dSe_dA_eff)

    def dSe_dQ(self, h, Q, i):
        """d(Se)/dQ at node i (ref channel.py:89-105)."""
        g = jax.tree_util.tree_map(lambda a: a[i], self.geometry)
        return float(sec.energy_slope(g, jnp.asarray(h), jnp.asarray(Q)).dSe_dQ)


class _SolverBase:
    """Shared grid setup + state accessors (ref: solver.py:10-63,244-296)."""

    def __init__(self, channel: Channel, time_step, spatial_step, simulation_time, fit_spatial_step=True):
        self.channel = channel
        self.time_step = float(time_step)
        self.spatial_step = float(spatial_step)
        self.number_of_nodes = int(channel.length // self.spatial_step + 1)
        self.number_of_time_levels = int(simulation_time // self.time_step + 1)
        if fit_spatial_step:
            # ref solver.py:53-55
            self.number_of_nodes = round(channel.length / self.spatial_step) + 1
            self.spatial_step = channel.length / (self.number_of_nodes - 1)
        self.depth = None  # [nt, N] after run()
        self.flow = None
        self.output: Optional[prs.SimOutput] = None
        self._results = None
        self.total_sim_duration = 0.0

    # accessors (ref solver.py:244-258): k=None -> last computed level;
    # k=-1 -> the level BEFORE it (the reference's time_level-1), not
    # python's last-element indexing
    def _level_index(self, k):
        last = self.depth.shape[0] - 1
        return last if k is None else last - 1 if k == -1 else k

    def depth_at(self, k=None, i=None):
        if i is None:
            raise ValueError("Spatial node must be specified.")
        return float(self.depth[self._level_index(k), i])

    def flow_at(self, k=None, i=None):
        if i is None:
            raise ValueError("Spatial node must be specified.")
        return float(self.flow[self._level_index(k), i])

    def water_level_at(self, k=None, i=None):
        return self.channel.bed_level_at(i) + self.depth_at(k, i)

    def area_at(self, k=None, i=None):
        """Wetted area at (level k, node i) (ref solver.py:271-283)."""
        return self.channel.area_at(i, self.water_level_at(k, i))

    def Se_at(self, k=None, i=None):
        """Energy slope at (level k, node i) (ref solver.py:290-293)."""
        return self.channel.Se(self.depth_at(k, i), self.flow_at(k, i), i)

    def dA_dh(self, k=None, i=None):
        """dA/dh (top width) at (level k, node i) (ref solver.py:295-296)."""
        return self.channel.dA_dh(i, self.water_level_at(k, i))

    def prepare_results(self):
        from flowsim_tpu.utils import results as res_mod

        if self._results is None:
            self._results = res_mod.prepare_results(self)
        return self._results

    def save_results(self, folder_path: str, file_name: str = None):
        from flowsim_tpu.utils import results as res_mod

        res_mod.save_results(self, folder_path, file_name=file_name)


class PreissmannSolver(_SolverBase):
    """Implicit Preissmann solver (ref: preissmann.py:9-46 surface).

    ``linear_solver`` is ``"thomas"``, ``"pcr"`` or ``"pcr_f32"``; ``None``
    takes the backend's default (:func:`flowsim_tpu.ops.tridiag.
    default_linear_solver`)."""

    _type = "preissmann"

    def __init__(self, channel, theta, time_step, spatial_step, simulation_time,
                 fit_spatial_step=True, linear_solver=None, newton="while",
                 regularization=False):
        if regularization:
            raise NotImplementedError(
                "regularization (wetting/drying) is a half-finished dead code "
                "path in the reference (SURVEY.md §2.15: unreachable Jacobian "
                "branches, broken A_reg call); all shipped cases run "
                "regularization=False, which is the supported behavior here"
            )
        super().__init__(channel, time_step, spatial_step, simulation_time, fit_spatial_step)
        self.theta = float(theta)
        self.linear_solver = linear_solver
        self.newton = newton
        channel.build_geometry(self.number_of_nodes)
        self.h0, self.Q0 = channel.initialize_conditions(self.number_of_nodes, self.spatial_step)
        times = np.arange(self.number_of_time_levels) * self.time_step
        geo = channel.geometry
        self.us_params = channel.upstream_boundary.build(times, geo.z_bed[0], geo.bed_slope[0])
        self.ds_params = channel.downstream_boundary.build(times, geo.z_bed[-1], geo.bed_slope[-1])

    def settings(self, tolerance, max_iter, diagnos=False) -> prs.PreissmannSettings:
        sset = prs.PreissmannSettings(
            theta=self.theta,
            time_step=self.time_step,
            spatial_step=self.spatial_step,
            n_time_levels=self.number_of_time_levels,
            tolerance=float(tolerance),
            max_iter=int(max_iter),
            linear_solver=self.linear_solver or tridiag.default_linear_solver(),
            newton=self.newton,
            diagnos=bool(diagnos),
        )
        return sset

    RCOND_THRESHOLD = 1e-12  # ref preissmann.py:142

    def run(self, tolerance=1e-4, verbose=1, max_iter=100, diagnos=False, live=False,
            lateral_inflow=None):
        """Run the full simulation.

        ``live=True`` streams the per-level progress lines from *inside* the
        scan (ref preissmann.py:116-117,151-155 prints as it solves) via a
        host callback; the default reports post-hoc, which is faster on
        accelerators (no per-level host sync).

        ``lateral_inflow``: distributed source q [m^2/s per unit length] —
        scalar (uniform), per-node [N], or per-level-and-node [nt, N]
        (a flowsim_tpu extension).
        """
        sset = self.settings(tolerance, max_iter, diagnos=diagnos)
        if live:
            import dataclasses

            sset = dataclasses.replace(sset, live_progress=True)
        if lateral_inflow is not None:
            lateral_inflow = np.asarray(lateral_inflow, dtype=np.float64)
            if lateral_inflow.ndim == 0:
                lateral_inflow = np.full(self.number_of_nodes,
                                         float(lateral_inflow))
        out = prs.simulate(
            self.channel.geometry, self.us_params, self.ds_params,
            self.h0, self.Q0, sset,
            lateral_inflow=None if lateral_inflow is None
            else jnp.asarray(lateral_inflow, self.h0.dtype),
        )
        out = jax.tree_util.tree_map(np.asarray, out)
        self.output = out
        self.depth = out.depth
        self.flow = out.flow
        self.total_sim_duration = (self.number_of_time_levels - 1) * self.time_step
        if diagnos:
            # ref preissmann.py:133-144: NaN and ill-conditioning checks run
            # inside each iteration and raise regardless of later convergence
            if np.isnan(out.error).any() or np.isnan(out.depth).any():
                bad = int(np.argmax(np.isnan(out.error) | np.isnan(out.depth).any(axis=1)))
                self.check_criticality(level=bad)
                raise ValueError("NaN in system assembly")  # ref preissmann.py:137
            if (out.rcond < self.RCOND_THRESHOLD).any():
                bad = int(np.argmax(out.rcond < self.RCOND_THRESHOLD))
                self.check_criticality(level=bad)
                raise ValueError(
                    "Jacobian is ill-conditioned (rcond too small)"
                )  # ref preissmann.py:143
        # storage-bracket saturation: the in-graph bisection clamps to
        # [y_min, y_max] where the reference's brentq RAISES when the root
        # leaves the solution_boundaries — surface that here (checked before
        # the convergence error: saturation is the root cause when both trip)
        for bc in (self.us_params, self.ds_params):
            sp = getattr(bc, "storage", None)
            if sp is None:
                continue
            stages = out.reservoir_stage[np.isfinite(out.reservoir_stage)]
            if stages.size == 0:
                continue
            ymin, ymax = float(sp.y_min), float(sp.y_max)
            tol = 1e-6 * max(ymax - ymin, 1.0)
            if (stages >= ymax - tol).any() or (
                    ymin > float(sp.min_stage) and (stages <= ymin + tol).any()):
                raise ValueError(
                    "Lumped-storage stage hit the solution_boundaries "
                    f"bracket [{ymin}, {ymax}] — the mass-balance root lies "
                    "outside it (the reference's brentq raises here); widen "
                    "solution_boundaries")
        if not bool(out.converged.all()):
            bad = int(np.argmin(out.converged))
            self.check_criticality(level=bad)  # ref preissmann.py:124-125
            raise ValueError(
                f"Convergence within {int(out.iterations[bad])} iterations couldn't be achieved."
            )  # ref preissmann.py:126
        if verbose >= 2:
            # per-level iteration/error lines (ref preissmann.py:116-159),
            # emitted post-hoc: logging inside the scan would force a host
            # sync per level
            from flowsim_tpu.utils.profiling import StepLogger

            StepLogger(verbose=verbose).report(out)
        if verbose >= 1:
            print("Simulation completed successfully.")
        return out

    def check_criticality(self, level=-1):
        """Froude scan with the reference's warning lines
        (ref preissmann.py:179-198)."""
        import jax.numpy as jnp

        from flowsim_tpu.ops import hydraulics as hyd
        from flowsim_tpu.ops import sections as sec

        geo = self.channel.geometry
        h = jnp.asarray(self.depth[level])
        Q = jnp.asarray(self.flow[level])
        st = sec.section_state(geo, h)
        fr = np.asarray(hyd.froude(st.T, st.A, Q))
        fail = False
        for i, f in enumerate(fr):
            x = self.channel.ch_at_node[i]
            if f == 1.0:
                fail = True
                print(f"WARNING: Flow goes critical at x = {x} m. Fr = {f}.")
            elif f > 1.0:
                fail = True
                print(f"WARNING: Flow goes supercritical at x = {x} m. Fr = {f}.")
        if not fail:
            print("Flow is subcritical.")
        return fail


class Junction:
    """Marker for a channel end that meets network junction ``id`` — used in
    place of a :class:`Boundary` when assembling a :class:`NetworkSolver`
    (a capability beyond the reference, which is strictly single-reach).

    ``bed_level``/``initial_depth`` play the same geometry/IC roles as on a
    Boundary (provisional rectangle endpoints, GVF/linear IC anchors).
    """

    condition = "junction"

    def __init__(self, id: int, chainage, bed_level=None, initial_depth=None):
        self.id = int(id)
        self.chainage = chainage
        self.bed_level = bed_level
        self.initial_depth = initial_depth
        self.lumped_storage = None


class _BranchView(_SolverBase):
    """Read-only per-branch solver facade over a network run: exposes the
    single-reach results surface (accessors, prepare_results, save_results)
    for one branch of a :class:`NetworkSolver`."""

    _type = "network_branch"

    def __init__(self, channel, time_step, spatial_step, simulation_time,
                 theta, depth, flow, output):
        super().__init__(channel, time_step, spatial_step, simulation_time,
                         fit_spatial_step=False)
        self.theta = theta
        self.depth = depth
        self.flow = flow
        self.output = output
        self.total_sim_duration = simulation_time


class _BranchOutput:
    """Just enough of SimOutput for the results pipeline (reservoir series)."""

    def __init__(self, reservoir_stage):
        self.reservoir_stage = reservoir_stage


class NetworkSolver:
    """Implicit Preissmann solve over a river NETWORK of channels joined at
    junctions (see :mod:`flowsim_tpu.ops.network`; beyond the reference).

    ``channels``: list of :class:`Channel` whose upstream/downstream
    boundaries may be :class:`Junction` markers instead of Boundaries.
    Branch flow orientation is upstream -> downstream per channel.

    ``junction_area``: per-junction surface areas (junction reservoirs);
    ``junction_rating``: per-junction :class:`RatingCurve` (or params, or
    None) — rated outflow leaving the network at the junction.

    ``initial_conditions``: optional per-channel ``(h0, Q0)`` overrides
    (e.g. slices of a single-reach run); ``None`` entries use the channel's
    own IC generator.
    """

    _type = "network"

    def __init__(self, channels, theta, time_step, spatial_step, simulation_time,
                 junction_area=None, junction_rating=None,
                 fit_spatial_step=True, linear_solver=None, newton="while",
                 initial_conditions=None):
        from flowsim_tpu.ops import network as net

        self.channels = list(channels)
        self.theta = float(theta)
        self.time_step = float(time_step)
        self.simulation_time = float(simulation_time)
        self.linear_solver = linear_solver
        self.newton = newton
        self.junction_area = junction_area
        self.number_of_time_levels = int(simulation_time // self.time_step + 1)
        times = np.arange(self.number_of_time_levels) * self.time_step

        if junction_rating is None:
            self.junction_rating = None
        else:
            self.junction_rating = [
                rc.params if isinstance(rc, RatingCurve) else rc
                for rc in junction_rating]

        if np.ndim(spatial_step) == 0:
            spatial_step = [spatial_step] * len(self.channels)
        if len(spatial_step) != len(self.channels):
            raise ValueError(
                f"spatial_step has {len(spatial_step)} entries for "
                f"{len(self.channels)} channels")
        ics = initial_conditions or [None] * len(self.channels)
        if len(ics) != len(self.channels):
            raise ValueError(
                f"initial_conditions has {len(ics)} entries for "
                f"{len(self.channels)} channels")

        self.branches = []
        self.branch_dx = []
        junction_ids = set()
        for ch, dx, ic_pair in zip(self.channels, spatial_step, ics):
            dx = float(dx)
            n_nodes = int(ch.length // dx + 1)
            if fit_spatial_step:  # ref solver.py:53-55
                n_nodes = round(ch.length / dx) + 1
                dx = ch.length / (n_nodes - 1)
            self.branch_dx.append(dx)
            geo = ch.build_geometry(n_nodes)
            if ic_pair is None:
                h0, Q0 = ch.initialize_conditions(n_nodes, dx)
            else:
                h0, Q0 = (jnp.asarray(ic_pair[0]), jnp.asarray(ic_pair[1]))

            def lower(b, node):
                if isinstance(b, Junction):
                    junction_ids.add(b.id)
                    return b.id
                return b.build(times, geo.z_bed[node], geo.bed_slope[node])

            self.branches.append(net.BranchDef(
                geo=geo, dx=dx, us=lower(ch.upstream_boundary, 0),
                ds=lower(ch.downstream_boundary, -1), h0=h0, Q0=Q0))
        self.n_junctions = (max(junction_ids) + 1) if junction_ids else 0
        self.output = None

    def settings(self, tolerance, max_iter, **kw) -> prs.PreissmannSettings:
        sset = prs.PreissmannSettings(
            theta=self.theta,
            time_step=self.time_step,
            spatial_step=self.branch_dx[0],
            n_time_levels=self.number_of_time_levels,
            tolerance=float(tolerance),
            max_iter=int(max_iter),
            linear_solver=self.linear_solver or tridiag.default_linear_solver(),
            newton=self.newton,
            **kw,
        )
        return sset

    def run(self, tolerance=1e-4, verbose=1, max_iter=100, engine="loop"):
        """``engine="stacked"`` batches all branches into one padded
        assembly + solve per Newton iteration (the fast path for
        many-branch networks); ``"loop"`` solves each branch as its own
        subgraph.  See ops/network.py."""
        from flowsim_tpu.ops import network as net

        sset = self.settings(tolerance, max_iter)
        out = net.simulate_network(
            self.branches, self.n_junctions, sset,
            junction_area=self.junction_area,
            junction_rating=self.junction_rating, engine=engine)
        out = jax.tree_util.tree_map(np.asarray, out)
        self.output = out
        if not bool(out.converged.all()):
            bad = int(np.argmin(out.converged))
            self.check_criticality(level=bad)  # ref preissmann.py:124-125
            raise ValueError(
                f"Convergence within {int(out.iterations[bad])} iterations "
                "couldn't be achieved.")  # ref preissmann.py:126
        if verbose >= 1:
            print("Simulation completed successfully.")
        return out

    def check_criticality(self, level=-1):
        """Per-branch Froude scan with the reference's warning lines
        (ref preissmann.py:179-198), prefixed by the branch index."""
        from flowsim_tpu.ops import hydraulics as hyd

        fail = False
        for bi, (ch, br) in enumerate(zip(self.channels, self.branches)):
            h = jnp.asarray(np.asarray(self.output.depth[bi])[level])
            Q = jnp.asarray(np.asarray(self.output.flow[bi])[level])
            st = sec.section_state(br.geo, h)
            fr = np.asarray(hyd.froude(st.T, st.A, Q))
            for i, f in enumerate(fr):
                x = ch.ch_at_node[i]
                if f == 1.0:
                    fail = True
                    print(f"WARNING: [branch {bi}] Flow goes critical at "
                          f"x = {x} m. Fr = {f}.")
                elif f > 1.0:
                    fail = True
                    print(f"WARNING: [branch {bi}] Flow goes supercritical "
                          f"at x = {x} m. Fr = {f}.")
        if not fail:
            print("Flow is subcritical.")
        return fail

    def branch(self, i) -> _BranchView:
        """Per-branch results facade with the single-reach solver surface."""
        if self.output is None:
            raise ValueError("run() first")
        res_stage = np.asarray(self.output.reservoir_stage)[:, i, 1]
        return _BranchView(
            self.channels[i], self.time_step, self.branch_dx[i],
            self.simulation_time, self.theta,
            np.asarray(self.output.depth[i]), np.asarray(self.output.flow[i]),
            _BranchOutput(res_stage))

    def summary(self) -> dict:
        """Network-wide acceptance scalars (inflow/outflow volumes, mass
        imbalance incl. junction-reservoir storage, peak flows, the max
        instantaneous junction-continuity residual) — the network
        counterpart of the reference's TXT summary (ref solver.py:203-233).
        See :func:`flowsim_tpu.utils.results.network_summary`."""
        from flowsim_tpu.utils import results as res_mod

        if self.output is None:
            raise ValueError("run() the solver first")
        return res_mod.network_summary(self.output, self.branches,
                                       self.time_step,
                                       junction_area=self.junction_area)

    def save_results(self, folder_path: str):
        """Per-branch workbooks (branch_<i>/) + junction series CSV."""
        import os

        for i in range(len(self.branches)):
            self.branch(i).save_results(os.path.join(folder_path, f"branch_{i}"))
        os.makedirs(folder_path, exist_ok=True)
        J = self.n_junctions
        if J:
            nt = self.number_of_time_levels
            time = np.arange(nt) * self.time_step
            stage = np.asarray(self.output.junction_stage)
            outflow = np.asarray(self.output.junction_outflow)
            header = ("time_s," + ",".join(f"stage_{j}" for j in range(J))
                      + "," + ",".join(f"outflow_{j}" for j in range(J)))
            np.savetxt(os.path.join(folder_path, "junctions.csv"),
                       np.column_stack([time, stage, outflow]),
                       delimiter=",", header=header, comments="")


class LaxSolver(_SolverBase):
    """Explicit Lax-Friedrichs solver; see ops/lax_friedrichs.py."""

    _type = "lax"

    def __init__(self, channel, time_step, spatial_step, simulation_time,
                 secondary_BC=("constant", "constant"), fit_spatial_step=True):
        super().__init__(channel, time_step, spatial_step, simulation_time, fit_spatial_step)
        self.secondary_BC = secondary_BC
        channel.build_geometry(self.number_of_nodes)
        self.h0, self.Q0 = channel.initialize_conditions(self.number_of_nodes, self.spatial_step)
        times = np.arange(self.number_of_time_levels) * self.time_step
        geo = channel.geometry
        self.us_params = channel.upstream_boundary.build(times, geo.z_bed[0], geo.bed_slope[0])
        self.ds_params = channel.downstream_boundary.build(times, geo.z_bed[-1], geo.bed_slope[-1])

    def run(self, verbose=1):
        from flowsim_tpu.ops import lax_friedrichs as lxf

        out = lxf.simulate(
            self.channel.geometry, self.us_params, self.ds_params,
            self.h0, self.Q0,
            lxf.LaxSettings(
                time_step=self.time_step,
                spatial_step=self.spatial_step,
                n_time_levels=self.number_of_time_levels,
                secondary_bc_us=self.secondary_BC[0],
                secondary_bc_ds=self.secondary_BC[1],
            ),
        )
        out = jax.tree_util.tree_map(np.asarray, out)
        self.output = out
        self.depth = out.depth
        self.flow = out.flow
        self.total_sim_duration = (self.number_of_time_levels - 1) * self.time_step
        if bool(out.cfl_violated.any()):
            k = int(np.argmax(out.cfl_violated))
            raise ValueError(f"CFL condition failed at k={k}.")  # ref lax.py:241-243
        if verbose >= 1:
            print("Simulation completed successfully.")
        return out
