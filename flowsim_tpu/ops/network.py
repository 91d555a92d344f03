"""River-network (junction) extension of the Preissmann solver.

NEW CAPABILITY beyond the reference (`cve-mohd/flow-sim` is strictly
single-reach): a network of 1-D branches joined at junctions, solved as a
single implicit system per time level.  Junction physics is the standard
practice for 1-D river models (equal water-surface elevation at every
branch end meeting a junction + discharge continuity across it — the
momentum flux through the junction is neglected, as in HEC-RAS):

    at junction j with stage Y_j:
        h_end,b = Y_j - z_bed_end,b        (one row per connected end)
        sum_b  sgn_b * Q_end,b = 0          (one row per junction)

sgn is +1 for a branch whose DOWNSTREAM end meets the junction (flow into
it) and -1 for one whose UPSTREAM end does (flow out of it).

Note a useful exactness property: splitting a single reach at an interior
node loses NO physics — every theta-box cell survives the split (branch 1
keeps cells [0, cut), branch 2 keeps [cut, N-1)), and the junction rows
merely tie the duplicated node's (h, Q) together — so a 2-branch serial
split solves the SAME nonlinear system as the single reach (observed
agreement ~1e-14 in f64).  Genuine approximation enters only at >= 3-way
junctions, where the momentum flux through the junction is neglected.

Structure: each branch contributes the same fused theta-box
interior stencil as the single-reach solver (ops/preissmann.py
``cell_stencil`` — single source of truth for the physics, ref
preissmann.py:220-301) and a 2x2 block-tridiagonal Jacobian; the junction
stages couple only the end rows, giving a global arrowhead matrix solved
by a Schur complement:

    T_b dx_b + C_b dY = -R_b       per branch (block-tridiagonal T_b)
    E dx          = -G             junction continuity rows

    u_b = T_b^{-1}(-R_b);  V_b^j = T_b^{-1} C_b^j   (<= 2 extra solves
    per branch, same factorization-free PCR/Thomas as the main solver)
    (E V) dY = G + E u             dense J x J system (J = #junctions)
    dx_b = u_b - sum_j V_b^j dY_j

Newton convergence follows the reference's pre-update-residual rule
(ref preissmann.py:146-153) over the concatenated residual of every
branch plus the junction imbalances.

External ends support the complete boundary surface of
:mod:`flowsim_tpu.ops.boundary` (ref boundary.py:32): flow/stage
hydrographs, fixed depth, normal depth, rating curves including the
non-smooth gated controller, and lumped storage (orientation-aware on
either end) — each external end carries its own
:class:`~flowsim_tpu.ops.boundary.BCState` (reservoir stage + gate
hysteresis state) across time levels, exactly like the single-reach
solver's scan carry (ops/preissmann.py:simulate).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import partial
from typing import List, NamedTuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from flowsim_tpu.ops import boundary as bnd
from flowsim_tpu.ops import preissmann as prs
from flowsim_tpu.ops import rating_curve as rcurve
from flowsim_tpu.ops import sections as sec
from flowsim_tpu.ops.tridiag import solve_block_tridiag


@dataclass
class BranchDef:
    """One network branch: geometry + per-branch grid and initial state.

    ``us``/``ds``: either a :class:`~flowsim_tpu.ops.boundary.BoundaryParams`
    (external end) or an ``int`` junction id in ``[0, n_junctions)``.
    Flow orientation is us -> ds (positive Q flows toward ``ds``).

    ``qlat``: optional distributed lateral inflow q [m^2/s per unit
    length] on this branch — per-node [N] or per-level-and-node [nt, N]
    (see ops/preissmann.py:cell_stencil).
    """

    geo: object             # TrapezoidGeometry | TableGeometry, [N] nodes
    dx: float
    us: Union[bnd.BoundaryParams, int]
    ds: Union[bnd.BoundaryParams, int]
    h0: jnp.ndarray
    Q0: jnp.ndarray
    qlat: object = None


class NetworkOutput(NamedTuple):
    depth: tuple            # per branch [nt, N_b]
    flow: tuple             # per branch [nt, N_b]
    junction_stage: jnp.ndarray  # [nt, J]
    iterations: jnp.ndarray      # [nt]
    error: jnp.ndarray           # [nt]
    converged: jnp.ndarray       # [nt]
    # per external end [nt, n_branches, 2 (us, ds)]; NaN where unused
    reservoir_stage: jnp.ndarray = None
    gate_open: jnp.ndarray = None
    # rated outflow leaving the network at each junction [nt, J] (zeros
    # unless ``junction_rating`` was given)
    junction_outflow: jnp.ndarray = None


def _is_junction(end) -> bool:
    return isinstance(end, (int, np.integer))


def _check_supported(branches: List[BranchDef], n_junctions: int,
                     settings=None):
    for i, br in enumerate(branches):
        for end_name, end in (("us", br.us), ("ds", br.ds)):
            if _is_junction(end):
                if not 0 <= int(end) < n_junctions:
                    raise ValueError(
                        f"branch {i} {end_name}: junction id {end} out of "
                        f"range [0, {n_junctions})")
        if br.qlat is not None and settings is not None:
            n_b = int(jnp.asarray(br.h0).shape[0])
            shape = jnp.shape(br.qlat)
            nt = settings.n_time_levels
            ok = shape == (n_b,) or shape == (nt, n_b)
            if not ok:  # a wrong time length would silently clamp-index
                raise ValueError(
                    f"branch {i} qlat shape {shape} must be [{n_b}] or "
                    f"[nt={nt}, {n_b}]")
    for j in range(n_junctions):
        ends = sum(int(isinstance(e, (int, np.integer)) and int(e) == j)
                   for br in branches for e in (br.us, br.ds))
        if ends < 2:
            raise ValueError(f"junction {j} connects {ends} end(s); needs >= 2")


def _split_branches(branches):
    """(static topology key, dynamic pytree) per branch — the jit cache key
    split shared by simulate_network and simulate_network_chunk."""
    topo = tuple((int(br.us) if _is_junction(br.us) else None,
                  int(br.ds) if _is_junction(br.ds) else None,
                  float(br.dx)) for br in branches)
    dyn = tuple(dict(geo=br.geo,
                     us=None if _is_junction(br.us) else br.us,
                     ds=None if _is_junction(br.ds) else br.ds,
                     h0=jnp.asarray(br.h0), Q0=jnp.asarray(br.Q0),
                     qlat=br.qlat)
                for br in branches)
    return topo, dyn


def _end_row_junction(h_end, z_end, Y_j):
    """Equal-stage row at a junction-connected branch end."""
    residual = h_end - (Y_j - z_end)
    return residual, jnp.ones_like(h_end), jnp.zeros_like(h_end)


def default_initial_stages(branches, n_junctions, dtype):
    """Default Y0: the first connected end's water level per junction, ds
    ends preferred (traceable — works under vmap)."""
    found = {}
    for br in branches:
        for end, idx in ((br.ds, -1), (br.us, 0)):
            if _is_junction(end) and int(end) not in found:
                found[int(end)] = (jnp.asarray(br.geo.z_bed)[idx]
                                   + jnp.asarray(br.h0, dtype)[idx])
    return (jnp.stack([found[j] for j in range(n_junctions)])
            if n_junctions else jnp.zeros((0,), dtype))


def _solve_junction_system(M, rhs):
    """Solve the dense J x J Schur system (a scalar divide when J == 1)."""
    if M.shape[0] == 1:
        return rhs / M[0, 0]
    return jnp.linalg.solve(M, rhs)


def _assemble_branch(br: BranchDef, settings, prev: prs.PrevLevel, h, Q, k, Y,
                     end_states):
    """Branch residual + block-tridiagonal Jacobian with junction-aware end
    rows (same regrouping as ops/preissmann.py:assemble, ref
    preissmann.py:200-320).

    ``end_states``: (us BCState, ds BCState) — per-end carried boundary
    state (reservoir stage, gate hysteresis); ignored at junction ends.
    Returns the per-end new reservoir stages alongside the block system.
    """
    geo, dx = br.geo, br.dx
    theta, dt = settings.theta, settings.time_step
    st = sec.section_state(geo, h)
    es = sec.energy_slope(geo, h, Q, st)
    if br.qlat is None:
        qc = qp = None
    else:
        ql = jnp.asarray(br.qlat, h.dtype)
        qc, qp = (ql, ql) if ql.ndim == 1 else (ql[k], ql[k - 1])
    cells = prs.cell_stencil(
        theta, dt, dx,
        dict(prs.node_stencil_fields(geo, st, es, h, Q), qlat=qc),
        dict(A=prev.A, Se=prev.Se, Q2A=prev.Q2A, Q=prev.Q, h=prev.h, qlat=qp))
    th_dx = theta / dx
    dtype = h.dtype
    N = h.shape[0]
    nan = jnp.asarray(jnp.nan, dtype)

    couplings = []  # (junction_id, node_index, block_row) of each -1 dR/dY

    def end_row(end, node_idx, h_e, Q_e, Q_prev_e, h_prev_e, upstream, est):
        if _is_junction(end):
            z_e = geo.z_bed[node_idx]
            res, dfh, dfq = _end_row_junction(h_e, z_e, Y[int(end)])
            couplings.append((int(end), node_idx, 0 if upstream else 1))
            return res, dfh, dfq, nan
        ev = bnd.evaluate(end, prs._node_section(st, node_idx), h_e, Q_e,
                          k, dt, Q_prev=Q_prev_e,
                          reservoir_stage_prev=est.reservoir_stage,
                          bc_state=est, upstream=upstream, h_prev=h_prev_e)
        return ev.residual, ev.df_dh, ev.df_dQ, ev.reservoir_stage

    us_res, us_dh, us_dq, us_stage = end_row(
        br.us, 0, h[0], Q[0], prev.Q[0], prev.h[0], True, end_states[0])
    ds_res, ds_dh, ds_dq, ds_stage = end_row(
        br.ds, -1, h[-1], Q[-1], prev.Q[-1], prev.h[-1], False, end_states[1])

    err_sq = (us_res**2 + ds_res**2
              + jnp.sum(cells.Rc**2) + jnp.sum(cells.Rm**2))

    z1 = jnp.zeros((1,), dtype)
    L = jnp.stack(
        [jnp.stack([jnp.concatenate([z1, cells.dM_dh_i]),
                    jnp.concatenate([z1, cells.dM_dQ_i])], axis=-1),
         jnp.zeros((N, 2), dtype)], axis=-2)
    D_row0 = jnp.stack([jnp.concatenate([us_dh[None], cells.dM_dh_i1]),
                        jnp.concatenate([us_dq[None], cells.dM_dQ_i1])],
                       axis=-1)
    D_row1 = jnp.stack([jnp.concatenate([cells.dC_dh_i, ds_dh[None]]),
                        jnp.concatenate([jnp.full((N - 1,), -th_dx, dtype),
                                         ds_dq[None]])], axis=-1)
    D = jnp.stack([D_row0, D_row1], axis=-2)
    U = jnp.stack(
        [jnp.zeros((N, 2), dtype),
         jnp.stack([jnp.concatenate([cells.dC_dh_i1, z1]),
                    jnp.concatenate([jnp.full((N - 1,), th_dx, dtype), z1])],
                   axis=-1)], axis=-2)
    b = -jnp.stack([jnp.concatenate([us_res[None], cells.Rm]),
                    jnp.concatenate([cells.Rc, ds_res[None]])], axis=-1)
    return L, D, U, b, err_sq, couplings, (us_stage, ds_stage)


def _sum_signed_ends(branches, Qs, n_junctions, dtype):
    """sum sgn * Q_end per junction (sgn=+1 for a ds end, -1 for us)."""
    S = jnp.zeros((n_junctions,), dtype)
    for br, Q in zip(branches, Qs):
        if isinstance(br.ds, (int, np.integer)):
            S = S.at[int(br.ds)].add(Q[-1])
        if isinstance(br.us, (int, np.integer)):
            S = S.at[int(br.us)].add(-Q[0])
    return S


def _junction_outflow(junction_rating, Y, dtype):
    """Per-junction rated outflow Q_out(Y) and its stage derivative.

    ``junction_rating``: None, or a length-J list whose entries are either
    None (no outflow) or a RatingCurveParams — a dam release / withdrawal
    LEAVING the network at that junction.  Returns ([J] outflow, [J] dQ/dz).
    """
    J = Y.shape[0]
    if junction_rating is None:
        z = jnp.zeros((J,), dtype)
        return z, z
    q, dq = [], []
    for j, rc in enumerate(junction_rating):
        if rc is None:
            q.append(jnp.zeros((), dtype))
            dq.append(jnp.zeros((), dtype))
        else:
            q.append(rcurve.discharge(rc, Y[j]))
            dq.append(rcurve.dQ_dz(rc, Y[j]))
    return jnp.stack(q), jnp.stack(dq)


def _junction_residuals(S, Y, area, dt, q_out, prev_terms):
    """Junction rows (shared by the loop and stacked engines).

    Plain junction (area=0): G_j = sum sgn * Q_end - Q_out(Y_j) = 0
    (continuity, with any rated outflow leaving the network).
    Junction reservoir (area>0): a 0-D storage AT the junction —
        area_j * (Y_j - Y_j^prev)/dt
          - 0.5*(sum sgn Q + sum sgn Q^prev)
          + 0.5*(Q_out(Y_j) + Q_out(Y_j^prev)) = 0
    (trapezoidal inflow/outflow, the same rule as the lumped storage mass
    balance, ref lumped_storage.py:24-35, at a multi-branch node).

    ``S``: the current signed end-discharge sums [J];
    ``prev_terms`` = (Y_prev, Sp, q_out_prev) — level-start constants.
    """
    Y_prev, Sp, q_out_prev = prev_terms
    stor = area > 0.0
    G_plain = S - q_out
    G_stor = (area * (Y - Y_prev) / dt - 0.5 * (S + Sp)
              + 0.5 * (q_out + q_out_prev))
    return jnp.where(stor, G_stor, G_plain)


def simulate_network(branches: List[BranchDef], n_junctions: int,
                     settings: prs.PreissmannSettings,
                     Y0=None, junction_area=None,
                     junction_rating=None, engine: str = "loop") -> NetworkOutput:
    """Run the implicit network solve over ``settings.n_time_levels``.

    ``engine``: ``"loop"`` (default) assembles and solves each branch as its
    own subgraph — exact and fully general.  ``"stacked"`` pads every branch
    to the longest branch length and runs ONE batched assembly + ONE batched
    multi-RHS block-tridiagonal solve per Newton iteration (pad nodes carry
    delta-copy equations, so the padded ends mirror each branch's real end) —
    the fast path for many-branch networks, numerically equivalent to
    within solver roundoff (the padded PCR reduces in a different order).
    Requires all branch geometries to share one pytree structure.

    ``Y0``: initial junction stages [J]; defaults to the water level of the
    first downstream-connected branch end at t=0.

    ``junction_area``: optional [J] surface areas — a junction with
    ``area > 0`` is a JUNCTION RESERVOIR (0-D storage fed/drained by every
    connected branch, trapezoidal mass balance as the single-reach lumped
    storage, ref lumped_storage.py:24-35); ``area == 0`` is a plain
    equal-stage junction.  ``NetworkOutput.junction_stage`` then carries
    the reservoir stage trajectory.

    ``junction_rating``: optional length-J list of RatingCurveParams (or
    None per entry) — a rated outflow Q_out(Y_j) LEAVING the network at
    that junction: a dam release to outside the modeled system on a
    junction reservoir, or a stage-dependent withdrawal on a plain
    junction.  The trajectory is returned as
    ``NetworkOutput.junction_outflow``.  (The gated controller is not
    supported at junctions — put it on an external end.)
    """
    _check_supported(branches, n_junctions, settings)
    settings = prs.guard_f32_floor(settings)
    if junction_area is not None and len(junction_area) != n_junctions:
        raise ValueError(f"junction_area must have {n_junctions} entries")
    if junction_rating is not None:
        if len(junction_rating) != n_junctions:
            raise ValueError(f"junction_rating must have {n_junctions} entries")
        for rc in junction_rating:
            if rc is not None and rc.kind == "gated_blend":
                raise ValueError("gated_blend is not supported at junctions")
    # split each branch into a static topology key (junction ids, dx) and a
    # dynamic pytree, so repeated calls with the same network structure hit
    # the jit cache instead of retracing the whole scan (repeat calls were
    # ~8x slower than prs.simulate before this split)
    topo, dyn = _split_branches(branches)
    rating = None if junction_rating is None else tuple(junction_rating)
    if engine == "stacked":
        return _simulate_network_stacked(dyn, Y0, junction_area, rating,
                                         topo=topo, n_junctions=n_junctions,
                                         settings=settings)
    if engine != "loop":
        raise ValueError(f"unknown engine {engine!r}")
    return _simulate_network_impl(dyn, Y0, junction_area, rating,
                                  topo=topo, n_junctions=n_junctions,
                                  settings=settings)


def simulate_network_chunk(branches: List[BranchDef], n_junctions: int,
                           settings: prs.PreissmannSettings, ks, carry=None,
                           Y0=None, junction_area=None, junction_rating=None,
                           engine: str = "loop"):
    """Advance the network over the absolute time levels ``ks`` only.

    The chunked form of :func:`simulate_network` for checkpoint/resume
    (utils/checkpoint.py): ``carry=None`` starts from the branches' initial
    state; otherwise pass the carry returned by the previous chunk.
    Returns ``((hs_t, Qs_t, Y_t, errs, iters, stages_t, gates_t), carry)``
    where each output stacks the levels in ``ks`` (no initial row) and
    ``carry = (hs, Qs, Y, end_states)`` is the full restart state —
    chaining chunks is bitwise-identical to the one-shot scan (same
    per-level step function).  The carry uses per-branch (unpadded) arrays
    for both engines, so a checkpointed run may switch engines between
    chunks.
    """
    _check_supported(branches, n_junctions, settings)
    settings = prs.guard_f32_floor(settings)
    topo, dyn = _split_branches(branches)
    rating = None if junction_rating is None else tuple(junction_rating)
    impl = (_simulate_network_stacked if engine == "stacked"
            else _simulate_network_impl)
    if engine not in ("loop", "stacked"):
        raise ValueError(f"unknown engine {engine!r}")
    return impl(dyn, Y0, junction_area, rating, carry, jnp.asarray(ks),
                topo=topo, n_junctions=n_junctions,
                settings=settings, chunked=True)


@partial(jax.jit, static_argnames=("topo", "n_junctions", "settings",
                                   "chunked"))
def _simulate_network_impl(dyn, Y0, junction_area, junction_rating,
                           carry_in=None, ks=None, *,
                           topo, n_junctions, settings, chunked=False):
    branches = [BranchDef(geo=d["geo"], dx=t[2],
                          us=t[0] if t[0] is not None else d["us"],
                          ds=t[1] if t[1] is not None else d["ds"],
                          h0=d["h0"], Q0=d["Q0"], qlat=d["qlat"])
                for d, t in zip(dyn, topo)]
    dtype = jnp.asarray(branches[0].h0).dtype
    nt = settings.n_time_levels
    tol = settings.tolerance
    max_iter = settings.max_iter
    solver_kind = settings.linear_solver
    dt = settings.time_step
    J = n_junctions
    area = (jnp.zeros((J,), dtype) if junction_area is None
            else jnp.asarray(junction_area, dtype))

    if Y0 is None:
        Y0 = default_initial_stages(branches, J, dtype)
    Y0 = jnp.asarray(Y0, dtype)

    h0s = tuple(jnp.asarray(br.h0, dtype) for br in branches)
    Q0s = tuple(jnp.asarray(br.Q0, dtype) for br in branches)

    def newton_level(hs, Qs, Y, prevs, k, end_states):
        Y_prev = Y  # level-start stage: the storage-balance reference point
        Qs_prev = tuple(p.Q for p in prevs)
        # level-start constants of the junction rows
        Sp = _sum_signed_ends(branches, Qs_prev, J, dtype)
        q_out_prev, _ = _junction_outflow(junction_rating, Y_prev, dtype)
        prev_terms = (Y_prev, Sp, q_out_prev)

        def one_iteration(hs, Qs, Y):
            new_hs, new_Qs = [], []
            us_list, Vs_list, coup_list, stage_rows = [], [], [], []
            err_sq = jnp.zeros((), dtype)
            for br, h, Q, prev, ests in zip(branches, hs, Qs, prevs,
                                            end_states):
                L, D, U, b, e2, coup, stages_b = _assemble_branch(
                    br, settings, prev, h, Q, k, Y, ests)
                stage_rows.append(jnp.stack(stages_b))
                err_sq = err_sq + e2
                # u = T^{-1}(-R) plus one Schur column V = T^{-1} C per
                # junction coupling (C: dR_end/dY_j = -1 at (node, row)) —
                # solved together as one multi-RHS system so the
                # block-tridiagonal reduction work is shared across columns
                cols = [b]
                for (j, node_idx, block_row) in coup:
                    cols.append(jnp.zeros_like(b)
                                .at[node_idx, block_row].set(-1.0))
                X = solve_block_tridiag(L, D, U, jnp.stack(cols, axis=-1),
                                        method=solver_kind)
                u = X[..., 0]
                Vs = [X[..., 1 + i] for i in range(len(coup))]
                us_list.append(u)
                Vs_list.append(Vs)
                coup_list.append(coup)

            q_out, dq_dz = _junction_outflow(junction_rating, Y, dtype)
            S = _sum_signed_ends(branches, Qs, J, dtype)
            G = _junction_residuals(S, Y, area, dt, q_out, prev_terms)
            err = jnp.sqrt(err_sq + jnp.sum(G**2))

            if J:
                # Schur system; E picks fac * sgn * dQ_end where fac is the
                # junction row's dG/dQ_end scale (1 plain, -1/2 storage)
                fac = jnp.where(area > 0.0, -0.5, 1.0)
                M = jnp.zeros((J, J), dtype)
                rhs = jnp.array(G)
                for br, u, Vs, coup in zip(branches, us_list, Vs_list,
                                           coup_list):
                    ends = []
                    if isinstance(br.ds, (int, np.integer)):
                        ends.append((int(br.ds), -1, 1.0))
                    if isinstance(br.us, (int, np.integer)):
                        ends.append((int(br.us), 0, -1.0))
                    for (jj, idx, sgn) in ends:
                        rhs = rhs.at[jj].add(fac[jj] * sgn * u[idx, 1])
                        for (jcol, _, _), V in zip(coup, Vs):
                            M = M.at[jj, jcol].add(fac[jj] * sgn
                                                   * V[idx, 1])
                # derivation: T dx + C dY = -R and E dx + D_Y dY = -G with
                # D_Y = diag(dG/dY): area/dt + 0.5 dQout/dz for a storage
                # junction, -dQout/dz for a plain one (both 0 when unrated);
                # with u = T^{-1}(-R), V = T^{-1} C: dx = u - V dY, so
                # (E V - D_Y) dY = G + E u
                D_Y = jnp.where(area > 0.0, area / dt + 0.5 * dq_dz, -dq_dz)
                M = M - jnp.diag(D_Y)
                dY = _solve_junction_system(M, rhs)
            else:
                dY = jnp.zeros((0,), dtype)

            for br, h, Q, u, Vs, coup in zip(branches, hs, Qs, us_list,
                                             Vs_list, coup_list):
                dx_b = u
                for (jcol, _, _), V in zip(coup, Vs):
                    dx_b = dx_b - V * dY[jcol]
                new_hs.append(h + dx_b[:, 0])
                new_Qs.append(Q + dx_b[:, 1])
            return (tuple(new_hs), tuple(new_Qs), Y + dY, err,
                    jnp.stack(stage_rows))

        stages0 = jnp.stack([
            jnp.stack([ests[0].reservoir_stage, ests[1].reservoir_stage])
            for ests in end_states])
        init = (hs, Qs, Y, jnp.asarray(jnp.inf, dtype),
                jnp.asarray(0, jnp.int32), stages0)

        if settings.newton == "fixed":
            # fixed-length masked Newton: reverse-mode differentiable
            # (gradient calibration through the network solve), mirroring
            # ops/preissmann.py newton_solve's fixed mode
            def fbody(c, _):
                hs, Qs, Y, err, it, stages = c
                active = err >= tol
                hs2, Qs2, Y2, err2, st2 = one_iteration(hs, Qs, Y)
                sel = lambda a, b: jnp.where(active, a, b)
                hs = jax.tree_util.tree_map(sel, hs2, hs)
                Qs = jax.tree_util.tree_map(sel, Qs2, Qs)
                return (hs, Qs, sel(Y2, Y), sel(err2, err),
                        it + active.astype(it.dtype), sel(st2, stages)), None

            (hs, Qs, Y, err, iters, stages), _ = jax.lax.scan(
                fbody, init, None, length=max_iter)
            return hs, Qs, Y, err, iters, stages

        def cond(c):
            err, it = c[3], c[4]
            return (err >= tol) & (it < max_iter)

        def body(c):
            hs, Qs, Y, _, it, _ = c
            hs, Qs, Y, err, stages = one_iteration(hs, Qs, Y)
            return hs, Qs, Y, err, it + 1, stages

        hs, Qs, Y, err, iters, stages = jax.lax.while_loop(cond, body, init)
        return hs, Qs, Y, err, iters, stages

    def step(carry, k):
        hs, Qs, Y, end_states = carry
        # per-level gate-controller update on every gated external end
        # (no-op otherwise), as in ops/preissmann.py:simulate
        t = k.astype(dtype) * dt
        end_states = tuple(
            tuple(est if _is_junction(end)
                  else bnd.update_gate_level_start(end, est, t)
                  for end, est in zip((br.us, br.ds), ests))
            for br, ests in zip(branches, end_states))
        prevs = tuple(prs.prev_level_state(br.geo, h, Q)
                      for br, h, Q in zip(branches, hs, Qs))
        hs, Qs, Y, err, iters, stages = newton_level(hs, Qs, Y, prevs, k,
                                                     end_states)
        new_states, gate_rows = [], []
        for bi, (br, ests) in enumerate(zip(branches, end_states)):
            pair = []
            for j, (end, h_e) in enumerate(((br.us, hs[bi][0]),
                                            (br.ds, hs[bi][-1]))):
                est = ests[j]
                if not _is_junction(end):
                    est = est._replace(reservoir_stage=stages[bi, j],
                                       gate_stage=end.bed_level + h_e)
                pair.append(est)
            gate_rows.append(jnp.stack([pair[0].gate_open,
                                        pair[1].gate_open]))
            new_states.append(tuple(pair))
        end_states = tuple(new_states)
        out = (hs, Qs, Y, err, iters, stages, jnp.stack(gate_rows))
        return (hs, Qs, Y, end_states), out

    gate_open0 = 1.0 if settings.gate_initially_open else 0.0

    def init_est(end, h0, node):
        if _is_junction(end):
            return bnd.initial_bc_state(dtype)
        return bnd.initial_bc_state(dtype, gate_open=gate_open0,
                                    gate_stage=end.bed_level + h0[node])

    end_states0 = tuple((init_est(br.us, h0, 0), init_est(br.ds, h0, -1))
                        for br, h0 in zip(branches, h0s))

    carry0 = ((h0s, Q0s, Y0, end_states0) if carry_in is None else carry_in)
    if ks is None:
        ks = jnp.arange(1, nt)
    carry_out, (hs_t, Qs_t, Y_t, errs, iters, stages_t, gates_t) = (
        jax.lax.scan(step, carry0, ks))
    if chunked:
        return (hs_t, Qs_t, Y_t, errs, iters, stages_t, gates_t), carry_out

    depth = tuple(jnp.concatenate([h0[None], ht], axis=0)
                  for h0, ht in zip(h0s, hs_t))
    flow = tuple(jnp.concatenate([Q0[None], qt], axis=0)
                 for Q0, qt in zip(Q0s, Qs_t))
    stage = jnp.concatenate([Y0[None], Y_t], axis=0)
    zero = jnp.zeros((1,), errs.dtype)
    errs = jnp.concatenate([zero, errs])
    iters = jnp.concatenate([jnp.zeros((1,), iters.dtype), iters])
    converged = (errs < tol)
    res0 = jnp.full((1,) + stages_t.shape[1:], jnp.nan, stages_t.dtype)
    gates0 = jnp.stack([
        jnp.stack([ests[0].gate_open, ests[1].gate_open])
        for ests in end_states0])[None]
    if junction_rating is None:
        outflow = jnp.zeros_like(stage)
    else:
        outflow = jnp.stack(
            [jnp.zeros((stage.shape[0],), dtype) if rc is None
             else rcurve.discharge(rc, stage[:, j])
             for j, rc in enumerate(junction_rating)], axis=-1)
    return NetworkOutput(depth=depth, flow=flow, junction_stage=stage,
                         iterations=iters, error=errs, converged=converged,
                         reservoir_stage=jnp.concatenate([res0, stages_t]),
                         gate_open=jnp.concatenate([gates0, gates_t]),
                         junction_outflow=outflow)


def _edge_pad(x, Nmax):
    """[N, ...] -> [Nmax, ...], replicating the last row along axis 0."""
    N = x.shape[0]
    if N == Nmax:
        return x
    pad = [(0, Nmax - N)] + [(0, 0)] * (x.ndim - 1)
    return jnp.pad(x, pad, mode="edge")


@partial(jax.jit, static_argnames=("topo", "n_junctions", "settings",
                                   "chunked"))
def _simulate_network_stacked(dyn, Y0, junction_area, junction_rating,
                              carry_in=None, ks=None, *,
                              topo, n_junctions, settings, chunked=False):
    """Stacked-branch engine (``engine="stacked"``).

    Every branch is edge-padded to the longest branch length Nmax and the B
    branch systems become ONE batched [B, Nmax] assembly + ONE batched
    multi-RHS block-tridiagonal solve per Newton iteration.  Pad cells carry
    delta-copy equations (dh_{i+1} = dh_i, dQ_{i+1} = dQ_i with zero
    residual), so node Nmax-1 always mirrors the branch's real end: external
    ds rows and junction couplings live at a uniform index, and the physics
    is untouched.  Pad nodes are re-synced to the branch end at every level
    start so float drift cannot accumulate.
    """
    B = len(topo)
    dtype = jnp.asarray(dyn[0]["h0"]).dtype
    n_bs = tuple(int(d["h0"].shape[0]) for d in dyn)
    Nmax = max(n_bs)
    Nc = Nmax - 1
    theta, dt = settings.theta, settings.time_step
    nt = settings.n_time_levels
    tol, max_iter = settings.tolerance, settings.max_iter
    solver_kind = settings.linear_solver
    J = n_junctions
    area = (jnp.zeros((J,), dtype) if junction_area is None
            else jnp.asarray(junction_area, dtype))
    dxs = jnp.asarray([t[2] for t in topo], dtype)

    geoS = jax.tree_util.tree_map(
        lambda *xs: jnp.stack([_edge_pad(jnp.asarray(x), Nmax) for x in xs]),
        *[d["geo"] for d in dyn])
    h0S = jnp.stack([_edge_pad(jnp.asarray(d["h0"], dtype), Nmax) for d in dyn])
    Q0S = jnp.stack([_edge_pad(jnp.asarray(d["Q0"], dtype), Nmax) for d in dyn])

    if any(d["qlat"] is not None for d in dyn):
        any2d = any(d["qlat"] is not None and jnp.ndim(d["qlat"]) == 2
                    for d in dyn)
        per = []
        for d, nb in zip(dyn, n_bs):
            q = d["qlat"]
            q = (jnp.zeros((nb,), dtype) if q is None
                 else jnp.asarray(q, dtype))
            if q.ndim == 1:
                q = _edge_pad(q, Nmax)
                if any2d:
                    q = jnp.broadcast_to(q, (nt, Nmax))
            else:
                q = _edge_pad(q.T, Nmax).T
            per.append(q)
        qlatS = jnp.stack(per, axis=1 if any2d else 0)  # [nt,B,Nmax]|[B,Nmax]
        qlat_time_varying = any2d
    else:
        qlatS = None
        qlat_time_varying = False

    n_b_arr = jnp.asarray(n_bs)
    node_real = jnp.arange(Nmax)[None, :] < n_b_arr[:, None]      # [B, Nmax]
    cell_real = jnp.arange(Nc)[None, :] < (n_b_arr - 1)[:, None]  # [B, Nc]
    end_idx = n_b_arr - 1

    def sync(xS):
        endv = jnp.take_along_axis(xS, end_idx[:, None], axis=1)
        return jnp.where(node_real, xS, endv)

    # per-branch junction couplings at the uniform stacked indices
    coups = []
    for t in topo:
        c = []
        if t[0] is not None:
            c.append((t[0], 0, 0))          # us junction: node 0, row 0
        if t[1] is not None:
            c.append((t[1], Nmax - 1, 1))   # ds junction: padded end, row 1
        coups.append(c)
    m_rhs = 1 + max((len(c) for c in coups), default=0)

    # static index maps so the per-iteration Schur assembly is a handful of
    # gathers/scatter-adds instead of Python loops of .at ops (which made
    # the traced graph — and compile time — grow with junction count)
    eb, eidx, esgn, ejj = [], [], [], []      # junction ends
    for b, t in enumerate(topo):
        if t[1] is not None:
            eb.append(b); eidx.append(Nmax - 1); esgn.append(1.0); ejj.append(t[1])
        if t[0] is not None:
            eb.append(b); eidx.append(0); esgn.append(-1.0); ejj.append(t[0])
    eb = np.asarray(eb, np.int32)
    eidx = np.asarray(eidx, np.int32)
    esgn = np.asarray(esgn)
    ejj = np.asarray(ejj, np.int32)
    # (end, coupling-of-same-branch) pairs -> M[row, col] scatter targets
    pb, pidx, pci, prow, pcol, psgn = [], [], [], [], [], []
    for e in range(len(eb)):
        b = int(eb[e])
        for ci, (jcol, _, _) in enumerate(coups[b]):
            pb.append(b); pidx.append(int(eidx[e])); pci.append(ci)
            prow.append(int(ejj[e])); pcol.append(jcol)
            psgn.append(float(esgn[e]))
    pb, pidx, pci = (np.asarray(a, np.int32) for a in (pb, pidx, pci))
    prow, pcol = np.asarray(prow, np.int32), np.asarray(pcol, np.int32)
    psgn = np.asarray(psgn)
    # per-branch coupling-column -> junction id (for the dY correction)
    colmap = np.zeros((B, max(m_rhs - 1, 1)), np.int32)
    colmask_np = np.zeros((B, max(m_rhs - 1, 1)))
    for b, c in enumerate(coups):
        for ci, (jcol, _, _) in enumerate(c):
            colmap[b, ci] = jcol
            colmask_np[b, ci] = 1.0
    colmask = jnp.asarray(colmask_np, dtype)
    # constant -1 coupling columns of the multi-RHS solve
    rhs_coup_np = np.zeros((B, Nmax, 2, max(m_rhs - 1, 1)))
    for b, c in enumerate(coups):
        for ci, (jcol, idx, row) in enumerate(c):
            rhs_coup_np[b, idx, row, ci] = -1.0
    rhs_coup = jnp.asarray(rhs_coup_np, dtype)

    def sum_signed_ends(QS_):
        return (jnp.zeros((J,), dtype)
                .at[ejj].add(jnp.asarray(esgn, dtype) * QS_[eb, eidx]))

    if Y0 is None:
        found = {}
        for b, t in enumerate(topo):
            for jid, idx in ((t[1], n_bs[b] - 1), (t[0], 0)):
                if jid is not None and jid not in found:
                    found[jid] = geoS.z_bed[b, idx] + h0S[b, idx]
        Y0 = (jnp.stack([found[j] for j in range(J)]) if J
              else jnp.zeros((0,), dtype))
    Y0 = jnp.asarray(Y0, dtype)

    def node_sec(stS, b, idx):
        return bnd.NodeSection(
            A=stS.A[b, idx], R=stS.R[b, idx], K=stS.K[b, idx],
            n_eq=stS.n_eq[b, idx], dA_dh=stS.dA_dh[b, idx],
            dR_dA=stS.dR_dA[b, idx], dK_dA=stS.dK_dA[b, idx])

    nan = jnp.asarray(jnp.nan, dtype)
    th_dx = (theta / dxs)[:, None]  # [B, 1]

    def newton_level(hS, QS, Y, prevS, k, end_states):
        Y_prev = Y
        Sp = sum_signed_ends(prevS.Q)
        q_out_prev, _ = _junction_outflow(junction_rating, Y_prev, dtype)

        if qlatS is None:
            qc = qp = None
        elif qlat_time_varying:
            qc, qp = qlatS[k], qlatS[k - 1]
        else:
            qc = qp = qlatS

        def one_iteration(hS, QS, Y):
            stS = jax.vmap(sec.section_state)(geoS, hS)
            esS = jax.vmap(lambda g, h, Q, st: sec.energy_slope(g, h, Q, st))(
                geoS, hS, QS, stS)

            def stencil_one(geo_b, st_b, es_b, h_b, Q_b, dx_b, prev_b, q2):
                qc_b, qp_b = q2
                cur = dict(prs.node_stencil_fields(geo_b, st_b, es_b, h_b, Q_b),
                           qlat=qc_b)
                pv = dict(A=prev_b.A, Se=prev_b.Se, Q2A=prev_b.Q2A,
                          Q=prev_b.Q, h=prev_b.h, qlat=qp_b)
                return prs.cell_stencil(theta, dt, dx_b, cur, pv)

            cells = jax.vmap(stencil_one)(geoS, stS, esS, hS, QS, dxs, prevS,
                                          (qc, qp))

            mask = cell_real
            Rc = jnp.where(mask, cells.Rc, hS[:, 1:] - hS[:, :-1])
            Rm = jnp.where(mask, cells.Rm, QS[:, 1:] - QS[:, :-1])
            dC_dh_i = jnp.where(mask, cells.dC_dh_i, -1.0)
            dC_dQ_i = jnp.where(mask, -th_dx, 0.0)
            dC_dh_i1 = jnp.where(mask, cells.dC_dh_i1, 1.0)
            dC_dQ_i1 = jnp.where(mask, th_dx, 0.0)
            dM_dh_i = jnp.where(mask, cells.dM_dh_i, 0.0)
            dM_dQ_i = jnp.where(mask, cells.dM_dQ_i, -1.0)
            dM_dh_i1 = jnp.where(mask, cells.dM_dh_i1, 0.0)
            dM_dQ_i1 = jnp.where(mask, cells.dM_dQ_i1, 1.0)

            us_rows, ds_rows, stage_rows = [], [], []
            for b, (t, d, ests) in enumerate(zip(topo, dyn, end_states)):
                out_b = []
                for j, (jid, bc, idx, upstream) in enumerate(
                        ((t[0], d["us"], 0, True),
                         (t[1], d["ds"], Nmax - 1, False))):
                    est = ests[j]
                    if jid is not None:
                        z_e = geoS.z_bed[b, idx]
                        res, dfh, dfq = _end_row_junction(hS[b, idx], z_e,
                                                          Y[jid])
                        out_b.append((res, dfh, dfq, nan))
                        continue
                    ev = bnd.evaluate(
                        bc, node_sec(stS, b, idx), hS[b, idx], QS[b, idx],
                        k, dt, Q_prev=prevS.Q[b, idx],
                        reservoir_stage_prev=est.reservoir_stage,
                        bc_state=est, upstream=upstream,
                        h_prev=prevS.h[b, idx])
                    out_b.append((ev.residual, ev.df_dh, ev.df_dQ,
                                  ev.reservoir_stage))
                us_rows.append(out_b[0])
                ds_rows.append(out_b[1])
                stage_rows.append(jnp.stack([out_b[0][3], out_b[1][3]]))
            us_res, us_dh, us_dq = (jnp.stack([r[i] for r in us_rows])
                                    for i in range(3))
            ds_res, ds_dh, ds_dq = (jnp.stack([r[i] for r in ds_rows])
                                    for i in range(3))
            stages = jnp.stack(stage_rows)

            z1 = jnp.zeros((B, 1), dtype)
            L = jnp.stack(
                [jnp.stack([jnp.concatenate([z1, dM_dh_i], 1),
                            jnp.concatenate([z1, dM_dQ_i], 1)], -1),
                 jnp.zeros((B, Nmax, 2), dtype)], -2)
            D_row0 = jnp.stack([jnp.concatenate([us_dh[:, None], dM_dh_i1], 1),
                                jnp.concatenate([us_dq[:, None], dM_dQ_i1], 1)],
                               -1)
            D_row1 = jnp.stack([jnp.concatenate([dC_dh_i, ds_dh[:, None]], 1),
                                jnp.concatenate([dC_dQ_i, ds_dq[:, None]], 1)],
                               -1)
            D = jnp.stack([D_row0, D_row1], -2)
            U = jnp.stack(
                [jnp.zeros((B, Nmax, 2), dtype),
                 jnp.stack([jnp.concatenate([dC_dh_i1, z1], 1),
                            jnp.concatenate([dC_dQ_i1, z1], 1)], -1)], -2)
            rhs0 = -jnp.stack([jnp.concatenate([us_res[:, None], Rm], 1),
                               jnp.concatenate([Rc, ds_res[:, None]], 1)], -1)

            q_out, dq_dz = _junction_outflow(junction_rating, Y, dtype)
            S = sum_signed_ends(QS)
            G = _junction_residuals(S, Y, area, dt, q_out,
                                    (Y_prev, Sp, q_out_prev))

            err = jnp.sqrt(jnp.sum(us_res**2) + jnp.sum(ds_res**2)
                           + jnp.sum(jnp.where(mask, Rc, 0.0)**2)
                           + jnp.sum(jnp.where(mask, Rm, 0.0)**2)
                           + jnp.sum(G**2))

            if m_rhs > 1:
                rhs = jnp.concatenate([rhs0[..., None], rhs_coup], axis=-1)
            else:
                rhs = rhs0[..., None]
            X = solve_block_tridiag(L, D, U, rhs, method=solver_kind)

            if J:
                fac = jnp.where(area > 0.0, -0.5, 1.0)
                rhsJ = G.at[ejj].add(
                    fac[ejj] * jnp.asarray(esgn, dtype) * X[eb, eidx, 1, 0])
                pvals = (fac[prow] * jnp.asarray(psgn, dtype)
                         * X[pb, pidx, 1, 1 + pci])
                M = jnp.zeros((J, J), dtype).at[prow, pcol].add(pvals)
                D_Y = jnp.where(area > 0.0, area / dt + 0.5 * dq_dz, -dq_dz)
                M = M - jnp.diag(D_Y)
                dY = _solve_junction_system(M, rhsJ)
            else:
                dY = jnp.zeros((0,), dtype)

            delta = X[..., 0]
            if m_rhs > 1:
                dY_cols = dY[colmap] * colmask        # [B, m_rhs-1], pads 0
                delta = delta - jnp.einsum("bnrm,bm->bnr", X[..., 1:], dY_cols)
            return (hS + delta[..., 0], QS + delta[..., 1], Y + dY, err,
                    stages)

        stages0 = jnp.stack([
            jnp.stack([ests[0].reservoir_stage, ests[1].reservoir_stage])
            for ests in end_states])
        init = (hS, QS, Y, jnp.asarray(jnp.inf, dtype),
                jnp.asarray(0, jnp.int32), stages0)

        if settings.newton == "fixed":  # differentiable masked Newton
            def fbody(c, _):
                hS, QS, Y, err, it, stages = c
                active = err >= tol
                hS2, QS2, Y2, err2, st2 = one_iteration(hS, QS, Y)
                sel = lambda a, b: jnp.where(active, a, b)
                return (sel(hS2, hS), sel(QS2, QS), sel(Y2, Y),
                        sel(err2, err), it + active.astype(it.dtype),
                        sel(st2, stages)), None

            (hS, QS, Y, err, iters, stages), _ = jax.lax.scan(
                fbody, init, None, length=max_iter)
            return hS, QS, Y, err, iters, stages

        def cond(c):
            err, it = c[3], c[4]
            return (err >= tol) & (it < max_iter)

        def body(c):
            hS, QS, Y, _, it, _ = c
            hS, QS, Y, err, stages = one_iteration(hS, QS, Y)
            return hS, QS, Y, err, it + 1, stages

        hS, QS, Y, err, iters, stages = jax.lax.while_loop(cond, body, init)
        return hS, QS, Y, err, iters, stages

    def step(carry, k):
        hS, QS, Y, end_states = carry
        hS, QS = sync(hS), sync(QS)  # pads re-anchored to the branch ends
        t_now = k.astype(dtype) * dt
        new_states = []
        for b, (t, d, ests) in enumerate(zip(topo, dyn, end_states)):
            pair = []
            for j, (jid, bc) in enumerate(((t[0], d["us"]), (t[1], d["ds"]))):
                est = ests[j]
                if jid is None:
                    est = bnd.update_gate_level_start(bc, est, t_now)
                pair.append(est)
            new_states.append(tuple(pair))
        end_states = tuple(new_states)
        prevS = jax.vmap(prs.prev_level_state)(geoS, hS, QS)
        hS, QS, Y, err, iters, stages = newton_level(hS, QS, Y, prevS, k,
                                                     end_states)
        new_states, gate_rows = [], []
        for b, (t, d, ests) in enumerate(zip(topo, dyn, end_states)):
            pair = []
            for j, (jid, bc, idx) in enumerate(((t[0], d["us"], 0),
                                                (t[1], d["ds"], Nmax - 1))):
                est = ests[j]
                if jid is None:
                    est = est._replace(reservoir_stage=stages[b, j],
                                       gate_stage=bc.bed_level + hS[b, idx])
                pair.append(est)
            gate_rows.append(jnp.stack([pair[0].gate_open,
                                        pair[1].gate_open]))
            new_states.append(tuple(pair))
        end_states = tuple(new_states)
        out = (hS, QS, Y, err, iters, stages, jnp.stack(gate_rows))
        return (hS, QS, Y, end_states), out

    gate_open0 = 1.0 if settings.gate_initially_open else 0.0

    def init_est(jid, bc, b, idx):
        if jid is not None:
            return bnd.initial_bc_state(dtype)
        return bnd.initial_bc_state(dtype, gate_open=gate_open0,
                                    gate_stage=bc.bed_level + h0S[b, idx])

    end_states0 = tuple(
        (init_est(t[0], d["us"], b, 0), init_est(t[1], d["ds"], b, n_bs[b] - 1))
        for b, (t, d) in enumerate(zip(topo, dyn)))

    if carry_in is None:
        carry0 = (h0S, Q0S, Y0, end_states0)
    else:
        # carries are exchanged in the engine-agnostic per-branch tuple form
        # (as the loop engine's), so checkpointed runs can switch engines;
        # edge-padding reproduces exactly what sync() enforces at level start
        hs_in, Qs_in, Y_in, ests_in = carry_in
        carry0 = (jnp.stack([_edge_pad(jnp.asarray(h, dtype), Nmax)
                             for h in hs_in]),
                  jnp.stack([_edge_pad(jnp.asarray(q, dtype), Nmax)
                             for q in Qs_in]),
                  jnp.asarray(Y_in, dtype), ests_in)
    if ks is None:
        ks = jnp.arange(1, nt)
    carry_out, (hS_t, QS_t, Y_t, errs, iters, stages_t, gates_t) = (
        jax.lax.scan(step, carry0, ks))
    if chunked:
        hS_f, QS_f, Y_f, ests_f = carry_out
        outs = (tuple(hS_t[:, b, :n_bs[b]] for b in range(B)),
                tuple(QS_t[:, b, :n_bs[b]] for b in range(B)),
                Y_t, errs, iters, stages_t, gates_t)
        carry = (tuple(hS_f[b, :n_bs[b]] for b in range(B)),
                 tuple(QS_f[b, :n_bs[b]] for b in range(B)),
                 Y_f, ests_f)
        return outs, carry

    depth = tuple(jnp.concatenate([h0S[b, :n_bs[b]][None],
                                   hS_t[:, b, :n_bs[b]]], axis=0)
                  for b in range(B))
    flow = tuple(jnp.concatenate([Q0S[b, :n_bs[b]][None],
                                  QS_t[:, b, :n_bs[b]]], axis=0)
                 for b in range(B))
    stage = jnp.concatenate([Y0[None], Y_t], axis=0)
    zero = jnp.zeros((1,), errs.dtype)
    errs = jnp.concatenate([zero, errs])
    iters = jnp.concatenate([jnp.zeros((1,), iters.dtype), iters])
    converged = (errs < tol)
    res0 = jnp.full((1,) + stages_t.shape[1:], jnp.nan, stages_t.dtype)
    gates0 = jnp.stack([
        jnp.stack([ests[0].gate_open, ests[1].gate_open])
        for ests in end_states0])[None]
    if junction_rating is None:
        outflow = jnp.zeros_like(stage)
    else:
        outflow = jnp.stack(
            [jnp.zeros((stage.shape[0],), dtype) if rc is None
             else rcurve.discharge(rc, stage[:, j])
             for j, rc in enumerate(junction_rating)], axis=-1)
    return NetworkOutput(depth=depth, flow=flow, junction_stage=stage,
                         iterations=iters, error=errs, converged=converged,
                         reservoir_stage=jnp.concatenate([res0, stages_t]),
                         gate_open=jnp.concatenate([gates0, gates_t]),
                         junction_outflow=outflow)
