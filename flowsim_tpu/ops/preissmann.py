"""Preissmann four-point implicit box scheme — the dynamical core.

Accelerator redesign of the reference solver (ref: src/hydromodel/preissmann.py):
instead of per-node Python loops assembling a scipy CSR matrix and a
sequential sparse LU per Newton iteration (ref :79-99, :146), each Newton
iteration here is

    1. one fused, fully vectorized stencil evaluating all 2N residuals and
       all (8N-4) Jacobian entries from the per-node closure arrays
       (formulas: ref :200-320 residuals, :346-798 Jacobian entries), and
    2. one O(log N)-depth block-tridiagonal solve (PCR; see
       :mod:`flowsim_tpu.ops.tridiag`) for the Newton update.

Time stepping is a ``lax.scan`` over levels; the Newton iteration is a
``lax.while_loop`` (or a fixed-length masked scan when reverse-mode
differentiability is required, e.g. gradient calibration).

Numerical semantics replicated exactly from the reference:

* theta-weighted operators time_diff / spatial_diff / cell_avg (ref :899-910);
* unknown ordering [h0,Q0,h1,Q1,...] and equation ordering
  [US, C_0, M_0, ..., C_{N-2}, M_{N-2}, DS] (ref :76-81), regrouped into the
  equivalent 2x2-block tridiagonal form;
* convergence on the L2 norm of the *pre-update* residual, with the final
  Newton increment still applied (ref :146-153);
* the downstream storage volume 0.5 (Q_ds^{k-1} + Q_ds^k) dt (ref :314).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from flowsim_tpu.config import GRAVITY as g
from flowsim_tpu.ops import boundary as bnd
from flowsim_tpu.ops import sections as sec
from flowsim_tpu.ops import tridiag


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class PreissmannSettings:
    theta: float = field(metadata=dict(static=True))
    time_step: float = field(metadata=dict(static=True))
    spatial_step: float = field(metadata=dict(static=True))
    n_time_levels: int = field(metadata=dict(static=True))
    tolerance: float = field(metadata=dict(static=True))
    max_iter: int = field(metadata=dict(static=True))
    linear_solver: str = field(default="pcr", metadata=dict(static=True))
    # 'while': data-dependent Newton loop (fastest forward; not reverse-
    #          differentiable on its own);
    # 'fixed': fixed-length masked Newton (reverse-differentiable by
    #          unrolling — stores max_iter x nt iterates on the tape);
    # 'implicit': while-Newton forward + adjoint/IFT backward via
    #          custom_vjp (ops/adjoint.py) — the fast differentiable path.
    newton: str = field(default="while", metadata=dict(static=True))
    gate_initially_open: bool = field(default=False, metadata=dict(static=True))
    # diagnos=True mirrors the reference's per-iteration ill-conditioning
    # check (ref preissmann.py:133-144): an in-graph PCR-pivot rcond proxy is
    # tracked per level and surfaced as SimOutput.rcond.
    diagnos: bool = field(default=False, metadata=dict(static=True))
    # live_progress=True streams the reference's per-level verbose lines
    # (ref preissmann.py:116-117,151-155) from inside the scan via
    # jax.debug.callback — one host callback per time level, so long runs
    # show progress as they execute.  Off by default: the callback forces a
    # host round-trip per level.
    live_progress: bool = field(default=False, metadata=dict(static=True))
    # store="boundaries" keeps only the two boundary nodes of each level's
    # (h, Q) fields (SimOutput.depth/flow become [nt, 2] = [upstream,
    # downstream]) — for Monte-Carlo ensembles where the per-member outputs
    # are hydrograph/stage series, this cuts the stacked-output working set
    # by N/2 and lifts the large-batch sims/s ceiling.  "full" (default)
    # stores every node, as the reference does
    # (ref solver.py:43-44).
    store: str = field(default="full", metadata=dict(static=True))


class PrevLevel(NamedTuple):
    """Quantities of the previous (converged) time level, computed once."""

    h: jnp.ndarray
    Q: jnp.ndarray
    A: jnp.ndarray
    Se: jnp.ndarray
    Q2A: jnp.ndarray


class SimOutput(NamedTuple):
    depth: jnp.ndarray        # [nt, N]
    flow: jnp.ndarray         # [nt, N]
    iterations: jnp.ndarray   # [nt] Newton iterations (0 at level 0)
    error: jnp.ndarray        # [nt] final pre-update residual norm
    converged: jnp.ndarray    # [nt] bool
    reservoir_stage: jnp.ndarray  # [nt] NaN unless a storage BC (ds, or us-only)
    gate_open: jnp.ndarray    # [nt] gate flag (gated_blend downstream curve)
    rcond: Optional[jnp.ndarray] = None  # [nt] min pivot-rcond proxy (diagnos)
    reservoir_stage_us: Optional[jnp.ndarray] = None  # [nt] upstream storage stage (both-ends runs)


def _node_section(st: sec.SectionState, i) -> bnd.NodeSection:
    return bnd.NodeSection(
        A=st.A[i], R=st.R[i], K=st.K[i], n_eq=st.n_eq[i],
        dA_dh=st.dA_dh[i], dR_dA=st.dR_dA[i], dK_dA=st.dK_dA[i],
    )


def prev_level_state(geo, h, Q) -> PrevLevel:
    st = sec.section_state(geo, h)
    es = sec.energy_slope(geo, h, Q, st)
    return PrevLevel(h=h, Q=Q, A=st.A, Se=es.Se, Q2A=Q * Q / st.A)


class CellOut(NamedTuple):
    """Per-cell stencil outputs needed by the two adjacent block rows."""

    Rc: jnp.ndarray
    Rm: jnp.ndarray
    dC_dh_i: jnp.ndarray
    dC_dh_i1: jnp.ndarray
    dM_dh_i: jnp.ndarray
    dM_dh_i1: jnp.ndarray
    dM_dQ_i: jnp.ndarray
    dM_dQ_i1: jnp.ndarray


def node_stencil_fields(geo, st, es, h, Q) -> dict:
    """The per-node arrays :func:`cell_stencil` consumes (ref :220-301)."""
    return dict(
        A=st.A, z=geo.z_bed, h=h, Se=es.Se, Q2A=Q * Q / st.A, Q=Q,
        dA_dh=st.dA_dh, dSe_dA=es.dSe_dA_eff, dSe_dQ=es.dSe_dQ, QA=Q / st.A,
    )


def cell_stencil(theta, dt, dx, cur: dict, prev: dict) -> CellOut:
    """Fused interior residual + Jacobian stencil over the n-1 cells of n
    node arrays (ref :220-301 residuals, :407-733 Jacobian entries).

    Single source of truth for the theta-box physics: the single-device
    :func:`assemble` and the sharded assemble
    (parallel/domain.py:_assemble_local, which feeds halo-extended local
    arrays) both call this, so numeric hardenings apply to both paths.
    ``prev`` needs keys A, Se, Q2A, Q, h only.

    Optional ``qlat`` key on both dicts ([N] lateral inflow per unit
    length, m^2/s): continuity becomes dA/dt + dQ/dx = q with q entering
    as the theta-weighted cell average (a flowsim_tpu extension — the
    reference has no distributed sources; the lateral momentum flux is
    neglected, the standard treatment for inflow entering perpendicular
    to the channel).  State-independent, so the Jacobian is unchanged.
    """
    A, Se, Q2A, Q, hcur, z = cur["A"], cur["Se"], cur["Q2A"], cur["Q"], cur["h"], cur["z"]
    dA_dh, dSe_dA, dSe_dQ, QA = cur["dA_dh"], cur["dSe_dA"], cur["dSe_dQ"], cur["QA"]
    Ap, Sep, Q2Ap, Qp, hp = prev["A"], prev["Se"], prev["Q2A"], prev["Q"], prev["h"]

    tdiff = lambda c, p: (c[1:] + c[:-1] - p[1:] - p[:-1]) / (2.0 * dt)
    sdiff = lambda c, p: (theta * (c[1:] - c[:-1]) + (1.0 - theta) * (p[1:] - p[:-1])) / dx
    cavg = lambda c, p: 0.5 * theta * (c[1:] + c[:-1]) + 0.5 * (1.0 - theta) * (p[1:] + p[:-1])

    Rc = tdiff(A, Ap) + sdiff(Q, Qp)
    if cur.get("qlat") is not None:
        Rc = Rc - cavg(cur["qlat"], prev["qlat"])
    avgA = cavg(A, Ap)
    # water-level slope as bed slope + theta-weighted depth slope: identical
    # algebra to sdiff(z+h) but cancellation-free — with z ~ 5e2 and f32 the
    # direct difference loses ~6 digits and floors the Newton residual.
    dYdx = (z[1:] - z[:-1]) / dx + sdiff(hcur, hp)
    avgSe = cavg(Se, Sep)
    Rm = tdiff(Q, Qp) + sdiff(Q2A, Q2Ap) + g * avgA * (dYdx + avgSe)

    th_dx = theta / dx
    inv2dt = 1.0 / (2.0 * dt)
    geom = dYdx + avgSe
    return CellOut(
        Rc=Rc,
        Rm=Rm,
        dC_dh_i=dA_dh[:-1] * inv2dt,
        dC_dh_i1=dA_dh[1:] * inv2dt,
        # dC_dQ_i = -th_dx ; dC_dQ_i1 = th_dx (constants)
        dM_dh_i=(th_dx * QA[:-1] ** 2 * dA_dh[:-1]
                 + g * (avgA * (-th_dx + 0.5 * theta * dSe_dA[:-1] * dA_dh[:-1])
                        + 0.5 * theta * dA_dh[:-1] * geom)),
        dM_dh_i1=(-th_dx * QA[1:] ** 2 * dA_dh[1:]
                  + g * (avgA * (th_dx + 0.5 * theta * dSe_dA[1:] * dA_dh[1:])
                         + 0.5 * theta * dA_dh[1:] * geom)),
        dM_dQ_i=inv2dt - th_dx * 2.0 * QA[:-1] + g * avgA * 0.5 * theta * dSe_dQ[:-1],
        dM_dQ_i1=inv2dt + th_dx * 2.0 * QA[1:] + g * avgA * 0.5 * theta * dSe_dQ[1:],
    )


def assemble(geo, us_bc, ds_bc, settings: PreissmannSettings, prev: PrevLevel, h, Q, k, reservoir_stage_prev, bc_state=None,
             reservoir_stage_prev_us=None, qlat_cur=None, qlat_prev=None):
    """Residuals + block-tridiagonal Jacobian at the current Newton iterate.

    Returns (L, D, U, b, err_norm, reservoir_stage, reservoir_stage_us):
    the 2x2 block system J delta = b (b = -R grouped per node), the L2 norm
    of R, and the two boundaries' new storage stages.  ``reservoir_stage``
    keeps the merged (ds-preferred) value for backward compatibility;
    ``reservoir_stage_us`` is NaN unless the upstream boundary has storage.
    ``reservoir_stage_prev_us`` defaults to ``reservoir_stage_prev`` so
    single-storage callers need not pass it; both-ends runs MUST pass each
    boundary its own previous stage.
    """
    theta = settings.theta
    dt = settings.time_step
    dx = settings.spatial_step

    st = sec.section_state(geo, h)
    es = sec.energy_slope(geo, h, Q, st)

    # -- interior residuals + Jacobian, one fused stencil over cells -------
    cells = cell_stencil(
        theta, dt, dx, dict(node_stencil_fields(geo, st, es, h, Q), qlat=qlat_cur),
        dict(A=prev.A, Se=prev.Se, Q2A=prev.Q2A, Q=prev.Q, h=prev.h, qlat=qlat_prev))
    Rc, Rm = cells.Rc, cells.Rm
    dC_dh_i, dC_dh_i1 = cells.dC_dh_i, cells.dC_dh_i1
    dM_dh_i, dM_dh_i1 = cells.dM_dh_i, cells.dM_dh_i1
    dM_dQ_i, dM_dQ_i1 = cells.dM_dQ_i, cells.dM_dQ_i1
    th_dx = theta / dx

    # -- boundary rows (ref :200-218, :303-320) ----------------------------
    if reservoir_stage_prev_us is None:
        reservoir_stage_prev_us = reservoir_stage_prev
    us = bnd.evaluate(us_bc, _node_section(st, 0), h[0], Q[0], k, dt,
                      Q_prev=prev.Q[0], reservoir_stage_prev=reservoir_stage_prev_us,
                      bc_state=bc_state, upstream=True, h_prev=prev.h[0])
    ds = bnd.evaluate(ds_bc, _node_section(st, -1), h[-1], Q[-1], k, dt,
                      Q_prev=prev.Q[-1], reservoir_stage_prev=reservoir_stage_prev,
                      bc_state=bc_state)
    reservoir_stage = jnp.where(jnp.isnan(ds.reservoir_stage), us.reservoir_stage, ds.reservoir_stage)
    reservoir_stage_us = us.reservoir_stage

    # -- norm of the full residual vector (ref :149) -----------------------
    err = jnp.sqrt(us.residual**2 + ds.residual**2 + jnp.sum(Rc**2) + jnp.sum(Rm**2))

    # -- regroup into 2x2 block-tridiagonal form ---------------------------
    dtype = h.dtype
    N = h.shape[0]

    # L[i], i>=1: row0 = dM[i-1]/dx_{i-1}; row1 = 0
    L = jnp.stack(
        [
            jnp.stack([jnp.concatenate([jnp.zeros((1,), dtype), dM_dh_i]),
                       jnp.concatenate([jnp.zeros((1,), dtype), dM_dQ_i])], axis=-1),
            jnp.zeros((N, 2), dtype),
        ],
        axis=-2,
    )
    # D[i]: row0 = US row (i=0) or dM[i-1]/dx_i ; row1 = dC[i]/dx_i (i<N-1) or DS row
    D_row0 = jnp.stack(
        [jnp.concatenate([us.df_dh[None], dM_dh_i1]),
         jnp.concatenate([us.df_dQ[None], dM_dQ_i1])], axis=-1)
    D_row1 = jnp.stack(
        [jnp.concatenate([dC_dh_i, ds.df_dh[None]]),
         jnp.concatenate([jnp.full((N - 1,), -th_dx, dtype), ds.df_dQ[None]])], axis=-1)
    D = jnp.stack([D_row0, D_row1], axis=-2)
    # U[i], i<N-1: row0 = 0; row1 = dC[i]/dx_{i+1}
    U = jnp.stack(
        [
            jnp.zeros((N, 2), dtype),
            jnp.stack([jnp.concatenate([dC_dh_i1, jnp.zeros((1,), dtype)]),
                       jnp.concatenate([jnp.full((N - 1,), th_dx, dtype), jnp.zeros((1,), dtype)])], axis=-1),
        ],
        axis=-2,
    )

    b_row0 = jnp.concatenate([us.residual[None], Rm])
    b_row1 = jnp.concatenate([Rc, ds.residual[None]])
    b = -jnp.stack([b_row0, b_row1], axis=-1)

    return L, D, U, b, err, reservoir_stage, reservoir_stage_us


def _solve_with_diag(L, D, U, b, settings):
    """Newton increment + (when ``settings.diagnos``) an rcond proxy.

    With diagnos off, rcond is a constant 1.0 and costs nothing.  With it on,
    the pcr paths reuse their own final pivots; other solvers run an extra
    diagnostic PCR pass — mirroring the reference, whose diagnos mode also
    pays an extra factorization (``splu`` purely for rcond, ref
    preissmann.py:139-141).
    """
    method = settings.linear_solver
    if not settings.diagnos:
        delta = tridiag.solve_block_tridiag(L, D, U, b, method=method)
        return delta, jnp.asarray(1.0, b.dtype)
    if method == "pcr":
        delta, rc = tridiag.block_pcr_diag(L, D, U, b)
    elif method == "pcr_f32":
        f32 = jnp.float32
        x, rc = tridiag.block_pcr_diag(L.astype(f32), D.astype(f32),
                                       U.astype(f32), b.astype(f32))
        delta = x.astype(b.dtype)
    else:
        delta = tridiag.solve_block_tridiag(L, D, U, b, method=method)
        _, rc = tridiag.block_pcr_diag(L, D, U, b)
    return delta, rc.astype(b.dtype)


def newton_solve(geo, us_bc, ds_bc, settings, prev: PrevLevel, h, Q, k, reservoir_stage_prev, bc_state=None,
                 reservoir_stage_prev_us=None, qlat_cur=None, qlat_prev=None):
    """One time level: Newton-iterate to tolerance (ref :101-163 inner loop).

    Returns ``(h, Q, err, iters, reservoir_stage, reservoir_stage_us,
    rcond)`` where rcond is the minimum pivot-rcond proxy across the
    level's iterations (1.0 when ``settings.diagnos`` is off).
    """
    tol = settings.tolerance

    def one_iteration(h, Q):
        L, D, U, b, err, res_stage, res_stage_us = assemble(
            geo, us_bc, ds_bc, settings, prev, h, Q, k, reservoir_stage_prev, bc_state,
            reservoir_stage_prev_us=reservoir_stage_prev_us,
            qlat_cur=qlat_cur, qlat_prev=qlat_prev,
        )
        delta, rc = _solve_with_diag(L, D, U, b, settings)
        return h + delta[:, 0], Q + delta[:, 1], err, res_stage, res_stage_us, rc

    nan = jnp.asarray(jnp.nan, dtype=h.dtype)
    one = jnp.asarray(1.0, dtype=h.dtype)

    if settings.newton == "while":
        def cond(c):
            err, it = c[2], c[3]
            return (err >= tol) & (it < settings.max_iter)

        def body(c):
            h, Q, _, it, _, _, rc_min = c
            h2, Q2, err, res_stage, res_us, rc = one_iteration(h, Q)
            return (h2, Q2, err, it + 1, res_stage, res_us, jnp.minimum(rc_min, rc))

        h, Q, err, iters, res_stage, res_stage_us, rcond = jax.lax.while_loop(
            cond, body, (h, Q, jnp.asarray(jnp.inf, h.dtype), jnp.asarray(0), nan, nan, one)
        )
    else:  # fixed-length masked Newton: reverse-mode differentiable
        def body(c, _):
            h, Q, err, it, res_stage, res_stage_us, rc_min = c
            active = err >= tol
            h2, Q2, err2, res2, res2_us, rc = one_iteration(h, Q)
            h = jnp.where(active, h2, h)
            Q = jnp.where(active, Q2, Q)
            err = jnp.where(active, err2, err)
            res_stage = jnp.where(active, res2, res_stage)
            res_stage_us = jnp.where(active, res2_us, res_stage_us)
            rc_min = jnp.where(active, jnp.minimum(rc_min, rc), rc_min)
            it = it + active.astype(it.dtype)
            return (h, Q, err, it, res_stage, res_stage_us, rc_min), None

        (h, Q, err, iters, res_stage, res_stage_us, rcond), _ = jax.lax.scan(
            body, (h, Q, jnp.asarray(jnp.inf, h.dtype), jnp.asarray(0), nan, nan, one),
            None, length=settings.max_iter,
        )

    return h, Q, err, iters, res_stage, res_stage_us, rcond


def guard_f32_floor(settings: PreissmannSettings) -> PreissmannSettings:
    """Guard the f32 inner-solve precision floor (docs/PRECISION.md).

    ``linear_solver="pcr_f32"`` computes Newton increments in f32: below
    tolerance ~1e-6 the increment noise can stall the residual or NaN a
    Monte-Carlo member (seen at tol=1e-8 on the stacked network engine).
    Auto-select the f64
    ``"pcr"`` solve for tighter tolerances instead of failing silently;
    the solver entry points call this before dispatch.
    """
    if settings.linear_solver == "pcr_f32" and settings.tolerance < 1e-6:
        import dataclasses as _dc
        import warnings

        warnings.warn(
            "tolerance < 1e-6 with linear_solver='pcr_f32' sits below the "
            "f32 inner-solve precision floor (docs/PRECISION.md): the "
            "residual can stall or a Monte-Carlo member can NaN. "
            "Auto-selecting the f64 'pcr' solve; set linear_solver='pcr' "
            "explicitly (or tolerance >= 1e-6) to silence this.",
            stacklevel=3)
        return _dc.replace(settings, linear_solver="pcr")
    return settings


@partial(jax.jit, static_argnames=("settings",))
def _simulate_jit(geo, us_bc, ds_bc, h0, Q0, settings: PreissmannSettings,
                  lateral_inflow=None) -> SimOutput:
    return _simulate_impl(geo, us_bc, ds_bc, h0, Q0, settings,
                          lateral_inflow)


def simulate(geo, us_bc, ds_bc, h0, Q0, settings: PreissmannSettings,
             lateral_inflow=None) -> SimOutput:
    """Full run: scan Newton-solved levels 1..nt-1 (ref :101-163 outer loop).

    ``lateral_inflow``: optional distributed source q [m^2/s] — per-node
    [N] (constant in time) or per-level-and-node [nt, N] (see
    :func:`cell_stencil`); a flowsim_tpu extension beyond the reference.
    """
    settings = guard_f32_floor(settings)
    if settings.newton == "implicit":
        # adjoint-differentiable path: while-Newton forward + IFT backward
        # (ops/adjoint.py) — usable under jax.grad unlike newton="while",
        # and O(1)-memory unlike newton="fixed"
        from flowsim_tpu.ops import adjoint

        return adjoint.simulate_implicit(geo, us_bc, ds_bc, h0, Q0,
                                         settings, lateral_inflow)
    return _simulate_jit(geo, us_bc, ds_bc, h0, Q0, settings, lateral_inflow)


def _simulate_impl(geo, us_bc, ds_bc, h0, Q0, settings: PreissmannSettings,
                   lateral_inflow=None) -> SimOutput:
    nt = settings.n_time_levels

    ds_bed = ds_bc.bed_level
    if lateral_inflow is not None:
        lateral_inflow = jnp.asarray(lateral_inflow, h0.dtype)
        if lateral_inflow.shape[-1] != h0.shape[0]:
            raise ValueError(
                f"lateral_inflow last dim {lateral_inflow.shape[-1]} != "
                f"n_nodes {h0.shape[0]}")
        if lateral_inflow.ndim == 1:
            lateral_inflow = jnp.broadcast_to(lateral_inflow,
                                              (nt,) + lateral_inflow.shape)
        elif lateral_inflow.ndim != 2 or lateral_inflow.shape[0] != nt:
            # a wrong time length would otherwise clamp-index (JAX
            # out-of-bounds gather) and silently reuse the last row
            raise ValueError(
                f"lateral_inflow must be [N] or [nt={nt}, N]; got "
                f"{lateral_inflow.shape}")

    def step(carry, k):
        h_prev, Q_prev, bc_state = carry
        # per-level gate-controller update (no-op unless gated_blend ds curve)
        bc_state = bnd.update_gate_level_start(ds_bc, bc_state, k.astype(h_prev.dtype) * settings.time_step)
        prev = prev_level_state(geo, h_prev, Q_prev)
        qlat_cur = None if lateral_inflow is None else lateral_inflow[k]
        qlat_prev = None if lateral_inflow is None else lateral_inflow[k - 1]
        h, Q, err, iters, res_stage, res_stage_us, rcond = newton_solve(
            geo, us_bc, ds_bc, settings, prev, h_prev, Q_prev, k,
            bc_state.reservoir_stage, bc_state,
            reservoir_stage_prev_us=bc_state.reservoir_stage_us,
            qlat_cur=qlat_cur, qlat_prev=qlat_prev,
        )
        bc_state = bc_state._replace(
            reservoir_stage=res_stage,
            gate_stage=ds_bed + h[-1],
            reservoir_stage_us=res_stage_us,
        )
        if settings.live_progress:
            jax.debug.callback(
                lambda k, it, e: print(
                    f"\n> Time level #{int(k)}\n>> {int(it)} iterations.\n"
                    f">> Error = {float(e)}", flush=True),
                k, iters, err, ordered=True)
        if settings.store == "boundaries":
            h_out, Q_out = h[jnp.array([0, -1])], Q[jnp.array([0, -1])]
        else:
            h_out, Q_out = h, Q
        out = (h_out, Q_out, iters, err, err < settings.tolerance, res_stage, bc_state.gate_open, rcond, res_stage_us)
        return (h, Q, bc_state), out

    ks = jnp.arange(1, nt)
    gate_open0 = 1.0 if settings.gate_initially_open else 0.0
    bc_state0 = bnd.initial_bc_state(h0.dtype, gate_open=gate_open0, gate_stage=ds_bed + h0[-1])
    (_, _, _), (hs, qs, iters, errs, conv, stages, gates, rconds, stages_us) = jax.lax.scan(
        step, (h0, Q0, bc_state0), ks
    )

    if settings.store == "boundaries":
        h0_out, Q0_out = h0[jnp.array([0, -1])], Q0[jnp.array([0, -1])]
    else:
        h0_out, Q0_out = h0, Q0
    depth = jnp.concatenate([h0_out[None], hs], axis=0)
    flow = jnp.concatenate([Q0_out[None], qs], axis=0)
    pad0 = lambda x, v: jnp.concatenate([jnp.asarray([v], dtype=x.dtype), x])
    return SimOutput(
        depth=depth,
        flow=flow,
        iterations=pad0(iters, 0),
        error=pad0(errs, 0.0),
        converged=pad0(conv, True),
        reservoir_stage=pad0(stages, jnp.nan),
        gate_open=pad0(gates, gate_open0),
        rcond=pad0(rconds, 1.0),
        reservoir_stage_us=pad0(stages_us, jnp.nan),
    )


def single_step(geo, us_bc, ds_bc, h, Q, k, reservoir_stage_prev, settings: PreissmannSettings, bc_state=None,
                qlat_cur=None, qlat_prev=None):
    """Advance one time level (benchmarks, __graft_entry__, checkpoint/resume).

    Performs the full per-level semantics of :func:`simulate`'s scan body —
    gate-controller update at level start, Newton solve, and the BCState
    carry update — so chunked runs (utils/checkpoint.py) match ``simulate``
    bitwise, including the gated_blend hysteresis state.

    Returns ``(h, Q, err, iters, bc_state)``.
    """
    if bc_state is None:
        gate_open0 = 1.0 if settings.gate_initially_open else 0.0
        bc_state = bnd.initial_bc_state(h.dtype, gate_open=gate_open0,
                                        gate_stage=ds_bc.bed_level + h[-1])
        rs = jnp.asarray(reservoir_stage_prev, h.dtype)
        # a legacy scalar prev-stage seeds BOTH carries (safe: at most one
        # boundary reads each, and single-storage runs stored the one stage
        # in the merged slot)
        bc_state = bc_state._replace(reservoir_stage=rs, reservoir_stage_us=rs)
    k = jnp.asarray(k)
    bc_state = bnd.update_gate_level_start(ds_bc, bc_state, k.astype(h.dtype) * settings.time_step)
    prev = prev_level_state(geo, h, Q)
    h2, Q2, err, iters, res_stage, res_stage_us, _ = newton_solve(
        geo, us_bc, ds_bc, settings, prev, h, Q, k, bc_state.reservoir_stage, bc_state,
        reservoir_stage_prev_us=bc_state.reservoir_stage_us,
        qlat_cur=qlat_cur, qlat_prev=qlat_prev,
    )
    bc_state = bc_state._replace(
        reservoir_stage=res_stage,
        gate_stage=ds_bc.bed_level + h2[-1],
        reservoir_stage_us=res_stage_us,
    )
    return h2, Q2, err, iters, bc_state
