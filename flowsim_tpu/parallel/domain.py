"""Channel-axis domain decomposition (the SP analog; SURVEY.md §2.17).

Long reaches are sharded over the ``space`` mesh axis with ``shard_map``:

* **Assembly** stays the same fused stencil per shard; the only communication
  is a 2-message halo per Newton iteration — (a) each shard sends its first
  node's closure state to the left neighbor (for the straddling cell), and
  (b) sends its last (straddling) cell's momentum-row entries to the right
  neighbor (whose first block row needs them).  Both are ``ppermute`` collectives.
* **Linear solve** uses SPIKE substructuring: each shard factors its local
  2x2-block tridiagonal system once per iteration (shared across 5 RHS:
  the residual plus two spike columns per side), eliminates its interior
  unknowns, ``all_gather``s a tiny 4x4-block tridiagonal *reduced* system
  of size n_shards, solves it redundantly on every shard, and
  back-substitutes locally.  This is algebraically the global solve, so
  results match the single-device path to roundoff.

The reference has no distributed anything (ref: SURVEY.md §2.17 —
single-threaded NumPy loops; `spsolve` per iteration).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from flowsim_tpu.config import GRAVITY as g
from flowsim_tpu.ops import boundary as bnd
from flowsim_tpu.ops import preissmann as prs
from flowsim_tpu.ops import sections as sec
from flowsim_tpu.ops import tridiag
from flowsim_tpu.parallel.mesh import SPACE_AXIS


def shard_map(f, mesh, in_specs, out_specs):
    return jax.shard_map(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                         check_vma=False)


def _pull_right_first(x, axis_name):
    """Each shard receives the FIRST element of its RIGHT neighbor."""
    S = lax.axis_size(axis_name)
    first = jax.tree_util.tree_map(lambda a: a[..., :1] if a.ndim else a, x)
    perm = [(i, (i - 1) % S) for i in range(S)]
    return jax.tree_util.tree_map(lambda a: lax.ppermute(a, axis_name, perm), first)


def _push_right_last(x, axis_name):
    """Each shard receives the LAST element of its LEFT neighbor."""
    S = lax.axis_size(axis_name)
    last = jax.tree_util.tree_map(lambda a: a[..., -1:] if a.ndim else a, x)
    perm = [(i, (i + 1) % S) for i in range(S)]
    return jax.tree_util.tree_map(lambda a: lax.ppermute(a, axis_name, perm), last)


# the interior theta-box stencil is shared with the single-device solver:
# ops.preissmann.cell_stencil is the single source of truth (numeric
# hardenings there apply to both paths); here it runs over halo-extended
# local arrays ([n_loc+1] nodes -> n_loc cells)
_cells = prs.cell_stencil


def _node_fields(geo, h, Q):
    st = sec.section_state(geo, h)
    es = sec.energy_slope(geo, h, Q, st)
    return prs.node_stencil_fields(geo, st, es, h, Q), st


def _extend(fields, axis_name):
    """Append the right neighbor's first node to every field."""
    halo = _pull_right_first(fields, axis_name)
    return {k: jnp.concatenate([v, halo[k]]) for k, v in fields.items()}


def _spike_solve(L, D, U, b, axis_name, method):
    """Distributed block-tridiagonal solve via SPIKE substructuring.

    L, D, U: [n_loc, 2, 2] with L[0] / U[-1] holding the couplings to the
    neighbor shards (zero on the global boundary shards).  Returns the local
    solution block [n_loc, 2].  ``method`` is the local solver
    (``settings.linear_solver``): the residual and the four spike columns
    are one 5-column solve, so PCR (the GPU default) keeps the local solve
    free of the n_loc-step sequential scan that Thomas would run.
    """
    S = lax.axis_size(axis_name)
    s_idx = lax.axis_index(axis_name)

    L_ext = L[0]
    U_ext = U[-1]
    L_int = L.at[0].set(0.0)
    U_int = U.at[-1].set(0.0)

    EV = jnp.zeros_like(L).at[0].set(L_ext)                        # [n, 2, 2]
    EW = jnp.zeros_like(U).at[-1].set(U_ext)
    X = tridiag.solve_block_tridiag(                               # [n, 2, 5]
        L_int, D, U_int, jnp.concatenate([b[..., None], EV, EW], axis=-1),
        method=method)
    G, V, W = X[..., 0], X[..., 1:3], X[..., 3:5]

    # reduced system over shard-boundary unknowns y_s = [x_first; x_last]
    pieces = jnp.concatenate(
        [V[0].reshape(-1), V[-1].reshape(-1), W[0].reshape(-1), W[-1].reshape(-1),
         G[0], G[-1]], axis=0,
    )  # [20]
    allp = lax.all_gather(pieces, axis_name)                        # [S, 20]
    V0 = allp[:, 0:4].reshape(S, 2, 2)
    Vl = allp[:, 4:8].reshape(S, 2, 2)
    W0 = allp[:, 8:12].reshape(S, 2, 2)
    Wl = allp[:, 12:16].reshape(S, 2, 2)
    G0 = allp[:, 16:18]
    Gl = allp[:, 18:20]

    Z = jnp.zeros((S, 2, 2), dtype=D.dtype)
    Lr = jnp.concatenate(
        [jnp.concatenate([Z, V0], axis=-1), jnp.concatenate([Z, Vl], axis=-1)], axis=-2
    )  # [S, 4, 4]: coupling of y_s to y_{s-1} (only its x_last half)
    Ur = jnp.concatenate(
        [jnp.concatenate([W0, Z], axis=-1), jnp.concatenate([Wl, Z], axis=-1)], axis=-2
    )
    Dr = jnp.broadcast_to(jnp.eye(4, dtype=D.dtype), (S, 4, 4))
    br = jnp.concatenate([G0, Gl], axis=-1)  # [S, 4]

    # tiny sequential 4x4 block Thomas, solved redundantly on every shard
    y = tridiag.dense_block_thomas(Lr, Dr, Ur, br)  # [S, 4]

    x_prev_last = jnp.where(s_idx > 0, 1.0, 0.0) * y[jnp.maximum(s_idx - 1, 0), 2:4]
    x_next_first = jnp.where(s_idx < S - 1, 1.0, 0.0) * y[jnp.minimum(s_idx + 1, S - 1), 0:2]

    return G - tridiag._mv(V, x_prev_last) - tridiag._mv(W, x_next_first)


class _RowEval(NamedTuple):
    """End-row override carrier (same fields bnd.evaluate returns)."""

    residual: jnp.ndarray
    df_dh: jnp.ndarray
    df_dQ: jnp.ndarray
    reservoir_stage: jnp.ndarray


def _assemble_local(geo, us_bc, ds_bc, settings, prev_fields, h, Q, k,
                    reservoir_stage_prev, axis_name, bc_state=None,
                    reservoir_stage_prev_us=None, us_row=None, ds_row=None,
                    dx=None):
    """Local rows of the global block-tridiagonal system + residual norm.

    Returns ``(L, D, U, b, err, res_stage, res_stage_us)`` — the merged
    (ds-preferred) storage stage plus the upstream boundary's own stage so
    both-ends storage runs carry independent histories (mirrors
    ops.preissmann.assemble).

    ``us_row``/``ds_row``: optional ``(residual, df_dh, df_dQ)`` end-row
    overrides (junction equal-stage rows of a sharded NETWORK branch,
    parallel/network_domain.py) — when given, the corresponding
    ``bnd.evaluate`` is skipped."""
    theta, dt = settings.theta, settings.time_step
    dx = settings.spatial_step if dx is None else dx
    S = lax.axis_size(axis_name)
    s_idx = lax.axis_index(axis_name)
    first_shard = s_idx == 0
    last_shard = s_idx == S - 1
    n = h.shape[0]
    dtype = h.dtype

    cur, st = _node_fields(geo, h, Q)
    cur_ext = _extend(cur, axis_name)
    cells = _cells(theta, dt, dx, cur_ext, prev_fields)

    # halo (b): straddling-cell outputs from the left neighbor
    from_left = _push_right_last(cells, axis_name)
    fl = jax.tree_util.tree_map(lambda a: a[0], from_left)

    # boundary rows (evaluated on the owning shard, masked elsewhere)
    def node_sec(i):
        return bnd.NodeSection(A=st.A[i], R=st.R[i], K=st.K[i], n_eq=st.n_eq[i],
                               dA_dh=st.dA_dh[i], dR_dA=st.dR_dA[i], dK_dA=st.dK_dA[i])

    if reservoir_stage_prev_us is None:
        reservoir_stage_prev_us = reservoir_stage_prev
    if us_row is None:
        us = bnd.evaluate(us_bc, node_sec(0), h[0], Q[0], k, dt,
                          Q_prev=prev_fields["Q"][0],
                          reservoir_stage_prev=reservoir_stage_prev_us,
                          bc_state=bc_state, upstream=True,
                          h_prev=prev_fields["h"][0])
    else:
        us = _RowEval(*[jnp.asarray(v, dtype) for v in us_row],
                      jnp.asarray(jnp.nan, dtype))
    if ds_row is None:
        ds = bnd.evaluate(ds_bc, node_sec(-1), h[-1], Q[-1], k, dt,
                          Q_prev=prev_fields["Q"][n - 1],
                          reservoir_stage_prev=reservoir_stage_prev,
                          bc_state=bc_state)
    else:
        ds = _RowEval(*[jnp.asarray(v, dtype) for v in ds_row],
                      jnp.asarray(jnp.nan, dtype))
    # broadcast the owning shard's reservoir stage to all shards (NaN-safe).
    # Downstream (last shard) wins; otherwise fall back to an upstream
    # storage's stage (first shard) — same precedence as the single-device
    # assemble (ops/preissmann.py reservoir_stage = where(isnan(ds), us, ds)).
    fin_ds = last_shard & jnp.isfinite(ds.reservoir_stage)
    fin_us = first_shard & jnp.isfinite(us.reservoir_stage)
    packed = lax.psum(
        jnp.stack([fin_ds.astype(dtype),
                   jnp.where(fin_ds, ds.reservoir_stage, 0.0),
                   fin_us.astype(dtype),
                   jnp.where(fin_us, us.reservoir_stage, 0.0)]), axis_name)
    res_stage = jnp.where(packed[0] > 0, packed[1],
                          jnp.where(packed[2] > 0, packed[3], jnp.nan))
    res_stage_us = jnp.where(packed[2] > 0, packed[3], jnp.nan)

    th_dx = theta / dx

    # momentum-row entries per block row i come from cell i-1: locally that is
    # cells[:-1] shifted, with row 0 taken from the left-neighbor halo.
    mh_i = jnp.concatenate([fl.dM_dh_i[None], cells.dM_dh_i[:-1]])
    mq_i = jnp.concatenate([fl.dM_dQ_i[None], cells.dM_dQ_i[:-1]])
    mh_i1 = jnp.concatenate([fl.dM_dh_i1[None], cells.dM_dh_i1[:-1]])
    mq_i1 = jnp.concatenate([fl.dM_dQ_i1[None], cells.dM_dQ_i1[:-1]])
    rm = jnp.concatenate([fl.Rm[None], cells.Rm[:-1]])

    # first shard: block row 0 is the upstream BC row
    row0_h = jnp.where(first_shard & (jnp.arange(n) == 0), us.df_dh, mh_i1)
    row0_q = jnp.where(first_shard & (jnp.arange(n) == 0), us.df_dQ, mq_i1)
    row0_b = jnp.where(first_shard & (jnp.arange(n) == 0), us.residual, rm)
    L_row0_h = jnp.where(first_shard & (jnp.arange(n) == 0), 0.0, mh_i)
    L_row0_q = jnp.where(first_shard & (jnp.arange(n) == 0), 0.0, mq_i)

    # last shard: block row n-1's continuity row is the downstream BC row
    is_last_node = last_shard & (jnp.arange(n) == n - 1)
    row1_h = jnp.where(is_last_node, ds.df_dh, jnp.concatenate([cells.dC_dh_i[:-1], cells.dC_dh_i[-1:]]))
    row1_q = jnp.where(is_last_node, ds.df_dQ, jnp.full((n,), -th_dx, dtype))
    row1_b = jnp.where(is_last_node, ds.residual, cells.Rc)
    U_row1_h = jnp.where(is_last_node, 0.0, cells.dC_dh_i1)
    U_row1_q = jnp.where(is_last_node, 0.0, th_dx)

    L = jnp.stack([jnp.stack([L_row0_h, L_row0_q], axis=-1), jnp.zeros((n, 2), dtype)], axis=-2)
    D = jnp.stack([jnp.stack([row0_h, row0_q], axis=-1),
                   jnp.stack([row1_h, row1_q], axis=-1)], axis=-2)
    U = jnp.stack([jnp.zeros((n, 2), dtype),
                   jnp.stack([U_row1_h, jnp.broadcast_to(U_row1_q, (n,))], axis=-1)], axis=-2)
    b = -jnp.stack([row0_b, row1_b], axis=-1)

    err = jnp.sqrt(lax.psum(jnp.sum(b * b), axis_name))
    return L, D, U, b, err, res_stage, res_stage_us


def _bcast_last_node(x_last, axis_name, dtype):
    """Broadcast the last shard's boundary-node scalar to every shard."""
    last = lax.axis_index(axis_name) == lax.axis_size(axis_name) - 1
    return lax.psum(jnp.where(last, x_last, jnp.zeros_like(x_last)), axis_name)


def _bcast_bnd_pair(x, axis_name):
    """[..., n_local] node field -> [..., 2] global (first, last) boundary
    values, replicated on every shard (settings.store="boundaries": the
    scan then stacks O(nt*2) instead of O(nt*N) — same output contract as
    ops.preissmann.simulate's boundaries mode)."""
    first = lax.axis_index(axis_name) == 0
    last = lax.axis_index(axis_name) == lax.axis_size(axis_name) - 1
    v0 = lax.psum(jnp.where(first, x[..., 0], jnp.zeros_like(x[..., 0])), axis_name)
    v1 = lax.psum(jnp.where(last, x[..., -1], jnp.zeros_like(x[..., -1])), axis_name)
    return jnp.stack([v0, v1], axis=-1)


def _local_time_scan(geo_loc, h0_loc, Q0_loc, us, ds, bc_state0, settings,
                     k0: int = 0):
    """Per-shard scan over time levels (runs inside shard_map; uses SPACE
    collectives for halos, the SPIKE solve, and the global residual norm).

    The cross-level BCState (reservoir stage + gated-curve controller) is
    carried replicated on every shard: the gate update is a per-level scalar
    computed identically everywhere, and the downstream stage it watches is
    the last shard's boundary node, broadcast with a psum.

    ``bc_state0`` is the carried state at level ``k0`` (a resumed chunk
    passes the checkpointed state and its absolute level index so the gate
    controller's absolute times and the hydrograph targets line up);
    returns the final (h, Q, BCState) alongside the stacked outputs so
    chunked runs continue bitwise.
    """
    axis = SPACE_AXIS
    nt = settings.n_time_levels
    tol = settings.tolerance
    dtype = h0_loc.dtype

    def prev_fields_of(h, Q):
        f, _ = _node_fields(geo_loc, h, Q)
        return _extend(f, axis)

    def newton(h, Q, k, bc_state, prev_ext):
        def one(h, Q):
            L, D, U, b, err, res_stage, res_us = _assemble_local(
                geo_loc, us, ds, settings, prev_ext, h, Q, k,
                bc_state.reservoir_stage, axis, bc_state=bc_state,
                reservoir_stage_prev_us=bc_state.reservoir_stage_us,
            )
            delta = _spike_solve(L, D, U, b, axis, settings.linear_solver)
            return h + delta[:, 0], Q + delta[:, 1], err, res_stage, res_us

        def cond(c):
            return (c[2] >= tol) & (c[3] < settings.max_iter)

        def body(c):
            h, Q, _, it, _, _ = c
            h2, Q2, err, rs, rs_us = one(h, Q)
            return (h2, Q2, err, it + 1, rs, rs_us)

        nan = jnp.asarray(jnp.nan, h.dtype)
        h, Q, err, iters, rs, rs_us = lax.while_loop(
            cond, body,
            (h, Q, jnp.asarray(jnp.inf, h.dtype), jnp.asarray(0), nan, nan),
        )
        return h, Q, err, iters, rs, rs_us

    store_bnd = getattr(settings, "store", "full") == "boundaries"

    def step(carry, k):
        h, Q, bc_state = carry
        bc_state = bnd.update_gate_level_start(ds, bc_state, k.astype(dtype) * settings.time_step)
        prev_ext = prev_fields_of(h, Q)
        h2, Q2, err, iters, rs, rs_us = newton(h, Q, k, bc_state, prev_ext)
        bc_state = bc_state._replace(
            reservoir_stage=rs,
            gate_stage=ds.bed_level + _bcast_last_node(h2[-1], axis, dtype),
            reservoir_stage_us=rs_us,
        )
        out_h = _bcast_bnd_pair(h2, axis) if store_bnd else h2
        out_q = _bcast_bnd_pair(Q2, axis) if store_bnd else Q2
        return (h2, Q2, bc_state), (out_h, out_q, iters, err, err < tol, rs, bc_state.gate_open, rs_us)

    ks = k0 + jnp.arange(1, nt)
    (h_fin, Q_fin, bc_fin), (hs, qs, iters, errs, conv, stages, gates, stages_us) = lax.scan(
        step, (h0_loc, Q0_loc, bc_state0), ks
    )
    return hs, qs, iters, errs, conv, stages, gates, stages_us, h_fin, Q_fin, bc_fin


def simulate_sharded(geo, us_bc, ds_bc, h0, Q0, settings: prs.PreissmannSettings, mesh: Mesh,
                     bc_state0=None, k0: int = 0, return_final_state: bool = False):
    """Full Preissmann run with the node axis sharded over ``mesh['space']``.

    Requires n_nodes % n_space_shards == 0.  Matches the single-device
    ``ops.preissmann.simulate`` to roundoff.

    Chunked / resumed runs: pass the checkpointed ``bc_state0``
    (:class:`~flowsim_tpu.ops.boundary.BCState`) and the ABSOLUTE level
    index ``k0`` the initial (h0, Q0) belong to — hydrograph targets and
    the gate controller's absolute times then line up, so stitching chunks
    reproduces a single-shot run bitwise (see
    utils.checkpoint.simulate_sharded_with_checkpoints).
    ``return_final_state=True`` additionally returns ``(h, Q, BCState)`` at
    the last level (the restart state; with ``store="boundaries"`` the
    stacked outputs alone wouldn't contain it).
    """
    n_shards = mesh.shape[SPACE_AXIS]
    N = geo.n_nodes
    if N % n_shards != 0:
        raise ValueError(f"n_nodes={N} not divisible by space shards {n_shards}")

    if bc_state0 is None:
        # numpy leaves, NOT eager jnp: a committed single-device BCState
        # would pin the jitted run to device 0 and clash with the mesh
        gate_open0 = 1.0 if settings.gate_initially_open else 0.0
        dt0 = np.asarray(h0).dtype
        bc_state0 = bnd.BCState(
            reservoir_stage=np.asarray(np.nan, dt0),
            gate_open=np.asarray(gate_open0, dt0),
            gate_cooldown=np.asarray(0.0, dt0),
            gate_prev_time=np.asarray(-1.0, dt0),
            gate_stage=np.asarray(np.asarray(ds_bc.bed_level)
                                  + np.asarray(h0)[-1], dt0),
            reservoir_stage_us=np.asarray(np.nan, dt0),
        )

    out, final = _run_sharded(geo, h0, Q0, us_bc, ds_bc, bc_state0,
                              settings=settings, mesh=mesh, k0=int(k0))
    return (out, final) if return_final_state else out


# one cached executable per (settings, mesh, k0) and input structure: a
# jit built inside simulate_sharded would recompile on every call
@partial(jax.jit, static_argnames=("settings", "mesh", "k0"))
def _run_sharded(geo, h0, Q0, us_bc, ds_bc, bc0, *, settings, mesh, k0):
    def shard_fn(geo_loc, h0_loc, Q0_loc, us, ds, bc0_):
        return _local_time_scan(geo_loc, h0_loc, Q0_loc, us, ds, bc0_,
                                settings, k0=k0)

    store_bnd = getattr(settings, "store", "full") == "boundaries"
    field_spec = P(None, None) if store_bnd else P(None, SPACE_AXIS)
    geo_specs = jax.tree_util.tree_map(lambda _: P(SPACE_AXIS), geo)
    bc_spec_us = jax.tree_util.tree_map(lambda _: P(), us_bc)
    bc_spec_ds = jax.tree_util.tree_map(lambda _: P(), ds_bc)
    bc_state_spec = jax.tree_util.tree_map(lambda _: P(), bc0)
    f = shard_map(
        shard_fn, mesh,
        in_specs=(geo_specs, P(SPACE_AXIS), P(SPACE_AXIS), bc_spec_us,
                  bc_spec_ds, bc_state_spec),
        out_specs=(field_spec, field_spec, P(None), P(None), P(None),
                   P(None), P(None), P(None), P(SPACE_AXIS), P(SPACE_AXIS),
                   bc_state_spec),
    )
    # post-processing stays inside jit: on a multi-host mesh the outputs are
    # not fully addressable per process, so eager concatenation would fail
    (hs, qs, iters, errs, conv, stages, gates, stages_us,
     h_fin, Q_fin, bc_fin) = f(geo, h0, Q0, us_bc, ds_bc, bc0)
    h0_out = h0[jnp.array([0, -1])] if store_bnd else h0
    Q0_out = Q0[jnp.array([0, -1])] if store_bnd else Q0
    depth = jnp.concatenate([h0_out[None], hs], axis=0)
    flow = jnp.concatenate([Q0_out[None], qs], axis=0)
    pad0 = lambda x, v: jnp.concatenate(
        [jnp.reshape(jnp.asarray(v, dtype=x.dtype), (1,)), x])
    out = prs.SimOutput(
        depth=depth, flow=flow,
        iterations=pad0(iters, 0), error=pad0(errs, 0.0),
        converged=pad0(conv, True), reservoir_stage=pad0(stages, jnp.nan),
        gate_open=pad0(gates, bc0.gate_open),
        reservoir_stage_us=pad0(stages_us, jnp.nan),
    )
    return out, (h_fin, Q_fin, bc_fin)


def simulate_sharded_ensemble(geo_batch, us_bc, ds_bc, h0, Q0,
                              settings: prs.PreissmannSettings, mesh: Mesh,
                              us_axes=None, ds_axes=None):
    """Ensemble x space: scenario batch sharded over the ``ensemble`` axis,
    each member domain-decomposed over the ``space`` axis (the full 2-D mesh
    use of SURVEY.md §2.17 — DP and SP analogs composed).

    ``geo_batch`` leaves and ``h0``/``Q0`` carry a leading batch dimension.
    Boundary params are shared across members by default; per-member forcing
    (inflow hydrographs, rating coefficients, storage params) is enabled by
    passing the stacked params + axes from
    :func:`flowsim_tpu.parallel.ensemble.batch_boundaries` as
    ``us_bc``/``us_axes`` (likewise downstream).  Requires batch % ensemble
    shards == 0 and n_nodes % space shards == 0.
    """
    from flowsim_tpu.parallel.mesh import ENSEMBLE_AXIS

    E = mesh.shape[ENSEMBLE_AXIS]
    S = mesh.shape[SPACE_AXIS]
    B, N = h0.shape
    if B % E != 0:
        raise ValueError(f"batch={B} not divisible by ensemble shards {E}")
    if N % S != 0:
        raise ValueError(f"n_nodes={N} not divisible by space shards {S}")

    from flowsim_tpu.parallel.mesh import ENSEMBLE_AXIS as EAX

    def shard_fn(geo_loc, h0_loc, Q0_loc, us, ds):
        return _local_time_scan_batched(geo_loc, h0_loc, Q0_loc, us, ds, settings,
                                        us_axes=us_axes, ds_axes=ds_axes)

    def geo_spec(leaf):
        extra = (None,) * (leaf.ndim - 2)  # e.g. TableGeometry [B, N, M]
        return P(EAX, SPACE_AXIS, *extra)

    geo_specs = jax.tree_util.tree_map(geo_spec, geo_batch)
    bc_u = jax.tree_util.tree_map(lambda _: P() if us_axes is None else P(EAX), us_bc)
    bc_d = jax.tree_util.tree_map(lambda _: P() if ds_axes is None else P(EAX), ds_bc)
    store_bnd = getattr(settings, "store", "full") == "boundaries"
    field_spec = (P(EAX, None, None) if store_bnd
                  else P(EAX, None, SPACE_AXIS))
    f = shard_map(
        shard_fn, mesh,
        in_specs=(geo_specs, P(EAX, SPACE_AXIS), P(EAX, SPACE_AXIS), bc_u, bc_d),
        out_specs=(field_spec, field_spec,
                   P(EAX, None), P(EAX, None), P(EAX, None), P(EAX, None),
                   P(EAX, None)),
    )
    gate_open0 = 1.0 if settings.gate_initially_open else 0.0

    @jax.jit
    def run(geo_batch, h0, Q0, us_bc, ds_bc):
        hs, qs, iters, errs, conv, stages, gates = f(geo_batch, h0, Q0,
                                                     us_bc, ds_bc)
        h0_out = h0[:, jnp.array([0, -1])] if store_bnd else h0
        Q0_out = Q0[:, jnp.array([0, -1])] if store_bnd else Q0
        depth = jnp.concatenate([h0_out[:, None, :], hs], axis=1)
        flow = jnp.concatenate([Q0_out[:, None, :], qs], axis=1)

        def pad0(x, v):
            lead = jnp.full((B, 1), v, dtype=x.dtype)
            return jnp.concatenate([lead, x], axis=1)

        return prs.SimOutput(
            depth=depth, flow=flow,
            iterations=pad0(iters, 0), error=pad0(errs, 0.0),
            converged=pad0(conv, True), reservoir_stage=pad0(stages, jnp.nan),
            gate_open=pad0(gates, gate_open0),
        )

    return run(geo_batch, h0, Q0, us_bc, ds_bc)


def _local_time_scan_batched(geo_loc, h0_loc, Q0_loc, us, ds, settings,
                             us_axes=None, ds_axes=None):
    """Batched variant of :func:`_local_time_scan` for the ensemble x space
    mesh.  ``us_axes``/``ds_axes`` are vmap axis pytrees (from
    ``ensemble.batch_boundaries``) when the boundary params carry a leading
    member axis; None when shared.

    Every device of the mesh must execute the same number of collectives, but
    Newton iteration counts differ between ensemble members; a per-row
    while_loop would deadlock the space-axis ppermute/all_gather rendezvous.
    The loop condition is therefore synchronized across the WHOLE mesh
    (pmax over the ensemble axis of "any member still active") and converged
    members mask their updates — numerically identical to per-member
    convergence, with trip count = the slowest member's.
    """
    from flowsim_tpu.parallel.mesh import ENSEMBLE_AXIS

    axis = SPACE_AXIS
    nt = settings.n_time_levels
    tol = settings.tolerance
    Bloc = h0_loc.shape[0]

    dtype = h0_loc.dtype

    def prev_ext_of(h, Q):
        def one(g, hh, qq):
            f, _ = _node_fields(g, hh, qq)
            return _extend(f, axis)

        return jax.vmap(one)(geo_loc, h, Q)

    def one_iter(g, prev_ext, h, Q, k, bc_member, us_m, ds_m):
        L, D, U, b, err, rs, rs_us = _assemble_local(
            g, us_m, ds_m, settings, prev_ext, h, Q, k,
            bc_member.reservoir_stage, axis, bc_state=bc_member,
            reservoir_stage_prev_us=bc_member.reservoir_stage_us,
        )
        delta = _spike_solve(L, D, U, b, axis, settings.linear_solver)
        return h + delta[:, 0], Q + delta[:, 1], err, rs, rs_us

    def newton(h, Q, k, bc, prev_ext):
        def cond(c):
            err, it = c[2], c[3]
            any_active = jnp.any(err >= tol) | (it == 0)
            return lax.pmax(any_active, ENSEMBLE_AXIS) & (it < settings.max_iter)

        def body(c):
            h, Q, err, it, rs, rs_us = c
            active = (err >= tol) | (it == 0)
            h2, Q2, err2, rs2, rs2_us = jax.vmap(
                one_iter, in_axes=(0, 0, 0, 0, None, 0, us_axes, ds_axes)
            )(geo_loc, prev_ext, h, Q, k, bc, us, ds)
            h = jnp.where(active[:, None], h2, h)
            Q = jnp.where(active[:, None], Q2, Q)
            err = jnp.where(active, err2, err)
            rs = jnp.where(active, rs2, rs)
            rs_us = jnp.where(active, rs2_us, rs_us)
            return (h, Q, err, it + 1, rs, rs_us)

        err0 = jnp.full((Bloc,), jnp.inf, h.dtype)
        nanB = jnp.full((Bloc,), jnp.nan, h.dtype)
        h, Q, err, iters, rs, rs_us = lax.while_loop(
            cond, body, (h, Q, err0, jnp.asarray(0), nanB, nanB)
        )
        return h, Q, err, iters, rs, rs_us

    store_bnd = getattr(settings, "store", "full") == "boundaries"

    def step(carry, k):
        h, Q, bc = carry
        time = k.astype(dtype) * settings.time_step
        bc = jax.vmap(
            lambda s, d: bnd.update_gate_level_start(d, s, time),
            in_axes=(0, ds_axes),
        )(bc, ds)
        prev_ext = prev_ext_of(h, Q)
        h2, Q2, err, iters, rs, rs_us = newton(h, Q, k, bc, prev_ext)
        bc = bc._replace(
            reservoir_stage=rs,
            gate_stage=ds.bed_level + _bcast_last_node(h2[:, -1], axis, dtype),
            reservoir_stage_us=rs_us,
        )
        out_h = _bcast_bnd_pair(h2, axis) if store_bnd else h2
        out_q = _bcast_bnd_pair(Q2, axis) if store_bnd else Q2
        return (h2, Q2, bc), (out_h, out_q, jnp.broadcast_to(iters, (Bloc,)),
                              err, err < tol, rs,
                              jnp.broadcast_to(bc.gate_open, (Bloc,)))

    ks = jnp.arange(1, nt)
    gate_open0 = 1.0 if settings.gate_initially_open else 0.0
    bc0 = jax.vmap(
        lambda gs: bnd.initial_bc_state(dtype, gate_open=gate_open0, gate_stage=gs)
    )(ds.bed_level + _bcast_last_node(h0_loc[:, -1], axis, dtype))
    _, (hs, qs, iters, errs, conv, stages, gates) = lax.scan(
        step, (h0_loc, Q0_loc, bc0), ks
    )
    # reorder to [Bloc, nt-1, ...]
    return (jnp.moveaxis(hs, 1, 0), jnp.moveaxis(qs, 1, 0), jnp.moveaxis(iters, 1, 0),
            jnp.moveaxis(errs, 1, 0), jnp.moveaxis(conv, 1, 0),
            jnp.moveaxis(stages, 1, 0), jnp.moveaxis(gates, 1, 0))
