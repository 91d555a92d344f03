"""Space-sharded river networks: domain-decompose the LONG branches.

The SP analog for networks (SURVEY.md §2.17): a basin whose long branches
cannot use the single-reach channel decomposition (parallel/domain.py)
because their ends couple to junctions.  Here a SET of designated branches
(default: the longest; pass ``sharded_branches`` for several) is sharded
over the ``space`` mesh axis with the same halo-exchange assembly and
SPIKE substructured solve, while the remaining (short) branches are solved
REDUNDANTLY on every shard — they are replicated data, so the only extra
cost is the duplicated flops of the small systems, and the only
communication beyond the single-reach machinery is two psum broadcasts per
sharded branch per Newton iteration (its end discharges and its
Schur-column end values).

Junction coupling of a sharded branch: its end rows become equal-stage
junction rows (``_assemble_local``'s ``us_row``/``ds_row`` overrides) and
its Schur columns V = T^{-1} C are obtained with one extra SPIKE solve
per coupling — algebraically identical to the loop engine's multi-RHS
solve (ops/network.py:_simulate_network_impl), so the sharded network
matches the single-device solve to solver roundoff.

Round 5 lifted the single-designated-branch limit: every branch in
``sharded_branches`` is decomposed over the SAME space axis (its node
count must divide the shard count), so a basin with several long stems
splits its dominant work across chips instead of replicating it.

Scope: TrapezoidGeometry branches, plain junctions and junction
reservoirs with rated outflow (the [J]-scalar junction physics is
replicated), the full external-boundary surface of ops/boundary.py, and
``newton="while"``.  Lateral inflow is not supported on SHARDED branches
(short branches may carry constant [N] qlat).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from flowsim_tpu.ops import boundary as bnd
from flowsim_tpu.ops import preissmann as prs
from flowsim_tpu.ops import rating_curve as rcurve
from flowsim_tpu.ops.network import (NetworkOutput,
                                     _assemble_branch, _check_supported,
                                     _end_row_junction, _is_junction,
                                     _junction_outflow, _junction_residuals,
                                     _solve_junction_system,
                                     default_initial_stages)
from flowsim_tpu.ops.tridiag import solve_block_tridiag
from flowsim_tpu.parallel.domain import (_assemble_local, _extend,
                                         _spike_solve, shard_map)
from flowsim_tpu.parallel.mesh import SPACE_AXIS


def _bcast_from(pred, value, axis):
    """psum-broadcast ``value`` from the shard where ``pred`` holds."""
    return lax.psum(jnp.where(pred, value, jnp.zeros_like(value)), axis)


def simulate_network_sharded(branches, n_junctions, settings, mesh: Mesh,
                             long_branch: int = None, Y0=None,
                             junction_area=None, junction_rating=None,
                             sharded_branches=None):
    """Network solve with selected branches sharded over the space axis.

    Same output contract as :func:`flowsim_tpu.ops.network.simulate_network`
    (while-Newton, pre-update-residual convergence).  ``sharded_branches``:
    branch indices to domain-decompose (default: the single longest, or
    ``[long_branch]`` for backward compatibility); each must have a node
    count divisible by the mesh's space size.
    """
    _check_supported(branches, n_junctions, settings)
    settings = prs.guard_f32_floor(settings)
    if settings.newton != "while":
        raise ValueError("simulate_network_sharded implements while-Newton")
    J = n_junctions
    B = len(branches)
    n_bs = [int(np.asarray(br.h0).shape[0]) for br in branches]
    if sharded_branches is None:
        sharded_branches = [int(long_branch) if long_branch is not None
                            else int(np.argmax(n_bs))]
    sls = [int(b) for b in dict.fromkeys(sharded_branches)]
    S = mesh.shape[SPACE_AXIS]
    for l in sls:
        if n_bs[l] % S != 0:
            raise ValueError(
                f"sharded branch {l} has {n_bs[l]} nodes, not divisible by "
                f"{S} space shards")
        if branches[l].qlat is not None:
            raise ValueError("lateral inflow on a sharded branch is not "
                             "supported")
    dtype = jnp.asarray(branches[0].h0).dtype
    nt = settings.n_time_levels
    dt = settings.time_step
    tol = settings.tolerance

    area = (jnp.zeros((J,), dtype) if junction_area is None
            else jnp.asarray(junction_area, dtype))
    rating = None if junction_rating is None else tuple(junction_rating)
    if Y0 is None:
        Y0 = default_initial_stages(branches, J, dtype)
    Y0 = jnp.asarray(Y0, dtype)

    shorts = [b for b in range(B) if b not in sls]
    # per-sharded-branch junction bookkeeping
    sb_meta = {}
    for l in sls:
        br = branches[l]
        sb_meta[l] = dict(
            jus=int(br.us) if _is_junction(br.us) else None,
            jds=int(br.ds) if _is_junction(br.ds) else None,
            z_us=float(np.asarray(br.geo.z_bed)[0]),
            z_ds=float(np.asarray(br.geo.z_bed)[-1]))
        c = []
        if sb_meta[l]["jus"] is not None:
            c.append((sb_meta[l]["jus"], "us"))
        if sb_meta[l]["jds"] is not None:
            c.append((sb_meta[l]["jds"], "ds"))
        sb_meta[l]["coups"] = c

    def ends_of(br):
        out = []
        if _is_junction(br.ds):
            out.append((int(br.ds), -1, 1.0))
        if _is_junction(br.us):
            out.append((int(br.us), 0, -1.0))
        return out

    short_coups = {}
    for b in shorts:
        c = []
        if _is_junction(branches[b].us):
            c.append((int(branches[b].us), 0, 0))
        if _is_junction(branches[b].ds):
            c.append((int(branches[b].ds), -1, 1))
        short_coups[b] = c

    gate_open0 = 1.0 if settings.gate_initially_open else 0.0

    def init_est(end, b, idx):
        if _is_junction(end):
            return bnd.initial_bc_state(dtype)
        return bnd.initial_bc_state(
            dtype, gate_open=gate_open0,
            gate_stage=end.bed_level + jnp.asarray(branches[b].h0, dtype)[idx])

    end_states0 = tuple(
        (init_est(br.us, b, 0), init_est(br.ds, b, n_bs[b] - 1))
        for b, br in enumerate(branches))

    # sharded branches' dynamic data (sharded over space); shorts replicated
    geo_ls = tuple(branches[l].geo for l in sls)
    h0_ls = tuple(jnp.asarray(branches[l].h0, dtype) for l in sls)
    Q0_ls = tuple(jnp.asarray(branches[l].Q0, dtype) for l in sls)
    dyn_shorts = tuple(
        dict(geo=branches[b].geo, h0=jnp.asarray(branches[b].h0, dtype),
             Q0=jnp.asarray(branches[b].Q0, dtype)) for b in shorts)

    def shard_fn(geo_locs, h0_locs, Q0_locs, dyn_s, Y0_, ests0):
        axis = SPACE_AXIS
        s_idx = lax.axis_index(axis)
        first = s_idx == 0
        last = s_idx == S - 1

        def end_vals(h_loc, Q_loc):
            """One sharded branch's global end (h, Q), via psum."""
            h_us = _bcast_from(first, h_loc[0], axis)
            Q_us = _bcast_from(first, Q_loc[0], axis)
            h_ds = _bcast_from(last, h_loc[-1], axis)
            Q_ds = _bcast_from(last, Q_loc[-1], axis)
            return h_us, Q_us, h_ds, Q_ds

        def sum_signed_ends(Qs_short, ends_l):
            """ends_l: per sharded branch (Q_us, Q_ds) global end flows."""
            Ssum = jnp.zeros((J,), dtype)
            for bi, b in enumerate(shorts):
                for (jj, idx, sgn) in ends_of(branches[b]):
                    Ssum = Ssum.at[jj].add(sgn * Qs_short[bi][idx])
            for li, l in enumerate(sls):
                if sb_meta[l]["jds"] is not None:
                    Ssum = Ssum.at[sb_meta[l]["jds"]].add(ends_l[li][1])
                if sb_meta[l]["jus"] is not None:
                    Ssum = Ssum.at[sb_meta[l]["jus"]].add(-ends_l[li][0])
            return Ssum

        def newton_level(h_locs, Q_locs, hs, Qs, Y, prev_exts, prevs_s, k,
                         ests):
            Y_prev = Y
            ends_prev = []
            for li in range(len(sls)):
                _, Qp_us, _, Qp_ds = end_vals(
                    prev_exts[li]["h"][:-1], prev_exts[li]["Q"][:-1])
                ends_prev.append((Qp_us, Qp_ds))
            Sp = sum_signed_ends([p.Q for p in prevs_s], ends_prev)
            q_out_prev, _ = _junction_outflow(rating, Y_prev, dtype)
            prev_terms = (Y_prev, Sp, q_out_prev)

            def one(h_locs, Q_locs, hs, Qs, Y):
                err2 = jnp.zeros((), dtype)
                stages_rows = [None] * B
                # --- sharded branches: junction-aware end-row overrides ---
                us_l, Vs_l, ends_now = [], [], []
                for li, l in enumerate(sls):
                    meta = sb_meta[l]
                    lbd = branches[l]
                    h_loc, Q_loc = h_locs[li], Q_locs[li]
                    h_us, Q_us, h_ds, Q_ds = end_vals(h_loc, Q_loc)
                    ends_now.append((Q_us, Q_ds))
                    us_row = (None if meta["jus"] is None else
                              _end_row_junction(
                                  h_us, jnp.asarray(meta["z_us"], dtype),
                                  Y[meta["jus"]]))
                    ds_row = (None if meta["jds"] is None else
                              _end_row_junction(
                                  h_ds, jnp.asarray(meta["z_ds"], dtype),
                                  Y[meta["jds"]]))
                    est_l = ests[l]
                    L, D, Umat, b_loc, _, rs_l, rs_l_us = _assemble_local(
                        geo_locs[li],
                        None if meta["jus"] is not None else lbd.us,
                        None if meta["jds"] is not None else lbd.ds,
                        settings, prev_exts[li], h_loc, Q_loc, k,
                        est_l[1].reservoir_stage, axis, bc_state=est_l[1],
                        reservoir_stage_prev_us=est_l[0].reservoir_stage,
                        us_row=us_row, ds_row=ds_row, dx=lbd.dx)
                    u = _spike_solve(L, D, Umat, b_loc, axis,
                                     settings.linear_solver)
                    Vs = []
                    for (jj, side) in meta["coups"]:
                        n_loc = h_loc.shape[0]
                        cvec = jnp.zeros_like(b_loc)
                        if side == "us":
                            cvec = cvec.at[0, 0].set(
                                jnp.where(first, -1.0, 0.0).astype(dtype))
                        else:
                            cvec = cvec.at[n_loc - 1, 1].set(
                                jnp.where(last, -1.0, 0.0).astype(dtype))
                        Vs.append(_spike_solve(L, D, Umat, cvec, axis,
                                               settings.linear_solver))
                    us_l.append(u)
                    Vs_l.append(Vs)
                    stages_rows[l] = jnp.stack([rs_l_us, rs_l])
                    err2 = err2 + lax.psum(jnp.sum(b_loc * b_loc), axis)

                # --- short branches, replicated ---------------------------
                us_s, Vs_s = [], []
                for bi, b in enumerate(shorts):
                    br = branches[b]
                    Lb, Db, Ub, bb, e2, coup, st_b = _assemble_branch(
                        br, settings, prevs_s[bi], hs[bi], Qs[bi], k, Y,
                        ests[b])
                    stages_rows[b] = jnp.stack(st_b)
                    err2 = err2 + e2
                    cols = [bb]
                    for (jc, node_idx, block_row) in coup:
                        cols.append(jnp.zeros_like(bb)
                                    .at[node_idx, block_row].set(-1.0))
                    X = solve_block_tridiag(
                        Lb, Db, Ub, jnp.stack(cols, axis=-1),
                        method=settings.linear_solver)
                    us_s.append(X[..., 0])
                    Vs_s.append([X[..., 1 + i] for i in range(len(coup))])

                # --- junction residuals + Schur system --------------------
                q_out, dq_dz = _junction_outflow(rating, Y, dtype)
                Ssum = sum_signed_ends(Qs, ends_now)
                G = _junction_residuals(Ssum, Y, area, dt, q_out, prev_terms)
                err = jnp.sqrt(err2 + jnp.sum(G * G))

                fac = jnp.where(area > 0.0, -0.5, 1.0)
                M = jnp.zeros((J, J), dtype)
                rhs = jnp.array(G)
                # short-branch contributions (loop-engine rule)
                for bi, b in enumerate(shorts):
                    for (jj, idx, sgn) in ends_of(branches[b]):
                        rhs = rhs.at[jj].add(fac[jj] * sgn
                                             * us_s[bi][idx, 1])
                        for (jc, _, _), V in zip(short_coups[b], Vs_s[bi]):
                            M = M.at[jj, jc].add(fac[jj] * sgn * V[idx, 1])
                # sharded-branch contributions: end values of u and V,
                # broadcast from the owning shard
                for li, l in enumerate(sls):
                    meta = sb_meta[l]
                    u = us_l[li]
                    u_q_us = _bcast_from(first, u[0, 1], axis)
                    u_q_ds = _bcast_from(last, u[-1, 1], axis)
                    if meta["jds"] is not None:
                        rhs = rhs.at[meta["jds"]].add(
                            fac[meta["jds"]] * u_q_ds)
                    if meta["jus"] is not None:
                        rhs = rhs.at[meta["jus"]].add(
                            -fac[meta["jus"]] * u_q_us)
                    for ci, (jc, _) in enumerate(meta["coups"]):
                        V_q_us = _bcast_from(first, Vs_l[li][ci][0, 1], axis)
                        V_q_ds = _bcast_from(last, Vs_l[li][ci][-1, 1], axis)
                        if meta["jds"] is not None:
                            M = M.at[meta["jds"], jc].add(
                                fac[meta["jds"]] * V_q_ds)
                        if meta["jus"] is not None:
                            M = M.at[meta["jus"], jc].add(
                                -fac[meta["jus"]] * V_q_us)
                D_Y = jnp.where(area > 0.0, area / dt + 0.5 * dq_dz,
                                -dq_dz)
                M = M - jnp.diag(D_Y)
                dY = _solve_junction_system(M, rhs)

                # --- increments ------------------------------------------
                h_locs2, Q_locs2 = [], []
                for li, l in enumerate(sls):
                    dx_l = us_l[li]
                    for ci, (jc, _) in enumerate(sb_meta[l]["coups"]):
                        dx_l = dx_l - Vs_l[li][ci] * dY[jc]
                    h_locs2.append(h_locs[li] + dx_l[:, 0])
                    Q_locs2.append(Q_locs[li] + dx_l[:, 1])
                hs2, Qs2 = [], []
                for bi, b in enumerate(shorts):
                    dxb = us_s[bi]
                    for (jc, _, _), V in zip(short_coups[b], Vs_s[bi]):
                        dxb = dxb - V * dY[jc]
                    hs2.append(hs[bi] + dxb[:, 0])
                    Qs2.append(Qs[bi] + dxb[:, 1])
                return (tuple(h_locs2), tuple(Q_locs2), tuple(hs2),
                        tuple(Qs2), Y + dY, err, jnp.stack(stages_rows))

            stages0 = jnp.stack([
                jnp.stack([es[0].reservoir_stage, es[1].reservoir_stage])
                for es in ests])
            init = (h_locs, Q_locs, hs, Qs, Y,
                    jnp.asarray(jnp.inf, dtype), jnp.asarray(0, jnp.int32),
                    stages0)

            def cond(c):
                return (c[5] >= tol) & (c[6] < settings.max_iter)

            def body(c):
                h_locs, Q_locs, hs, Qs, Y = c[:5]
                h2, Q2, hs2, Qs2, Y2, err, st2 = one(h_locs, Q_locs, hs, Qs,
                                                     Y)
                return (h2, Q2, hs2, Qs2, Y2, err, c[6] + 1, st2)

            (h_locs, Q_locs, hs, Qs, Y, err, iters,
             stages) = lax.while_loop(cond, body, init)
            return h_locs, Q_locs, hs, Qs, Y, err, iters, stages

        def step(carry, k):
            h_locs, Q_locs, hs, Qs, Y, ests = carry
            t_now = k.astype(dtype) * dt
            new_states = []
            for b, br in enumerate(branches):
                pair = []
                for j, end in enumerate((br.us, br.ds)):
                    est = ests[b][j]
                    if not _is_junction(end):
                        est = bnd.update_gate_level_start(end, est, t_now)
                    pair.append(est)
                new_states.append(tuple(pair))
            ests = tuple(new_states)

            prev_exts = []
            for li in range(len(sls)):
                pf = prs.prev_level_state(geo_locs[li], h_locs[li],
                                          Q_locs[li])
                prev_exts.append(_extend(
                    dict(A=pf.A, Se=pf.Se, Q2A=pf.Q2A, Q=pf.Q, h=pf.h),
                    axis))
            prevs_s = tuple(prs.prev_level_state(dyn_s[bi]["geo"], hs[bi],
                                                 Qs[bi])
                            for bi in range(len(shorts)))
            (h_locs, Q_locs, hs, Qs, Y, err, iters,
             stages) = newton_level(h_locs, Q_locs, hs, Qs, Y, prev_exts,
                                    prevs_s, k, ests)
            new_states, gate_rows = [], []
            for b, br in enumerate(branches):
                pair = []
                for j, (end, idx) in enumerate(((br.us, 0),
                                                (br.ds, n_bs[b] - 1))):
                    est = ests[b][j]
                    if not _is_junction(end):
                        if b in sls:
                            li = sls.index(b)
                            h_end = _bcast_from(
                                first if idx == 0 else last,
                                h_locs[li][0] if idx == 0
                                else h_locs[li][-1], axis)
                        else:
                            h_end = hs[shorts.index(b)][idx if idx == 0
                                                        else -1]
                        est = est._replace(
                            reservoir_stage=stages[b, j],
                            gate_stage=end.bed_level + h_end)
                    pair.append(est)
                gate_rows.append(jnp.stack([pair[0].gate_open,
                                            pair[1].gate_open]))
                new_states.append(tuple(pair))
            ests = tuple(new_states)
            out = (h_locs, Q_locs, hs, Qs, Y, err, iters, stages,
                   jnp.stack(gate_rows))
            return (h_locs, Q_locs, hs, Qs, Y, ests), out

        carry0 = (h0_locs, Q0_locs,
                  tuple(d["h0"] for d in dyn_s),
                  tuple(d["Q0"] for d in dyn_s), Y0_, ests0)
        carry, outs = lax.scan(step, carry0, jnp.arange(1, nt))
        return outs

    n_sh = len(sls)
    geo_specs = tuple(
        jax.tree_util.tree_map(lambda _: P(SPACE_AXIS), geo_ls[li])
        for li in range(n_sh))
    rep = lambda tree: jax.tree_util.tree_map(lambda _: P(), tree)
    n_short = len(shorts)
    out_specs = ((P(None, SPACE_AXIS),) * n_sh, (P(None, SPACE_AXIS),) * n_sh,
                 (P(None),) * n_short, (P(None),) * n_short,
                 P(None), P(None), P(None), P(None), P(None))
    f = shard_map(
        shard_fn, mesh,
        in_specs=(geo_specs, (P(SPACE_AXIS),) * n_sh,
                  (P(SPACE_AXIS),) * n_sh,
                  rep(dyn_shorts), P(None), rep(end_states0)),
        out_specs=out_specs)

    @jax.jit
    def run():
        (h_l, Q_l, hs_s, Qs_s, Y_t, errs, iters, stages_t,
         gates_t) = f(geo_ls, h0_ls, Q0_ls, dyn_shorts, Y0, end_states0)
        return h_l, Q_l, hs_s, Qs_s, Y_t, errs, iters, stages_t, gates_t

    h_l, Q_l, hs_s, Qs_s, Y_t, errs, iters, stages_t, gates_t = run()

    depth, flow = [None] * B, [None] * B
    for li, l in enumerate(sls):
        depth[l] = jnp.concatenate([h0_ls[li][None], h_l[li]], axis=0)
        flow[l] = jnp.concatenate([Q0_ls[li][None], Q_l[li]], axis=0)
    for bi, b in enumerate(shorts):
        depth[b] = jnp.concatenate([dyn_shorts[bi]["h0"][None], hs_s[bi]],
                                   axis=0)
        flow[b] = jnp.concatenate([dyn_shorts[bi]["Q0"][None], Qs_s[bi]],
                                  axis=0)
    stage = jnp.concatenate([Y0[None], Y_t], axis=0)
    zero = jnp.zeros((1,), errs.dtype)
    errs = jnp.concatenate([zero, errs])
    iters = jnp.concatenate([jnp.zeros((1,), iters.dtype), iters])
    res0 = jnp.full((1,) + stages_t.shape[1:], jnp.nan, stages_t.dtype)
    gates0 = jnp.stack([
        jnp.stack([es[0].gate_open, es[1].gate_open])
        for es in end_states0])[None]
    if rating is None:
        outflow = jnp.zeros_like(stage)
    else:
        outflow = jnp.stack(
            [jnp.zeros((stage.shape[0],), dtype) if rc is None
             else rcurve.discharge(rc, stage[:, j])
             for j, rc in enumerate(rating)], axis=-1)
    return NetworkOutput(depth=tuple(depth), flow=tuple(flow),
                         junction_stage=stage, iterations=iters,
                         error=errs, converged=errs < tol,
                         reservoir_stage=jnp.concatenate([res0, stages_t]),
                         gate_open=jnp.concatenate([gates0, gates_t]),
                         junction_outflow=outflow)
