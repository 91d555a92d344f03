"""Periodic checkpoint / resume of solver state.

The reference has no checkpointing (SURVEY.md §5): full state history lives
in RAM and is dumped once at the end.  Here the minimal restart state
(time level k, h, Q, and the full cross-level boundary state — reservoir
stage plus the gated-rating-curve controller fields) and the accumulated
history can be saved every ``interval`` levels and a run resumed from the
latest file.  Plain ``.npz`` files — dependency-free and portable; an
orbax-backed variant can layer on top for multi-host sharded state.

Chunked advancement goes through :func:`flowsim_tpu.ops.preissmann.single_step`,
which executes the exact per-level semantics of ``simulate``'s scan body
(gate update at level start, Newton solve, BCState carry), so a checkpointed
run of a gated (``gated_blend``) downstream curve reproduces ``simulate``
bitwise, hysteresis included.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np


CKPT_RE = re.compile(r"ckpt_(\d+)\.npz$")

_BC_FIELDS = ("reservoir_stage", "gate_open", "gate_cooldown", "gate_prev_time", "gate_stage", "reservoir_stage_us")


def save_checkpoint(directory: str, k: int, h, Q, bc_state=None, history=None,
                    reservoir_stage=None, stats=None, keep: int = 0) -> str:
    """Write an atomic checkpoint.

    ``bc_state`` is a :class:`flowsim_tpu.ops.boundary.BCState`; the legacy
    ``reservoir_stage`` scalar is still accepted when no gate state exists.
    ``history``/``stats`` arrays are truncated to the completed levels
    ``[:k+1]`` (a preallocated full-length buffer is mostly zeros early on).
    ``keep > 0`` prunes the directory to the ``keep`` newest files after a
    successful write.
    """
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt_{k:08d}.npz")
    payload = dict(k=np.asarray(k), h=np.asarray(h), Q=np.asarray(Q))
    if bc_state is not None:
        for name in _BC_FIELDS:
            payload[name] = np.asarray(getattr(bc_state, name))
    else:
        payload["reservoir_stage"] = np.asarray(
            np.nan if reservoir_stage is None else reservoir_stage
        )
    if history is not None:
        payload["depth_history"] = np.asarray(history[0])[: k + 1]
        payload["flow_history"] = np.asarray(history[1])[: k + 1]
    if stats is not None:
        for name, arr in stats.items():
            payload["stat_" + name] = np.asarray(arr)[: k + 1]
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)
    if keep > 0:
        files = sorted(
            (nm for nm in os.listdir(directory) if CKPT_RE.match(nm)),
            key=lambda nm: int(CKPT_RE.match(nm).group(1)))
        for nm in files[:-keep]:
            os.remove(os.path.join(directory, nm))
    return path


def latest_checkpoint(directory: str) -> Optional[str]:
    if not os.path.isdir(directory):
        return None
    best = None
    best_k = -1
    for name in os.listdir(directory):
        m = CKPT_RE.match(name)
        if m and int(m.group(1)) > best_k:
            best_k = int(m.group(1))
            best = os.path.join(directory, name)
    return best


def load_checkpoint(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _bc_state_from_payload(z: dict, dtype, default_state):
    """Rebuild a BCState from checkpoint arrays.  Legacy files lack the gate
    fields; those restore from ``default_state`` — the same fresh-start state
    a non-resumed run would begin with (so ``gate_initially_open`` is
    honored, not silently reset to closed)."""
    import jax.numpy as jnp

    updates = {}
    for name in _BC_FIELDS:
        if name in z:
            updates[name] = jnp.asarray(float(z[name]), dtype=dtype)
    if "reservoir_stage_us" not in z and "reservoir_stage" in z:
        # legacy files carried a single merged stage; an upstream-only
        # storage run stored its stage there, so mirror it into the us
        # carry (harmless when the run has no upstream storage — unread)
        updates["reservoir_stage_us"] = jnp.asarray(float(z["reservoir_stage"]), dtype=dtype)
    return default_state._replace(**updates)


def simulate_with_checkpoints(solver, tolerance=1e-4, max_iter=100, interval=50,
                              directory="checkpoints", resume=True, verbose=0,
                              keep: int = 0):
    """Run a PreissmannSolver in chunks, checkpointing every ``interval`` levels.

    Resumes from the latest checkpoint in ``directory`` if present (``keep > 0``
    retains only that many newest files — long runs otherwise accumulate one
    full-history file per interval).  Populates ``solver.output`` with the same
    :class:`~flowsim_tpu.ops.preissmann.SimOutput` a plain ``solver.run()``
    produces, so the results pipeline (``prepare_results``/``save_results``,
    including the lumped-storage stage/outflow reconstruction) works on a
    checkpointed run.
    """
    import jax
    import jax.numpy as jnp
    from flowsim_tpu.ops import boundary as bnd
    from flowsim_tpu.ops import preissmann as prs

    nt = solver.number_of_time_levels
    N = solver.number_of_nodes
    depth = np.zeros((nt, N))
    flow = np.zeros((nt, N))
    depth[0] = np.asarray(solver.h0)
    flow[0] = np.asarray(solver.Q0)
    stats = dict(
        iterations=np.zeros(nt, np.int64),
        error=np.zeros(nt),
        reservoir_stage=np.full(nt, np.nan),
        gate_open=np.zeros(nt),
        reservoir_stage_us=np.full(nt, np.nan),
    )

    settings = solver.settings(tolerance, max_iter)
    geo = solver.channel.geometry
    dtype = jnp.asarray(solver.h0).dtype

    start_k = 1
    h, Q = solver.h0, solver.Q0
    gate_open0 = 1.0 if settings.gate_initially_open else 0.0
    bc_state = bnd.initial_bc_state(
        dtype, gate_open=gate_open0,
        gate_stage=solver.ds_params.bed_level + jnp.asarray(h)[-1],
    )
    stats["gate_open"][0] = gate_open0
    if resume:
        ck = latest_checkpoint(directory)
        if ck is not None:
            z = load_checkpoint(ck)
            start_k = int(z["k"]) + 1
            h, Q = jnp.asarray(z["h"]), jnp.asarray(z["Q"])
            bc_state = _bc_state_from_payload(z, dtype, bc_state)
            if "depth_history" in z:
                kk = min(start_k, len(z["depth_history"]))
                depth[:kk] = z["depth_history"][:kk]
                flow[:kk] = z["flow_history"][:kk]
            for name, arr in stats.items():
                key = "stat_" + name
                if key in z:
                    kk = min(start_k, len(z[key]))
                    arr[:kk] = z[key][:kk]

    # one traced program for the whole loop: k and the BCState are dynamic,
    # geometry/BC params/settings are trace-time constants (re-tracing the
    # Newton while_loop once per level dominates a long checkpointed run)
    @jax.jit
    def step(h, Q, k, bc_state):
        return prs.single_step(
            geo, solver.us_params, solver.ds_params, h, Q, k,
            bc_state.reservoir_stage, settings, bc_state=bc_state,
        )

    for k in range(start_k, nt):
        h, Q, err, iters, bc_state = step(h, Q, jnp.asarray(k), bc_state)
        depth[k] = np.asarray(h)
        flow[k] = np.asarray(Q)
        stats["iterations"][k] = int(iters)
        stats["error"][k] = float(err)
        stats["reservoir_stage"][k] = float(bc_state.reservoir_stage)
        stats["gate_open"][k] = float(bc_state.gate_open)
        stats["reservoir_stage_us"][k] = float(bc_state.reservoir_stage_us)
        if float(err) >= tolerance:
            raise ValueError(f"Convergence within {int(iters)} iterations couldn't be achieved.")
        if k % interval == 0 or k == nt - 1:
            save_checkpoint(directory, k, h, Q, bc_state=bc_state,
                            history=(depth, flow), stats=stats, keep=keep)
        if verbose:
            print(f"level {k}: iters={int(iters)} err={float(err):.2e}")

    solver.depth = depth
    solver.flow = flow
    solver.output = prs.SimOutput(
        depth=depth, flow=flow,
        iterations=stats["iterations"],
        error=stats["error"],
        converged=(stats["error"] < tolerance) | (np.arange(nt) == 0),
        reservoir_stage=stats["reservoir_stage"],
        gate_open=stats["gate_open"],
        rcond=np.ones(nt),
        reservoir_stage_us=stats["reservoir_stage_us"],
    )
    solver.total_sim_duration = (nt - 1) * solver.time_step
    return depth, flow


# ---------------------------------------------------------------------------
# Sharded (multi-host) checkpoint/resume — orbax-backed
# ---------------------------------------------------------------------------


def _ocp():
    try:
        import orbax.checkpoint as ocp
    except ImportError as e:
        raise ImportError("orbax-checkpoint is required for the sharded "
                          "checkpoints; the .npz checkpoints need only "
                          "numpy") from e
    return ocp


def save_sharded_checkpoint(directory: str, k: int, h, Q, bc_state) -> str:
    """Save the sharded restart state at level ``k`` with orbax.

    Unlike the ``.npz`` path, this works for arrays that are NOT fully
    addressable per process (space-sharded state on a multi-host mesh):
    every process calls it collectively and orbax writes each host's shards.
    """
    ocp = _ocp()
    os.makedirs(directory, exist_ok=True)
    path = os.path.abspath(os.path.join(directory, f"sck_{k:08d}"))
    tree = {"k": np.asarray(k), "h": h, "Q": Q,
            "bc": dict(bc_state._asdict())}
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(path, tree, force=True)
    ckptr.wait_until_finished()
    return path


def latest_sharded_checkpoint(directory: str):
    """(path, k) of the newest orbax checkpoint in ``directory``; None if none."""
    if not os.path.isdir(directory):
        return None
    best, best_k = None, -1
    for name in os.listdir(directory):
        m = re.match(r"sck_(\d+)$", name)
        if m and int(m.group(1)) > best_k:
            best_k = int(m.group(1))
            best = os.path.join(directory, name)
    return (best, best_k) if best else None


def restore_sharded_checkpoint(path: str, h_like, Q_like, bc_like):
    """Restore ``(k, h, Q, BCState)`` with the shardings of the templates."""
    import jax

    from flowsim_tpu.ops import boundary as bnd

    ocp = _ocp()

    def abstract(a):
        from jax.sharding import SingleDeviceSharding

        a = jax.numpy.asarray(a)
        sh = getattr(a, "sharding", None)
        if isinstance(sh, SingleDeviceSharding):
            # an eager/uncommitted template means "give me host values" —
            # restoring committed-to-device-0 arrays would pin later jitted
            # mesh computations off their device set
            sh = None
        return jax.ShapeDtypeStruct(a.shape, a.dtype, sharding=sh)

    tpl = {"k": jax.ShapeDtypeStruct((), np.asarray(0).dtype),
           "h": abstract(h_like), "Q": abstract(Q_like),
           "bc": jax.tree_util.tree_map(abstract, dict(bc_like._asdict()))}
    ckptr = ocp.StandardCheckpointer()
    z = ckptr.restore(os.path.abspath(path), tpl)

    def host(x, t):
        # a template without sharding means the caller wants host values:
        # orbax would otherwise hand back arrays COMMITTED to device 0,
        # which pins any later jitted mesh computation off its device set
        return np.asarray(x) if t.sharding is None else x

    h = host(z["h"], tpl["h"])
    Q = host(z["Q"], tpl["Q"])
    bc = jax.tree_util.tree_map(host, z["bc"], tpl["bc"])
    return int(z["k"]), h, Q, bnd.BCState(**bc)


def simulate_sharded_with_checkpoints(geo, us_bc, ds_bc, h0, Q0, settings,
                                      mesh, interval=50,
                                      directory="checkpoints_sharded",
                                      resume=True):
    """Domain-decomposed run in chunks of ``interval`` levels with orbax
    checkpoints of the sharded restart state (level index, h, Q, BCState —
    including the gate controller, so a resumed gated run continues its
    hysteresis bitwise).

    Returns a SimOutput covering levels [0, nt-1] identical to a single-shot
    :func:`flowsim_tpu.parallel.domain.simulate_sharded` (each chunk passes
    the ABSOLUTE level offset, so hydrograph targets and gate times line up).
    A RESUMED run returns only the recomputed tail — levels (k_ckpt, nt-1]
    — since the checkpoint stores the restart state, not the history (the
    sharded history may not be addressable per process; keep earlier
    chunks' outputs from the pre-crash run, or re-run with resume=False).
    """
    import dataclasses

    import jax
    import jax.numpy as jnp

    from flowsim_tpu.ops import boundary as bnd
    from flowsim_tpu.parallel.domain import simulate_sharded

    nt = settings.n_time_levels
    k0 = 0
    h, Q = h0, Q0
    # None -> simulate_sharded builds the (uncommitted) fresh-start BCState;
    # an eagerly built jnp state here would pin the jitted run to device 0
    bc_state = None
    if resume:
        found = latest_sharded_checkpoint(directory)
        if found is not None:
            gate_open0 = 1.0 if settings.gate_initially_open else 0.0
            dt0 = np.asarray(h0).dtype
            bc_tpl = bnd.BCState(
                reservoir_stage=np.asarray(np.nan, dt0),
                gate_open=np.asarray(gate_open0, dt0),
                gate_cooldown=np.asarray(0.0, dt0),
                gate_prev_time=np.asarray(-1.0, dt0),
                gate_stage=np.asarray(0.0, dt0),
                reservoir_stage_us=np.asarray(np.nan, dt0))
            path, _ = found
            k0, h, Q, bc_state = restore_sharded_checkpoint(
                path, h0, Q0, bc_tpl)

    chunks = []
    while k0 < nt - 1:
        n_levels = min(interval, nt - 1 - k0)
        csettings = dataclasses.replace(settings, n_time_levels=n_levels + 1)
        out, (h, Q, bc_state) = simulate_sharded(
            geo, us_bc, ds_bc, h, Q, csettings, mesh,
            bc_state0=bc_state, k0=k0, return_final_state=True)
        # drop each chunk's level-0 row except the very first chunk's (it
        # duplicates the previous chunk's final level)
        sl = (lambda a: a) if k0 == 0 else (lambda a: a[1:])
        chunks.append(jax.tree_util.tree_map(sl, out))
        k0 += n_levels
        save_sharded_checkpoint(directory, k0, h, Q, bc_state)

    cat = jax.jit(lambda *xs: jax.tree_util.tree_map(
        lambda *ls: jnp.concatenate(ls, axis=0), *xs))
    return cat(*chunks) if len(chunks) > 1 else chunks[0]


# -- river networks ---------------------------------------------------------


def save_network_checkpoint(directory: str, k: int, carry, hist,
                            keep: int = 0) -> str:
    """Atomic network checkpoint: restart carry + accumulated histories.

    ``carry`` = (hs, Qs, Y, end_states) from
    :func:`flowsim_tpu.ops.network.simulate_network_chunk`; ``hist`` is the
    dict of history arrays accumulated so far (levels 0..k).
    """
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt_{k:08d}.npz")
    hs, Qs, Y, end_states = carry
    payload = dict(k=np.asarray(k), Y=np.asarray(Y))
    for b, (h, Q) in enumerate(zip(hs, Qs)):
        payload[f"h_{b}"] = np.asarray(h)
        payload[f"Q_{b}"] = np.asarray(Q)
        for j in range(2):
            for name in _BC_FIELDS:
                payload[f"est_{b}_{j}_{name}"] = np.asarray(
                    getattr(end_states[b][j], name))
    for name, arr in hist.items():
        payload["hist_" + name] = np.asarray(arr)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)
    if keep > 0:
        files = sorted(
            (nm for nm in os.listdir(directory) if CKPT_RE.match(nm)),
            key=lambda nm: int(CKPT_RE.match(nm).group(1)))
        for nm in files[:-keep]:
            os.remove(os.path.join(directory, nm))
    return path


def _load_network_checkpoint(path: str, n_branches: int, dtype):
    import jax.numpy as jnp

    from flowsim_tpu.ops.boundary import BCState

    with np.load(path) as f:
        z = dict(f.items())
    k = int(z["k"])
    hs = tuple(jnp.asarray(z[f"h_{b}"], dtype) for b in range(n_branches))
    Qs = tuple(jnp.asarray(z[f"Q_{b}"], dtype) for b in range(n_branches))
    Y = jnp.asarray(z["Y"], dtype)
    ests = tuple(
        tuple(BCState(*(jnp.asarray(z[f"est_{b}_{j}_{name}"], dtype)
                        for name in _BC_FIELDS))
              for j in range(2))
        for b in range(n_branches))
    hist = {name[len("hist_"):]: z[name] for name in z if name.startswith("hist_")}
    return k, (hs, Qs, Y, ests), hist


def simulate_network_with_checkpoints(branches, n_junctions, settings,
                                      directory, interval=50,
                                      junction_area=None, junction_rating=None,
                                      keep: int = 0, engine: str = "loop"):
    """Checkpointed network run: resumable, bitwise-equal to
    :func:`flowsim_tpu.ops.network.simulate_network` (loop engine).

    Advances ``interval`` levels per chunk via ``simulate_network_chunk``
    (the exact scan body of the one-shot run, gate/reservoir end state
    carried), writing an ``.npz`` checkpoint after each chunk.  If
    ``directory`` holds a checkpoint, the run resumes after its level.
    """
    import jax.numpy as jnp

    from flowsim_tpu.ops import network as net
    from flowsim_tpu.ops import rating_curve as rcurve

    nt = settings.n_time_levels
    B = len(branches)
    dtype = jnp.asarray(branches[0].h0).dtype

    path = latest_checkpoint(directory)
    if path is not None:
        k0, carry, hist = _load_network_checkpoint(path, B, dtype)
        hist = {k: list(v) for k, v in hist.items()}
        hist_depth = [hist.pop(f"depth_{b}") for b in range(B)]
        hist_flow = [hist.pop(f"flow_{b}") for b in range(B)]
    else:
        k0 = 0
        carry = None
        Y0 = np.asarray(net.default_initial_stages(branches, n_junctions,
                                                   dtype))
        gate0 = 1.0 if settings.gate_initially_open else 0.0
        gates0 = np.array([[gate0 if not net._is_junction(e) else 0.0
                            for e in (br.us, br.ds)] for br in branches])
        hist = dict(Y=[Y0], err=[0.0], iters=[0],
                    stages=[np.full((B, 2), np.nan)], gates=[gates0])
        hist_depth = [[np.asarray(br.h0)] for br in branches]
        hist_flow = [[np.asarray(br.Q0)] for br in branches]

    while k0 < nt - 1:
        n_levels = min(interval, nt - 1 - k0)
        ks = np.arange(k0 + 1, k0 + 1 + n_levels)
        (hs_t, Qs_t, Y_t, errs, iters, stages_t, gates_t), carry = (
            net.simulate_network_chunk(
                branches, n_junctions, settings, ks, carry=carry,
                junction_area=junction_area,
                junction_rating=junction_rating, engine=engine))
        for b in range(B):
            hist_depth[b].extend(np.asarray(hs_t[b]))
            hist_flow[b].extend(np.asarray(Qs_t[b]))
        hist["Y"].extend(np.asarray(Y_t))
        hist["err"].extend(np.asarray(errs))
        hist["iters"].extend(np.asarray(iters))
        hist["stages"].extend(np.asarray(stages_t))
        hist["gates"].extend(np.asarray(gates_t))
        k0 += n_levels
        payload_hist = {k: np.asarray(v) for k, v in hist.items()}
        for b in range(B):
            payload_hist[f"depth_{b}"] = np.asarray(hist_depth[b])
            payload_hist[f"flow_{b}"] = np.asarray(hist_flow[b])
        save_network_checkpoint(directory, k0, carry, payload_hist, keep=keep)

    errs = np.asarray(hist["err"])
    stage = np.asarray(hist["Y"])
    if junction_rating is None:
        outflow = np.zeros_like(stage)
    else:
        outflow = np.stack(
            [np.zeros(stage.shape[0]) if rc is None
             else np.asarray(rcurve.discharge(rc, jnp.asarray(stage[:, j])))
             for j, rc in enumerate(junction_rating)], axis=-1)
    return net.NetworkOutput(
        depth=tuple(np.asarray(hist_depth[b]) for b in range(B)),
        flow=tuple(np.asarray(hist_flow[b]) for b in range(B)),
        junction_stage=stage,
        iterations=np.asarray(hist["iters"]),
        error=errs,
        converged=errs < settings.tolerance,
        reservoir_stage=np.asarray(hist["stages"]),
        gate_open=np.asarray(hist["gates"]),
        junction_outflow=outflow)
