#!/usr/bin/env python3
"""Smoke test of flowsim_tpu's main paths on an NVIDIA GPU.

    python chip_smoke.py            # one card: six phases
    python chip_smoke.py --multi    # four cards: the two sharded paths only

Every phase drives the system through the entry points a user calls, on
``jax.devices()[0]`` (a GPU), and compares the result in the same process
with the CPU float64 path, the plain reference here (block-Thomas solve on
``jax.devices("cpu")[0]``).  All phases run in float64; no float32 matrix
product enters a compared phase (the ``pcr_f32`` solver is timed, not
compared).  Each phase prints its compile time (first call, compilation
included), its steady wall (median of 3 after ``block_until_ready``) and
every comparison beside its bound.

Phases (one card):
  device     the first device is a GPU and x64 is on;
  flagship   gerd_roseires (N=121, 385 hourly levels, theta 0.6, tol 1e-6)
             through ``model.build`` and ``PreissmannSolver.run``; all levels
             converge, the Newton total equals the CPU run's (4,803),
             max|dh| <= 1e-6 m, max|dQ| <= 1e-3 m^3/s (the parity bounds the
             README states against the NumPy reference); then each of the
             thomas / pcr / pcr_f32 solvers is timed;
  ensemble   ``batched_simulate`` over a 256-member roughness ensemble with
             full fields; members 0 and 255 match serial CPU runs to the
             same bounds with identical per-level iteration counts;
  gradient   ``simulate_value_and_grad`` of an upstream-stage RMSE; the
             gradient with respect to the per-node roughness matches the
             CPU adjoint to rtol 1e-6 (norm-wise);
  network    ``models.gerd_tributary`` with the stacked engine on the GPU
             against the loop engine on the CPU: identical iteration counts,
             max|dh| <= 1e-6 m;
  long reach a 10^5-node prismatic reach, 4 levels, f64 ``pcr`` on the GPU
             against the CPU run.  Bound 1e-8 m / 1e-5 m^3/s: both runs end
             with a residual near 4e-12, so anything above f64 roundoff of
             the 17 PCR sweeps is an error, not noise.

Phases (``--multi``, four cards): ``simulate_sharded`` over a 4-way space
mesh at 10^5 nodes against single-card ``simulate``, and ``batched_simulate``
sharded over a 4-card ensemble axis against single-card vmap.

Exits non-zero, printing no result, when JAX finds no GPU or any phase
fails.  The last line of stdout is one JSON object with the device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

H_TOL = 1e-6          # m
Q_TOL = 1e-3          # m^3/s
GRAD_RTOL = 1e-6
LONG_H_TOL = 1e-8     # m
LONG_Q_TOL = 1e-5     # m^3/s
FLAGSHIP_ITERS = 4803
LONG_NODES = 100_000
ENSEMBLE_MEMBERS = 256
SOLVERS = ("thomas", "pcr", "pcr_f32")
TOLERANCE = 1e-6
SLOW_S = 30.0         # first runs slower than this are timed once more, not 3x


class PhaseFailure(AssertionError):
    pass


def log(msg: str = "") -> None:
    print(msg, flush=True)


def check(what: str, value: float, bound: float) -> None:
    ok = value <= bound
    log(f"  {what}: {value:.3e} (bound {bound:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailure(f"{what} = {value:.3e} exceeds {bound:.0e}")


def require(what: str, ok: bool) -> None:
    log(f"  {what}: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailure(what)


def time_call(fn, reps: int = 3):
    """(first-call seconds, median steady seconds, result).  A call whose
    first run took over SLOW_S is repeated once instead of ``reps`` times."""
    import jax

    from flowsim_tpu.utils.profiling import timed

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    steady, _, out = timed(fn, reps=reps if first < SLOW_S else 1)
    return first, steady, out


def on(dev):
    """Default-device context: uncommitted inputs built on the CPU follow it."""
    import jax

    return jax.default_device(dev)


def platform_of(x) -> str:
    return next(iter(x.devices())).platform


def max_abs(a, b) -> float:
    import numpy as np

    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


# -- phases -----------------------------------------------------------------


def phase_device():
    import jax

    dev = jax.devices()[0]
    log(f"device: {dev.platform} {dev.device_kind} (count {len(jax.devices())})")
    if dev.platform != "gpu":
        raise PhaseFailure(f"no GPU: jax.devices()[0] is {dev.platform}")
    if not jax.config.jax_enable_x64:
        raise PhaseFailure("x64 is off")
    return dev


def _cpu_reference(solver, channel, sset):
    """Serial CPU float64 block-Thomas run of a built flagship solver."""
    from flowsim_tpu.ops import preissmann as prs

    ref_set = dataclasses.replace(sset, linear_solver="thomas")
    return prs.simulate(channel.geometry, solver.us_params, solver.ds_params,
                        solver.h0, solver.Q0, ref_set)


def phase_flagship(dev, ref, sim_hours=None, solvers=SOLVERS,
                   expected_iters=FLAGSHIP_ITERS):
    import numpy as np

    from flowsim_tpu.models.gerd_roseires import model
    from flowsim_tpu.ops import preissmann as prs

    log("phase flagship: gerd_roseires through api.PreissmannSolver.run")
    kw = {} if sim_hours is None else dict(sim_duration=3600 * sim_hours)
    with on(ref):
        t0 = time.perf_counter()
        solver, channel = model.build(**kw)
        log(f"  host build: {time.perf_counter() - t0:.3f} s  "
            f"N={solver.number_of_nodes} nt={solver.number_of_time_levels}")
        sset = solver.settings(tolerance=TOLERANCE, max_iter=100)
        out_ref = _cpu_reference(solver, channel, sset)
    ref_iters = int(np.asarray(out_ref.iterations).sum())
    log(f"  CPU f64 reference: {ref_iters} Newton iterations")
    if expected_iters is not None:
        require(f"CPU reference total {ref_iters} == {expected_iters}",
                ref_iters == expected_iters)

    with on(dev):
        first, api_s, out = time_call(
            lambda: solver.run(tolerance=TOLERANCE, verbose=0))
    iters = int(np.asarray(out.iterations).sum())
    log(f"  api run ({solver.settings(TOLERANCE, 100).linear_solver}): "
        f"compile+first {first:.3f} s, steady {api_s:.4f} s, "
        f"{iters} Newton iterations")
    require("all levels converged", bool(np.asarray(out.converged).all()))
    require(f"Newton total {iters} == CPU {ref_iters}", iters == ref_iters)
    require("per-level iterations equal CPU",
            np.array_equal(out.iterations, np.asarray(out_ref.iterations)))
    check("max|dh| vs CPU f64 [m]", max_abs(out.depth, out_ref.depth), H_TOL)
    check("max|dQ| vs CPU f64 [m^3/s]", max_abs(out.flow, out_ref.flow), Q_TOL)

    timings = {}
    for name in solvers:
        s = dataclasses.replace(sset, linear_solver=name)
        with on(dev):
            first, steady, o = time_call(lambda: prs.simulate(
                channel.geometry, solver.us_params, solver.ds_params,
                solver.h0, solver.Q0, s))
        require(f"{name} ran on {dev.platform}", platform_of(o.depth) == dev.platform)
        it = int(np.asarray(o.iterations).sum())
        conv = bool(np.asarray(o.converged).all())
        dh = max_abs(o.depth, out_ref.depth)
        timings[name] = steady
        log(f"  solver {name}: compile+first {first:.3f} s, steady {steady:.4f} s, "
            f"{it} iterations, converged={conv}, max|dh| vs CPU {dh:.2e} m")
        require(f"{name} converged", conv)
    return dict(iterations=iters, steady_s=api_s, solver_s=timings)


def _flagship_members(n_members, sim_hours):
    """Built flagship solver + a roughness ensemble around its main-channel n."""
    import numpy as np

    from flowsim_tpu.models.gerd_roseires import model
    from flowsim_tpu.parallel.ensemble import roughness_ensemble

    kw = {} if sim_hours is None else dict(sim_duration=3600 * sim_hours)
    solver, channel = model.build(**kw)
    sset = solver.settings(tolerance=TOLERANCE, max_iter=100)
    n0 = float(np.asarray(channel.geometry.n_main)[0])
    n_values = np.linspace(0.85 * n0, 1.15 * n0, n_members)
    geo_b = roughness_ensemble(channel.geometry, n_values)
    return solver, channel, sset, n_values, geo_b


def _serial_member(solver, channel, sset, n):
    from flowsim_tpu.models.calibrate import set_main_roughness
    from flowsim_tpu.ops import preissmann as prs

    s = dataclasses.replace(sset, linear_solver="thomas")
    return prs.simulate(set_main_roughness(channel.geometry, n),
                        solver.us_params, solver.ds_params, solver.h0,
                        solver.Q0, s)


def phase_ensemble(dev, ref, n_members=ENSEMBLE_MEMBERS, sim_hours=None):
    import numpy as np

    from flowsim_tpu.parallel.ensemble import batched_simulate

    log(f"phase ensemble: batched_simulate over {n_members} roughness members")
    with on(ref):
        solver, channel, sset, n_values, geo_b = _flagship_members(
            n_members, sim_hours)
        refs = {m: _serial_member(solver, channel, sset, n_values[m])
                for m in (0, n_members - 1)}
    with on(dev):
        first, steady, out = time_call(lambda: batched_simulate(
            geo_b, solver.us_params, solver.ds_params, solver.h0, solver.Q0,
            sset, shard=False))
    require(f"ran on {dev.platform}", platform_of(out.depth) == dev.platform)
    log(f"  compile+first {first:.3f} s, steady {steady:.4f} s, "
        f"{n_members / steady:.1f} members/s, depth {tuple(out.depth.shape)}")
    require("all members converged", bool(np.asarray(out.converged).all()))
    for m, r in refs.items():
        require(f"member {m} per-level iterations equal serial CPU",
                np.array_equal(np.asarray(out.iterations[m]),
                               np.asarray(r.iterations)))
        check(f"member {m} max|dh| [m]", max_abs(out.depth[m], r.depth), H_TOL)
        check(f"member {m} max|dQ| [m^3/s]", max_abs(out.flow[m], r.flow), Q_TOL)
    return dict(steady_s=steady, members=n_members)


def phase_gradient(dev, ref, sim_hours=None):
    import jax.numpy as jnp
    import numpy as np

    from flowsim_tpu.models.calibrate import set_main_roughness
    from flowsim_tpu.ops import adjoint

    log("phase gradient: simulate_value_and_grad of an upstream-stage RMSE")
    with on(ref):
        solver, channel, sset, n_values, _ = _flagship_members(2, sim_hours)
        geo = channel.geometry
        z0 = float(np.asarray(geo.z_bed)[0])
        # observed stages: the run at +10% roughness
        n0 = float(np.asarray(geo.n_main)[0])
        target = np.asarray(_serial_member(solver, channel, sset, 1.1 * n0)
                            .depth[:, 0]) + z0

    def loss_fn(out):
        return jnp.sqrt(jnp.mean((out.depth[:, 0] + z0 - target) ** 2))

    def grad_on(device, linear_solver):
        s = dataclasses.replace(sset, linear_solver=linear_solver)
        with on(device):
            return adjoint.simulate_value_and_grad(
                loss_fn, geo, solver.us_params, solver.ds_params, solver.h0,
                solver.Q0, s)

    with on(ref):
        loss_ref, grads_ref, _ = grad_on(ref, "thomas")
    first, steady, (loss, grads, _) = time_call(
        lambda: grad_on(dev, sset.linear_solver))
    require(f"ran on {dev.platform}", platform_of(grads[0].n_main) == dev.platform)
    g = np.asarray(grads[0].n_main)
    g_ref = np.asarray(grads_ref[0].n_main)
    log(f"  compile+first {first:.3f} s, steady {steady:.4f} s; loss "
        f"{float(loss):.6e} (CPU {float(loss_ref):.6e}), d loss/d n summed "
        f"{g.sum():.6e} (CPU {g_ref.sum():.6e})")
    require("gradient finite", bool(np.isfinite(g).all()))
    check("|grad - CPU| / |CPU| (per-node n_main)",
          float(np.linalg.norm(g - g_ref) / np.linalg.norm(g_ref)), GRAD_RTOL)
    return dict(steady_s=steady)


def phase_network(dev, ref, sim_hours=None):
    import numpy as np

    from flowsim_tpu.models import gerd_tributary
    from flowsim_tpu.ops.network import simulate_network

    log("phase network: gerd_tributary, stacked engine vs CPU loop engine")
    with on(ref):
        kw = {} if sim_hours is None else dict(sim_duration=3600 * sim_hours)
        branches, nj, sset, _ = gerd_tributary.build(**kw)
        out_ref = simulate_network(
            branches, nj, dataclasses.replace(sset, linear_solver="thomas"),
            engine="loop")
    with on(dev):
        first, steady, out = time_call(
            lambda: simulate_network(branches, nj, sset, engine="stacked"))
    require(f"ran on {dev.platform}", platform_of(out.junction_stage) == dev.platform)
    iters = int(np.asarray(out.iterations).sum())
    log(f"  compile+first {first:.3f} s, steady {steady:.4f} s, "
        f"{iters} Newton iterations")
    require("all levels converged", bool(np.asarray(out.converged).all()))
    require("per-level iterations equal CPU loop",
            np.array_equal(np.asarray(out.iterations),
                           np.asarray(out_ref.iterations)))
    check("max|dh| over branches [m]",
          max(max_abs(a, b) for a, b in zip(out.depth, out_ref.depth)), H_TOL)
    return dict(steady_s=steady, iterations=iters)


def phase_long_reach(dev, ref, n_nodes=LONG_NODES, levels=4):
    import numpy as np

    from flowsim_tpu.models import long_reach
    from flowsim_tpu.ops import preissmann as prs

    log(f"phase long reach: {n_nodes} nodes, {levels} levels, f64 pcr")
    with on(ref):
        geo, us, ds, h0, Q0, sset = long_reach.build(n_nodes, levels=levels,
                                                     linear_solver="pcr")
        out_ref = prs.simulate(geo, us, ds, h0, Q0,
                               dataclasses.replace(sset, linear_solver="thomas"))
    with on(dev):
        first, steady, out = time_call(
            lambda: prs.simulate(geo, us, ds, h0, Q0, sset))
    require(f"ran on {dev.platform}", platform_of(out.depth) == dev.platform)
    iters = int(np.asarray(out.iterations).sum())
    log(f"  compile+first {first:.3f} s, steady {steady:.4f} s, {iters} "
        f"Newton iterations, {n_nodes * iters / steady:.4e} newton-node-updates/s")
    require("all levels converged", bool(np.asarray(out.converged).all()))
    require("per-level iterations equal CPU",
            np.array_equal(np.asarray(out.iterations),
                           np.asarray(out_ref.iterations)))
    check("max|dh| [m]", max_abs(out.depth, out_ref.depth), LONG_H_TOL)
    check("max|dQ| [m^3/s]", max_abs(out.flow, out_ref.flow), LONG_Q_TOL)
    return dict(steady_s=steady)


def phase_multi(devices, n_nodes=LONG_NODES, levels=4,
                n_members=ENSEMBLE_MEMBERS, sim_hours=None):
    """The two sharded paths over ``devices`` against the first one alone."""
    import jax
    import numpy as np

    from flowsim_tpu.models import long_reach
    from flowsim_tpu.ops import preissmann as prs
    from flowsim_tpu.parallel.domain import simulate_sharded
    from flowsim_tpu.parallel.ensemble import batched_simulate
    from flowsim_tpu.parallel.mesh import make_mesh

    n = len(devices)
    one = devices[0]
    cpu = jax.devices("cpu")[0]

    log(f"phase multi/space: simulate_sharded over {n} devices, {n_nodes} nodes")
    with on(cpu):
        geo, us, ds, h0, Q0, sset = long_reach.build(n_nodes, levels=levels,
                                                     linear_solver="pcr")
    mesh = make_mesh(n_ensemble=1, n_space=n, devices=devices)
    first, steady, out = time_call(
        lambda: simulate_sharded(geo, us, ds, h0, Q0, sset, mesh))
    spread = len(out.depth.sharding.device_set)
    log(f"  compile+first {first:.3f} s, steady {steady:.4f} s, "
        f"fields spread over {spread} devices")
    require(f"fields spread over {n} devices", spread == n)
    with on(one):
        f1, s1, single = time_call(lambda: prs.simulate(geo, us, ds, h0, Q0, sset))
    log(f"  single device: compile+first {f1:.3f} s, steady {s1:.4f} s")
    require("all levels converged", bool(np.asarray(out.converged).all()))
    require("per-level iterations equal single device",
            np.array_equal(np.asarray(out.iterations),
                           np.asarray(single.iterations)))
    check("max|dh| vs single device [m]", max_abs(out.depth, single.depth),
          LONG_H_TOL)
    check("max|dQ| vs single device [m^3/s]", max_abs(out.flow, single.flow),
          LONG_Q_TOL)

    log(f"phase multi/ensemble: batched_simulate, {n_members} members "
        f"sharded over {n} devices")
    with on(cpu):
        solver, channel, sset_f, n_values, geo_b = _flagship_members(
            n_members, sim_hours)
    emesh = make_mesh(n_ensemble=n, n_space=1, devices=devices)
    run = lambda mesh_, shard: batched_simulate(
        geo_b, solver.us_params, solver.ds_params, solver.h0, solver.Q0,
        sset_f, mesh=mesh_, shard=shard)
    first, steady, out = time_call(lambda: run(emesh, True))
    spread = len(out.depth.sharding.device_set)
    log(f"  compile+first {first:.3f} s, steady {steady:.4f} s, "
        f"{n_members / steady:.1f} members/s over {spread} devices")
    require(f"members spread over {n} devices", spread == n)
    with on(one):
        f1, s1, single = time_call(lambda: run(None, False))
    log(f"  single device: compile+first {f1:.3f} s, steady {s1:.4f} s, "
        f"{n_members / s1:.1f} members/s")
    require("all members converged", bool(np.asarray(out.converged).all()))
    require("per-member iterations equal single device",
            np.array_equal(np.asarray(out.iterations),
                           np.asarray(single.iterations)))
    check("max|dh| vs single device [m]", max_abs(out.depth, single.depth), H_TOL)
    check("max|dQ| vs single device [m^3/s]", max_abs(out.flow, single.flow), Q_TOL)
    return dict(space_steady_s=steady)


# -- driver -----------------------------------------------------------------


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, check=True, timeout=60)
    return r.stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the two sharded paths, on four cards")
    args = ap.parse_args(argv)

    # keep the CPU backend beside the GPU: it runs the reference
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    import jax

    jax.config.update("jax_enable_x64", True)
    dev = phase_device()

    from flowsim_tpu.utils import compile_cache

    log(f"compile cache: {compile_cache.enable()}")
    ref = jax.devices("cpu")[0]
    t0 = time.perf_counter()
    if args.multi:
        devices = jax.devices()[:4]
        if len(devices) < 4:
            raise PhaseFailure(f"--multi needs 4 GPUs, found {len(devices)}")
        phase_multi(devices)
        count = len(devices)
    else:
        phase_flagship(dev, ref)
        phase_ensemble(dev, ref)
        phase_gradient(dev, ref)
        phase_network(dev, ref)
        phase_long_reach(dev, ref)
        count = 1
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    for line in card_line().splitlines()[:count]:
        log(f"card: {line}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
