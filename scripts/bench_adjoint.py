"""Gradient-path benchmark: adjoint vs unrolled-fixed autodiff.

Measures, on the flagship gerd configuration (N=121, 385 levels, tol 1e-6
semantics), the wall time of one value+gradient evaluation of the RMSE
calibration objective (ref cases/gerd_roseires/n_calibrate.py:19-31) via:

1. legacy ``newton="fixed"`` reverse-mode (models/calibrate.py) — forward
   + unrolled backward through max_iter masked Newton iterations per level;
2. ``newton="implicit"`` (ops/adjoint.py simulate_implicit): while-Newton
   forward + IFT adjoint backward, under plain jax.grad;
3. the two-phase driver (adjoint.simulate_value_and_grad): eager forward +
   the same jitted adjoint backward.

Each wall is the median of 3 runs ended by ``block_until_ready``.  Prints
one JSON line with the three walls and the speedups.  Run from the repo
root: ``python scripts/bench_adjoint.py [cpu] [fixed_iters]``.
"""

import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    force_cpu = "cpu" in sys.argv[1:]
    import jax

    if force_cpu:
        jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    from flowsim_tpu.utils import compile_cache

    compile_cache.enable()

    import jax.numpy as jnp

    from flowsim_tpu.models.calibrate import (set_main_roughness,
                                              upstream_stage_at)
    from flowsim_tpu.models.gerd_roseires import model, settings
    from flowsim_tpu.ops import adjoint
    from flowsim_tpu.ops import preissmann as prs

    from flowsim_tpu.utils.profiling import timed

    device = jax.devices()[0]
    log(f"device: {device.platform} {device.device_kind}")

    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        solver, channel = model.build()  # smooth (non-gated) ds curve
        sset = solver.settings(tolerance=settings.tolerance, max_iter=100)
        geo = solver.channel.geometry

    # the reference's six calibration targets (ref n_calibrate.py:27-29)
    Q_t = jnp.asarray([1562.5, 2000.0, 3000.0, 4000.0, 5000.0, 6000.0])
    H_t = jnp.asarray([500.0, 501.0, 502.3, 503.4, 504.3, 505.1])

    us, ds, h0, Q0 = solver.us_params, solver.ds_params, solver.h0, solver.Q0

    def loss_of(out, g):
        H = upstream_stage_at(out, g.z_bed[0], Q_t)
        return jnp.sqrt(jnp.mean((H - H_t) ** 2))

    def make_objective(newton, max_iter=None):
        ss = dataclasses.replace(sset, newton=newton)
        if max_iter is not None:
            ss = dataclasses.replace(ss, max_iter=max_iter)

        def f(n_main):
            g = set_main_roughness(geo, n_main)
            out = prs.simulate(g, us, ds, h0, Q0, ss)
            return loss_of(out, g)

        return f

    def time_reps(fn):
        return timed(fn, jnp.asarray(0.029), reps=3)[0]

    def first_call(fn, label):
        t0 = time.perf_counter()
        v, g = jax.block_until_ready(fn(jnp.asarray(0.029)))
        log(f"{label} compile+first: {time.perf_counter()-t0:.1f}s  "
            f"loss={float(v):.4f} grad={float(g):.3f}")

    results = {}

    # --- 2. implicit adjoint under jax.grad --------------------------------
    vg_impl = jax.jit(jax.value_and_grad(make_objective("implicit")))
    first_call(vg_impl, "implicit")
    results["implicit_s"] = time_reps(vg_impl)
    log(f"implicit steady: {results['implicit_s']:.3f}s")

    # --- 1. legacy fixed-path autodiff -------------------------------------
    # max_iter=100 at flagship scale unrolls 100x385 assemblies on the tape;
    # use the measured per-level iteration ceiling (~30) as the reference
    # points do, unless overridden
    fixed_iters = next((int(a) for a in sys.argv[1:] if a.isdigit()), 30)
    vg_fixed = jax.jit(jax.value_and_grad(make_objective("fixed",
                                                         fixed_iters)))
    first_call(vg_fixed, f"fixed({fixed_iters})")
    results["fixed_s"] = time_reps(vg_fixed)
    log(f"fixed steady: {results['fixed_s']:.3f}s")

    # --- 3. two-phase forward + adjoint backward --------------------------
    ss_w = dataclasses.replace(sset, newton="while")

    def two_phase_vg(n):
        g = set_main_roughness(geo, n)
        loss, grads, _ = adjoint.simulate_value_and_grad(
            lambda o: loss_of(o, geo), g, us, ds, h0, Q0, ss_w)
        return loss, jnp.sum(grads[0].n_main)

    first_call(two_phase_vg, "two-phase")
    results["two_phase_s"] = time_reps(two_phase_vg)
    log(f"two-phase steady: {results['two_phase_s']:.3f}s")

    results["speedup_implicit_vs_fixed"] = results["fixed_s"] / results["implicit_s"]
    results["platform"] = device.platform
    results["device_kind"] = device.device_kind
    print(json.dumps(results))


if __name__ == "__main__":
    main()
