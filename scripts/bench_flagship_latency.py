"""Flagship-latency decomposition: where a Newton iteration's time goes.

The full gerd run is one jit: scan over 384 levels x while_loop Newton
(4,803 iterations total, N=121), far too little arithmetic per iteration
to fill a GPU.  This script chains K data-dependent repetitions of each
stage inside a single jit (so launch and host overheads of the outer call
amortize away) and reports microseconds per repetition:

  a. assemble-only      — residual + Jacobian stencil
  b. solve-only         — the block-tridiagonal solve (settings' solver)
  c. assemble+solve     — one full Newton iteration body
  d. chained-noop floor — scan of trivial chained vector ops (loop overhead)
  e. end-to-end simulate for each solver (cross-check a+b against it)

Each time is the median of 3 runs ended by ``block_until_ready``.
Usage: python scripts/bench_flagship_latency.py [K]
"""

import dataclasses
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from flowsim_tpu.models.gerd_roseires import model, settings as gsettings
    from flowsim_tpu.ops import boundary as bnd
    from flowsim_tpu.ops import preissmann as prs
    from flowsim_tpu.ops import tridiag
    from flowsim_tpu.utils.profiling import timed

    K = int(sys.argv[1]) if len(sys.argv) > 1 else 4800

    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        solver, channel = model.build()
        sset = solver.settings(tolerance=gsettings.tolerance, max_iter=100)
        geo = solver.channel.geometry
    dev = jax.devices()[0]
    log(f"device: {dev.platform} {dev.device_kind}; K={K}; "
        f"linear_solver={sset.linear_solver}")

    geo_d, us_d, ds_d, h0_d, Q0_d = jax.device_put(
        (geo, solver.us_params, solver.ds_params, solver.h0, solver.Q0), dev
    )

    def median_of(fn, *args):
        jax.block_until_ready(fn(*args))  # compile
        return timed(fn, *args, reps=3)[0]

    bc0 = bnd.initial_bc_state(h0_d.dtype, gate_open=0.0,
                               gate_stage=ds_d.bed_level + h0_d[-1])
    karr = jnp.asarray(1)

    # (a) assemble-only: chain h,Q through a tiny function of the outputs
    @jax.jit
    def assemble_loop(h, Q):
        prev = prs.prev_level_state(geo_d, h, Q)

        def body(c, _):
            h, Q = c
            L, D, U, b, err, rs, _ = prs.assemble(
                geo_d, us_d, ds_d, sset, prev, h, Q, karr,
                bc0.reservoir_stage, bc0)
            use = jnp.sum(L) + jnp.sum(D) + jnp.sum(U)
            return (h + 1e-30 * b[:, 0] + 1e-30 * err,
                    Q + 1e-30 * b[:, 1] + 1e-30 * use), None

        (h, Q), _ = jax.lax.scan(body, (h, Q), None, length=K)
        return h + Q

    # (b) solve-only: fixed system, chained rhs
    with jax.default_device(cpu):
        prev0 = prs.prev_level_state(geo, solver.h0, solver.Q0)
        L0, D0, U0, b0, _, _, _ = prs.assemble(
            geo, solver.us_params, solver.ds_params, sset, prev0,
            solver.h0, solver.Q0, jnp.asarray(1),
            jnp.asarray(jnp.nan, solver.h0.dtype),
            bnd.initial_bc_state(solver.h0.dtype, gate_open=0.0,
                                 gate_stage=solver.ds_params.bed_level + solver.h0[-1]))
    L0, D0, U0, b0 = jax.device_put((L0, D0, U0, b0), dev)

    @jax.jit
    def solve_loop(L, D, U, b):
        def body(c, _):
            x = tridiag.solve_block_tridiag(L, D, U, c,
                                            method=sset.linear_solver)
            return b + 1e-30 * x, None

        c, _ = jax.lax.scan(body, b, None, length=K)
        return c

    # (c) full Newton iteration body (assemble + solve), chained
    @jax.jit
    def newton_body_loop(h, Q):
        prev = prs.prev_level_state(geo_d, h, Q)

        def body(c, _):
            h, Q = c
            L, D, U, b, err, rs, _ = prs.assemble(
                geo_d, us_d, ds_d, sset, prev, h, Q, karr,
                bc0.reservoir_stage, bc0)
            delta, _ = prs._solve_with_diag(L, D, U, b, sset)
            return (h + 1e-30 * delta[:, 0], Q + 1e-30 * delta[:, 1]), None

        (h, Q), _ = jax.lax.scan(body, (h, Q), None, length=K)
        return h + Q

    # (d) chained-noop floor: same scan length, trivial body
    @jax.jit
    def noop_loop(h):
        def body(c, _):
            return c * 1.0000000001 + 1e-30, None

        c, _ = jax.lax.scan(body, h, None, length=K)
        return c


    results = {}
    for name, fn, args in [
        ("noop_floor", noop_loop, (h0_d,)),
        ("assemble_only", assemble_loop, (h0_d, Q0_d)),
        ("solve_only", solve_loop, (L0, D0, U0, b0)),
        ("newton_body", newton_body_loop, (h0_d, Q0_d)),
    ]:
        t = median_of(fn, *args)
        per_iter_us = t / K * 1e6
        results[name] = dict(wall_s=t, per_iter_us=per_iter_us)
        log(f"{name}: {t:.3f}s total, {per_iter_us:.1f} us/iter")

    # (e) end-to-end simulate for each solver
    for method in ("pcr", "pcr_f32"):
        s = dataclasses.replace(sset, linear_solver=method)
        t = median_of(lambda: prs.simulate(geo_d, us_d, ds_d, h0_d, Q0_d, s))
        out = prs.simulate(geo_d, us_d, ds_d, h0_d, Q0_d, s)
        iters = int(np.asarray(out.iterations).sum())
        conv = bool(np.asarray(out.converged).all())
        results[f"end_to_end_{method}"] = dict(
            wall_s=t, iters=iters, converged=conv, per_iter_us=t / iters * 1e6)
        log(f"end_to_end[{method}]: {t:.3f}s, {iters} iters "
            f"(converged={conv}), {t/iters*1e6:.1f} us/iter")
    results["platform"] = dev.platform
    results["device_kind"] = dev.device_kind
    print(json.dumps(results))


if __name__ == "__main__":
    main()
