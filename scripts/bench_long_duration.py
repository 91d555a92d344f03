"""Year-long hourly simulation of the flagship reach on the default device.

A full year of hourly levels (nt=8761) of the flagship reach — 22.8x the
reference case's duration — through the default XLA path, cross-checked
for convergence, iteration counts and fields against the CPU float64
block-Thomas run in the same process.

Forcing: the 384 h GERD release hydrograph repeated with a +-10% seasonal
modulation (a synthetic wet/dry cycle) so every level has realistic
dynamics; downstream the standard smooth Roseires rating curve.

Usage: python scripts/bench_long_duration.py [n_years_hours]
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
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from flowsim_tpu.models.gerd_roseires import model, settings as gsettings
    from flowsim_tpu.ops import preissmann as prs
    from flowsim_tpu.utils.profiling import timed

    hours = int(sys.argv[1]) if len(sys.argv) > 1 else 8760

    dev = jax.devices()[0]
    log(f"device: {dev.platform} {dev.device_kind}")
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        solver, channel = model.build()
        base = solver.settings(tolerance=gsettings.tolerance, max_iter=100)
        geo = solver.channel.geometry

        # year-long forcing: tile the 384 h release table with a slow
        # seasonal modulation; same downstream rating params
        ts0 = np.asarray(solver.us_params.target_series)
        nt = hours + 1
        tiled = np.tile(ts0, -(-nt // len(ts0)))[:nt]
        season = 1.0 + 0.1 * np.sin(2 * np.pi * np.arange(nt) / nt)
        us = dataclasses.replace(solver.us_params,
                                 target_series=jnp.asarray(tiled * season))
        sset = dataclasses.replace(base, n_time_levels=nt)
        args = (geo, us, solver.ds_params, solver.h0, solver.Q0)

        t0 = time.perf_counter()
        ref = prs.simulate(*args, dataclasses.replace(sset, linear_solver="thomas"))
        ref_iters = int(np.asarray(ref.iterations).sum())
        log(f"CPU f64 thomas: {time.perf_counter()-t0:.1f}s  iters={ref_iters}")

    args = jax.device_put(args, dev)
    t0 = time.perf_counter()
    jax.block_until_ready(prs.simulate(*args, sset))
    log(f"compile+first: {time.perf_counter()-t0:.1f}s ({sset.linear_solver})")
    wall, _, out = timed(lambda: prs.simulate(*args, sset), reps=2)

    iters = int(np.asarray(out.iterations).sum())
    conv = bool(np.asarray(out.converged).all())
    dd = float(np.abs(np.asarray(out.depth) - np.asarray(ref.depth)).max())
    it_ident = bool((np.asarray(out.iterations)
                     == np.asarray(ref.iterations)).all())
    log(f"steady: {wall:.2f}s  iters={iters}  identical={it_ident} "
        f"conv={conv}  max|dh|={dd:.2e} m")
    print(json.dumps({
        "platform": dev.platform, "device_kind": dev.device_kind,
        "levels": nt, "wall_s": wall, "newton_iters": iters,
        "iters_identical_to_cpu": it_ident, "converged": conv,
        "max_dh_m": dd, "newton_node_updates_per_s": 121 * iters / wall,
    }))


if __name__ == "__main__":
    main()
