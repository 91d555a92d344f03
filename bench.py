"""Benchmark: Newton-Preissmann throughput on the flagship GERD config, on a GPU.

Prints ONE JSON line on stdout:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "device": {...}}

Workload: the gerd_roseires standard configuration (N=121 nodes, 384 hourly
levels, theta=0.6, tol=1e-6, float64) through the default XLA path with the
backend's default linear solver.  The run must converge at every level with
the CPU float64 path's Newton total (4,803); otherwise the bench fails.

Metric: newton-node-updates/s = n_nodes * total_Newton_iterations / wall_s,
wall_s the median of 3 steady runs, each ended by ``block_until_ready``
(compile reported separately on stderr).  ``vs_baseline`` divides it by the
same metric of the NumPy/SciPy reference solver measured on a CPU
(scripts/measure_reference_baseline.py -> scripts/reference_baseline.json).

With no GPU visible it exits non-zero and prints no number.  Stderr carries
the card's name and power limit, compile time and iteration counts.
"""

import json
import os
import subprocess
import sys
import time

FLAGSHIP_ITERS = 4803


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main() -> int:
    import jax

    jax.config.update("jax_enable_x64", True)
    device = jax.devices()[0]
    if device.platform != "gpu":
        log(f"bench.py needs a GPU; jax.devices()[0] is {device.platform}")
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    log(f"card: {card.splitlines()[0]}")

    import numpy as np

    from flowsim_tpu.models.gerd_roseires import model, settings
    from flowsim_tpu.ops import preissmann as prs
    from flowsim_tpu.utils import compile_cache
    from flowsim_tpu.utils.profiling import timed

    log(f"compile cache: {compile_cache.enable()}")
    # host setup (station interpolation, GERD routing, initial conditions)
    # is many small eager ops: run it on the CPU; the simulate runs on the GPU
    t0 = time.perf_counter()
    with jax.default_device(jax.devices("cpu")[0]):
        solver, channel = model.build()
        sset = solver.settings(tolerance=settings.tolerance, max_iter=100)
    args = jax.device_put(
        (channel.geometry, solver.us_params, solver.ds_params, solver.h0,
         solver.Q0), device)
    log(f"host build: {time.perf_counter() - t0:.3f} s  N={solver.number_of_nodes} "
        f"nt={solver.number_of_time_levels}  linear_solver={sset.linear_solver}")

    t0 = time.perf_counter()
    out = jax.block_until_ready(prs.simulate(*args, sset))
    log(f"compile+first run: {time.perf_counter() - t0:.3f} s")
    wall, times, out = timed(lambda: prs.simulate(*args, sset), reps=3)

    iters = int(np.asarray(out.iterations).sum())
    converged = bool(np.asarray(out.converged).all())
    n = solver.number_of_nodes
    log(f"steady: {wall:.4f} s (runs {', '.join(f'{t:.4f}' for t in times)})  "
        f"converged={converged}  newton_iters={iters}")
    if not converged or iters != FLAGSHIP_ITERS:
        log(f"FAIL: expected convergence with {FLAGSHIP_ITERS} iterations")
        return 1
    nnups = n * iters / wall

    baseline_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "scripts", "reference_baseline.json")
    with open(baseline_path) as f:
        base = json.load(f)
    vs = nnups / base["newton_node_updates_per_s"]
    log(f"NumPy reference on a CPU: {base['newton_node_updates_per_s']:.1f} "
        f"newton-node-updates/s ({base['wall_s']:.1f} s, "
        f"{base['newton_iterations']} iters)")

    print(json.dumps({
        "metric": "newton-node-updates/s (gerd_roseires, f64, tol=1e-6)",
        "value": nnups,
        "unit": "node-updates/s",
        "vs_baseline": vs,
        "device": {"platform": device.platform, "kind": device.device_kind,
                   "count": 1},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
