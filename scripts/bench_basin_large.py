"""Large-basin stress benchmark.

A dendritic binary-tree basin at 511-1023 branches / ~10^5 total nodes
(models/basin.py scaled via ``levels`` and ``link_nodes``) run on the
stacked engine, the one built for many-branch networks.  Reports branches / junctions / nodes, compile and
steady wall, Newton iterations, and node-update throughput as one JSON
line.

Run from the repo root:
    python scripts/bench_basin_large.py [levels] [link_nodes] [cpu]
defaults: levels=9 (511 branches, 255 junctions), link_nodes=197
(~100,667 nodes), 6 simulated hours at dt=900 s.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    args = [a for a in sys.argv[1:]]
    force_cpu = "cpu" in args
    nums = [int(a) for a in args if a.isdigit()]
    levels = nums[0] if nums else 9
    link_nodes = nums[1] if len(nums) > 1 else 197

    import jax

    if force_cpu:
        jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    from flowsim_tpu.utils import compile_cache

    compile_cache.enable()

    from flowsim_tpu.models import basin
    from flowsim_tpu.ops.network import simulate_network
    from flowsim_tpu.utils.profiling import timed

    device = jax.devices()[0]
    log(f"device: {device.platform} {device.device_kind}")

    with jax.default_device(jax.devices("cpu")[0]):
        branches, nj, sset = basin.build(levels=levels, sim_hours=6,
                                         time_step=900.0,
                                         link_nodes=link_nodes)
    n_nodes = sum(int(np.asarray(b.h0).shape[0]) for b in branches)
    log(f"basin: {len(branches)} branches, {nj} junctions, "
        f"{n_nodes} nodes, nt={sset.n_time_levels}, {sset.linear_solver}")

    run = lambda: simulate_network(branches, nj, sset, engine="stacked")
    t0 = time.perf_counter()
    jax.block_until_ready(run())
    compile_s = time.perf_counter() - t0
    log(f"compile+first run: {compile_s:.1f}s")
    best, _, out = timed(run, reps=2)

    iters = int(np.asarray(out.iterations).sum())
    conv = bool(np.asarray(out.converged).all())
    nnups = n_nodes * iters / best
    log(f"steady: {best:.2f}s converged={conv} iters={iters} "
        f"({nnups:.3g} newton-node-updates/s)")
    print(json.dumps(dict(
        branches=len(branches), junctions=nj, nodes=n_nodes,
        nt=sset.n_time_levels, compile_s=compile_s, steady_s=best,
        newton_iters=iters, converged=conv, nnups=nnups,
        platform=device.platform, device_kind=device.device_kind)))


if __name__ == "__main__":
    main()
