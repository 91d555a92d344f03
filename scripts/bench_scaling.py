"""Scaling benchmarks beyond the flagship config.

1. Long-reach stress: N = 1e4..1e6 nodes (models/long_reach.py), one
   device, f64, newton-node-updates/s (the channel axis the reference
   cannot scale; SURVEY.md §5).
2. Monte-Carlo ensemble: vmapped roughness scenarios, sims/s.
3. Domain-decomposition scaling over 1 -> 8 shards on the virtual CPU mesh
   (a correctness-and-overhead check; chip_smoke.py --multi runs the
   sharded path on four GPUs).

Usage: python scripts/bench_scaling.py [longreach|ensemble|ddscale|all]
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if __name__ == "__main__" and (len(sys.argv) < 2 or sys.argv[1] in ("ddscale", "all")):
    # dd scaling needs the virtual multi-device CPU mesh
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def bench_longreach():
    import jax

    from flowsim_tpu.models import long_reach
    from flowsim_tpu.ops import preissmann as prs
    from flowsim_tpu.utils.profiling import timed

    results = {}
    for n in [10_000, 100_000, 1_000_000]:
        with jax.default_device(jax.devices("cpu")[0]):
            geo, us, ds, h0, Q0, sset = long_reach.build(n)
        args = jax.device_put((geo, us, ds, h0, Q0), jax.devices()[0])
        t0 = time.perf_counter()
        jax.block_until_ready(prs.simulate(*args, sset))
        compile_s = time.perf_counter() - t0
        wall, _, out = timed(lambda: prs.simulate(*args, sset), reps=3)
        iters = int(np.asarray(out.iterations).sum())
        nnups = n * iters / wall
        results[n] = dict(wall_s=wall, iters=iters, newton_node_updates_per_s=nnups,
                          compile_s=compile_s, linear_solver=sset.linear_solver)
        log(f"long-reach N={n}: {wall:.4f}s, {iters} iters, "
            f"{nnups:.3e} newton-node-updates/s ({sset.linear_solver}, f64)")
    return results


def bench_ensemble():
    import jax

    from flowsim_tpu.models import long_reach
    from flowsim_tpu.parallel.ensemble import batched_simulate, roughness_ensemble
    from flowsim_tpu.utils.profiling import timed

    with jax.default_device(jax.devices("cpu")[0]):
        geo, us, ds, h0, Q0, sset = long_reach.build(256, levels=24)
    results = {}
    for batch in [64, 512, 4096]:
        with jax.default_device(jax.devices("cpu")[0]):
            geo_b = roughness_ensemble(geo, np.linspace(0.02, 0.06, batch))
        run = lambda: batched_simulate(geo_b, us, ds, h0, Q0, sset, shard=False)
        t0 = time.perf_counter()
        jax.block_until_ready(run())
        compile_s = time.perf_counter() - t0
        wall, _, _ = timed(run, reps=3)
        results[batch] = dict(wall_s=wall, sims_per_s=batch / wall,
                              compile_s=compile_s)
        log(f"ensemble batch={batch}: {wall:.4f}s -> {batch / wall:.1f} sims/s "
            f"(24 levels x 256 nodes each)")
    return results


def bench_ddscale():
    """Domain-decomposition scaling on the virtual CPU mesh."""
    import jax

    from flowsim_tpu.models import long_reach
    from flowsim_tpu.ops import preissmann as prs
    from flowsim_tpu.parallel.domain import simulate_sharded
    from flowsim_tpu.parallel.mesh import make_mesh
    from flowsim_tpu.utils.profiling import timed

    cpus = jax.devices("cpu")
    with jax.default_device(cpus[0]):
        geo, us, ds, h0, Q0, sset = long_reach.build(65536, levels=4,
                                                     linear_solver="pcr")
    results = {}
    base = None
    for shards in [1, 2, 4, 8]:
        if shards == 1:
            f = lambda: prs.simulate(geo, us, ds, h0, Q0, sset)
        else:
            mesh = make_mesh(n_ensemble=1, n_space=shards, devices=cpus[:shards])
            f = lambda: simulate_sharded(geo, us, ds, h0, Q0, sset, mesh)
        with jax.default_device(cpus[0]):
            jax.block_until_ready(f())
            el, _, _ = timed(f, reps=1)
        eff = None if base is None else base / (el * shards)
        if shards == 1:
            base = el
        results[shards] = dict(wall_s=el, efficiency=eff)
        log(f"dd shards={shards}: {el:.3f}s  efficiency={eff}")
    return results


if __name__ == "__main__":
    what = sys.argv[1] if len(sys.argv) > 1 else "all"
    import jax

    jax.config.update("jax_enable_x64", True)
    out = {"platform": jax.devices()[0].platform,
           "device_kind": jax.devices()[0].device_kind}
    if what in ("longreach", "all"):
        out["longreach"] = bench_longreach()
    if what in ("ensemble", "all"):
        out["ensemble"] = bench_ensemble()
    if what in ("ddscale", "all"):
        out["ddscale"] = bench_ddscale()
    print(json.dumps(out, indent=1, default=float))
