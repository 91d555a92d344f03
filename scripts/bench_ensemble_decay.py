"""Ensemble batch scaling: throughput, synchronized Newton and output size.

A vmapped ``lax.while_loop`` runs every level until its slowest member has
converged, so the executed iterations per level are max_B(iters) while the
useful ones are mean_B(iters).  For each batch size and each output mode
(``store="full"``, [B, nt, N] fields, and ``store="boundaries"``,
[B, nt, 2]) this reports sims/s and the executed-vs-useful iteration ratio,
which separates the algorithmic cost of synchronized Newton from memory
effects of the stacked outputs.

Workload: a 256-node long-reach roughness ensemble, 24 levels, f64.
Usage: python scripts/bench_ensemble_decay.py [batch ...]
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
    from flowsim_tpu.models import long_reach
    from flowsim_tpu.parallel.ensemble import batched_simulate, roughness_ensemble
    from flowsim_tpu.utils.profiling import timed

    batches = [int(a) for a in sys.argv[1:]] or [512, 2048, 8192, 16384]
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        geo, us, ds, h0, Q0, sset = long_reach.build(256, levels=24)
    dev = jax.devices()[0]
    log(f"device: {dev.platform} {dev.device_kind}")

    results = {}
    for batch in batches:
        with jax.default_device(cpu):
            geo_b = roughness_ensemble(geo, np.linspace(0.02, 0.06, batch))
        geo_b = jax.device_put(geo_b, dev)
        for store in ("full", "boundaries"):
            s = dataclasses.replace(sset, store=store)
            run = lambda: batched_simulate(geo_b, us, ds, h0, Q0, s, shard=False)
            jax.block_until_ready(run())
            wall, _, out = timed(run, reps=3)
            iters = np.asarray(out.iterations)  # [B, nt]
            executed = int(iters.max(axis=0).sum())
            useful = float(iters.sum() / batch)
            results[f"{batch}/{store}"] = dict(
                wall_s=wall, sims_per_s=batch / wall, iters_executed=executed,
                iters_useful_mean=useful, sync_ratio=executed / max(useful, 1e-9))
            log(f"batch={batch} store={store}: {wall:.4f}s -> "
                f"{batch / wall:.0f} sims/s; executed iters {executed} vs mean "
                f"useful {useful:.1f}")
    print(json.dumps(dict(platform=dev.platform, device_kind=dev.device_kind,
                          results=results)))


if __name__ == "__main__":
    main()
