"""10^4-scenario Monte-Carlo of the flagship on one device.

Runs a 10,240-member roughness x inflow ensemble of the FULL flagship
gerd_roseires configuration (N=121 nodes, 385 hourly levels, tol 1e-6)
through ``batched_simulate`` (vmap over members, ``chunk_size`` members per
vmapped chunk).  Reports ensemble sims/s and the wall for the whole study;
the reference NumPy solver runs ONE such simulation in ~569 s on a CPU.

Usage: python scripts/bench_montecarlo.py [n_members] [store] [chunk]
  store: "boundaries" (default; hydrograph outputs per member) or "full"
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
    from flowsim_tpu.models.gerd_roseires import model, settings as gsettings
    from flowsim_tpu.parallel.ensemble import (batch_boundaries, batched_simulate,
                                               roughness_ensemble)

    B_total = int(sys.argv[1]) if len(sys.argv) > 1 else 10240
    store = sys.argv[2] if len(sys.argv) > 2 else "boundaries"
    chunk = int(sys.argv[3]) if len(sys.argv) > 3 else 1024

    dev = jax.devices()[0]
    log(f"device: {dev.platform} {dev.device_kind}")
    rng = np.random.default_rng(42)
    with jax.default_device(jax.devices("cpu")[0]):
        solver, channel = model.build()
        sset = dataclasses.replace(
            solver.settings(tolerance=gsettings.tolerance, max_iter=100),
            store=store)
        t0 = time.perf_counter()
        geo_b = roughness_ensemble(channel.geometry,
                                   rng.uniform(0.035, 0.048, B_total))
        ts0 = np.asarray(solver.us_params.target_series)
        us_b, us_axes = batch_boundaries([solver.us_params])
        us_b = dataclasses.replace(
            jax.tree_util.tree_map(
                lambda x: np.broadcast_to(np.asarray(x)[0], (B_total,) + np.shape(x)[1:]),
                us_b),
            target_series=ts0[None, :] * rng.uniform(0.8, 1.2, B_total)[:, None])
        log(f"ensemble build ({B_total} members): {time.perf_counter()-t0:.1f}s")

    def run():
        return batched_simulate(geo_b, us_b, solver.ds_params, solver.h0,
                                solver.Q0, sset, shard=False, us_axes=us_axes,
                                chunk_size=min(chunk, B_total))

    t0 = time.perf_counter()
    out = jax.block_until_ready(run())
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(run())
    wall = time.perf_counter() - t0

    conv = bool(np.asarray(out.converged).all())
    iters = int(np.asarray(out.iterations).sum())
    peak = np.asarray(out.flow)[..., -1].max(axis=1)
    log(f"first call {first:.1f}s, steady {wall:.2f}s, converged={conv}, "
        f"total Newton iters={iters}")
    log(f"downstream peak-flow quantiles [5,50,95]%: "
        f"{np.percentile(peak, [5, 50, 95]).round(1)}")
    print(json.dumps({
        "platform": dev.platform, "device_kind": dev.device_kind,
        "members": B_total, "store": store, "chunk": chunk, "wall_s": wall,
        "first_call_s": first, "sims_per_s": B_total / wall,
        "newton_iters": iters, "converged": conv,
    }))


if __name__ == "__main__":
    main()
