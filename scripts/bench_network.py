"""River-network solver benchmark: the GERD tributary network (3 branches,
1 junction, flagship geometry/duration) on the default device.

Run: ``python scripts/bench_network.py [hours]``  (default: the flagship
384 h), or ``python scripts/bench_network.py chain [B]`` for loop vs
stacked engines on a B-branch chain.  Steady numbers are the median of
the repetitions, each ended by ``block_until_ready``.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run(hours=384, reps=3, engine="stacked"):
    import jax

    from flowsim_tpu.models import gerd_tributary
    from flowsim_tpu.ops.network import simulate_network
    from flowsim_tpu.utils.profiling import timed

    dev = jax.devices()[0]
    print(f"device: {dev.device_kind} ({dev.platform})")

    t0 = time.perf_counter()
    with jax.default_device(jax.devices("cpu")[0]):
        branches, nj, sset, _ = gerd_tributary.build(sim_duration=3600 * hours)
    print(f"engine={engine} linear_solver={sset.linear_solver}")
    n_nodes = sum(int(np.asarray(br.h0).shape[0]) for br in branches)
    print(f"host build: {time.perf_counter() - t0:.1f}s  branches=3 junctions=1 "
          f"nodes={n_nodes} nt={sset.n_time_levels}")

    sim = lambda: simulate_network(branches, nj, sset, engine=engine)
    t0 = time.perf_counter()
    out = jax.block_until_ready(sim())
    iters = int(np.asarray(out.iterations).sum())
    print(f"compile+first run: {time.perf_counter() - t0:.1f}s  "
          f"converged={bool(np.asarray(out.converged).all())}  iters={iters}")
    wall, _, _ = timed(sim, reps=reps)
    nnups = iters * n_nodes / wall
    print(f"steady (median of {reps}): {wall:.4f}s  "
          f"newton-node-updates/s: {nnups:,.0f}")
    return wall, iters, n_nodes


def chain_branches(B):
    """A B-branch chain of 15-node akbari-like links sharing junction
    elevations (consecutive links continue the bed profile)."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from flowsim_tpu.models import akbari_firoozi as ak
    from flowsim_tpu.ops import initial_conditions as ic
    from flowsim_tpu.ops.network import BranchDef

    solver, _ = ak.build()
    geo = solver.channel.geometry
    seg = jax.tree_util.tree_map(lambda x: x[:15], geo)
    drop = float(np.asarray(seg.z_bed)[0] - np.asarray(seg.z_bed)[-1])
    brs = []
    for i in range(B):
        g = dataclasses.replace(seg, z_bed=seg.z_bed - i * drop)
        h0, Q0 = ic.initial_conditions(g, "steady-state",
                                       float(solver.Q0[0]), solver.spatial_step)
        us = solver.us_params if i == 0 else i - 1
        ds = (dataclasses.replace(
                  solver.ds_params,
                  bed_level=jnp.asarray(np.asarray(g.z_bed)[-1]))
              if i == B - 1 else i)
        brs.append(BranchDef(geo=g, dx=solver.spatial_step, us=us, ds=ds,
                             h0=h0, Q0=Q0))
    sset = solver.settings(tolerance=1e-8, max_iter=100)
    return brs, B - 1, sset


def run_chain(B=16, levels=25, reps=3):
    """loop vs stacked engines on a B-branch chain."""
    import dataclasses

    import jax

    from flowsim_tpu.ops.network import simulate_network
    from flowsim_tpu.utils.profiling import timed

    dev = jax.devices()[0]
    print(f"device: {dev.device_kind} ({dev.platform})  chain B={B}")
    brs, nj, sset = chain_branches(B)
    sset = dataclasses.replace(sset, n_time_levels=levels)
    for eng in ("loop", "stacked"):
        sim = lambda: simulate_network(brs, nj, sset, engine=eng)
        t0 = time.perf_counter()
        jax.block_until_ready(sim())
        tc = time.perf_counter() - t0
        wall, _, out = timed(sim, reps=reps)
        print(f"{eng:8s} compile+first {tc:6.1f}s  steady {wall:7.4f}s  "
              f"iters {int(np.asarray(out.iterations).sum())}  "
              f"converged {bool(np.asarray(out.converged).all())}")


if __name__ == "__main__":
    args = [a for a in sys.argv[1:]]
    if args and args[-1] == "cpu":
        import jax

        jax.config.update("jax_platforms", "cpu")
        args = args[:-1]
    import jax

    jax.config.update("jax_enable_x64", True)
    if args and args[0] == "chain":
        run_chain(int(args[1]) if len(args) > 1 else 16)
    else:
        run(int(args[0]) if args else 384)
