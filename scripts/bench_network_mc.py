"""Network Monte-Carlo benchmark: vmapped stacked vs loop engines.

Two workloads (SURVEY.md §2.17 DP analog; ref n_calibrate.py:58-62 is a
serial full-resimulation sweep):

* ``tributary``: the flagship GERD tributary network (3 branches, 385
  levels) with per-member inflow scaling — long-duration few-branch
  Monte-Carlo;
* ``basin``: the dendritic basin (15 branches, 25 levels) with per-member
  headwater inflow scaling — many-branch short-duration Monte-Carlo.

Each mode first checks a few members' per-level iteration counts against
serial CPU float64 loop-engine runs, then reports network-sims/s for both
engines (median of ``reps`` runs ended by ``block_until_ready``):

    python scripts/bench_network_mc.py [tributary|basin] [M]
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


def _scale_us(branches, scales):
    """Batch overrides: per-member inflow scaling on every external
    flow-hydrograph upstream end."""
    import jax
    import jax.numpy as jnp

    from flowsim_tpu.ops.network import _is_junction

    batch = []
    for br in branches:
        if (not _is_junction(br.us)
                and br.us.kind == "flow_hydrograph"):
            series = np.asarray(br.us.target_series, np.float64)
            us_b = jax.vmap(lambda s, _se=jnp.asarray(series), _us=br.us:
                            dataclasses.replace(_us, target_series=_se * s))(
                jnp.asarray(scales))
            batch.append(dict(us=us_b))
        else:
            batch.append(dict())
    return batch


def _member_branches(branches, scale):
    import jax.numpy as jnp

    from flowsim_tpu.ops.network import _is_junction

    return [dataclasses.replace(br, us=dataclasses.replace(
                br.us, target_series=jnp.asarray(
                    np.asarray(br.us.target_series, np.float64) * scale)))
            if not _is_junction(br.us) and br.us.kind == "flow_hydrograph"
            else br for br in branches]


def run(mode="tributary", M=None, reps=3):
    import jax

    jax.config.update("jax_enable_x64", True)  # flagship f64 semantics
    from flowsim_tpu.ops.network import simulate_network
    from flowsim_tpu.parallel.ensemble import batched_simulate_network
    from flowsim_tpu.utils.profiling import timed

    dev = jax.devices()[0]
    log(f"device: {dev.device_kind} ({dev.platform})")
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        if mode == "tributary":
            from flowsim_tpu.models import gerd_tributary

            branches, nj, sset, _ = gerd_tributary.build()
            M = M or 32
        else:
            from flowsim_tpu.models import basin

            branches, nj, sset = basin.build(levels=4, sim_hours=24)
            M = M or 256
    n_nodes = sum(int(np.asarray(br.h0).shape[0]) for br in branches)
    log(f"{mode}: B={len(branches)} J={nj} nodes={n_nodes} "
        f"nt={sset.n_time_levels} M={M} {sset.linear_solver}")
    scales = 0.9 + 0.2 * np.random.default_rng(0).random(M)
    batch = _scale_us(branches, scales)
    results = dict(mode=mode, M=M, platform=dev.platform,
                   device_kind=dev.device_kind)
    for engine in ("stacked", "loop"):
        sim = lambda: batched_simulate_network(branches, nj, sset, batch,
                                               engine=engine)
        t0 = time.perf_counter()
        out = jax.block_until_ready(sim())
        first = time.perf_counter() - t0
        wall, _, _ = timed(sim, reps=reps)
        results[engine] = dict(first_s=first, steady_s=wall, sims_per_s=M / wall)
        log(f"{engine}: first={first:.2f}s steady={wall:.4f}s "
            f"-> {M / wall:.1f} network-sims/s")

    Mv = min(M, 4)
    same = True
    with jax.default_device(cpu):
        ref_set = dataclasses.replace(sset, linear_solver="thomas")
        for m in range(Mv):
            ref = simulate_network(_member_branches(branches, scales[m]), nj,
                                   ref_set, engine="loop")
            same &= bool(np.array_equal(np.asarray(out.iterations)[m],
                                        np.asarray(ref.iterations)))
    results["same_iters_as_serial_cpu"] = same
    results["converged"] = bool(np.asarray(out.converged).all())
    log(f"validate M={Mv} vs serial CPU f64 loop: same_iters={same}")
    print(json.dumps(results))


if __name__ == "__main__":
    mode = sys.argv[1] if len(sys.argv) > 1 else "tributary"
    M = int(sys.argv[2]) if len(sys.argv) > 2 else None
    run(mode, M)
