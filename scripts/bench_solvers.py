"""Device timing of the block-tridiagonal solvers at long-reach sizes.

K independent solves (each with its own scaled right-hand side, so XLA
cannot merge them) run inside ONE jitted scan; the wall clock up to
``block_until_ready`` is divided by K, which amortizes the launch and
host overheads out of the per-solve number.

Usage: python scripts/bench_solvers.py [validate|bench|all]
Writes one JSON line to stdout; progress to stderr.
"""

import functools
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def make_system(N, seed=0):
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    L = rng.normal(size=(N, 2, 2)) * 0.3
    L[0] = 0.0
    D = rng.normal(size=(N, 2, 2)) + 6 * np.eye(2)
    U = rng.normal(size=(N, 2, 2)) * 0.3
    U[-1] = 0.0
    b = rng.normal(size=(N, 2))
    return tuple(map(jnp.asarray, (L, D, U, b)))


def amortized_time(method, L, D, U, b, K):
    """(median seconds per solve over 3 runs, first-call seconds)."""
    import jax
    import jax.numpy as jnp

    from flowsim_tpu.ops import tridiag
    from flowsim_tpu.utils.profiling import timed

    fn = functools.partial(tridiag.solve_block_tridiag, method=method)

    @jax.jit
    def many(L, D, U, b):
        def body(acc, i):
            x = fn(L, D, U, b * (1.0 + 1e-6 * i.astype(b.dtype)))
            return acc + jnp.sum(x), None

        acc, _ = jax.lax.scan(body, jnp.zeros((), b.dtype), jnp.arange(1, K + 1))
        return acc

    t0 = time.perf_counter()
    jax.block_until_ready(many(L, D, U, b))
    first = time.perf_counter() - t0
    wall, _, _ = timed(many, L, D, U, b, reps=3)
    return wall / K, first


def validate(device):
    import jax
    import jax.numpy as jnp

    from flowsim_tpu.ops import tridiag

    out = {}
    for N in [10_000, 100_000]:
        sys_ = jax.device_put(make_system(N), device)
        x_ref = tridiag.block_thomas(*sys_)
        for method in ("pcr", "pcr_f32"):
            x = tridiag.solve_block_tridiag(*sys_, method=method)
            rel = float(jnp.max(jnp.abs(x - x_ref)) / jnp.max(jnp.abs(x_ref)))
            out[f"{N}/{method}"] = rel
            log(f"validate N={N}: {method} vs block Thomas max rel diff {rel:.3e}")
    return out


def bench(device):
    import jax

    results = []
    cases = [(10_000, ("thomas", "pcr", "pcr_f32"), 20),
             (100_000, ("pcr", "pcr_f32"), 20),
             (1_000_000, ("pcr", "pcr_f32"), 5)]
    for N, methods, K in cases:
        sys_ = jax.device_put(make_system(N), device)
        for method in methods:
            per_solve, first = amortized_time(method, *sys_, K)
            rec = dict(N=N, method=method, per_solve_s=per_solve,
                       solves_per_s=1.0 / per_solve, first_call_s=first, K=K)
            results.append(rec)
            log(f"N={N} {method}: {per_solve*1e3:.3f} ms/solve "
                f"(first call {first:.1f} s)")
    return results


def main():
    what = sys.argv[1] if len(sys.argv) > 1 else "all"
    import jax

    jax.config.update("jax_enable_x64", True)
    dev = jax.devices()[0]
    log(f"device: {dev.platform} {dev.device_kind}")
    payload = {"platform": dev.platform, "device_kind": dev.device_kind}
    if what in ("validate", "all"):
        payload["validate"] = validate(dev)
    if what in ("bench", "all"):
        payload["bench"] = bench(dev)
    print(json.dumps(payload))


if __name__ == "__main__":
    main()
