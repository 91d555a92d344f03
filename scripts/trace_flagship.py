"""Profile one flagship run on the GPU and reduce the trace to launch metrics.

    python scripts/trace_flagship.py [--solvers pcr,thomas] [--out DIR]

For each linear solver: build gerd_roseires (N=121, 385 levels, tol 1e-6,
float64), warm the executable up, then trace one ``prs.simulate`` run with
``jax.profiler`` inside a ``TraceAnnotation("flagship_run")`` window.  The
reduction (:func:`reduce_trace`) reads the ``.xplane.pb`` with
``jax.profiler.ProfileData`` and reports, over that window:

* kernel launches (device events that are not copies or memsets), in total
  and per Newton iteration;
* device->host copies (the while-loop predicate read-backs among them), in
  total and per Newton iteration;
* device busy time (union of all device event intervals) and the idle
  share, 1 - busy / window;
* the kernels that launch most often.

One JSON file per solver goes to ``--out`` (default
``chiprun_out/trace_flagship``); the raw trace is deleted unless ``--keep``.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import glob
import json
import os
import shutil
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

WINDOW = "flagship_run"


def _union_ns(intervals):
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _is_copy(name: str) -> bool:
    n = name.lower()
    return "memcpy" in n or "memset" in n


def _is_d2h(name: str) -> bool:
    n = name.lower().replace(" ", "")
    return "memcpy" in n and ("dtoh" in n or "d2h" in n)


def reduce_trace(profile, n_iters: int, window: str = WINDOW) -> dict:
    """Launch and idle metrics of the device planes inside ``window``.

    ``profile``: a ``jax.profiler.ProfileData``.  Device planes are those
    named ``/device:GPU:*``; their stream lines (``Stream ...``) hold one
    event per kernel or copy.  Derived summary lines (``XLA Ops`` and the
    like) are skipped so nothing counts twice.
    """
    host = [e for p in profile.planes if p.name.startswith("/host")
            for l in p.lines for e in l.events if e.name == window]
    if not host:
        raise ValueError(f"no host span named {window!r} in the trace")
    w0 = min(e.start_ns for e in host)
    w1 = max(e.end_ns for e in host)
    kernels, d2h, intervals = 0, 0, []
    counts = collections.Counter()
    lines_seen = []
    for p in profile.planes:
        if not p.name.startswith("/device:GPU"):
            continue
        for l in p.lines:
            lines_seen.append(f"{p.name}/{l.name}")
            if not l.name.lower().startswith("stream"):
                continue
            for e in l.events:
                if e.end_ns < w0 or e.start_ns > w1:
                    continue
                intervals.append((max(e.start_ns, w0), min(e.end_ns, w1)))
                if _is_d2h(e.name):
                    d2h += 1
                elif not _is_copy(e.name):
                    kernels += 1
                    counts[e.name] += 1
    window_ns = w1 - w0
    busy_ns = _union_ns(intervals)
    return dict(
        window_s=window_ns * 1e-9, device_busy_s=busy_ns * 1e-9,
        idle_share=1.0 - busy_ns / window_ns if window_ns else None,
        kernel_launches=kernels, kernels_per_newton_iteration=kernels / n_iters,
        d2h_copies=d2h, d2h_per_newton_iteration=d2h / n_iters,
        newton_iterations=n_iters,
        top_kernels=counts.most_common(15), device_lines=lines_seen)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--solvers", default="pcr,thomas")
    ap.add_argument("--out", default=os.path.join("chiprun_out", "trace_flagship"))
    ap.add_argument("--keep", action="store_true", help="keep the raw trace")
    args = ap.parse_args(argv)

    import jax
    import numpy as np

    jax.config.update("jax_enable_x64", True)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"needs a GPU; jax.devices()[0] is {dev.platform}", file=sys.stderr)
        return 2
    from jax.profiler import ProfileData, TraceAnnotation

    from flowsim_tpu.models.gerd_roseires import model
    from flowsim_tpu.ops import preissmann as prs
    from flowsim_tpu.utils import compile_cache

    compile_cache.enable()
    with jax.default_device(jax.devices("cpu")[0]):
        solver, channel = model.build()
        base = solver.settings(tolerance=1e-6, max_iter=100)
    args_dev = jax.device_put((channel.geometry, solver.us_params,
                               solver.ds_params, solver.h0, solver.Q0), dev)
    os.makedirs(args.out, exist_ok=True)
    for name in args.solvers.split(","):
        sset = dataclasses.replace(base, linear_solver=name)
        out = jax.block_until_ready(prs.simulate(*args_dev, sset))  # compile
        n_iters = int(np.asarray(out.iterations).sum())
        raw = os.path.join(args.out, f"raw_{name}")
        shutil.rmtree(raw, ignore_errors=True)
        jax.profiler.start_trace(raw)
        t0 = time.perf_counter()
        with TraceAnnotation(WINDOW):
            jax.block_until_ready(prs.simulate(*args_dev, sset))
        wall = time.perf_counter() - t0
        jax.profiler.stop_trace()
        path = glob.glob(os.path.join(raw, "plugins", "profile", "*", "*.xplane.pb"))[0]
        res = reduce_trace(ProfileData.from_file(path), n_iters)
        res.update(solver=name, traced_wall_s=wall, device_kind=dev.device_kind)
        with open(os.path.join(args.out, f"{name}.json"), "w") as f:
            json.dump(res, f, indent=1)
        if not args.keep:
            shutil.rmtree(raw)
        print(json.dumps({k: v for k, v in res.items() if k != "device_lines"}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
