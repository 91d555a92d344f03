"""Profiling / observability helpers.

The reference's only observability is print-based verbose levels and a final
TXT summary (ref: preissmann.py:116-159, solver.py:187-233; SURVEY.md §5).
Here:

* :func:`trace` — context manager around ``jax.profiler`` emitting a
  TensorBoard/Perfetto-loadable trace of the compiled solver;
* :func:`timed` — wall-clock timing that ends each repetition in
  ``jax.block_until_ready`` (JAX returns before the device finishes);
* :class:`StepLogger` — per-level iteration/error logging equivalent to the
  reference's verbose>=2 output, fed from SimOutput after the fact (logging
  inside the scan would force host syncs every level).
"""

from __future__ import annotations

import contextlib
import time

import numpy as np


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed work into ``logdir`` (``jax.profiler``)."""
    import jax

    jax.profiler.start_trace(logdir, create_perfetto_trace=True)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def timed(fn, *args, reps: int = 3, **kw):
    """``(median_seconds, times, last_result)`` over ``reps`` calls.

    Each repetition is timed on the host clock up to
    ``jax.block_until_ready`` of the whole output pytree.
    """
    import jax

    times = []
    out = None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args, **kw))
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), times, out


class StepLogger:
    """Post-hoc per-level log lines matching the reference's verbose output
    (ref preissmann.py:116-117,151-159)."""

    def __init__(self, verbose: int = 1):
        self.verbose = verbose

    def report(self, output) -> None:
        if self.verbose < 1:
            return
        iters = np.asarray(output.iterations)
        errs = np.asarray(output.error)
        for k in range(1, len(iters)):
            if self.verbose >= 1:
                print(f"\n> Time level #{k}")
            if self.verbose >= 2:
                print(f">> {int(iters[k])} iterations.")
            if self.verbose >= 3:
                print(f">> Error = {errs[k]}")
