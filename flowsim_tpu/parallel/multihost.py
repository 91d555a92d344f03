"""Multi-host (multi-process) distributed runtime.

The reference is single-process NumPy with no communication backend at all
(SURVEY.md §2.17); flowsim_tpu scales out with JAX collectives: within a GPU
host the cards are joined all to all (NVLink), across hosts by the network.
This module provides the multi-host half:

* :func:`initialize` — ``jax.distributed`` wiring.  Pass the coordinator
  address (host:port), ``num_processes`` and ``process_id`` explicitly
  (nothing auto-detects a cluster); the test suite launches 2 CPU processes
  this way and checks equality with single-process, see
  tests/test_multihost.py.
* :func:`make_multihost_mesh` — mesh over the *global* device set: devices
  enumerate process-major, so laying the ``space`` axis fastest keeps a
  channel shard's halo neighbors on the same host wherever possible — only
  the shard pairs straddling a host boundary cross the network, and the
  SPIKE reduced all-gather is the single unavoidable cross-host collective
  per Newton iteration.
* :func:`replicate_to_host` — gather a (possibly non-addressable) global
  array pytree into ordinary host NumPy on every process.

All collectives in parallel/domain.py (`ppermute` halos, `all_gather` reduced
system, `psum` norms) are standard XLA collectives, which the runtime routes
over NVLink or the network transparently once the global mesh spans hosts.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from flowsim_tpu.parallel.mesh import ENSEMBLE_AXIS, SPACE_AXIS

_initialized_here = False  # idempotence fallback when the private API moves


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids=None) -> None:
    """Join the distributed runtime (idempotent).

    Pass ``coordinator_address`` (host:port), ``num_processes`` and
    ``process_id`` explicitly; without a cluster environment
    ``jax.distributed.initialize()`` cannot find them itself.
    """
    global _initialized_here
    if is_initialized():
        return
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    if local_device_ids is not None:
        kwargs["local_device_ids"] = local_device_ids
    jax.distributed.initialize(**kwargs)
    _initialized_here = True


def is_initialized() -> bool:
    try:
        from jax._src.distributed import global_state

        return global_state.client is not None
    except Exception:  # pragma: no cover - private API moved
        # MUST NOT touch jax.process_count() here: it initializes the
        # backends, which both breaks a subsequent
        # jax.distributed.initialize() ('must be called before any JAX
        # computations') and, on a cluster, would bring the backend up
        # single-host.  Fall back to our own bookkeeping.
        return _initialized_here


def make_multihost_mesh(n_ensemble: Optional[int] = None,
                        n_space: Optional[int] = None) -> Mesh:
    """(ensemble, space) mesh over the global device set.

    Global devices are ordered process-major, so with the space axis varying
    fastest a block of consecutive space shards lives on one host: halo
    ``ppermute`` traffic stays within a host except at host boundaries.  When
    ``n_ensemble >= process_count`` each host holds whole ensemble members
    and the space axis never crosses hosts at all.
    """
    from flowsim_tpu.parallel.mesh import make_mesh

    # same factorization logic as the single-host mesh builder, over the
    # GLOBAL process-major device list (one source of truth — the bodies
    # had already started drifting when this was a verbatim copy)
    return make_mesh(n_ensemble, n_space, devices=jax.devices())


def host_local_view(tree, mesh: Mesh, specs):
    """Place identical host values as global sharded arrays on the mesh.

    Every process must pass the same host values (the usual case here:
    geometry/ICs are built identically on each process).
    """
    def put(x, spec):
        return jax.device_put(x, NamedSharding(mesh, spec))

    return jax.tree_util.tree_map(put, tree, specs)


import functools


@functools.lru_cache(maxsize=8)
def _replicator(mesh: Mesh):
    # one cached jitted identity per mesh: a fresh jax.jit(lambda ...) per
    # leaf per call keeps its own trace cache, re-compiling the replicating
    # all-gather for every leaf of every call
    return jax.jit(lambda a: a, out_shardings=NamedSharding(mesh, P()))


def replicate_to_host(tree, mesh: Mesh):
    """Fully replicate global arrays and return host NumPy on every process.

    Works on outputs that are not fully addressable per process (e.g. the
    space-sharded field histories of ``simulate_sharded``).
    """
    rep_fn = _replicator(mesh)

    def rep(x):
        if not isinstance(x, jax.Array):
            return np.asarray(x)
        return np.asarray(rep_fn(x))

    return jax.tree_util.tree_map(rep, tree)


def shutdown() -> None:
    if is_initialized():
        jax.distributed.shutdown()
