"""Device-mesh helpers.

The reference is single-process NumPy with no parallelism (SURVEY.md §2.17).
flowsim_tpu scales on two axes:

* ``ensemble`` — independent scenarios (calibration sweeps, Monte-Carlo
  roughness/inflow ensembles): batched with vmap, sharded across chips.
* ``space``    — the channel-node axis for long reaches: shard_map domain
  decomposition with halo exchange (see parallel/domain.py).

The mesh is topology-free: on a GPU host every card reaches every other at
the same rate (NVLink, all to all), and XLA hands the collectives to NCCL, so
the mesh shape follows the algorithm alone.  The axes are declared here once
so all modules agree on names.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

ENSEMBLE_AXIS = "ensemble"
SPACE_AXIS = "space"


def make_mesh(n_ensemble: int = None, n_space: int = None, devices=None) -> Mesh:
    """Mesh over the available devices.

    Defaults: all devices on the ensemble axis.  ``n_ensemble * n_space``
    must cover the device count when both given.
    """
    devices = np.asarray(jax.devices() if devices is None else devices)
    n = devices.size
    if n_ensemble is None and n_space is None:
        n_ensemble, n_space = n, 1
    elif n_ensemble is None:
        n_ensemble = n // n_space
    elif n_space is None:
        n_space = n // n_ensemble
    if n_ensemble * n_space != n:
        raise ValueError(f"{n_ensemble} x {n_space} != {n} devices")
    return Mesh(devices.reshape(n_ensemble, n_space), (ENSEMBLE_AXIS, SPACE_AXIS))


def ensemble_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(ENSEMBLE_AXIS))


def space_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(SPACE_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
