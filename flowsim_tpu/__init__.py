"""flowsim_tpu — a JAX open-channel hydrodynamics framework for GPUs.

A ground-up JAX/XLA re-design of the capabilities of the reference
``cve-mohd/flow-sim`` package (1-D Saint-Venant river hydraulics):

* struct-of-arrays geometry pytrees instead of per-node Python objects
  (ref: ``src/hydromodel/cross_section.py``),
* vectorized pure-function hydraulic closures (ref: ``src/hydromodel/hydraulics.py``),
* a Preissmann implicit box-scheme solver whose Newton iteration assembles the
  residual + block-tridiagonal Jacobian as one fused stencil and solves it with
  parallel cyclic reduction (ref: ``src/hydromodel/preissmann.py`` uses per-node
  Python loops + ``scipy.sparse.linalg.spsolve``),
* a Lax-Friedrichs explicit solver (ref: ``src/hydromodel/lax.py``),
* five boundary-condition types, rating curves, hydrographs and 0-D lumped
  reservoir storage (ref: ``boundary.py``, ``rating_curve.py``,
  ``hydrograph.py``, ``lumped_storage.py``),
* ensemble (vmap/pjit) and channel-axis (shard_map) scale-out, which the
  reference does not have.
"""

from flowsim_tpu.config import default_dtype, set_default_dtype
from flowsim_tpu.geometry import (
    TrapezoidGeometry,
    TableGeometry,
    build_trapezoid_geometry,
    trapezoid_station,
    interpolate_stations,
)
from flowsim_tpu.geometry_tables import IrregularStation, build_table_geometry
from flowsim_tpu.api import (
    Boundary,
    Channel,
    Hydrograph,
    Junction,
    LumpedStorage,
    NetworkSolver,
    RatingCurve,
    PreissmannSolver,
    LaxSolver,
)

__version__ = "0.1.0"
