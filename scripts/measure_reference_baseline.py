"""Measure the reference CPU baseline on the gerd_roseires flagship config.

Runs the mounted reference (read-only) in-process with the standard settings
(N~121 nodes, 385 levels, theta=0.6, tol=1e-6) and records wall time plus the
number of Newton iterations (counted by wrapping spsolve, called once per
iteration; ref preissmann.py:146).  Results feed bench.py.
"""
import json
import os
import sys
import time

sys.path.insert(0, "/root/reference")

# reference hardcodes Windows-style relative paths; run from a cwd with
# literal backslash-named symlinks
os.chdir("/tmp/refrun")

import numpy as np
import scipy.sparse.linalg as spla

calls = {"spsolve": 0}
_orig = spla.spsolve

def counting_spsolve(*a, **k):
    calls["spsolve"] += 1
    return _orig(*a, **k)

spla.spsolve = counting_spsolve
import src.hydromodel.preissmann as ref_prs
ref_prs.spla.spsolve = counting_spsolve

from cases.gerd_roseires import model

t0 = time.time()
out = model.run(Q=np.array([1562.5]), verbose=0, folder=None)  # full 384 h config
elapsed = time.time() - t0

n_nodes = 121
n_levels = 384
result = dict(
    case="gerd_roseires full (384h, dt=3600, theta=0.6, tol=1e-6)",
    wall_s=elapsed,
    newton_iterations=calls["spsolve"],
    n_nodes=n_nodes,
    levels_solved=n_levels,
    node_level_updates_per_s=n_nodes * n_levels / elapsed,
    newton_node_updates_per_s=n_nodes * calls["spsolve"] / elapsed,
)
print(json.dumps(result))
with open("/root/repo/scripts/reference_baseline.json", "w") as f:
    json.dump(result, f, indent=1)
