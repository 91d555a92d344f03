"""chip_smoke.py and bench.py on the CPU.

The phase functions of chip_smoke.py run here at small sizes with the CPU
standing in for the card (the comparisons are then exact).  The GPU gate
refuses the CPU, and both scripts exit non-zero without printing a result
when no GPU is visible.  Only the gate's GPU case needs the card; it skips
here.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cpu():
    return jax.devices("cpu")[0]


def test_flagship_phase(cpu):
    res = cs.phase_flagship(cpu, cpu, sim_hours=12, solvers=("thomas", "pcr"),
                            expected_iters=None)
    assert res["iterations"] > 0 and set(res["solver_s"]) == {"thomas", "pcr"}


def test_flagship_phase_checks_expected_iterations(cpu):
    with pytest.raises(cs.PhaseFailure, match="CPU reference total"):
        cs.phase_flagship(cpu, cpu, sim_hours=3, solvers=(), expected_iters=1)


def test_ensemble_phase(cpu):
    assert cs.phase_ensemble(cpu, cpu, n_members=4, sim_hours=6)["members"] == 4


def test_gradient_phase(cpu):
    assert cs.phase_gradient(cpu, cpu, sim_hours=6)["steady_s"] > 0


def test_network_phase(cpu):
    assert cs.phase_network(cpu, cpu, sim_hours=6)["iterations"] > 0


def test_long_reach_phase(cpu):
    assert cs.phase_long_reach(cpu, cpu, n_nodes=2000, levels=2)["steady_s"] > 0


def test_multi_phase_on_virtual_devices():
    devices = jax.devices()[:4]
    assert len(devices) == 4  # conftest forces 8 virtual CPU devices
    cs.phase_multi(devices, n_nodes=2000, levels=2, n_members=8, sim_hours=6)


def test_checks_raise():
    cs.check("x", 1.0, 1.0)
    with pytest.raises(cs.PhaseFailure):
        cs.check("x", 2.0, 1.0)
    with pytest.raises(cs.PhaseFailure):
        cs.require("y", False)


def test_device_gate_refuses_cpu():
    with pytest.raises(cs.PhaseFailure, match="no GPU"):
        cs.phase_device()


@pytest.mark.gpu
def test_device_gate_accepts_gpu():
    if shutil.which("nvidia-smi") is None:
        pytest.skip("no NVIDIA GPU on this machine")
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    code = ("import jax; jax.config.update('jax_enable_x64', True)\n"
            "import chip_smoke as cs\nprint(cs.phase_device().platform)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().endswith("gpu")


def _run_cpu(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable] + args, capture_output=True,
                          text=True, cwd=cwd, env=env, timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_script_fails_without_gpu(script):
    r = _run_cpu([script], REPO)
    assert r.returncode != 0
    for line in r.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_cpu(["chip_smoke.py"], str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
