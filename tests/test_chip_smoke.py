"""chip_smoke.py: refusal without a GPU, and the CLI phases at tiny sizes
on the CPU (the same checks the card runs at full size)."""
import os
import shutil
import subprocess
import sys

import conftest  # noqa: F401
import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_alone(script, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_refuses_without_gpu(tmp_path):
    r = _run_alone(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "not a GPU" in r.stderr


def test_refuses_outside_the_repo(tmp_path):
    script = shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_alone(script, tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_phase_codeml_tiny(tmp_path):
    lnls = chip_smoke.phase_codeml(str(tmp_path), ns=5, ncodon=40)
    assert sorted(lnls) == [0, 1, 2]
    assert lnls[2] >= lnls[1] - 1e-6 and lnls[1] >= lnls[0] - 1e-6


def test_phase_baseml_tiny(tmp_path):
    lnl = chip_smoke.phase_baseml(str(tmp_path), ns=5, nsite=200)
    assert lnl < 0
