"""chip_smoke.py and bench.py measure the GPU or nothing: without a card
they exit non-zero and print no result line.  On a machine with a card,
`python -m pytest -m gpu tests/` runs chip_smoke.py itself."""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd, env_extra=None, timeout=600):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.update(env_extra or {})
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("where", ["checkout", "script_alone"])
def test_chip_smoke_refuses_without_gpu(where, tmp_path):
    if where == "checkout":
        cwd = REPO
    else:
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    r = _run(["chip_smoke.py"], cwd)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "FAILED" in r.stdout


def test_bench_refuses_without_gpu():
    r = _run(["bench.py"], REPO, {"HINGE_BENCH_BUDGET": "120"})
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "no GPU" in r.stderr


@pytest.mark.gpu
def test_chip_smoke_on_the_card(gpu):
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=1500)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"
