"""2-process jax.distributed test: the sharded filter step's collectives
(psum/pmax/all_gather) crossing a real process boundary on the CPU backend
(2 virtual devices per process, 4 global).  SURVEY.md §4's multi-host test
requirement; exercises parallel/distributed.py's init path for real.

A CPU-only harness: both processes pin the CPU backend (two JAX processes
on one GPU would each try to reserve most of its memory).
"""

import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "multihost_worker.py")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_sharded_filter():
    port = _free_port()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["PYTHONPATH"] = REPO
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(i), "2", str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=REPO, env=env,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multihost worker timed out")
        outs.append((p.returncode, out, err))
    for i, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"worker {i}: {err[-2000:]}"
        assert f"MULTIHOST_OK {i}/2 devices=4" in out, out
