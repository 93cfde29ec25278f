"""Test configuration: run JAX on a virtual 8-device CPU mesh so sharding
tests work without accelerator hardware (and CI stays hermetic)."""

import os
import shutil
import subprocess

# Pin the CPU backend before anything imports jax: jax.config.update below
# works as long as no backend has been initialized yet.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from hinge_tpu.data.simulator import SimParams, simulate  # noqa: E402


@pytest.fixture
def gpu():
    """Skip unless an NVIDIA card is visible.  Decided when a test asks for
    it, never at import: every xdist worker must collect the same tests."""
    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run([smi, "-L"], capture_output=True).returncode:
        pytest.skip("no NVIDIA GPU visible (nvidia-smi -L)")


@pytest.fixture(scope="session")
def small_sim():
    """A small error-free circular genome with one exact repeat."""
    p = SimParams(
        genome_len=60_000,
        coverage=20.0,
        mean_read_len=5000,
        std_read_len=1200,
        repeats=((5_000, 35_000, 3_000),),
        seed=7,
    )
    genome, reads, rs, ov = simulate(p)
    return dict(params=p, genome=genome, reads=reads, read_store=rs, overlaps=ov)


@pytest.fixture(scope="session")
def noisy_sim():
    """Reads with indel+substitution errors (tests trace-point machinery)."""
    p = SimParams(
        genome_len=40_000,
        coverage=15.0,
        mean_read_len=4000,
        std_read_len=800,
        sub_rate=0.01,
        ins_rate=0.005,
        del_rate=0.005,
        seed=11,
    )
    genome, reads, rs, ov = simulate(p)
    return dict(params=p, genome=genome, reads=reads, read_store=rs, overlaps=ov)
