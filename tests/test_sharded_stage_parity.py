"""Stage-FILE byte parity under mesh sharding.

HINGE_SHARDED=1 routes the filter profiles (record scatter + psum/pmax),
the per-(A,B) top-k (--mlas boundary partitioning), and the layout
GetMatchingPosition queries through the 8-virtual-device mesh.  Every
stage output file must byte-match the single-device run — the collectives
are integer and associative, so sharding must be invisible in the files.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import pytest

from hinge_tpu.data.simulator import SimParams, simulate
from hinge_tpu.io.fasta import write_fasta
from hinge_tpu.io.las import write_las

STAGE_FILES = [
    "X.mas", "X.cmas", "X.repeat.txt", "X.hinges.txt", "X.cov.flag",
    "X.self.flag", "X.coverage.txt",
    "X.max", "X.contained.txt",
    "X.edges.hinges", "X.edges.hinges2", "X.hinge.list",
]


def _run_stages(tmp, fasta, las, sharded: bool):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    if sharded:
        env["HINGE_SHARDED"] = "1"
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                            + " --xla_force_host_platform_device_count=8").strip()
    else:
        env.pop("HINGE_SHARDED", None)
    for args in (
        ["filter", "--fasta", fasta, "--las", las, "--prefix", "X"],
        ["maximal", "--fasta", fasta, "--las", las, "--prefix", "X"],
        ["layout", "--fasta", fasta, "--las", las, "--prefix", "X",
         "--out", "X"],
    ):
        r = subprocess.run(
            [sys.executable, "-m", "hinge_tpu.cli"] + args,
            capture_output=True, text=True, cwd=tmp, timeout=900, env=env,
        )
        assert r.returncode == 0, (args, r.stdout[-1500:], r.stderr[-1500:])


@pytest.mark.slow
def test_stage_files_byte_equal_under_sharding(tmp_path):
    p = SimParams(genome_len=40_000, coverage=16.0, mean_read_len=4500,
                  std_read_len=900, seed=33)
    genome, reads, rs, ov = simulate(p)
    fasta = str(tmp_path / "reads.fasta")
    las = str(tmp_path / "reads.las")
    write_fasta(fasta, ((rs.names[i], rs.get_seq(i))
                        for i in range(rs.n_reads)))
    write_las(las, ov)

    d1 = tmp_path / "single"
    d8 = tmp_path / "mesh8"
    d1.mkdir()
    d8.mkdir()
    _run_stages(str(d1), fasta, las, sharded=False)
    _run_stages(str(d8), fasta, las, sharded=True)

    for name in STAGE_FILES:
        f1, f8 = d1 / name, d8 / name
        assert f1.exists(), f"missing single-device {name}"
        assert f8.exists(), f"missing sharded {name}"
        assert f1.read_bytes() == f8.read_bytes(), f"{name} differs"


@pytest.mark.slow
def test_e2e_assemble_byte_equal_under_sharding(tmp_path):
    """Full assemble() (fasta -> consensus fasta + gfa) under HINGE_SHARDED=1
    on the 8-virtual-device mesh, byte-diffed against the single-device run
    (VERDICT r3 #7)."""
    p = SimParams(genome_len=60_000, coverage=15.0, mean_read_len=4500,
                  std_read_len=900, seed=7)
    genome, reads, rs, ov = simulate(p)
    fasta = str(tmp_path / "reads.fasta")
    write_fasta(fasta, ((rs.names[i], rs.get_seq(i))
                        for i in range(rs.n_reads)))

    outs = {}
    for tag, sharded in (("single", False), ("mesh8", True)):
        d = tmp_path / tag
        d.mkdir()
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        if sharded:
            env["HINGE_SHARDED"] = "1"
            env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                                + " --xla_force_host_platform_device_count=8").strip()
        else:
            env.pop("HINGE_SHARDED", None)
        r = subprocess.run(
            [sys.executable, "-m", "hinge_tpu.cli", "assemble",
             "--fasta", fasta, "--workdir", str(d)],
            capture_output=True, text=True, cwd=str(d), timeout=900, env=env,
        )
        assert r.returncode == 0, (tag, r.stdout[-1500:], r.stderr[-1500:])
        outs[tag] = d

    for name in ("asm.consensus.fasta", "asm_consensus.gfa"):
        b1 = (outs["single"] / name).read_bytes()
        b8 = (outs["mesh8"] / name).read_bytes()
        assert b1 == b8, f"{name} differs under sharding"
