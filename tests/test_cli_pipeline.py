"""CLI + one-shot pipeline + DAZZ_DB reader tests."""

import os
import subprocess
import sys

import numpy as np
import pytest

from hinge_tpu.data.simulator import SimParams, simulate
from hinge_tpu.io.dazz_db import read_db, write_db
from hinge_tpu.io.fasta import write_fasta
from hinge_tpu.io.las import write_las

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    p = SimParams(genome_len=40_000, coverage=16.0, mean_read_len=4500,
                  std_read_len=900, seed=33)
    genome, reads, rs, ov = simulate(p)
    fasta = str(tmp / "reads.fasta")
    las = str(tmp / "reads.las")
    write_fasta(fasta, ((rs.names[i], rs.get_seq(i)) for i in range(rs.n_reads)))
    write_las(las, ov)
    return dict(tmp=tmp, rs=rs, ov=ov, genome=genome, fasta=fasta, las=las)


def test_dazz_db_roundtrip(dataset, tmp_path):
    rs = dataset["rs"]
    db_path = str(tmp_path / "reads.db")
    write_db(db_path, rs)
    back = read_db(db_path)
    assert back.n_reads == rs.n_reads
    np.testing.assert_array_equal(back.length, rs.length)
    for i in (0, rs.n_reads // 2, rs.n_reads - 1):
        np.testing.assert_array_equal(back.get_bases(i), rs.get_bases(i))
    # qual track round-trips
    assert back.has_qv()
    np.testing.assert_array_equal(back.qv_val, rs.qv_val)


def test_dazz_db_trim(tmp_path, dataset):
    rs = dataset["rs"]
    db_path = str(tmp_path / "cut.db")
    write_db(db_path, rs, cutoff=5000, all_reads=0)
    back = read_db(db_path)
    assert back.n_reads == int((rs.length >= 5000).sum())


def _run_cli(args, cwd):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, "-m", "hinge_tpu.cli"] + args,
        capture_output=True, text=True, cwd=cwd, timeout=600, env=env,
    )
    assert r.returncode == 0, (args, r.stdout[-2000:], r.stderr[-2000:])
    return r.stdout


@pytest.mark.slow
def test_cli_stage_by_stage(dataset):
    tmp = str(dataset["tmp"])
    fasta, las = dataset["fasta"], dataset["las"]
    _run_cli(["filter", "--fasta", fasta, "--las", las, "--prefix", "X"], tmp)
    assert os.path.exists(os.path.join(tmp, "X.mas"))
    _run_cli(["maximal", "--fasta", fasta, "--las", las, "--prefix", "X"], tmp)
    assert os.path.exists(os.path.join(tmp, "X.max"))
    _run_cli(["layout", "--fasta", fasta, "--las", las, "--prefix", "X", "--out", "X"], tmp)
    assert os.path.exists(os.path.join(tmp, "X.edges.hinges"))
    _run_cli(["clip", "X.edges.hinges", "X.hinge.list", "1"], tmp)
    assert os.path.exists(os.path.join(tmp, "X1.G2.graphml"))
    _run_cli(["draft-path", tmp, "X", os.path.join(tmp, "X1.G2.graphml"),
              "--fasta", fasta], tmp)
    assert os.path.exists(os.path.join(tmp, "X.edges.list"))
    _run_cli(["draft", "--fasta", fasta, "--las", las, "--prefix",
              os.path.join(tmp, "X"), "--out", os.path.join(tmp, "X.draft")], tmp)
    draft = os.path.join(tmp, "X.draft.fasta")
    assert os.path.getsize(draft) > 10000
    _run_cli(["correct-head", draft, os.path.join(tmp, "X.draft.pb.fasta"),
              os.path.join(tmp, "draft_map.txt")], tmp)
    _run_cli(["map", draft, "--fasta", fasta, "--out", os.path.join(tmp, "draft.las")], tmp)
    _run_cli(["consensus", draft, fasta, os.path.join(tmp, "draft.las"),
              os.path.join(tmp, "X.consensus.fasta")], tmp)
    assert os.path.getsize(os.path.join(tmp, "X.consensus.fasta")) > 10000
    _run_cli(["gfa", tmp, "X", os.path.join(tmp, "X.consensus.fasta")], tmp)
    gfa = os.path.join(tmp, "X_consensus.gfa")
    content = open(gfa).read()
    assert content.startswith("H\tVN:Z:1.0")
    assert "\nS\t" in content


def test_pipeline_assemble(dataset, tmp_path):
    from hinge_tpu.pipeline import assemble

    res = assemble(
        fasta=dataset["fasta"], las=dataset["las"], workdir=str(tmp_path),
        log=lambda *a: None,
    )
    assert len(res["contigs"]) >= 2
    name, seq = max(res["contigs"], key=lambda c: len(c[1]))
    assert len(seq) > 0.8 * len(dataset["genome"])
    assert os.path.exists(str(tmp_path / "asm_consensus.gfa"))


def test_cli_split_las(dataset, tmp_path):
    import shutil

    las_copy = str(tmp_path / "parts.las")
    shutil.copy(dataset["las"], las_copy)
    _run_cli(["split_las", las_copy, "--max-records", "2000"], str(tmp_path))
    assert os.path.exists(str(tmp_path / "parts.1.las"))


def test_fasta_only_assembly(dataset, tmp_path):
    """Full assembly from FASTA alone: the built-in overlapper replaces the
    external DALIGNER/minimap entirely."""
    from hinge_tpu.pipeline import assemble

    res = assemble(fasta=dataset["fasta"], workdir=str(tmp_path),
                   log=lambda *a: None)
    assert len(res["contigs"]) >= 2
    name, seq = max(res["contigs"], key=lambda c: len(c[1]))
    assert len(seq) > 0.7 * len(dataset["genome"])


def test_cli_clip_nanopore(dataset):
    """clip-nanopore: the nanopore pruning profile (bubble 20 + dead-end 20,
    pruning_and_clipping_nanopore.py:1466-1467) through the CLI."""
    tmp = str(dataset["tmp"])
    # reuse the stage outputs from test_cli_stage_by_stage (module fixture
    # ordering guarantees X.edges.hinges exists after that test ran)
    import os
    if not os.path.exists(os.path.join(tmp, "X.edges.hinges")):
        fasta, las = dataset["fasta"], dataset["las"]
        _run_cli(["filter", "--fasta", fasta, "--las", las, "--prefix", "X"], tmp)
        _run_cli(["maximal", "--fasta", fasta, "--las", las, "--prefix", "X"], tmp)
        _run_cli(["layout", "--fasta", fasta, "--las", las, "--prefix", "X",
                  "--out", "X"], tmp)
    _run_cli(["clip-nanopore", "X.edges.hinges", "X.hinge.list", "np"], tmp)
    assert os.path.exists(os.path.join(tmp, "Xnp.G2.graphml"))


def test_hinge_dispatcher(tmp_path):
    """bin/hinge maps the reference's verb surface (src/hinge:8-58) onto
    the CLI: unknown verbs exit 1 with the hinge(1) pointer, known verbs
    dispatch (checked via --help exit 0 for every mapped verb)."""
    import subprocess
    import sys

    hinge = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "bin", "hinge")
    r = subprocess.run([sys.executable, hinge], capture_output=True, text=True)
    assert r.returncode == 1 and "hinge(1)" in r.stderr
    r = subprocess.run([sys.executable, hinge, "no-such-verb"],
                       capture_output=True, text=True)
    assert r.returncode == 1
    for verb in ("filter", "maximal", "layout", "clip", "clip-nanopore",
                 "draft-path", "draft", "correct-head", "consensus",
                 "fasta2q", "gfa", "visualize", "visualise", "condense",
                 "split_las"):
        r = subprocess.run([sys.executable, hinge, verb, "--help"],
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, (verb, r.stderr[-400:])
