"""Analysis / small-tool utilities: N50, unitigs, longest path,
fasta2fastq, clip-ends, bandage, condense-gfa, pileup drawing."""

import os
import subprocess
import sys

import numpy as np
import pytest

from hinge_tpu.graph.digraph import DiGraph
from hinge_tpu.graph.analysis import (
    comp_n50, longest_path, n50_from_fasta, unitigs, write_unitig_edges,
)


def _ref_comp_n50(contig_vec):
    """Literal transcription of compute_n50_from_draft.py:8-27 (quadratic)."""
    if len(contig_vec) == 0:
        return 0
    sorted_lengths = sorted(contig_vec)
    total_length = sum(contig_vec)
    half_length = 0.5 * total_length
    min_n50 = sorted_lengths[-1]
    max_n50 = 0
    for i in range(len(sorted_lengths)):
        sum_1 = sum(sorted_lengths[0 : i + 1])
        sum_2 = sum(sorted_lengths[i:])
        if sum_1 >= half_length and sum_2 >= half_length:
            min_n50 = min(sorted_lengths[i], min_n50)
            max_n50 = max(sorted_lengths[i], max_n50)
    return 0.5 * (min_n50 + max_n50)


def test_comp_n50_matches_reference_oracle():
    rng = np.random.default_rng(3)
    for _ in range(40):
        n = int(rng.integers(0, 12))
        vec = [int(x) for x in rng.integers(1, 100, n)]
        assert comp_n50(vec) == _ref_comp_n50(vec), vec


def test_unitigs_paths_and_cycle():
    g = DiGraph()
    # chain a->b->c->d with a branch at c, plus an isolated 3-cycle
    g.add_edges_from([("a", "b"), ("b", "c"), ("c", "d"), ("c", "e")])
    g.add_edges_from([("x", "y"), ("y", "z"), ("z", "x")])
    paths = unitigs(g)
    path_sets = {tuple(p) for p in paths}
    assert ("a", "b", "c") in path_sets
    assert ("c", "d") in path_sets
    assert ("c", "e") in path_sets
    cyc = [p for p in paths if p[0] == p[-1]]
    assert len(cyc) == 1 and set(cyc[0]) == {"x", "y", "z"}


def test_write_unitig_edges(tmp_path):
    g = DiGraph()
    attrs = dict(read_a_start_raw=0, read_a_end_raw=100,
                 read_b_start_raw=50, read_b_end_raw=150)
    g.add_edge("1_0", "2_1", **attrs)
    g.add_edge("2_1", "B3_0", **attrs)
    g.add_edge("B3_0", "4_0", **attrs)
    g.add_edge("B3_0", "5_0", **attrs)
    out = str(tmp_path / "u.edges.list")
    n = write_unitig_edges(g, out)
    text = open(out).read()
    assert n >= 2 and ">Unitig0" in text
    # B prefix stripped, weight = -0+100-50+150 = 200
    assert "3 0" in text and " 200 0 100 50 150" in text


def test_longest_path_dag():
    g = DiGraph()
    g.add_edges_from([("a", "b"), ("b", "c"), ("c", "d"), ("a", "d")])
    assert longest_path(g) == ["a", "b", "c", "d"]


def test_fasta2fastq_and_n50(tmp_path):
    from hinge_tpu.io.fasta import fasta_to_fastq

    fa = tmp_path / "x.fasta"
    fa.write_text(">r1\nACGT\n>r2\nACGTACGT\n")
    fq = str(tmp_path / "x.fastq")
    assert fasta_to_fastq(str(fa), fq) == 2
    lines = open(fq).read().splitlines()
    assert lines[0] == "@r1" and lines[1] == "ACGT"
    assert lines[3] == "I" * 4  # phred 40 -> chr(73)
    stats = n50_from_fasta(str(fa))
    assert stats["total_bases"] == 12


def test_clip_ends(tmp_path):
    from hinge_tpu.utils.smalltools import clip_ends

    gt = tmp_path / "gt.txt"
    # read 0 near chr start, read 1 interior, read 2 near chr end (chr len 100k)
    gt.write_text("0 1 1000 6000\n1 1 40000 45000\n2 1 95000 99000\n"
                  "3 1 99000 100000\n")
    edges = tmp_path / "g.edges"
    edges.write_text("0 1 x\n1 2 x\n1 1 y\n")
    out = str(tmp_path / "g.edges.clipped")
    kept = clip_ends(str(gt), str(edges), out)
    assert kept == 1
    assert open(out).read() == "1 1 y\n"


def test_bandage_file(tmp_path):
    from hinge_tpu.utils.smalltools import create_bandage_file

    edges = tmp_path / "g.edges"
    edges.write_text("1 2\n2 3\n3 1\n")
    out = str(tmp_path / "g.bandage")
    assert create_bandage_file(str(edges), out) == 3
    text = open(out).read()
    assert text.count("NODE") == 3 and text.count("ARC") == 3


def test_condense_gfa_n50(tmp_path):
    from hinge_tpu.graph.condense import condense_gfa_n50

    edges = tmp_path / "c.edges"
    # a 6-cycle; cols: a b weight d4 d5 d6 [a0 a1] [b0 b1]
    rows = []
    names = [str(i) for i in range(6)]
    for i in range(6):
        a, b = names[i], names[(i + 1) % 6]
        rows.append(f"{a} {b} 2000 x x x x [0 5000] [0 5000]\n")
    edges.write_text("".join(rows))
    n50, g = condense_gfa_n50(str(edges), out_prefix=str(tmp_path / "c"))
    # merges collapse the cycle; total length accounting stays positive
    assert len(g) >= 1 and n50 > 0
    assert os.path.exists(str(tmp_path / "c.condensed.graphml"))
    assert os.path.exists(str(tmp_path / "c.bandage"))


def test_draw_pileup(tmp_path, small_sim):
    from hinge_tpu.utils.draw import plot_pileup

    out = str(tmp_path / "p.png")
    n = plot_pileup(small_sim["overlaps"], small_sim["read_store"], 0, out)
    assert n > 0 and os.path.getsize(out) > 1000


def test_cli_n50_and_unitig(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.dirname(os.path.dirname(__file__)))
    fa = tmp_path / "x.fasta"
    fa.write_text(">r1\nACGT\n>r2\nACGTACGT\n")
    r = subprocess.run(
        [sys.executable, "-m", "hinge_tpu.cli", "n50", str(fa)],
        capture_output=True, text=True, env=env,
    )
    assert r.returncode == 0 and "contig_n50" in r.stdout
