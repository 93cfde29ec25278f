"""merge_hinges (alternative hinge-merged post-processing) + single-strand
utilities."""

import json

import networkx as nx
import numpy as np
import pytest

from hinge_tpu.graph.digraph import DiGraph
from hinge_tpu.graph.merge_hinges import (
    build_hinge_mapping,
    build_merged_graph,
    dead_end_clipping,
    merge_a_to_b,
    merge_hinges_run,
    random_condensation,
    read_hinge_sets,
    z_clipping,
)
from hinge_tpu.io.fasta import select_single_strand


def _chain(g, nodes):
    for u, v in zip(nodes, nodes[1:]):
        g.add_edge(u, v)


def test_dead_end_clipping_removes_short_spur():
    g = DiGraph()
    _chain(g, ["a", "b", "c", "d", "e", "f"])  # backbone
    g.add_edge("x", "c")  # 1-node in-spur
    _chain(g, ["d", "y1", "y2"])  # 2-node out-spur
    h = dead_end_clipping(g, 1)
    # the 1-node spur goes; the 2-node spur exceeds threshold 1 and stays
    assert "x" not in h
    assert "y1" in h and "y2" in h
    # backbone arms are length 2 (a,b / f,e) > threshold, so they survive
    assert all(n in h for n in "abcdef")


def test_dead_end_clipping_keeps_long_spur():
    g = DiGraph()
    _chain(g, ["a", "b", "c", "d", "e", "f", "g2", "h2"])
    _chain(g, ["s1", "s2", "s3", "s4", "c"])
    h = dead_end_clipping(g, 3)
    assert "s1" in h and "s4" in h


def _z_graph():
    # backbone a->b->c->d->e (too long to clip at threshold 1);
    # z-edge b->z into z which also takes w->z: classic Z at both ends
    g = DiGraph()
    _chain(g, ["a", "b", "c", "d", "e"])
    g.add_edge("b", "z")
    g.add_edge("w", "z")
    g.add_edge("z", "t")  # keep z alive as a through node
    return g


def test_z_clipping_removes_short_z_edge():
    h = z_clipping(_z_graph(), 1, set(), set())
    assert not h.has_edge("b", "z")
    assert h.has_edge("b", "c") and h.has_edge("w", "z")


def test_z_clipping_respects_hinges():
    # b is an out-hinge: its extra out-edges are legitimate repeat structure;
    # z as an in-hinge also blocks clipping from the end side
    h = z_clipping(_z_graph(), 1, {"z"}, {"b"})
    assert h.has_edge("b", "z")


def test_merge_a_to_b_redirects_edges():
    g = DiGraph()
    g.add_edge("p", "a")
    g.add_edge("a", "s")
    g.add_edge("x", "b")
    merge_a_to_b(g, "a", "b")
    assert "a" not in g
    assert g.has_edge("p", "b") and g.has_edge("b", "s")
    assert g.edges["p", "b"]["hinge_edge"] == 1


def test_random_condensation_shrinks_clean_paths():
    g = DiGraph()
    _chain(g, [str(i) for i in range(40)])
    for u, v in g.edges():
        g.edges[u, v]["false_positive"] = 0
    out = random_condensation(g, 10, seed=3)
    assert out.number_of_nodes() <= 12
    # false positives block merging
    g2 = DiGraph()
    _chain(g2, [str(i) for i in range(20)])
    for u, v in g2.edges():
        g2.edges[u, v]["false_positive"] = 1
    out2 = random_condensation(g2, 5, seed=3)
    assert out2.number_of_nodes() == 20


def test_read_hinge_sets_strand_convention():
    in_h, out_h = read_hinge_sets(["7 1200 1", "9 300 -1"])
    assert "7_0" in in_h and "7_1" in out_h
    assert "9_1" in in_h and "9_0" in out_h


def test_build_hinge_mapping_sink_selection():
    # chain of 11 reads hinge-matched pairwise: each strand is its own
    # 11-node weak component (> 10, so it gets a mapping)
    lines = [f"{i} {i+1} 100 100 1 0" for i in range(10)]
    hinge_list = [f"{i} 100 1" for i in range(11)]
    g, mapping = build_hinge_mapping(lines, hinge_list, {})
    assert g.number_of_nodes() == 22
    # strand-0 chain sink is 10_0_100 (out-degree 0, active==2)
    assert mapping["0_0_100"] == "10_0_100"
    assert g.nodes["10_0_100"]["active"] == 3
    # strand-1 edges run the same direction (rev=0): sink 10_1_100
    assert mapping["0_1_100"] == "10_1_100"
    # small components (<=10) get no mapping: separate 4-node component
    g2, mapping2 = build_hinge_mapping(["50 51 7 7 1 1"], [], {})
    assert mapping2 == {}
    assert all(d.get("active") == -1 for _, d in g2.nodes(data=True))


def test_build_merged_graph_collapses_hinged_edges():
    # hinge component: reads 1..11 all hinge-connected at pos 100 so the
    # component is >10 nodes; sink = last in chain
    hgraph = [f"{i} {i+1} 100 100 1 0" for i in range(1, 11)]
    hinge_list = [f"{i} 100 1" for i in range(1, 12)]
    _, mapping = build_hinge_mapping(hgraph, hinge_list, {})
    sink = mapping["2_0_100"]
    # one hinged edge 0->2 (forward-internal onto B=2's hinge at 100); the
    # sink read 11 must itself be in the string graph for the merge to apply
    # (merge_a_to_b returns early otherwise, merge_hinges.py:122-123)
    edges = [
        "0 2 5000 0 0 1 100 [0 1] [0 1] [0 1] [0 1]",
        "11 12 4500 0 0 0 -1 [0 1] [0 1] [0 1] [0 1]",
        "20 21 4000 0 0 0 -1 [0 1] [0 1] [0 1] [0 1]",
    ]
    G = build_merged_graph(edges, mapping)
    sink_node = "_".join(sink.split("_")[:2])
    # 2_0 was merged into the sink: edge 0_0 -> sink exists, 2_0 gone
    assert "2_0" not in G or sink_node == "2_0"
    assert G.has_edge("0_0", sink_node)
    # unhinged edges untouched
    assert G.has_edge("20_0", "21_0") and G.has_edge("21_1", "20_1")


@pytest.fixture(scope="module")
def layout_files(tmp_path_factory):
    from hinge_tpu.config import nominal_config
    from hinge_tpu.data.simulator import SimParams, simulate
    from hinge_tpu.stages.filter import run_filter
    from hinge_tpu.stages.layout import load_marked, run_layout
    from hinge_tpu.stages.maximal import run_maximal

    tmp = tmp_path_factory.mktemp("mh")
    p = SimParams(
        genome_len=60_000, coverage=20.0, mean_read_len=5000, std_read_len=1200,
        repeats=((5_000, 35_000, 3_000),), seed=7,
    )
    genome, reads, rs, ov = simulate(p)
    cfg = nominal_config()
    prefix = str(tmp / "X")
    fres = run_filter(rs, [ov], cfg, out_prefix=prefix)
    eff_s = fres.maskvec[:, 0].astype(np.int32)
    eff_e = fres.maskvec[:, 1].astype(np.int32)
    mres = run_maximal(rs, [ov], cfg, eff_s, eff_e, out_prefix=prefix)
    run_layout(
        rs, [ov], cfg, eff_s, eff_e, mres.active,
        load_marked(prefix + ".repeat.txt"), load_marked(prefix + ".hinges.txt"),
        out_prefix=prefix, filter_prefix=prefix,
    )
    # synthetic ground truth: perfect simulator coords
    mapping = {
        str(i): [[int(r.start), int(r.end), 0]] for i, r in enumerate(reads)
    }
    gt = str(tmp / "X.mapping.json")
    with open(gt, "w") as f:
        json.dump(mapping, f)
    return prefix, gt


def test_merge_hinges_end_to_end(layout_files, tmp_path):
    prefix, gt = layout_files
    out = merge_hinges_run(
        prefix + ".edges.hinges2", prefix + ".hgraph", prefix + ".hinge.list",
        gt_file=gt, prefix=str(tmp_path / "M"), seed=0,
    )
    g0, g1 = out["G0"], out["G1"]
    assert g0.number_of_nodes() > 0 and g0.number_of_edges() > 0
    # double-stranded: node count is even and strand mirror exists
    nodes = set(g0.nodes())
    some = next(iter(nodes))
    base, strand = some.rsplit("_", 1)
    assert f"{base}_{1-int(strand)}" in nodes
    # clipping only removes
    assert g1.number_of_nodes() <= g0.number_of_nodes()
    # outputs written
    for tag in ("G0_merged", "G0s_merged", "G1_merged", "Gs_merged"):
        f = tmp_path / f"M.{tag}.graphml"
        assert f.exists(), tag
        nx.read_graphml(str(f))
    assert (tmp_path / "M_hgraph2.graphml").exists()
    # every edge got a false_positive annotation from ground truth
    fp = [d["false_positive"] for _, _, d in g0.edges(data=True)]
    assert set(fp) <= {0, 1}
    # with perfect ground truth most retained edges are true positives
    assert np.mean(fp) < 0.5


def test_select_single_strand(tmp_path):
    fa = tmp_path / "in.fa"
    fa.write_text(">c0\nACGT\n>c0_rc\nACGT\n>c1\nGGGG\n>c1_rc\nCCCC\n")
    out = tmp_path / "even.fa"
    n = select_single_strand(str(fa), str(out), mode="even")
    assert n == 2
    assert out.read_text() == ">c0\nACGT\n>c1\nGGGG\n"
    # reference get_single_strand quirk: only the first record
    out2 = tmp_path / "first.fa"
    n2 = select_single_strand(str(fa), str(out2), mode="first")
    assert n2 == 1
    assert out2.read_text() == ">Consensus0\nACGT\n"
