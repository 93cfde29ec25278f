"""Clip stage: graph-op unit tests + end-to-end on the simulated pipeline.

The decisive semantic check: a circular genome must clip down to a clean
double-stranded cycle (every node in/out degree 1, two mirror components).
"""

import networkx as nx
import numpy as np
import pytest

from hinge_tpu.config import nominal_config
from hinge_tpu.graph import sgraph as S
from hinge_tpu.graph.digraph import DiGraph, weakly_connected_components


def _sym_add(G, u, v, **attrs):
    defaults = dict(
        hinge_edge=-1, intersection=0, length=1000, z=0,
        read_a_match_start=0, read_a_match_end=1000,
        read_b_match_start=0, read_b_match_end=1000,
        read_a_match_start_raw=0, read_a_match_end_raw=1000,
        read_b_match_start_raw=0, read_b_match_end_raw=1000,
    )
    defaults.update(attrs)
    G.add_edge(f"{u}_0", f"{v}_0", **defaults)
    G.add_edge(f"{v}_1", f"{u}_1", **defaults)


def _cycle_graph(n):
    G = DiGraph()
    for i in range(n):
        _sym_add(G, i, (i + 1) % n)
    return G


def test_dead_end_clipping_removes_spur():
    G = _cycle_graph(8)
    # spur: 100 -> 101 -> 102 -> joins node 3
    _sym_add(G, 100, 101)
    _sym_add(G, 101, 102)
    _sym_add(G, 102, 3)
    H = S.dead_end_clipping_sym(G, 10)
    assert not H.has_node("100_0") and not H.has_node("101_0") and not H.has_node("102_0")
    assert not H.has_node("100_1")
    # cycle untouched
    for i in range(8):
        assert H.has_node(f"{i}_0")


def test_dead_end_clipping_threshold():
    G = _cycle_graph(8)
    # long spur exceeding threshold survives
    prev = 200
    for k in range(201, 215):
        _sym_add(G, prev, k)
        prev = k
    _sym_add(G, prev, 3)
    H = S.dead_end_clipping_sym(G, 5)
    assert H.has_node("205_0")


def test_z_clipping():
    G = _cycle_graph(20)
    # z-edge: jump 2 -> 15; the detour along the cycle (13 edges) exceeds
    # the threshold, so the 1-edge z path is the one clipped
    _sym_add(G, 2, 15)
    H, G0 = S.z_clipping_sym(G, 6, set(), set())
    assert not H.has_edge("2_0", "15_0")
    assert not H.has_edge("15_1", "2_1")
    assert G0.edges["2_0", "15_0"]["z"] == 1
    # cycle intact
    assert H.has_edge("2_0", "3_0") and H.has_edge("14_0", "15_0")


def test_z_clipping_short_arm_first():
    """When both arms are under threshold, the first-iterated arm dies —
    reference behavior (successor insertion order)."""
    G = _cycle_graph(10)
    _sym_add(G, 2, 7)
    H, G0 = S.z_clipping_sym(G, 6, set(), set())
    # the cycle path 2->3->..->7 was inserted first and is <= threshold
    assert not H.has_edge("2_0", "3_0")
    assert H.has_edge("2_0", "7_0")


def test_bubble_bursting():
    G = _cycle_graph(6)
    # bubble: alternative path 1 -> 50 -> 2 parallel to 1 -> 2
    _sym_add(G, 1, 50)
    _sym_add(G, 50, 2)
    H = S.bubble_bursting_sym(G, 10)
    # one of the two arms is gone, graph returns to a simple cycle
    deg_ok = all(H.out_degree(x) == 1 and H.in_degree(x) == 1 for x in H.nodes())
    assert deg_ok
    assert len(H) in (12, 14)  # 6-cycle * 2 strands (+50 pair if kept arm)


def test_loop_resolution_duplicates_repeat():
    # st -> loop -> repeat -> back to st; plasmid shorter than max length is
    # left alone; longer gets B-duplicated
    G = DiGraph()
    n = 12
    for i in range(n):
        _sym_add(G, i, (i + 1) % n, read_a_match_start=0, read_b_match_start=100000)
    # give node 3 a second out-edge to a long flank (so out_degree==2)
    prev = 100
    _sym_add(G, 3, 100)
    for k in range(101, 160):
        _sym_add(G, prev, k)
        prev = k
    g = G.copy()
    S.loop_resolution(g, 500, 50, 500000)
    # loop_len here is huge (100000 per edge * 12) > 500000 -> resolved:
    has_b = any(x.startswith("B") for x in g.nodes())
    assert has_b


def test_y_pruning():
    G = _cycle_graph(60)
    # break the cycle into a line by removing one edge pair -> need a long
    # flank before the fork
    _sym_add(G, 20, 300)  # fork at 20 with successor 300 flagged chimeric
    for node in G.nodes():
        G.nodes[node]["CFLAG"] = False
    G.nodes["300_0"]["CFLAG"] = True
    G.nodes["300_1"]["CFLAG"] = True
    H = S.y_pruning(G, 10)
    assert not H.has_edge("20_0", "300_0")
    assert not H.has_edge("300_1", "20_1")
    assert H.has_edge("20_0", "21_0")


def test_clip_end_to_end(tmp_path):
    """Full pipeline filter->maximal->layout->clip on a circular genome:
    G1 must be a clean double cycle covering most maximal reads."""
    from hinge_tpu.data.simulator import SimParams, simulate
    from hinge_tpu.stages.filter import run_filter
    from hinge_tpu.stages.maximal import run_maximal
    from hinge_tpu.stages.layout import load_marked, run_layout
    from hinge_tpu.stages.clip import run_clip

    p = SimParams(genome_len=50_000, coverage=18.0, mean_read_len=5000,
                  std_read_len=1000, seed=21)
    genome, reads, rs, ov = simulate(p)
    cfg = nominal_config()
    prefix = str(tmp_path / "eco")
    fres = run_filter(rs, [ov], cfg, out_prefix=prefix)
    eff_s = fres.maskvec[:, 0].astype(np.int32)
    eff_e = fres.maskvec[:, 1].astype(np.int32)
    mres = run_maximal(rs, [ov], cfg, eff_s, eff_e, out_prefix=prefix)
    lres = run_layout(
        rs, [ov], cfg, eff_s, eff_e, mres.active,
        load_marked(prefix + ".repeat.txt"), load_marked(prefix + ".hinges.txt"),
        out_prefix=prefix, filter_prefix=prefix,
    )
    out = run_clip(prefix + ".edges.hinges", prefix + ".hinge.list", "1", cfg,
                   write_viz=False)
    G2 = out["G2"]
    assert len(G2) > 0
    # no repeats in this genome: expect a clean cycle pair
    degs_in = [G2.in_degree(x) for x in G2.nodes()]
    degs_out = [G2.out_degree(x) for x in G2.nodes()]
    assert max(degs_in) == 1 and max(degs_out) == 1, (max(degs_in), max(degs_out))
    comps = list(weakly_connected_components(G2))
    assert len(comps) == 2  # forward + reverse strand cycles
    import os
    assert os.path.exists(str(tmp_path / "eco1.G2.graphml"))
    g2_loaded = nx.read_graphml(str(tmp_path / "eco1.G2.graphml"))
    assert len(g2_loaded) == len(G2)


def test_clip_aggressive_chimera_e2e(tmp_path):
    """Aggressive profile end-to-end: a read flagged chimeric via .cov.flag
    loses its Y-fork edge in G3 (y_pruning, pruning_and_clipping.py:841-888,
    1518-1532), and G3.graphml is written."""
    from hinge_tpu.data.simulator import SimParams, simulate
    from hinge_tpu.stages.clip import run_clip
    from hinge_tpu.stages.filter import run_filter
    from hinge_tpu.stages.layout import load_marked, run_layout
    from hinge_tpu.stages.maximal import run_maximal

    p = SimParams(genome_len=50_000, coverage=18.0, mean_read_len=5000,
                  std_read_len=1000, seed=21)
    genome, reads, rs, ov = simulate(p)
    cfg = nominal_config()
    cfg.layout.aggressive_pruning = True
    prefix = str(tmp_path / "agg")
    fres = run_filter(rs, [ov], cfg, out_prefix=prefix)
    eff_s = fres.maskvec[:, 0].astype(np.int32)
    eff_e = fres.maskvec[:, 1].astype(np.int32)
    mres = run_maximal(rs, [ov], cfg, eff_s, eff_e, out_prefix=prefix)
    run_layout(
        rs, [ov], cfg, eff_s, eff_e, mres.active,
        load_marked(prefix + ".repeat.txt"), load_marked(prefix + ".hinges.txt"),
        out_prefix=prefix, filter_prefix=prefix,
    )
    # inject a chimera flag: pick a mid-path G2 node so the fork logic has a
    # long clean flank upstream
    out0 = run_clip(prefix + ".edges.hinges", prefix + ".hinge.list", "1",
                    cfg, write_viz=False)
    G2 = out0["G2"]
    victim = None
    for node in G2.nodes():
        if G2.in_degree(node) == 1 and G2.out_degree(node) == 1:
            victim = node.split("_")[0]
            break
    assert victim is not None
    with open(prefix + ".cov.flag", "w") as f:
        f.write(victim + "\n")
    out = run_clip(prefix + ".edges.hinges", prefix + ".hinge.list", "1",
                   cfg, write_viz=False)
    assert "G3" in out
    import os
    assert os.path.exists(prefix + "1.G3.graphml")
    # the flagged node carries CFLAG in the pruned graph
    G3 = out["G3"]
    flagged = [n for n in G3.nodes() if G3.nodes[n].get("CFLAG", False)]
    assert (victim + "_0" in flagged) or (victim + "_0" not in G3)
