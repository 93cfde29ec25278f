"""hinge_tpu.graph.digraph against networkx, the oracle it replaces.

Each case builds the same graph both ways (or feeds networkx the graph the
pipeline built) and requires identical iteration orders, algorithm results
and GraphML bytes."""

import random

import networkx as nx
import numpy as np
import pytest

from hinge_tpu.config import nominal_config
from hinge_tpu.graph import digraph as D
from hinge_tpu.graph.condense import condense_gfa_n50, merge_simple_path_ov


def _to_nx(g):
    h = nx.MultiDiGraph() if g.is_multigraph() else nx.DiGraph()
    h.graph.update(g.graph)
    for n, d in g.nodes(data=True):
        h.add_node(n, **d)
    if g.is_multigraph():
        for u, v, k, d in g.edges(data=True, keys=True):
            h.add_edge(u, v, key=k, **d)
    else:
        for u, v, d in g.edges(data=True):
            h.add_edge(u, v, **d)
    return h


def _same_structure(g, h):
    assert list(g.nodes()) == list(h.nodes())
    assert [d for _, d in g.nodes(data=True)] == [d for _, d in h.nodes(data=True)]
    assert list(g.edges(data=True)) == list(h.edges(data=True))
    for n in g:
        assert list(g.predecessors(n)) == list(h.predecessors(n)), n
        assert list(g.successors(n)) == list(h.successors(n)), n
        assert g.in_degree(n) == h.in_degree(n) and g.degree(n) == h.degree(n)


def _random_pair(seed, n=40, m=90, dag=False):
    """The same random digraph (self loops and removals included unless
    `dag`) built into a DiGraph and an nx.DiGraph."""
    rng = random.Random(seed)
    g, h = D.DiGraph(), nx.DiGraph()
    for _ in range(m):
        u, v = rng.randrange(n), rng.randrange(n)
        if dag and u >= v:
            u, v = v, u + (u == v)
        w = rng.randrange(100)
        for x in (g, h):
            x.add_edge(f"n{u}", f"n{v}", w=w)
    if not dag:
        for _ in range(8):
            u = f"n{rng.randrange(n)}"
            for x in (g, h):
                if x.has_node(u):
                    x.remove_node(u)
    return g, h


@pytest.fixture(scope="module")
def clip_graphs(small_sim, tmp_path_factory):
    """G0-G3 of the clip stage (aggressive pruning on) and the draft graph
    on the small simulated genome, with the files the stages wrote."""
    from hinge_tpu.stages.clip import run_clip
    from hinge_tpu.stages.draft_path import run_draft_path
    from hinge_tpu.stages.filter import run_filter
    from hinge_tpu.stages.layout import load_marked, run_layout
    from hinge_tpu.stages.maximal import run_maximal

    rs, ov = small_sim["read_store"], small_sim["overlaps"]
    cfg = nominal_config()
    cfg.layout.aggressive_pruning = True
    p = str(tmp_path_factory.mktemp("clip") / "sim")
    fres = run_filter(rs, [ov], cfg, out_prefix=p)
    eff_s = fres.maskvec[:, 0].astype(np.int32)
    eff_e = fres.maskvec[:, 1].astype(np.int32)
    mres = run_maximal(rs, [ov], cfg, eff_s, eff_e, out_prefix=p, has_db=True)
    run_layout(rs, [ov], cfg, eff_s, eff_e, mres.active,
               load_marked(p + ".repeat.txt"), load_marked(p + ".hinges.txt"),
               out_prefix=p, filter_prefix=p, has_db=True)
    graphs = run_clip(p + ".edges.hinges", p + ".hinge.list", "1", cfg,
                      write_viz=False)
    _, draft = run_draft_path(graphs["G2"], rs.length,
                              out_graphml=p + "_draft.graphml")
    files = {k: f"{p}1.{k}.graphml" for k in graphs}
    files["draft"] = p + "_draft.graphml"
    return dict(graphs, draft=draft), files


def _graphml_bytes(tmp_path, clip_graphs, name):
    graphs, files = clip_graphs
    assert len(graphs[name]) > 0
    ours = open(files[name], "rb").read()
    nx.write_graphml(_to_nx(graphs[name]), str(tmp_path / "nx.graphml"))
    assert ours == (tmp_path / "nx.graphml").read_bytes()


def _read_back(tmp_path, clip_graphs, name):
    _, files = clip_graphs
    g = D.read_graphml(files[name])
    h = nx.read_graphml(files[name])
    assert g.graph == h.graph
    _same_structure(g, h)
    D.write_graphml(g, str(tmp_path / "again.graphml"))
    assert (tmp_path / "again.graphml").read_bytes() == open(files[name], "rb").read()


def _components(tmp_path, clip_graphs):
    for seed in range(6):
        g, h = _random_pair(seed)
        assert ([set(c) for c in D.weakly_connected_components(g)]
                == [set(c) for c in nx.weakly_connected_components(h)])
        assert (D.number_strongly_connected_components(g)
                == nx.number_strongly_connected_components(h))
    graphs, _ = clip_graphs
    g = graphs["G2"]
    assert (D.number_strongly_connected_components(g)
            == nx.number_strongly_connected_components(_to_nx(g)))


def _topological(tmp_path, clip_graphs):
    for seed in range(6):
        g, h = _random_pair(seed, dag=True)
        assert list(D.topological_sort(g)) == list(nx.topological_sort(h))
    g, _ = _random_pair(0)
    g.add_edge("n1", "n1")
    with pytest.raises(D.GraphError):
        list(D.topological_sort(g))


def _dfs(tmp_path, clip_graphs):
    for seed in range(6):
        g, h = _random_pair(seed)
        assert list(D.dfs_edges(g)) == list(nx.dfs_edges(h))
        src = next(iter(g))
        assert list(D.dfs_edges(g, src)) == list(nx.dfs_edges(h, src))


def _derived(tmp_path, clip_graphs):
    for seed in range(4):
        g, h = _random_pair(seed)
        _same_structure(g.copy(), h.copy())
        _same_structure(g.reverse(), h.reverse())
        keep = list(g)[: max(1, 3 * len(g) // 4)]  # above half: nx keeps graph order
        _same_structure(g.subgraph(keep), h.subgraph(keep))


def _errors(tmp_path, clip_graphs):
    g, h = _random_pair(1)
    for op in (lambda x: x.remove_node("absent"),
               lambda x: x.remove_edge("n1", "absent"),
               lambda x: list(x.successors("absent"))):
        with pytest.raises(D.GraphError):
            op(g)
        with pytest.raises(nx.NetworkXError):
            op(h)


def _condense(tmp_path, clip_graphs):
    """condense_gfa_n50's MultiDiGraph path, replayed on nx.MultiDiGraph."""
    rng = random.Random(5)
    lines = []
    for i in range(60):  # chains with parallel edges and a few branches
        a, b = i, i + 1 if rng.random() > 0.1 else rng.randrange(60)
        for _ in range(1 + (rng.random() < 0.3)):
            s, e = rng.randrange(0, 500), rng.randrange(3000, 9000)
            lines.append(f"{a} {b} {rng.randrange(200, 2000)} x x x x "
                         f"[{s} {e}] [{s + 10} {e + 20}]")
    edges = tmp_path / "g.edges"
    edges.write_text("\n".join(lines) + "\n")
    n50, g = condense_gfa_n50(str(edges), out_prefix=str(tmp_path / "ours"))

    h = nx.MultiDiGraph()
    for line in lines:
        l = line.split()
        h.add_edge(l[0], l[1], overlap=int(l[2]) // 2)
        h.nodes[l[0]]["length"] = int(l[8][:-1]) - int(l[7][1:])
        h.nodes[l[1]]["length"] = int(l[10][:-1]) - int(l[9][1:])
    for _ in range(5):
        for node in list(h.nodes()):
            if h.has_node(node) and h.degree(node) < 2:
                h.remove_node(node)
    h.graph["aval"] = 1000000000
    for _ in range(5):
        merge_simple_path_ov(h)
    assert g.number_of_edges() == h.number_of_edges() > 0
    assert h.graph["aval"] > 1000000000  # merges happened
    nx.write_graphml(h, str(tmp_path / "nx.graphml"))
    assert ((tmp_path / "ours.condensed.graphml").read_bytes()
            == (tmp_path / "nx.graphml").read_bytes())


CASES = {
    "graphml_G0": lambda t, c: _graphml_bytes(t, c, "G0"),
    "graphml_G1": lambda t, c: _graphml_bytes(t, c, "G1"),
    "graphml_G2": lambda t, c: _graphml_bytes(t, c, "G2"),
    "graphml_G3": lambda t, c: _graphml_bytes(t, c, "G3"),
    "graphml_draft": lambda t, c: _graphml_bytes(t, c, "draft"),
    "read_back_G2": lambda t, c: _read_back(t, c, "G2"),
    "read_back_draft": lambda t, c: _read_back(t, c, "draft"),
    "components": _components,
    "topological_sort": _topological,
    "dfs_edges": _dfs,
    "copy_reverse_subgraph": _derived,
    "missing_node_and_edge_errors": _errors,
    "multidigraph_condense": _condense,
}


@pytest.mark.parametrize("case", list(CASES))
def test_digraph_matches_networkx(case, tmp_path, clip_graphs):
    CASES[case](tmp_path, clip_graphs)
