"""Adversarial cross-check of hinge_tpu.graph.sgraph against the
independent second transcription (tests/sgraph_oracle2.py).

The reference pruning scripts are Python-2-only, so real script diffs are
impossible offline; instead every pruning op runs on randomized
strand-symmetric graphs through BOTH transcriptions — graph.digraph-based
(production) and dict-based (oracle) — and must produce identical node
lists, edge sets, z annotations, and (where an op legitimately crashes on
mirror-overlapping paths, as the reference does) identical crash behavior.
"""

import random

import numpy as np
import pytest

import tests.sgraph_oracle2 as O
from hinge_tpu.graph import sgraph as S
from hinge_tpu.graph.digraph import DiGraph, GraphError


def _random_sym_graph(rng: random.Random, n_reads=14, n_edges=26,
                      with_attrs=True):
    """Random mirror-closed digraph over '<i>_<s>' nodes, built identically
    into a DiGraph and an oracle ODG (same insertion order)."""
    G = DiGraph()
    g2 = O.ODG()
    edges = []
    for _ in range(n_edges):
        a, b = rng.randrange(n_reads), rng.randrange(n_reads)
        sa, sb = rng.randrange(2), rng.randrange(2)
        u, v = f"{a}_{sa}", f"{b}_{sb}"
        if u == v:
            continue
        attrs = dict(z=0, intersection=rng.randrange(2), hinge_edge=-1)
        if with_attrs:
            attrs.update(
                length=rng.randrange(100, 5000),
                read_a_match_start=rng.randrange(0, 10000),
                read_a_match_end=rng.randrange(0, 10000),
                read_b_match_start=rng.randrange(0, 10000),
                read_b_match_end=rng.randrange(0, 10000),
                read_a_match_start_raw=0, read_a_match_end_raw=0,
                read_b_match_start_raw=0, read_b_match_end_raw=0,
            )
        edges.append((u, v, attrs))
    for u, v, attrs in edges:
        ru, rv = S.rev_node(v), S.rev_node(u)
        G.add_edge(u, v, **attrs)
        G.add_edge(ru, rv, **attrs)
        g2.add_edge(u, v, **attrs)
        g2.add_edge(ru, rv, **attrs)
    for node in G.nodes():
        cf = rng.random() < 0.2
        G.nodes[node]["CFLAG"] = cf
        g2.nattr(node)["CFLAG"] = cf
    return G, g2


def _assert_same(G: DiGraph, g2: O.ODG):
    assert list(G.nodes()) == g2.node_list()
    assert set(G.edges()) == g2.edge_set()


def _run_both(f_nx, f_o2):
    """Run both transcriptions; both must succeed or both must raise (the
    reference crashes on paths overlapping their own mirror)."""
    try:
        a = f_nx()
        ok1 = True
    except (GraphError, KeyError):
        ok1 = False
    try:
        b = f_o2()
        ok2 = True
    except KeyError:
        ok2 = False
    assert ok1 == ok2
    return (a, b) if ok1 else (None, None)


def test_dead_end_clipping_cross():
    for seed in range(120):
        rng = random.Random(seed)
        G, g2 = _random_sym_graph(rng)
        thr = rng.choice([1, 2, 3, 5])
        a, b = _run_both(lambda: S.dead_end_clipping_sym(G, thr),
                         lambda: O.dead_end_clipping_sym(g2, thr))
        if a is not None:
            _assert_same(a, b)


def test_z_clipping_cross():
    for seed in range(120):
        rng = random.Random(seed)
        G, g2 = _random_sym_graph(rng)
        hinge_nodes = [x for x in G.nodes() if rng.random() < 0.15]
        in_h = set(x for x in hinge_nodes if x.endswith("_0"))
        out_h = set(x for x in hinge_nodes if x.endswith("_1"))
        thr = rng.choice([1, 2, 3])
        a, b = _run_both(
            lambda: S.z_clipping_sym(G, thr, in_h, out_h),
            lambda: O.z_clipping_sym(g2, thr, in_h, out_h))
        if a is not None:
            (H1, G01), (H2, G02) = a, b
            _assert_same(H1, H2)
            z1 = {(u, v) for u, v, d in G01.edges(data=True) if d.get("z")}
            z2 = {(u, v) for u in G02._succ for v, d in G02._succ[u].items()
                  if d.get("z")}
            assert z1 == z2
            nz1 = {x for x in G01.nodes() if G01.nodes[x].get("z")}
            nz2 = {x for x in G02.nodes() if G02.nattr(x).get("z")}
            assert nz1 == nz2


def test_bubble_bursting_cross():
    for seed in range(120):
        rng = random.Random(seed)
        G, g2 = _random_sym_graph(rng)
        thr = rng.choice([1, 2, 4])
        a, b = _run_both(lambda: S.bubble_bursting_sym(G, thr),
                         lambda: O.bubble_bursting_sym(g2, thr))
        if a is not None:
            _assert_same(a, b)


def test_y_pruning_cross():
    for seed in range(120):
        rng = random.Random(seed)
        G, g2 = _random_sym_graph(rng)
        flank = rng.choice([0, 1, 2])
        a, b = _run_both(lambda: S.y_pruning(G, flank),
                         lambda: O.y_pruning(g2, flank))
        if a is not None:
            _assert_same(a, b)


def test_loop_resolution_cross():
    hits = 0
    for seed in range(200):
        rng = random.Random(10_000 + seed)
        flank = seed % 2
        G, g2 = _random_sym_graph(rng, n_reads=10, n_edges=18)
        a, b = _run_both(
            lambda: S.loop_resolution(G, 50, flank, 100),
            lambda: O.loop_resolution(g2, 50, flank, 100))
        if a is not None:
            _assert_same(a, b)
            if any(x.startswith("B") for x in a.nodes()):
                hits += 1
    assert hits > 0, "no random case exercised resolve_rep"


def test_loop_resolution_plasmid_cross():
    """The handcrafted tandem-loop topology from test_clip_stage, both ways."""
    def build(add_edge):
        n = 12
        for i in range(n):
            u, v = f"{i}_0", f"{(i + 1) % n}_0"
            kw = dict(z=0, intersection=0, hinge_edge=-1, length=1000,
                      read_a_match_start=0, read_a_match_end=0,
                      read_b_match_start=100000, read_b_match_end=0,
                      read_a_match_start_raw=0, read_a_match_end_raw=0,
                      read_b_match_start_raw=0, read_b_match_end_raw=0)
            add_edge(u, v, kw)
            add_edge(S.rev_node(v), S.rev_node(u), kw)
        chain = [("3_0", "100_0")] + [
            (f"{k - 1}_0", f"{k}_0") for k in range(101, 160)]
        for u, v in chain:
            kw = dict(z=0, intersection=0, hinge_edge=-1, length=1000,
                      read_a_match_start=0, read_a_match_end=0,
                      read_b_match_start=100000, read_b_match_end=0,
                      read_a_match_start_raw=0, read_a_match_end_raw=0,
                      read_b_match_start_raw=0, read_b_match_end_raw=0)
            add_edge(u, v, kw)
            add_edge(S.rev_node(v), S.rev_node(u), kw)

    G = DiGraph()
    build(lambda u, v, kw: G.add_edge(u, v, **kw))
    g2 = O.ODG()
    build(lambda u, v, kw: g2.add_edge(u, v, **kw))
    a = S.loop_resolution(G, 500, 50, 500000)
    b = O.loop_resolution(g2, 500, 50, 500000)
    _assert_same(a, b)
    assert any(x.startswith("B") for x in a.nodes())


def test_random_condensation_cross():
    for seed in range(40):
        rng = random.Random(seed)
        G, g2 = _random_sym_graph(rng, n_reads=20, n_edges=44)
        a = S.random_condensation_sym(G, 8, seed=seed)
        b = O.random_condensation_sym(g2, 8, seed=seed)
        _assert_same(a, b)


def test_connect_strands_cross():
    rng = random.Random(0)
    G, g2 = _random_sym_graph(rng)
    _assert_same(S.connect_strands(G), O.connect_strands(g2))
