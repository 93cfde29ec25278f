"""merge_hinges — alternative hinge-merged layout post-processing.

Re-implements the reference's ``scripts/merge_hinges.py`` (606 LoC): instead
of keeping hinged edges pointing at the individual B-read that carried the
hinge, every hinged edge endpoint is *merged into a canonical sink node* of
its hinge-graph connected component, so all copies of a repeat boundary
collapse onto one graph node.  Inputs are the layout stage's outputs:

- ``X.edges.hinges2``  (hinging.cpp PrintOverlapToFile2: cols
  ``A B len dirA dirB hinged hingepos [..]x4``)
- ``X.hgraph``         (hinging.cpp:1421-1431: ``src dst possrc posdst live rev``)
- ``X.hinge.list``     (``id pos type``)
- optional ``X.mapping.json`` ground truth (run_mapping.py format)

and the outputs are ``<prefix>.{G0,G0s,G1,Gs}_merged.graphml`` plus the
annotated double-stranded hinge graph ``<prefix>_hgraph2.graphml``
(merge_hinges.py:414,578-595).

Divergences from the reference (deliberate):
- ``random_condensation`` is seeded (the reference uses the global
  unseeded ``random`` module — viz-only output, merge_hinges.py:147).
- hinge nodes that fall in small (<=10-node) hinge-graph components have no
  entry in ``hinge_mapping`` (merge_hinges.py:408-411 marks them active=-1 and
  skips them); the reference would KeyError at :543 — we map them to
  themselves and log a warning.
- set-iteration orders (start/end node sets, component node order) are pinned
  to graph insertion order, as elsewhere in this package (CPython2 set order
  is not reproducible).
"""

from __future__ import annotations

import json
import random
from typing import Dict, Iterable, List, Optional, Set, Tuple

from hinge_tpu.graph.digraph import (
    DiGraph, weakly_connected_components, write_graphml,
)

from hinge_tpu.utils.log import get_logger


def _succ(G, n) -> List[str]:
    return list(G.successors(n))


def _pred(G, n) -> List[str]:
    return list(G.predecessors(n))


def dead_end_clipping(G: DiGraph, threshold: int) -> DiGraph:
    """Single-strand dead-end clip (merge_hinges.py:11-44).

    Unlike the symmetric clip variant this removes a short in/out spur
    unconditionally when its path length is <= threshold, and does not touch
    the reverse-complement mirror (the merged graph is already
    double-stranded with both strands present as ordinary nodes).
    """
    H = G.copy()
    start_nodes = [x for x in H.nodes() if H.in_degree(x) == 0]
    for st_node in start_nodes:
        if not H.has_node(st_node):
            continue
        cur_path = [st_node]
        succ = _succ(H, st_node)
        if len(succ) == 1:
            cur_node = succ[0]
            while (
                H.in_degree(cur_node) == 1
                and H.out_degree(cur_node) == 1
                and len(cur_path) < threshold + 2
            ):
                cur_path.append(cur_node)
                cur_node = _succ(H, cur_node)[0]
        if len(cur_path) <= threshold:
            for vertex in cur_path:
                H.remove_node(vertex)

    end_nodes = [x for x in H.nodes() if H.out_degree(x) == 0]
    for end_node in end_nodes:
        if not H.has_node(end_node):
            continue
        cur_path = [end_node]
        pred = _pred(H, end_node)
        if len(pred) == 1:
            cur_node = pred[0]
            while (
                H.in_degree(cur_node) == 1
                and H.out_degree(cur_node) == 1
                and len(cur_path) < threshold + 2
            ):
                cur_path.append(cur_node)
                cur_node = _pred(H, cur_node)[0]
        if len(cur_path) <= threshold:
            for vertex in cur_path:
                H.remove_node(vertex)
    return H


def z_clipping(
    G: DiGraph, threshold: int, in_hinges: Set[str], out_hinges: Set[str]
) -> DiGraph:
    """Single-strand Z-clip (merge_hinges.py:50-107)."""
    H = G.copy()
    start_nodes = [x for x in H.nodes() if H.out_degree(x) > 1 and x not in out_hinges]
    for st_node in start_nodes:
        if not H.has_node(st_node):
            continue
        for sec_node in _succ(H, st_node):
            if H.out_degree(st_node) == 1:
                break
            cur_node = sec_node
            cur_path = [[st_node, cur_node]]
            while H.in_degree(cur_node) == 1 and H.out_degree(cur_node) == 1:
                nxt = _succ(H, cur_node)[0]
                cur_path.append([cur_node, nxt])
                cur_node = nxt
                if len(cur_path) > threshold + 1:
                    break
            if (
                len(cur_path) <= threshold
                and H.in_degree(cur_node) > 1
                and H.out_degree(st_node) > 1
                and cur_node not in in_hinges
            ):
                for e in cur_path:
                    H.remove_edge(e[0], e[1])
                for j in range(len(cur_path) - 1):
                    H.remove_node(cur_path[j][1])

    end_nodes = [x for x in H.nodes() if H.in_degree(x) > 1 and x not in in_hinges]
    for end_node in end_nodes:
        if not H.has_node(end_node):
            continue
        for sec_node in _pred(H, end_node):
            if H.in_degree(end_node) == 1:
                break
            cur_node = sec_node
            cur_path = [[cur_node, end_node]]
            while H.in_degree(cur_node) == 1 and H.out_degree(cur_node) == 1:
                prv = _pred(H, cur_node)[0]
                cur_path.append([prv, cur_node])
                cur_node = prv
                if len(cur_path) > threshold + 1:
                    break
            if (
                len(cur_path) <= threshold
                and H.out_degree(cur_node) > 1
                and H.in_degree(end_node) > 1
                and cur_node not in out_hinges
            ):
                for e in cur_path:
                    H.remove_edge(e[0], e[1])
                for j in range(len(cur_path) - 1):
                    H.remove_node(cur_path[j][0])
    return H


def merge_path(g: DiGraph, in_node, node, out_node):
    """(merge_hinges.py:113-117)"""
    g.add_edge(in_node, out_node, hinge_edge=-1, false_positive=0)
    g.remove_node(node)


def merge_a_to_b(g: DiGraph, node_a, node_b):
    """Redirect every edge of node_a onto node_b, drop node_a
    (merge_hinges.py:120-133)."""
    if node_a not in g.nodes() or node_b not in g.nodes():
        return
    for node in _pred(g, node_a):
        if node != node_b:
            g.add_edge(node, node_b, hinge_edge=1, false_positive=0)
    for node in _succ(g, node_a):
        if node != node_b:
            g.add_edge(node_b, node, hinge_edge=1, false_positive=0)
    g.remove_node(node_a)


def random_condensation(
    G: DiGraph, n_nodes: int, seed: Optional[int] = 0
) -> DiGraph:
    """Sparsify to ~n_nodes by merging interior nodes of simple paths whose
    incident edges are not false positives (merge_hinges.py:136-172; seeded
    here, viz-only output)."""
    g = G.copy()
    rng = random.Random(seed) if seed is not None else random
    max_iter = 20000
    iter_cnt = 0
    while len(g.nodes()) > n_nodes and iter_cnt < max_iter:
        iter_cnt += 1
        nodes = list(g.nodes())
        node = nodes[rng.randrange(len(nodes))]
        if g.in_degree(node) == 1 and g.out_degree(node) == 1:
            in_node = list(g.in_edges(node))[0][0]
            out_node = list(g.out_edges(node))[0][1]
            if g.out_degree(in_node) == 1 and g.in_degree(out_node) == 1:
                if in_node != node and out_node != node and in_node != out_node:
                    bad_node = False
                    for in_edge in g.in_edges(node):
                        if g.edges[in_edge[0], in_edge[1]].get("false_positive") == 1:
                            bad_node = True
                    for out_edge in g.out_edges(node):
                        if g.edges[out_edge[0], out_edge[1]].get("false_positive") == 1:
                            bad_node = True
                    if not bad_node:
                        merge_path(g, in_node, node, out_node)
    if iter_cnt >= max_iter:
        get_logger().info(
            "couldn't finish sparsification %d", len(g.nodes())
        )
    return g


def add_groundtruth(
    g: DiGraph, mapping: Dict, in_hinges: Set[str], out_hinges: Set[str]
) -> DiGraph:
    """aln_start/aln_end + hinge flag per node, false_positive per edge
    (merge_hinges.py:176-233). Overlapping ground-truth intervals between
    edge endpoints clear the flag."""
    for node in g.nodes():
        node_base = node.split("_")[0]
        if node_base in mapping:
            ent = mapping[node_base][0]
            g.nodes[node]["aln_start"] = min(ent[0], ent[1])
            g.nodes[node]["aln_end"] = max(ent[0], ent[1])
        else:
            g.nodes[node]["aln_start"] = 0
            g.nodes[node]["aln_end"] = 0
        g.nodes[node]["hinge"] = 1 if (node in in_hinges or node in out_hinges) else 0

    for in_node, out_node in g.edges():
        ns, ne = g.nodes[in_node]["aln_start"], g.nodes[in_node]["aln_end"]
        ms, me = g.nodes[out_node]["aln_start"], g.nodes[out_node]["aln_end"]
        if (ns < ms < ne) or (ns < me < ne):
            g.edges[in_node, out_node]["false_positive"] = 0
        else:
            g.edges[in_node, out_node]["false_positive"] = 1
    return g


def read_hinge_sets(lines: Iterable[str]) -> Tuple[Set[str], Set[str]]:
    """in/out hinge node sets, merge_hinges convention (merge_hinges.py:556-569:
    an in-hinge of type 1 lives on strand 0 and its mirror out-hinge on
    strand 1; type -1 swaps)."""
    in_hinges: Set[str] = set()
    out_hinges: Set[str] = set()
    for ln in lines:
        t = ln.split()
        if len(t) < 3:
            continue
        if t[2] == "1":
            in_hinges.add(t[0] + "_0")
            out_hinges.add(t[0] + "_1")
        elif t[2] == "-1":
            in_hinges.add(t[0] + "_1")
            out_hinges.add(t[0] + "_0")
    return in_hinges, out_hinges


def build_hinge_mapping(
    hgraph_lines: Iterable[str],
    hinge_list_lines: Iterable[str],
    mapping: Dict,
    out_graphml: Optional[str] = None,
) -> Tuple[DiGraph, Dict[str, str]]:
    """Double-stranded hinge graph + canonical-sink mapping.

    Builds the (read,strand,hingepos) graph from X.hgraph exactly as
    merge_hinges.py:300-375 (rev match crosses strands), annotates nodes with
    ground-truth coords and ``active`` (2 for listed hinges, else the line's
    live flag), then for every weakly connected component of >10 nodes picks
    a canonical sink: the out-degree-0 active==2 node with the largest
    in-degree (first in insertion order on ties; merge_hinges.py:386-406),
    falling back to the component's first node. Components of <=10 nodes are
    marked active=-1 and get no mapping entries (:408-411).
    """
    hinge_nodes: Set[str] = set()
    for ln in hinge_list_lines:
        t = ln.split()
        if len(t) < 3:
            continue
        hinge_nodes.add(t[0] + "_0_" + t[1])
        hinge_nodes.add(t[0] + "_1_" + t[1])

    g = DiGraph()
    for ln in hgraph_lines:
        t = ln.split()
        if len(t) < 6:
            continue
        a, b, pa, pb, live, rev = t[0], t[1], t[2], t[3], t[4], t[5]
        nodeA0, nodeA1 = a + "_0_" + pa, a + "_1_" + pa
        nodeB0, nodeB1 = b + "_0_" + pb, b + "_1_" + pb
        for n in (nodeA0, nodeA1, nodeB0, nodeB1):
            g.add_node(n)

        for rid, n0, n1 in ((a, nodeA0, nodeA1), (b, nodeB0, nodeB1)):
            if rid in mapping:
                ent = mapping[rid][0]
                lo, hi = min(ent[0], ent[1]), max(ent[0], ent[1])
            else:
                lo = hi = 0
            g.nodes[n0]["aln_start"] = lo
            g.nodes[n0]["aln_end"] = hi
            g.nodes[n1]["aln_start"] = lo
            g.nodes[n1]["aln_end"] = hi

        if nodeA0 in hinge_nodes:
            g.nodes[nodeA0]["active"] = 2
            g.nodes[nodeA1]["active"] = 2
        else:
            g.nodes[nodeA0]["active"] = 1
            g.nodes[nodeA1]["active"] = 1
        if nodeB0 in hinge_nodes:
            g.nodes[nodeB0]["active"] = 2
            g.nodes[nodeB1]["active"] = 2
        else:
            g.nodes[nodeB0]["active"] = int(live)
            g.nodes[nodeB1]["active"] = int(live)

        if int(rev) == 1:  # reverse match crosses strands (:370-372)
            g.add_edge(nodeA0, nodeB1)
            g.add_edge(nodeA1, nodeB0)
        else:
            g.add_edge(nodeA0, nodeB0)
            g.add_edge(nodeA1, nodeB1)

    order = {n: i for i, n in enumerate(g.nodes())}
    hinge_mapping: Dict[str, str] = {}
    for c in weakly_connected_components(g):
        nodes = sorted(c, key=order.__getitem__)
        if len(c) > 10:
            component_sink = None
            for node in nodes:
                if g.out_degree(node) == 0 and g.nodes[node].get("active") == 2:
                    if component_sink is None or g.in_degree(node) > g.in_degree(
                        component_sink
                    ):
                        component_sink = node
            if component_sink is not None:
                g.nodes[component_sink]["active"] = 3
            else:
                component_sink = nodes[0]
            for node in nodes:
                hinge_mapping[node] = component_sink
        else:
            for node in nodes:
                g.nodes[node]["active"] = -1

    if out_graphml is not None:
        write_graphml(g, out_graphml)
    return g, hinge_mapping


def build_merged_graph(
    edges_lines: Iterable[str], hinge_mapping: Dict[str, str]
) -> DiGraph:
    """String graph from X.edges.hinges2 with hinged endpoints collapsed to
    their component sink (merge_hinges.py:516-553, the live merging==1
    branch)."""
    log = get_logger()
    G = DiGraph()
    to_be_merged: List[Tuple[str, str]] = []
    for ln in edges_lines:
        t = ln.split()
        if len(t) < 6:
            continue
        G.add_edge(t[0] + "_" + t[3], t[1] + "_" + t[4], hinge_edge=int(t[5]))
        G.add_edge(
            t[1] + "_" + str(1 - int(t[4])),
            t[0] + "_" + str(1 - int(t[3])),
            hinge_edge=int(t[5]),
        )
        if int(t[5]) == 1:  # forward-internal: hinge lives on B (:533-535)
            to_be_merged.append((t[1], t[6]))
        elif int(t[5]) == -1:  # backward-internal: hinge lives on A (:537-539)
            to_be_merged.append((t[0], t[6]))

    missing = 0
    for read, pos in to_be_merged:
        for strand in ("_0_", "_1_"):
            key = read + strand + pos
            sink_long = hinge_mapping.get(key)
            if sink_long is None:
                missing += 1
                continue
            parts = sink_long.split("_")
            sink_node = parts[0] + "_" + parts[1]
            src_node = read + strand[:-1]  # e.g. "12_0"
            if src_node != sink_node:
                merge_a_to_b(G, src_node, sink_node)
    if missing:
        log.info("merge_hinges: %d hinge nodes had no component mapping", missing)
    return G


def merge_hinges_run(
    edges_file: str,
    hg_file: str,
    hinge_file: str,
    gt_file: Optional[str] = None,
    prefix: Optional[str] = None,
    seed: Optional[int] = 0,
) -> Dict[str, DiGraph]:
    """Full merge_hinges flow (merge_hinges.py:240-595): hinge mapping from
    the hinge graph, merged string graph, ground-truth annotation, then
    G0_merged / G0s_merged (condense 3500) / G1_merged (dead-end 10 +
    z-clip 5) / Gs_merged (condense 2500) graphml outputs."""
    if prefix is None:
        prefix = edges_file.split(".")[0]

    mapping: Dict = {}
    if gt_file is not None:
        with open(gt_file) as f:
            mapping = json.load(f)

    with open(hinge_file) as f:
        hinge_list_lines = f.read().splitlines()
    with open(hg_file) as f:
        hgraph_lines = f.read().splitlines()
    with open(edges_file) as f:
        edges_lines = f.read().splitlines()

    _, hinge_mapping = build_hinge_mapping(
        hgraph_lines,
        hinge_list_lines,
        mapping,
        out_graphml=prefix + "_hgraph2.graphml",
    )
    G = build_merged_graph(edges_lines, hinge_mapping)

    in_hinges, out_hinges = read_hinge_sets(hinge_list_lines)
    add_groundtruth(G, mapping, in_hinges, out_hinges)

    G0 = G.copy()
    write_graphml(G0, prefix + ".G0_merged.graphml")
    G0s = random_condensation(G0, 3500, seed=seed)
    write_graphml(G0s, prefix + ".G0s_merged.graphml")

    G1 = dead_end_clipping(G0, 10)
    G1 = z_clipping(G1, 5, in_hinges, out_hinges)
    write_graphml(G1, prefix + ".G1_merged.graphml")

    Gs = random_condensation(G1, 2500, seed=seed)
    write_graphml(Gs, prefix + ".Gs_merged.graphml")
    return {"G0": G0, "G0s": G0s, "G1": G1, "Gs": Gs}
