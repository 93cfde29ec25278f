"""A small directed (multi)graph with the networkx 3.x semantics the graph
stages rely on, plus the few algorithms and the GraphML reader/writer they
use.

The pruning, draft-path and GFA stages are transcriptions of networkx
scripts whose results depend on iteration order, so this module keeps
networkx's storage model exactly: insertion-ordered dict-of-dict adjacency
(`_succ[u][v]` and `_pred[v][u]` share one edge-attribute dict), one
attribute dict per node, `copy()` rebuilding the predecessor order from
the successor walk, and `write_graphml` emitting byte-for-byte what
`networkx.write_graphml` (its lxml writer) emits for the same graph.
`tests/test_digraph.py` checks all of it against networkx.

One deliberate difference: `subgraph()` returns a copy that keeps this
graph's orders.  networkx returns a view, and its node order follows a
Python set when fewer than half the nodes are kept, which varies with
PYTHONHASHSEED.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Dict, Iterable, Iterator, List, Set

import numpy as np


class GraphError(Exception):
    """A missing node or edge, or an operation the graph cannot do
    (networkx raises NetworkXError in the same places)."""


# --------------------------------------------------------------------------
# views
# --------------------------------------------------------------------------


class NodeView:
    """`g.nodes`: iterate, `len`, `in`, `g.nodes[n]` -> attribute dict,
    `g.nodes()` / `g.nodes(data=True)`."""

    __slots__ = ("_nodes",)

    def __init__(self, nodes: Dict):
        self._nodes = nodes

    def __call__(self, data: bool = False):
        if data:
            return list(self._nodes.items())
        return self

    def __iter__(self):
        return iter(self._nodes)

    def __len__(self):
        return len(self._nodes)

    def __contains__(self, n):
        return n in self._nodes

    def __getitem__(self, n):
        return self._nodes[n]


class EdgeView:
    """`g.edges`: `(u, v)` pairs in successor-walk order, `g.edges[u, v]`
    -> attribute dict (`g.edges[u, v, key]` on a multigraph)."""

    __slots__ = ("_g",)

    def __init__(self, g):
        self._g = g

    def __call__(self, data: bool = False, keys: bool = False):
        return list(self._g._edge_iter(data=data, keys=keys))

    def __iter__(self):
        return self._g._edge_iter(data=False, keys=False)

    def __getitem__(self, e):
        u, v, *key = e
        d = self._g._succ[u][v]
        return d[key[0]] if key else d


# --------------------------------------------------------------------------
# graphs
# --------------------------------------------------------------------------


class DiGraph:
    """Directed graph; nodes are any hashable, edges carry attribute dicts."""

    def __init__(self):
        self.graph: Dict = {}
        self._node: Dict = {}
        self._succ: Dict = {}
        self._pred: Dict = {}

    # ---- kind ----
    def is_directed(self) -> bool:
        return True

    def is_multigraph(self) -> bool:
        return False

    # ---- container protocol: g[u][v] -> edge attribute dict ----
    def __iter__(self):
        return iter(self._node)

    def __len__(self):
        return len(self._node)

    def __contains__(self, n):
        return n in self._node

    def __getitem__(self, n):
        return self._succ[n]

    @property
    def nodes(self) -> NodeView:
        return NodeView(self._node)

    @property
    def edges(self) -> EdgeView:
        return EdgeView(self)

    @property
    def pred(self):
        return self._pred

    # ---- mutation ----
    def add_node(self, n, **attr):
        self._put_node(n, attr)

    def _ensure(self, n):
        if n not in self._node:
            self._succ[n] = {}
            self._pred[n] = {}
            self._node[n] = {}

    def _put_node(self, n, d: Dict):
        self._ensure(n)
        self._node[n].update(d)

    def add_edge(self, u, v, **attr):
        self._put_edge(u, v, attr)

    def add_edges_from(self, edges: Iterable):
        """`(u, v)` or `(u, v, attr_dict)` items."""
        for u, v, *d in edges:
            self._put_edge(u, v, d[0] if d else {})

    def _put_edge(self, u, v, attr: Dict, key=None):  # key: multigraphs only
        self._ensure(u)
        self._ensure(v)
        d = self._succ[u].get(v, {})
        d.update(attr)
        self._succ[u][v] = d
        self._pred[v][u] = d

    def remove_node(self, n):
        try:
            nbrs = self._succ[n]
            del self._node[n]
        except KeyError as err:
            raise GraphError(f"The node {n} is not in the digraph.") from err
        for v in nbrs:
            del self._pred[v][n]
        del self._succ[n]
        for u in self._pred[n]:
            del self._succ[u][n]
        del self._pred[n]

    def remove_edge(self, u, v):
        try:
            del self._succ[u][v]
            del self._pred[v][u]
        except KeyError as err:
            raise GraphError(f"The edge {u}-{v} not in graph.") from err

    # ---- queries ----
    def has_node(self, n) -> bool:
        return n in self._node

    def has_edge(self, u, v) -> bool:
        return u in self._succ and v in self._succ[u]

    def get_edge_data(self, u, v, default=None):
        try:
            return self._succ[u][v]
        except KeyError:
            return default

    def successors(self, n) -> Iterator:
        try:
            return iter(self._succ[n])
        except KeyError as err:
            raise GraphError(f"The node {n} is not in the digraph.") from err

    def predecessors(self, n) -> Iterator:
        try:
            return iter(self._pred[n])
        except KeyError as err:
            raise GraphError(f"The node {n} is not in the digraph.") from err

    def in_degree(self, n) -> int:
        return len(self._pred[n])

    def out_degree(self, n) -> int:
        return len(self._succ[n])

    def degree(self, n) -> int:
        return self.in_degree(n) + self.out_degree(n)

    def in_edges(self, n) -> List:
        return [(u, n) for u in self._pred[n]]

    def out_edges(self, n) -> List:
        return [(n, v) for v in self._succ[n]]

    def number_of_nodes(self) -> int:
        return len(self._node)

    def number_of_edges(self) -> int:
        return sum(len(nbrs) for nbrs in self._succ.values())

    def _edge_iter(self, data: bool, keys: bool):
        for u, nbrs in self._succ.items():
            for v, d in nbrs.items():
                yield (u, v) + ((None,) if keys else ()) + ((d,) if data else ())

    # ---- derived graphs (networkx copy semantics: shallow-copied attribute
    # dicts, predecessor order rebuilt from the successor walk) ----
    def _empty(self):
        return self.__class__()

    def _rebuilt(self, flip: bool):
        g = self._empty()
        g.graph.update(self.graph)
        for n, d in self._node.items():
            g._put_node(n, d)
        for u, v, k, d in self._edge_iter(data=True, keys=True):
            g._put_edge(*((v, u) if flip else (u, v)), d, k)
        return g

    def copy(self):
        return self._rebuilt(flip=False)

    def reverse(self):
        return self._rebuilt(flip=True)

    def subgraph(self, nodes: Iterable):
        """Copy of the induced subgraph; node, successor and predecessor
        orders are this graph's, filtered."""
        keep = set(nodes)
        g = self._empty()
        g.graph.update(self.graph)
        for n, d in self._node.items():
            if n in keep:
                g._put_node(n, d)
        copies = {}
        for u in g._node:
            for v, d in self._succ[u].items():
                if v in keep:
                    copies[u, v] = g._succ[u][v] = self._copy_edge_data(d)
        for v in g._node:
            for u in self._pred[v]:
                if u in keep:
                    g._pred[v][u] = copies[u, v]
        return g

    @staticmethod
    def _copy_edge_data(d):
        return dict(d)


class MultiDiGraph(DiGraph):
    """Directed multigraph: `_succ[u][v]` maps edge key -> attribute dict;
    keys are 0, 1, ... per (u, v) as networkx assigns them."""

    def is_multigraph(self) -> bool:
        return True

    def add_edge(self, u, v, key=None, **attr):
        return self._put_edge(u, v, attr, key)

    def _put_edge(self, u, v, attr: Dict, key=None):
        self._ensure(u)
        self._ensure(v)
        keydict = self._succ[u].get(v)
        if keydict is None:
            keydict = {}
            self._succ[u][v] = keydict
            self._pred[v][u] = keydict
        if key is None:
            key = len(keydict)
            while key in keydict:
                key += 1
        d = keydict.get(key, {})
        d.update(attr)
        keydict[key] = d
        return key

    def remove_edge(self, u, v, key=None):
        try:
            keydict = self._succ[u][v]
        except KeyError as err:
            raise GraphError(f"The edge {u}-{v} is not in the graph.") from err
        if key is None:
            keydict.popitem()
        else:
            try:
                del keydict[key]
            except KeyError as err:
                raise GraphError(f"The edge {u}-{v} with key {key} is not in the graph.") from err
        if not keydict:
            del self._succ[u][v]
            del self._pred[v][u]

    def in_degree(self, n) -> int:
        return sum(len(kd) for kd in self._pred[n].values())

    def out_degree(self, n) -> int:
        return sum(len(kd) for kd in self._succ[n].values())

    def in_edges(self, n) -> List:
        return [(u, n) for u, kd in self._pred[n].items() for _ in kd]

    def out_edges(self, n) -> List:
        return [(n, v) for v, kd in self._succ[n].items() for _ in kd]

    def number_of_edges(self) -> int:
        return sum(len(kd) for nbrs in self._succ.values() for kd in nbrs.values())

    def _edge_iter(self, data: bool, keys: bool):
        for u, nbrs in self._succ.items():
            for v, kd in nbrs.items():
                for k, d in kd.items():
                    yield (u, v) + ((k,) if keys else ()) + ((d,) if data else ())

    @staticmethod
    def _copy_edge_data(keydict):
        return {k: dict(d) for k, d in keydict.items()}


# --------------------------------------------------------------------------
# algorithms (networkx 3.x visiting orders)
# --------------------------------------------------------------------------


def weakly_connected_components(g: DiGraph) -> Iterator[Set]:
    """Node sets of the weak components, in order of each one's first node."""
    seen: Set = set()
    for v in g:
        if v in seen:
            continue
        comp = {v}
        frontier = [v]
        while frontier:
            nxt = []
            for u in frontier:
                for w in list(g._succ[u]) + list(g._pred[u]):
                    if w not in comp:
                        comp.add(w)
                        nxt.append(w)
            frontier = nxt
        seen |= comp
        yield comp


def number_weakly_connected_components(g: DiGraph) -> int:
    return sum(1 for _ in weakly_connected_components(g))


def number_strongly_connected_components(g: DiGraph) -> int:
    """Iterative Tarjan count."""
    index: Dict = {}
    low: Dict = {}
    on_stack: Set = set()
    stack: List = []
    count = 0
    counter = 0
    for root in g:
        if root in index:
            continue
        index[root] = low[root] = counter
        counter += 1
        stack.append(root)
        on_stack.add(root)
        work = [(root, iter(g._succ[root]))]
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter
                    counter += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(g._succ[w])))
                    advanced = True
                    break
                if w in on_stack:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[v])
            if low[v] == index[v]:
                count += 1
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    if w == v:
                        break
    return count


def topological_sort(g: DiGraph) -> Iterator:
    """Kahn generations, as networkx.topological_sort visits them; raises
    GraphError on a cycle."""
    indegree = {v: g.in_degree(v) for v in g if g.in_degree(v) > 0}
    zero = [v for v in g if g.in_degree(v) == 0]
    while zero:
        generation, zero = zero, []
        for node in generation:
            for child, kd in g._succ[node].items():
                indegree[child] -= len(kd) if g.is_multigraph() else 1
                if indegree[child] == 0:
                    zero.append(child)
                    del indegree[child]
        yield from generation
    if indegree:
        raise GraphError("Graph contains a cycle or graph changed during iteration")


def dfs_edges(g: DiGraph, source=None) -> Iterator:
    """Depth-first tree edges from every unvisited node in graph order (or
    from `source`), as networkx.dfs_edges yields them."""
    depth_limit = len(g)
    visited: Set = set()
    for start in (g if source is None else [source]):
        if start in visited:
            continue
        visited.add(start)
        stack = [(start, iter(g._succ[start]))]
        depth = 1
        while stack:
            parent, children = stack[-1]
            for child in children:
                if child not in visited:
                    yield parent, child
                    visited.add(child)
                    if depth < depth_limit:
                        stack.append((child, iter(g._succ[child])))
                        depth += 1
                        break
            else:
                stack.pop()
                depth -= 1


# --------------------------------------------------------------------------
# GraphML
# --------------------------------------------------------------------------

_NS = "http://graphml.graphdrawing.org/xmlns"
_HEADER = (
    "<?xml version='1.0' encoding='utf-8'?>\n"
    f'<graphml xmlns="{_NS}" '
    'xmlns:xsi="http://www.w3.org/2001/XMLSchema-instance" '
    f'xsi:schemaLocation="{_NS} http://graphml.graphdrawing.org/xmlns/1.0/graphml.xsd">'
)

# python type -> GraphML attr.type, as networkx's GraphML.construct_types
# resolves it (later entries of its table win)
_XML_TYPE = {
    int: "long", str: "string", float: "double", bool: "boolean",
    np.float64: "float", np.float32: "float", np.float16: "float",
    np.int8: "int", np.int16: "int", np.int32: "int", np.int64: "int",
    np.uint8: "int", np.uint16: "int", np.uint32: "int", np.uint64: "int",
    np.intc: "int", np.intp: "int", np.int_: "int",
}
_PY_TYPE = {
    "integer": int, "int": int, "long": int, "yfiles": str, "string": str,
    "float": float, "double": float, "boolean": bool,
}
_BOOL = {"true": True, "false": False, "0": False, "1": True}


def _esc_text(s: str) -> str:
    return s.replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;")


def _esc_attr(s: str) -> str:
    return (_esc_text(s).replace('"', "&quot;").replace("\n", "&#10;")
            .replace("\r", "&#13;").replace("\t", "&#9;"))


def _xml_type(v) -> str:
    try:
        return _XML_TYPE[type(v)]
    except KeyError as err:
        raise TypeError(f"GraphML does not support type {type(v)} as data values.") from err


def write_graphml(g: DiGraph, path: str) -> None:
    """Write `g` as GraphML, byte-identical to networkx's lxml writer."""
    keys: Dict = {}
    key_lines: List[str] = []
    node_default = g.graph.get("node_default", {})
    edge_default = g.graph.get("edge_default", {})
    graph_data = {k: v for k, v in g.graph.items()
                  if k not in ("node_default", "edge_default")}

    def key(name, v, scope, default):
        kk = (name, _xml_type(v), scope)
        if kk not in keys:
            keys[kk] = f"d{len(keys)}"
            head = (f'<key id="{keys[kk]}" for="{scope}" '
                    f'attr.name="{_esc_attr(name)}" attr.type="{kk[1]}"')
            if default is None:
                key_lines.append(head + "/>\n")
            else:
                key_lines.append(head + f">\n  <default>{_esc_text(str(default))}"
                                 "</default>\n</key>\n")
        return keys[kk]

    for k, v in graph_data.items():
        key(str(k), v, "graph", None)
    for _, d in g._node.items():
        for k, v in d.items():
            key(str(k), v, "node", node_default.get(k))
    edges = list(g._edge_iter(data=True, keys=True))
    for *_, d in edges:
        for k, v in d.items():
            key(str(k), v, "edge", edge_default.get(k))

    def element(tag, attrs, d, scope):
        head = f"<{tag} " + " ".join(f'{a}="{_esc_attr(str(x))}"' for a, x in attrs)
        if not d:
            return head + "/>\n"
        body = "".join(
            f'  <data key="{keys[(str(k), _xml_type(v), scope)]}">'
            f"{_esc_text(str(v))}</data>\n" for k, v in d.items())
        return f"{head}>\n{body}</{tag}>\n"

    out = [_HEADER]
    out.extend(reversed(key_lines))  # networkx inserts each new key first
    out.append('<graph edgedefault="directed">')
    for k, v in graph_data.items():
        out.append(f'<data key="{keys[(str(k), _xml_type(v), "graph")]}">'
                   f"{_esc_text(str(v))}</data>\n")
    for n, d in g._node.items():
        out.append(element("node", [("id", n)], d, "node"))
    for u, v, k, d in edges:
        attrs = [("source", u), ("target", v)]
        if g.is_multigraph():
            attrs.append(("id", k))
        out.append(element("edge", attrs, d, "edge"))
    out.append("</graph></graphml>")
    with open(path, "wb") as f:
        f.write("".join(out).encode("utf-8"))


def _decode(el, keys: Dict) -> Dict:
    data = {}
    for de in el.findall(f"{{{_NS}}}data"):
        name, typ = keys[de.get("key")]
        text = de.text
        if text is None:
            data[name] = ""
        elif typ is bool:
            data[name] = _BOOL[text.lower()]
        else:
            data[name] = typ(text)
    return data


def read_graphml(path: str) -> DiGraph:
    """Read a directed GraphML file as networkx.read_graphml does: a
    DiGraph (predecessor order rebuilt from the successor walk), or a
    MultiDiGraph keyed by edge id when the file holds parallel edges."""
    root = ET.parse(path).getroot()
    keys: Dict = {}
    defaults: Dict = {"node": {}, "edge": {}}
    for k in root.findall(f"{{{_NS}}}key"):
        typ = _PY_TYPE[k.get("attr.type") or "string"]
        keys[k.get("id")] = (k.get("attr.name"), typ)
        dflt = k.find(f"{{{_NS}}}default")
        if dflt is not None and k.get("for") in defaults:
            defaults[k.get("for")][k.get("attr.name")] = (
                _BOOL[dflt.text.lower()] if typ is bool else typ(dflt.text))
    gx = root.find(f"{{{_NS}}}graph")
    if gx is None or gx.get("edgedefault") != "directed":
        raise GraphError(f"{path}: not a directed GraphML graph")
    m = MultiDiGraph()
    m.graph["node_default"] = defaults["node"]
    m.graph["edge_default"] = defaults["edge"]
    for nx_ in gx.findall(f"{{{_NS}}}node"):
        m._put_node(nx_.get("id"), _decode(nx_, keys))
    parallel = False
    edge_ids: Dict = {}
    for ex in gx.findall(f"{{{_NS}}}edge"):
        u, v = ex.get("source"), ex.get("target")
        eid = ex.get("id")
        if eid:
            edge_ids[u, v] = eid
            try:
                eid = int(eid)
            except ValueError:
                pass
        else:
            eid = None
        parallel |= m.has_edge(u, v)
        m._put_edge(u, v, _decode(ex, keys), eid)
    m.graph.update(_decode(gx, keys))
    if parallel:
        return m
    g = DiGraph()
    g.graph.update(m.graph)
    for n, d in m._node.items():
        g._put_node(n, d)
    for u, v, _, d in m._edge_iter(data=True, keys=True):
        g._put_edge(u, v, d)
    for (u, v), eid in edge_ids.items():
        g._succ[u][v]["id"] = eid
    return g
