"""Underlay / overlay network model.

The port's own copy of the JAX package's ``net/topology.py``. The
original builds its graphs with networkx; this copy carries ``Graph``, a
small insertion-ordered graph that keeps networkx's storage and
iteration orders, and copies of the searches and generators the model
calls (bidirectional BFS, single-source BFS, connected components,
Prim's minimum spanning tree, the geometric, grid and path generators),
so underlays, paths, categories and spanning trees come out bitwise the
same.

The *underlay* is the physical communication network (e.g. a WiFi mesh);
the *overlay* is the logical network formed by the learning agents, where
each overlay link (i, j) is realized by an underlay routing path p_{i,j}.

Conventions
-----------
* Underlay nodes are integers (``Graph`` node ids).
* Agents are referenced by **index** 0..m-1 in all algorithm-facing code;
  ``OverlayNetwork.agents[idx]`` maps back to the underlay node id.
* Overlay links are unordered pairs ``(i, j)`` with ``i < j`` of agent
  indices. Directed overlay links are ordered pairs ``(i, j)``, i != j.
* Underlay links are undirected with symmetric capacity ``capacity``
  (bytes/second); each *direction* has the full capacity (paper §II-B).
* Routing paths are symmetric: ``p[i,j] == reversed(p[j,i])``.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
import random
from typing import Iterable, Mapping, Sequence

import numpy as np

# 1 Mbps in bytes/second (Roofnet data rate, paper §IV-A2).
MBPS = 125_000.0

# ResNet-50 model size used in the paper (94.47 MB), bytes.
PAPER_MODEL_BYTES = 94.47e6

# ---------------------------------------------------------------------------
# A small insertion-ordered graph (the networkx subset this model uses)
# ---------------------------------------------------------------------------


class _NodeView:
    """``graph.nodes``: iterates node ids in insertion order;
    ``nodes[n]`` is node n's attribute dict."""

    def __init__(self, node: dict):
        self._node = node

    def __iter__(self):
        return iter(self._node)

    def __len__(self) -> int:
        return len(self._node)

    def __getitem__(self, n) -> dict:
        return self._node[n]


class _EdgeView:
    """``graph.edges``: each undirected edge once, as ``(u, v)`` where u is
    the endpoint met first in node order and v follows u's adjacency
    order; ``edges(data=True)`` adds the attribute dict and
    ``edges[u, v]`` returns it."""

    def __init__(self, adj: dict):
        self._adj = adj

    def __call__(self, data: bool = False):
        seen = set()
        for n, nbrs in self._adj.items():
            for nbr, dd in nbrs.items():
                if nbr not in seen:
                    yield (n, nbr, dd) if data else (n, nbr)
            seen.add(n)

    def __iter__(self):
        return self()

    def __getitem__(self, e) -> dict:
        u, v = e
        return self._adj[u][v]


class Graph:
    """Undirected simple graph with insertion-ordered adjacency.

    The part of ``networkx.Graph`` (3.x) the network model uses, with its
    storage — ``_node`` (node → attribute dict) and ``_adj`` (node →
    neighbour → edge-attribute dict shared by both directions), both
    insertion-ordered — and its update rules, so every iteration order,
    and with it every tie the searches below break, is the one networkx
    gives: adding an existing edge keeps its place, ``remove_edge`` then
    ``add_edge`` moves it to the end of both adjacency rows, and ``copy``
    (like ``Graph(g)``) re-inserts the edges in adjacency order.
    """

    def __init__(self, incoming: "Graph | None" = None):
        self._node: dict = {}
        self._adj: dict = {}
        if incoming is not None:
            # networkx.Graph(g): nodes, then every adjacency entry (each
            # edge twice) in order, then the node attributes.
            self.add_nodes_from(incoming._adj)
            self.add_edges_from(
                (u, v, dd)
                for u, nbrs in incoming._adj.items()
                for v, dd in nbrs.items()
            )
            for n, dd in incoming._node.items():
                self._node[n].update(dd)

    def __iter__(self):
        return iter(self._node)

    def __len__(self) -> int:
        return len(self._node)

    @property
    def nodes(self) -> _NodeView:
        return _NodeView(self._node)

    @property
    def edges(self) -> _EdgeView:
        return _EdgeView(self._adj)

    @property
    def adj(self) -> dict:
        return self._adj

    @property
    def degree(self):
        """``(node, degree)`` pairs in node order (a self-loop counts 2)."""
        return [
            (n, len(nbrs) + (n in nbrs)) for n, nbrs in self._adj.items()
        ]

    def number_of_nodes(self) -> int:
        return len(self._node)

    def number_of_edges(self) -> int:
        return sum(d for _, d in self.degree) // 2

    def add_node(self, n, **attr) -> None:
        if n not in self._node:
            self._adj[n] = {}
            self._node[n] = {}
        self._node[n].update(attr)

    def add_nodes_from(self, nodes: Iterable) -> None:
        """Node ids, or ``(node, attribute dict)`` pairs."""
        for n in nodes:
            if isinstance(n, tuple) and len(n) == 2 and isinstance(n[1], dict):
                n, attr = n
            else:
                attr = {}
            self.add_node(n, **attr)

    def add_edge(self, u, v, **attr) -> None:
        for n in (u, v):
            if n not in self._node:
                self._adj[n] = {}
                self._node[n] = {}
        datadict = self._adj[u].get(v, {})
        datadict.update(attr)
        self._adj[u][v] = datadict
        self._adj[v][u] = datadict

    def add_edges_from(self, edges: Iterable) -> None:
        """``(u, v)`` pairs, or ``(u, v, attribute dict)`` triples."""
        for e in edges:
            if len(e) == 3:
                u, v, dd = e
            else:
                (u, v), dd = e, {}
            self.add_edge(u, v, **dd)

    def remove_edge(self, u, v) -> None:
        del self._adj[u][v]
        if u != v:
            del self._adj[v][u]

    def copy(self) -> "Graph":
        g = Graph()
        g.add_nodes_from((n, d.copy()) for n, d in self._node.items())
        g.add_edges_from(
            (u, v, dd.copy())
            for u, nbrs in self._adj.items()
            for v, dd in nbrs.items()
        )
        return g


def set_edge_attributes(g: Graph, value, name: str) -> None:
    """One value for attribute ``name`` on every edge."""
    for _, _, data in g.edges(data=True):
        data[name] = value


def _plain_bfs(g: Graph, n: int, source) -> set:
    """The nodes reachable from ``source``, as networkx's component BFS
    builds the set (insertion sequence and all, so its iteration order is
    networkx's too)."""
    adj = g._adj
    seen = {source}
    nextlevel = [source]
    while nextlevel:
        thislevel = nextlevel
        nextlevel = []
        for v in thislevel:
            for w in adj[v]:
                if w not in seen:
                    seen.add(w)
                    nextlevel.append(w)
            if len(seen) == n:
                return seen
    return seen


def connected_components(g: Graph):
    """Node sets of the components, in the order of their first node."""
    seen: set = set()
    n = len(g)
    for v in g:
        if v not in seen:
            c = _plain_bfs(g, n - len(seen), v)
            seen.update(c)
            yield c


def is_connected(g: Graph) -> bool:
    if len(g) == 0:
        raise ValueError("connectivity is undefined for the null graph")
    return len(next(connected_components(g))) == len(g)


def shortest_path(g: Graph, source, target) -> list:
    """Hop-count shortest path by networkx's bidirectional BFS: the smaller
    fringe grows first (forward on a tie), neighbours in adjacency order,
    and the search stops at the first node both sides have reached — the
    same tie-break among equal-length paths."""
    if source not in g._node or target not in g._node:
        raise KeyError(f"source {source} or target {target} not in graph")
    if target == source:
        pred, succ, w = {target: None}, {source: None}, source
    else:
        pred, succ, w = _bidirectional_pred_succ(g._adj, source, target)
    path = []
    while w is not None:
        path.append(w)
        w = pred[w]
    path.reverse()
    w = succ[path[-1]]
    while w is not None:
        path.append(w)
        w = succ[w]
    return path


def _bidirectional_pred_succ(adj: dict, source, target):
    pred = {source: None}
    succ = {target: None}
    forward_fringe = [source]
    reverse_fringe = [target]
    while forward_fringe and reverse_fringe:
        if len(forward_fringe) <= len(reverse_fringe):
            this_level = forward_fringe
            forward_fringe = []
            for v in this_level:
                for w in adj[v]:
                    if w not in pred:
                        forward_fringe.append(w)
                        pred[w] = v
                    if w in succ:
                        return pred, succ, w
        else:
            this_level = reverse_fringe
            reverse_fringe = []
            for v in this_level:
                for w in adj[v]:
                    if w not in succ:
                        succ[w] = v
                        reverse_fringe.append(w)
                    if w in pred:
                        return pred, succ, w
    raise ValueError(f"no path between {source} and {target}")


def single_source_shortest_path(g: Graph, source) -> dict:
    """Hop-count shortest path from ``source`` to every reachable node,
    level by level in adjacency order (networkx's ``method="bfs"``)."""
    if source not in g._node:
        raise KeyError(f"source {source} not in graph")
    adj = g._adj
    paths = {source: [source]}
    nextlevel = [source]
    n = len(adj)
    while nextlevel:
        thislevel = nextlevel
        nextlevel = []
        for v in thislevel:
            for w in adj[v]:
                if w not in paths:
                    paths[w] = paths[v] + [w]
                    nextlevel.append(w)
            if len(paths) == n:
                return paths
    return paths


def minimum_spanning_tree(g: Graph, weight: str = "weight") -> Graph:
    """networkx's ``minimum_spanning_tree(g, weight, algorithm="prim")``:
    the spanning tree (forest) as a new ``Graph`` holding every node and
    the tree's edges with their attribute dicts.

    Prim as networkx runs it, so ties fall the same way: the start node
    is ``set(g).pop()`` (node 0 for agent indices 0..m−1), each visited
    node's edges are pushed in adjacency order as ``(weight,
    next(counter), u, v, data)`` on one heap, and a missing weight counts
    1. A NaN weight raises.
    """
    tree = Graph()
    tree.add_nodes_from((n, dict(g.nodes[n])) for n in g)
    nodes = set(g)
    counter = itertools.count()

    def push(frontier, u, v, d):
        wt = d.get(weight, 1)
        if math.isnan(wt):
            raise ValueError(f"NaN found as an edge weight. Edge {(u, v, d)}")
        heapq.heappush(frontier, (wt, next(counter), u, v, d))

    while nodes:
        u = nodes.pop()
        frontier: list = []
        visited = {u}
        for v, d in g.adj[u].items():
            push(frontier, u, v, d)
        while nodes and frontier:
            _, _, u, v, d = heapq.heappop(frontier)
            if v in visited or v not in nodes:
                continue
            tree.add_edge(u, v, **d)
            visited.add(v)
            nodes.discard(v)
            for w, d2 in g.adj[v].items():
                if w not in visited:
                    push(frontier, v, w, d2)
    return tree


def path_graph(n: int) -> Graph:
    g = Graph()
    g.add_nodes_from(range(n))
    g.add_edges_from((i, i + 1) for i in range(n - 1))
    return g


def grid_2d_graph(rows: int, cols: int) -> Graph:
    """The rows × cols grid with nodes numbered in networkx's
    ``convert_node_labels_to_integers(grid_2d_graph(rows, cols))`` order:
    the (i, j) grid is built column edges first, then relabelled in node
    order with its edges re-added in edge-iteration order."""
    grid = Graph()
    grid.add_nodes_from((i, j) for i in range(rows) for j in range(cols))
    grid.add_edges_from(
        ((i, j), (i - 1, j)) for i in range(1, rows) for j in range(cols)
    )
    grid.add_edges_from(
        ((i, j), (i, j - 1)) for i in range(rows) for j in range(1, cols)
    )
    label = {n: k for k, n in enumerate(grid)}
    g = Graph()
    g.add_nodes_from(label[n] for n in grid)
    g.add_edges_from(
        (label[u], label[v], d.copy()) for u, v, d in grid.edges(data=True)
    )
    return g


def random_geometric_graph(n: int, radius: float, seed: int) -> Graph:
    """networkx's ``random_geometric_graph(n, radius, seed=seed)`` in 2-D:
    positions from ``random.Random(seed)`` in node order, x then y; edges
    are the pairs within ``radius`` (Euclidean, ``cKDTree.query_pairs``),
    added in sorted order."""
    from scipy.spatial import cKDTree

    rng = random.Random(seed)
    g = Graph()
    g.add_nodes_from(range(n))
    for v in g:
        g._node[v]["pos"] = [rng.random() for _ in range(2)]
    nodes = list(g)
    coords = [g._node[v]["pos"] for v in nodes]
    pairs = cKDTree(coords).query_pairs(radius, 2)
    g.add_edges_from((nodes[u], nodes[v]) for u, v in sorted(pairs))
    return g



@dataclasses.dataclass(frozen=True)
class Underlay:
    """Physical network: an undirected capacitated graph."""

    graph: Graph

    @property
    def num_nodes(self) -> int:
        return self.graph.number_of_nodes()

    @property
    def num_links(self) -> int:
        return self.graph.number_of_edges()

    def capacity(self, u: int, v: int) -> float:
        return float(self.graph.edges[u, v]["capacity"])

    def shortest_path(self, src: int, dst: int) -> tuple[int, ...]:
        """Hop-count shortest path (paper assumes hop-count routing)."""
        return tuple(shortest_path(self.graph, src, dst))

    def directed_capacities(self) -> dict[tuple[int, int], float]:
        """Capacity per *directed* underlay edge (each direction full)."""
        caps: dict[tuple[int, int], float] = {}
        for u, v, data in self.graph.edges(data=True):
            caps[(u, v)] = float(data["capacity"])
            caps[(v, u)] = float(data["capacity"])
        return caps

    def with_scaled_capacities(
        self, scale: float | Mapping[tuple[int, int], float]
    ) -> "Underlay":
        """New underlay with capacities multiplied by ``scale``.

        ``scale`` is a global factor or a per-undirected-edge map (either
        key order accepted; missing edges keep factor 1.0). Used to build
        statically degraded networks for scenario pricing.
        """
        g = self.graph.copy()
        for u, v, data in g.edges(data=True):
            if isinstance(scale, Mapping):
                f = scale.get((u, v), scale.get((v, u), 1.0))
            else:
                f = scale
            data["capacity"] = float(data["capacity"]) * float(f)
        out = Underlay(graph=g)
        out.validate()
        return out

    def validate(self) -> None:
        if not is_connected(self.graph):
            raise ValueError("underlay must be connected")
        for u, v, data in self.graph.edges(data=True):
            if data.get("capacity", 0) <= 0:
                raise ValueError(f"link ({u},{v}) has non-positive capacity")


def _path_edges_directed(path: Sequence[int]) -> tuple[tuple[int, int], ...]:
    """Directed underlay edges along a node path."""
    return tuple((path[k], path[k + 1]) for k in range(len(path) - 1))


@dataclasses.dataclass(frozen=True)
class OverlayNetwork:
    """Overlay of m agents atop an underlay, with fixed symmetric routing.

    ``paths[(i, j)]`` (agent indices, any order) is the underlay node path
    from agent i's node to agent j's node.
    """

    underlay: Underlay
    agents: tuple[int, ...]  # agent index -> underlay node id
    paths: Mapping[tuple[int, int], tuple[int, ...]]

    @property
    def num_agents(self) -> int:
        return len(self.agents)

    @property
    def overlay_links(self) -> tuple[tuple[int, int], ...]:
        """All undirected overlay links (full overlay), i < j, agent indices."""
        m = self.num_agents
        return tuple((i, j) for i in range(m) for j in range(i + 1, m))

    @property
    def directed_overlay_links(self) -> tuple[tuple[int, int], ...]:
        m = self.num_agents
        return tuple((i, j) for i in range(m) for j in range(m) if i != j)

    def path(self, i: int, j: int) -> tuple[int, ...]:
        """Underlay node path for directed overlay link i -> j."""
        if (i, j) in self.paths:
            return self.paths[(i, j)]
        return tuple(reversed(self.paths[(j, i)]))

    def path_edges(self, i: int, j: int) -> tuple[tuple[int, int], ...]:
        """Directed underlay edges traversed by directed overlay link i->j."""
        return _path_edges_directed(self.path(i, j))

    def propagation_delay(self, i: int, j: int) -> float:
        """Edge networks: negligible propagation delay (paper §III-A2)."""
        return 0.0

    def batched_path_edges(
        self,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """All (overlay-link, underlay-edge) incidence pairs as flat arrays.

        Returns ``(link, u, v, rank)`` int64 arrays with one row per
        directed underlay edge ``(u, v)`` traversed by a directed overlay
        link: ``link`` indexes ``directed_overlay_links`` (i-major order,
        ``i·(m−1) + j − [j > i]``), and ``rank`` is a strictly increasing
        key along each link's path and across links in that order —
        ``argsort(rank)`` recovers the exact per-hop traversal order a
        ``for (i, j) in directed_overlay_links: for e in path_edges(i, j)``
        double loop would visit. Rows are *emitted* batched by path
        length (each bucket is one stacked-matrix slice), not in
        traversal order; consumers that need order sort by ``rank``.

        This is the array replacement for the per-link ``path_edges``
        loop: the Python work is O(#pairs) dict lookups plus a few dozen
        per-length batches, while the per-hop work is numpy.
        """
        m = self.num_agents
        empty = np.empty(0, dtype=np.int64)
        if m < 2:
            return empty, empty, empty, empty
        # Bucket the m(m−1)/2 stored paths by length so each bucket
        # vectorizes as one [n, k+1] node matrix. When the paths mapping
        # holds exactly one entry per unordered pair (any key order),
        # iterate it directly; otherwise walk the pairs through
        # ``path()`` (which resolves reversed keys).
        by_len: dict[int, tuple[list, list, list]] = {}
        if len(self.paths) == m * (m - 1) // 2:
            for (a, b_), p in self.paths.items():
                if a > b_:
                    a, b_, p = b_, a, tuple(reversed(p))
                b = by_len.get(len(p))
                if b is None:
                    b = by_len[len(p)] = ([], [], [])
                b[0].append(a)
                b[1].append(b_)
                b[2].append(p)
        else:
            for i in range(m):
                for j in range(i + 1, m):
                    p = self.path(i, j)
                    b = by_len.get(len(p))
                    if b is None:
                        b = by_len[len(p)] = ([], [], [])
                    b[0].append(i)
                    b[1].append(j)
                    b[2].append(p)
        stride = max(by_len) - 1  # ≥ every path's edge count
        links, us, vs, ranks = [], [], [], []
        for npath, (ilist, jlist, plist) in sorted(by_len.items()):
            k = npath - 1
            if k <= 0:
                continue  # duplicate placement is rejected by validate()
            nodes = np.asarray(plist, dtype=np.int64)  # [n, k+1]
            li = np.asarray(ilist, dtype=np.int64)
            lj = np.asarray(jlist, dtype=np.int64)
            t = np.arange(k, dtype=np.int64)
            # Forward direction i→j: edges (p_t, p_{t+1}) in path order.
            lf = li * (m - 1) + lj - 1  # j > i
            links.append(np.repeat(lf, k))
            us.append(nodes[:, :-1].ravel())
            vs.append(nodes[:, 1:].ravel())
            ranks.append((lf[:, None] * stride + t).ravel())
            # Reverse direction j→i traverses the reversed node path.
            lr = lj * (m - 1) + li  # i < j
            links.append(np.repeat(lr, k))
            us.append(nodes[:, :0:-1].ravel())
            vs.append(nodes[:, -2::-1].ravel())
            ranks.append((lr[:, None] * stride + t).ravel())
        if not links:
            return empty, empty, empty, empty
        return (
            np.concatenate(links),
            np.concatenate(us),
            np.concatenate(vs),
            np.concatenate(ranks),
        )

    def validate(self) -> None:
        self.underlay.validate()
        if len(set(self.agents)) != len(self.agents):
            raise ValueError("duplicate agent placement")
        for i, j in self.overlay_links:
            p = self.path(i, j)
            if p[0] != self.agents[i] or p[-1] != self.agents[j]:
                raise ValueError(f"path for ({i},{j}) has wrong endpoints")
            rev = self.path(j, i)
            if tuple(reversed(rev)) != p:
                raise ValueError(f"asymmetric path for ({i},{j})")


def build_overlay(
    underlay: Underlay, agent_nodes: Sequence[int], method: str = "pairwise"
) -> OverlayNetwork:
    """Place agents on ``agent_nodes`` and route via hop-count shortest paths.

    Symmetry is enforced by computing each path once per unordered pair.
    ``method="bfs"`` runs one single-source BFS per agent instead of one
    search per pair — the only way to build 500+-agent overlays in
    reasonable time (m BFS sweeps vs m²/2 searches). Hop counts are
    identical; among equal-length paths the BFS tie-break may differ from
    the pairwise search, so the default stays "pairwise" for
    reproducibility of existing category structures.
    """
    agents = tuple(agent_nodes)
    paths: dict[tuple[int, int], tuple[int, ...]] = {}
    if method == "pairwise":
        for i in range(len(agents)):
            for j in range(i + 1, len(agents)):
                paths[(i, j)] = underlay.shortest_path(agents[i], agents[j])
    elif method == "bfs":
        for i in range(len(agents)):
            sp = single_source_shortest_path(underlay.graph, agents[i])
            for j in range(i + 1, len(agents)):
                paths[(i, j)] = tuple(sp[agents[j]])
    else:
        raise ValueError(f"unknown overlay build method {method!r}")
    ov = OverlayNetwork(underlay=underlay, agents=agents, paths=paths)
    ov.validate()
    return ov


def lowest_degree_nodes(underlay: Underlay, m: int) -> list[int]:
    """The paper selects the m lowest-degree underlay nodes as agents."""
    deg = sorted(underlay.graph.degree, key=lambda kv: (kv[1], kv[0]))
    return [n for n, _ in deg[:m]]


def mid_path_edges(
    overlay: OverlayNetwork, pairs: Sequence[tuple[int, int]]
) -> tuple[tuple[int, int], ...]:
    """Undirected mid-path underlay hops of the given overlay links'
    default paths — the hops a re-route can actually avoid (agent access
    edges, which every schedule must cross, are excluded). The canonical
    edge set for localized-degradation scenarios; sorted (min, max)
    pairs, deduplicated across links."""
    return tuple(sorted({
        (min(e), max(e))
        for (i, j) in pairs
        for e in overlay.path_edges(i, j)[1:-1]
    }))


# ---------------------------------------------------------------------------
# Topology generators
# ---------------------------------------------------------------------------


def roofnet_like(
    seed: int = 0,
    num_nodes: int = 38,
    num_links: int = 219,
    capacity: float = MBPS,
) -> Underlay:
    """Roofnet-statistics-matched surrogate (38 nodes, 219 links, 1 Mbps).

    The real Roofnet link-level measurement data is not shipped offline;
    we generate a random geometric mesh with the same node/link counts and
    uniform 1 Mbps capacity (paper §IV-A2), deterministic in ``seed``.
    """
    rng = np.random.default_rng(seed)
    pts = rng.random((num_nodes, 2))
    # Distance-ranked candidate edges; take the shortest ones that keep the
    # graph simple, then repair connectivity, then trim back to num_links.
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    order = sorted(
        ((i, j) for i in range(num_nodes) for j in range(i + 1, num_nodes)),
        key=lambda e: d2[e[0], e[1]],
    )
    g = Graph()
    g.add_nodes_from(range(num_nodes))
    g.add_edges_from(order[:num_links])
    # Repair connectivity by linking components with their closest node pair.
    while not is_connected(g):
        comps = list(connected_components(g))
        best = None
        for a, b in itertools.combinations(range(len(comps)), 2):
            for u in comps[a]:
                for v in comps[b]:
                    if best is None or d2[u, v] < d2[best[0], best[1]]:
                        best = (u, v)
        g.add_edge(*best)
    # Trim longest non-bridge edges back down to num_links.
    extra = g.number_of_edges() - num_links
    if extra > 0:
        for u, v in sorted(g.edges, key=lambda e: -d2[e[0], e[1]]):
            if extra == 0:
                break
            g.remove_edge(u, v)
            if is_connected(g):
                extra -= 1
            else:
                g.add_edge(u, v)
    set_edge_attributes(g, capacity, "capacity")
    u = Underlay(graph=g)
    u.validate()
    return u


def line_underlay(n: int, capacity: float = MBPS) -> Underlay:
    g = path_graph(n)
    set_edge_attributes(g, capacity, "capacity")
    return Underlay(graph=g)


def grid_underlay(rows: int, cols: int, capacity: float = MBPS) -> Underlay:
    g = grid_2d_graph(rows, cols)
    set_edge_attributes(g, capacity, "capacity")
    return Underlay(graph=g)


def random_geometric_underlay(
    n: int, radius: float = 0.35, seed: int = 0, capacity: float = MBPS
) -> Underlay:
    """Connected random geometric graph (generic edge-network surrogate)."""
    for attempt in range(100):
        g = random_geometric_graph(n, radius, seed=seed + attempt)
        if is_connected(g):
            set_edge_attributes(g, capacity, "capacity")
            return Underlay(graph=Graph(g))
    raise RuntimeError("could not generate a connected geometric graph")


def dumbbell_underlay(
    left: int = 2, right: int = 2, capacity: float = MBPS
) -> Underlay:
    """Two stars joined by one shared bottleneck link (Fig. 2 scenario).

    Nodes 0..left-1 attach to hub L; nodes left..left+right-1 attach to hub
    R; L—R is the shared bottleneck. Useful for unit tests of link sharing.
    """
    g = Graph()
    hub_l, hub_r = left + right, left + right + 1
    for i in range(left):
        g.add_edge(i, hub_l, capacity=capacity)
    for i in range(left, left + right):
        g.add_edge(i, hub_r, capacity=capacity)
    g.add_edge(hub_l, hub_r, capacity=capacity)
    return Underlay(graph=g)


def ici_torus_underlay(
    x: int, y: int, capacity: float = 50e9
) -> Underlay:
    """TPU ICI 2-D torus as an 'underlay' (hardware adaptation, DESIGN §4).

    Each chip is a node; wrap-around links with ~50 GB/s per direction.
    Lets the paper's congestion machinery reason about gossip schedules on
    the pod fabric itself.
    """
    g = Graph()
    for i in range(x):
        for j in range(y):
            n = i * y + j
            g.add_edge(n, ((i + 1) % x) * y + j, capacity=capacity)
            g.add_edge(n, i * y + (j + 1) % y, capacity=capacity)
    return Underlay(graph=g)
