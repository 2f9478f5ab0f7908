"""The aggregation overlay graph O_G (paper §2.2.1).

Three node kinds:
  'W' writer nodes (one per base node that produces consumed content),
  'I' partial aggregation (intermediate / virtual) nodes,
  'R' reader nodes (one per base node satisfying pred).

Edges carry a sign: +1 normal, -1 "negative" (subtraction) edges (§2.2.1).
For duplicate-sensitive aggregates, the *net signed path count* from any writer to
any reader it feeds must be exactly 1; duplicate-insensitive overlays only require
set-reachability to match the bipartite graph.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Overlay:
    kinds: list[str]                       # per overlay node: 'W' | 'I' | 'R'
    origin: list[int]                      # base node id for W/R nodes, -1 for I
    in_edges: list[list[tuple[int, int]]]  # per node: list of (src_node, sign)
    dup_insensitive: bool = False

    # ------------------------------------------------------------------ basics
    @property
    def n_nodes(self) -> int:
        return len(self.kinds)

    @property
    def n_edges(self) -> int:
        return sum(len(e) for e in self.in_edges)

    def add_node(self, kind: str, origin: int = -1) -> int:
        self.kinds.append(kind)
        self.origin.append(origin)
        self.in_edges.append([])
        return len(self.kinds) - 1

    def add_edge(self, src: int, dst: int, sign: int = 1) -> None:
        self.in_edges[dst].append((src, sign))

    def writer_nodes(self) -> list[int]:
        return [i for i, k in enumerate(self.kinds) if k == "W"]

    def reader_nodes(self) -> list[int]:
        return [i for i, k in enumerate(self.kinds) if k == "R"]

    def out_edges(self) -> list[list[tuple[int, int]]]:
        out: list[list[tuple[int, int]]] = [[] for _ in range(self.n_nodes)]
        for dst, ins in enumerate(self.in_edges):
            for src, sign in ins:
                out[src].append((dst, sign))
        return out

    def in_degree(self, v: int) -> int:
        return len(self.in_edges[v])

    # ------------------------------------------------------------------ metrics
    def sharing_index(self, bipartite_edges: int) -> float:
        """SI = 1 - |E_overlay| / |E_bipartite| (paper §3.1)."""
        if bipartite_edges == 0:
            return 0.0
        return 1.0 - self.n_edges / bipartite_edges

    def depth_per_reader(self) -> dict[int, int]:
        """Overlay depth of each reader = longest writer->reader path (§5.2)."""
        depth = [0] * self.n_nodes
        for v in self.toposort():
            for src, _ in self.in_edges[v]:
                depth[v] = max(depth[v], depth[src] + 1)
        return {v: depth[v] for v in self.reader_nodes()}

    # ------------------------------------------------------------------ order
    def toposort(self) -> list[int]:
        indeg = [len(e) for e in self.in_edges]
        out = self.out_edges()
        stack = [v for v in range(self.n_nodes) if indeg[v] == 0]
        order: list[int] = []
        while stack:
            v = stack.pop()
            order.append(v)
            for dst, _ in out[v]:
                indeg[dst] -= 1
                if indeg[dst] == 0:
                    stack.append(dst)
        if len(order) != self.n_nodes:
            raise ValueError("overlay graph contains a cycle")
        return order

    def levels(self) -> np.ndarray:
        """level[v] = longest path from any source to v (writers are level 0)."""
        level = np.zeros(self.n_nodes, dtype=np.int64)
        for v in self.toposort():
            for src, _ in self.in_edges[v]:
                level[v] = max(level[v], level[src] + 1)
        return level

    # ------------------------------------------------------------------ validation
    def contributions(self) -> list[dict[int, int]]:
        """Net signed writer contributions per node (exponential-free DP; for
        tests / small overlays). contributions()[r] maps base writer id -> count."""
        contrib: list[dict[int, int]] = [dict() for _ in range(self.n_nodes)]
        for v in self.toposort():
            if self.kinds[v] == "W":
                contrib[v] = {self.origin[v]: 1}
                continue
            acc: dict[int, int] = {}
            for src, sign in self.in_edges[v]:
                for w, c in contrib[src].items():
                    acc[w] = acc.get(w, 0) + sign * c
            contrib[v] = {w: c for w, c in acc.items() if c != 0}
        return contrib

    def validate(self, reader_inputs: dict[int, set[int]]) -> None:
        """Check the overlay computes exactly the bipartite spec.

        reader_inputs: base reader id -> set of base writer ids (= N(reader)).
        Raises AssertionError on any violation.
        """
        contrib = self.contributions()
        for r in self.reader_nodes():
            base = self.origin[r]
            want = reader_inputs[base]
            got = contrib[r]
            assert set(got.keys()) == set(want), (
                f"reader {base}: writers {sorted(got.keys())} != expected {sorted(want)}"
            )
            if self.dup_insensitive:
                assert all(c >= 1 for c in got.values()), f"reader {base}: negative net path count"
            else:
                bad = {w: c for w, c in got.items() if c != 1}
                assert not bad, f"reader {base}: duplicate/cancelled contributions {bad}"

    # ------------------------------------------------------------------ pruning
    def pruned(self) -> "Overlay":
        """Drop W/I nodes with no path to any reader (e.g. orphaned splits)."""
        useful = [False] * self.n_nodes
        order = self.toposort()
        for v in reversed(order):
            if self.kinds[v] == "R":
                useful[v] = True
        out = self.out_edges()
        for v in reversed(order):
            if useful[v]:
                continue
            useful[v] = any(useful[d] for d, _ in out[v])
        remap = {}
        ov = Overlay(kinds=[], origin=[], in_edges=[], dup_insensitive=self.dup_insensitive)
        for v in range(self.n_nodes):
            if useful[v]:
                remap[v] = ov.add_node(self.kinds[v], self.origin[v])
        for v in range(self.n_nodes):
            if not useful[v]:
                continue
            for src, sign in self.in_edges[v]:
                ov.add_edge(remap[src], remap[v], sign)
        return ov

    # ------------------------------------------------------------------ I-sets
    def input_writer_sets(self) -> list[set[int]]:
        """I(ovl): set of base writers aggregated by each node (ignoring signs)."""
        sets: list[set[int]] = [set() for _ in range(self.n_nodes)]
        for v in self.toposort():
            if self.kinds[v] == "W":
                sets[v] = {self.origin[v]}
            else:
                s: set[int] = set()
                for src, sign in self.in_edges[v]:
                    if sign > 0:
                        s |= sets[src]
                    else:
                        s -= sets[src]
                sets[v] = s
        return sets


def overlay_from_flat(
    kinds: list[str],
    origin: list[int],
    src: list[int],
    indptr: np.ndarray,
    signs: list[int] | None = None,
    dup_insensitive: bool = False,
) -> Overlay:
    """Materialize an Overlay from flat per-destination-grouped edge arrays:
    node v's in-edge sources are ``src[indptr[v]:indptr[v+1]]`` (in in-edge
    order). ``signs=None`` means all edges are positive. This is the bulk
    constructor for the vectorized assembly path — per-node Python edge lists
    are built in one pass instead of via n_edges ``add_edge`` calls."""
    in_edges: list[list[tuple[int, int]]] = []
    if signs is None:
        for a, b in zip(indptr[:-1], indptr[1:]):
            in_edges.append([(s, 1) for s in src[a:b]])
    else:
        for a, b in zip(indptr[:-1], indptr[1:]):
            in_edges.append(list(zip(src[a:b], signs[a:b])))
    return Overlay(kinds=list(kinds), origin=[int(o) for o in origin],
                   in_edges=in_edges, dup_insensitive=dup_insensitive)


def all_pull_overlay(reader_inputs: dict[int, "np.ndarray"], writers: np.ndarray) -> Overlay:
    """Baseline: direct writer->reader edges, no sharing (the bipartite graph
    itself as an overlay). Used for the *all-pull* / *all-push* baselines."""
    ov = Overlay(kinds=[], origin=[], in_edges=[])
    wmap: dict[int, int] = {}
    for w in writers:
        wmap[int(w)] = ov.add_node("W", int(w))
    for r, ins in reader_inputs.items():
        rid = ov.add_node("R", int(r))
        for w in ins:
            ov.add_edge(wmap[int(w)], rid)
    return ov
