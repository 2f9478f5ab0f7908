"""Compressed-sparse-row directed graph — the substrate for the data graph G(V, E).

All EAGr compile-phase algorithms (bipartite construction, VNM, IOB, dataflow)
operate on this host-side structure; the JAX runtime consumes flat arrays derived
from it.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CSRGraph:
    """Directed graph in CSR form. ``indptr[v]:indptr[v+1]`` slices ``indices``
    to give the *out*-neighbors of v. Edge (u -> v) means "v consumes u's content"
    when interpreted for ego-centric queries with N(x) = {y | y -> x}."""

    indptr: np.ndarray  # (n+1,) int64
    indices: np.ndarray  # (m,) int32/int64
    n_nodes: int

    @property
    def n_edges(self) -> int:
        return int(self.indices.shape[0])

    def out_neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v] : self.indptr[v + 1]]

    def out_degree(self, v: int) -> int:
        return int(self.indptr[v + 1] - self.indptr[v])

    def out_degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    @staticmethod
    def from_edges(src: np.ndarray, dst: np.ndarray, n_nodes: int) -> "CSRGraph":
        """Build from an edge list; parallel edges are deduplicated."""
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        if src.size:
            key = src * np.int64(n_nodes) + dst
            key = np.unique(key)
            src = key // n_nodes
            dst = key % n_nodes
        counts = np.bincount(src, minlength=n_nodes)
        indptr = np.zeros(n_nodes + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        order = np.argsort(src, kind="stable")
        return CSRGraph(indptr=indptr, indices=dst[order].astype(np.int64), n_nodes=n_nodes)

    def reverse(self) -> "CSRGraph":
        """Reverse all edges (gives in-neighbor adjacency as out-adjacency)."""
        src = np.repeat(np.arange(self.n_nodes, dtype=np.int64), np.diff(self.indptr))
        return CSRGraph.from_edges(self.indices, src, self.n_nodes)

    def edge_list(self) -> tuple[np.ndarray, np.ndarray]:
        src = np.repeat(np.arange(self.n_nodes, dtype=np.int64), np.diff(self.indptr))
        return src, self.indices.copy()

    def two_hop(self, cap_per_node: int | None = None) -> "CSRGraph":
        """Graph whose out-neighbors are the union of 1- and 2-hop out-neighbors.

        Used for 2-hop ego-centric queries (paper §5.4 "Two-hop Aggregates").
        ``cap_per_node`` optionally truncates huge 2-hop lists (hub protection).
        """
        new_src: list[np.ndarray] = []
        new_dst: list[np.ndarray] = []
        for v in range(self.n_nodes):
            one = self.out_neighbors(v)
            if one.size == 0:
                continue
            pieces = [one]
            for u in one:
                pieces.append(self.out_neighbors(int(u)))
            nbrs = np.unique(np.concatenate(pieces))
            nbrs = nbrs[nbrs != v]
            if cap_per_node is not None and nbrs.size > cap_per_node:
                nbrs = nbrs[:cap_per_node]
            new_src.append(np.full(nbrs.size, v, dtype=np.int64))
            new_dst.append(nbrs)
        if not new_src:
            return CSRGraph(np.zeros(self.n_nodes + 1, np.int64), np.zeros(0, np.int64), self.n_nodes)
        return CSRGraph.from_edges(np.concatenate(new_src), np.concatenate(new_dst), self.n_nodes)
