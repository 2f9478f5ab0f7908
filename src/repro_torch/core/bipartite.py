"""Bipartite writer/reader graph A_G construction (paper §3.1, Figure 1c).

Given the data graph G, a neighborhood selection function N(), and a predicate
over V, produce the directed bipartite graph: writer nodes -> reader nodes,
where reader v's inputs are N(v).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.graphs.csr import CSRGraph


@dataclasses.dataclass
class Bipartite:
    n_base: int
    reader_inputs: dict[int, np.ndarray]  # base reader id -> sorted base writer ids
    writers: np.ndarray                   # base ids of nodes that feed >=1 reader

    @property
    def n_edges(self) -> int:
        return sum(v.size for v in self.reader_inputs.values())

    @property
    def n_readers(self) -> int:
        return len(self.reader_inputs)

    def reader_input_sets(self) -> dict[int, set[int]]:
        return {r: set(map(int, ins)) for r, ins in self.reader_inputs.items()}

    def writer_out_degrees(self) -> dict[int, int]:
        deg: dict[int, int] = {}
        for ins in self.reader_inputs.values():
            for w in ins:
                deg[int(w)] = deg.get(int(w), 0) + 1
        return deg


def build_bipartite(
    graph: CSRGraph,
    *,
    hops: int = 1,
    pred: Callable[[int], bool] | None = None,
    neighborhood: Callable[[CSRGraph, int], np.ndarray] | None = None,
    two_hop_cap: int | None = None,
) -> Bipartite:
    """N(x) defaults to the in-neighborhood {y | y -> x} (paper's running example),
    extended to the 2-hop in-neighborhood for hops=2 (§5.4). A custom
    ``neighborhood(graph, v)`` callable supports filtered neighborhoods."""
    # in-neighbors as out-adjacency of the reversed graph
    rev = graph.reverse()
    if hops == 2:
        rev = rev.two_hop(cap_per_node=two_hop_cap)
    elif hops != 1:
        raise ValueError(f"hops must be 1 or 2, got {hops}")

    if pred is None and neighborhood is None:
        # bulk path: CSR rows are already deduplicated and sorted, so reader
        # lists are direct row views and the writer set is one np.unique
        reader_inputs = {
            int(v): rev.indices[rev.indptr[v]: rev.indptr[v + 1]]
            for v in np.flatnonzero(np.diff(rev.indptr) > 0)
        }
        return Bipartite(
            n_base=graph.n_nodes,
            reader_inputs=reader_inputs,
            writers=np.unique(rev.indices),
        )

    reader_inputs = {}
    writer_set: set[int] = set()
    for v in range(graph.n_nodes):
        if pred is not None and not pred(v):
            continue
        if neighborhood is not None:
            ins = np.asarray(neighborhood(graph, v), dtype=np.int64)
        else:
            ins = rev.out_neighbors(v)
        if ins.size == 0:
            continue
        ins = np.unique(ins)
        reader_inputs[v] = ins
        writer_set.update(map(int, ins))
    return Bipartite(
        n_base=graph.n_nodes,
        reader_inputs=reader_inputs,
        writers=np.array(sorted(writer_set), dtype=np.int64),
    )
