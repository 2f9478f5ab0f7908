"""Neighbor sampler for mini-batch GNN training (GraphSAGE-style fanouts).

The JAX package's ``repro.graphs.sampler``, copied (pure numpy). Produces
fixed-shape padded layered subgraphs so the downstream step sees stable
shapes: for fanouts [f1, f2] and a seed batch of B nodes, layer sizes are
exactly B, B*f1, B*f1*f2 (with padding + validity masks for nodes with fewer
neighbors). This is the `minibatch_lg` shape's real sampler — not a stub.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graphs.csr import CSRGraph


@dataclasses.dataclass
class SampledBlock:
    """One message-passing block: edges from src-layer nodes to dst-layer nodes."""

    src_nodes: np.ndarray   # (n_src,) global node ids (padded with 0)
    dst_nodes: np.ndarray   # (n_dst,) global node ids
    edge_src: np.ndarray    # (n_dst * fanout,) local indices into src_nodes
    edge_dst: np.ndarray    # (n_dst * fanout,) local indices into dst_nodes (sorted)
    edge_mask: np.ndarray   # (n_dst * fanout,) bool validity
    src_mask: np.ndarray    # (n_src,) bool validity


class NeighborSampler:
    """Uniform neighbor sampling over the *in*-adjacency (aggregation direction)."""

    def __init__(self, graph: CSRGraph, fanouts: tuple[int, ...], seed: int = 0):
        self.adj = graph  # caller passes the adjacency in aggregation direction
        self.fanouts = tuple(fanouts)
        self.rng = np.random.default_rng(seed)

    def sample(self, seed_nodes: np.ndarray) -> list[SampledBlock]:
        """Returns blocks ordered from the input layer to the seed layer."""
        blocks: list[SampledBlock] = []
        dst = np.asarray(seed_nodes, dtype=np.int64)
        dst_mask = np.ones(dst.shape[0], dtype=bool)
        for fanout in self.fanouts:
            n_dst = dst.shape[0]
            edge_src_global = np.zeros(n_dst * fanout, dtype=np.int64)
            edge_mask = np.zeros(n_dst * fanout, dtype=bool)
            for i in range(n_dst):
                if not dst_mask[i]:
                    continue
                nbrs = self.adj.out_neighbors(int(dst[i]))
                if nbrs.size == 0:
                    continue
                take = min(fanout, nbrs.size)
                chosen = self.rng.choice(nbrs, size=take, replace=nbrs.size < fanout)
                edge_src_global[i * fanout : i * fanout + take] = chosen
                edge_mask[i * fanout : i * fanout + take] = True
            # Unique source layer (dst nodes are also carried for self features).
            src_nodes, inverse = np.unique(
                np.concatenate([dst, edge_src_global[edge_mask]]), return_inverse=True
            )
            src_mask = np.ones(src_nodes.shape[0], dtype=bool)
            # local edge indices
            edge_src = np.zeros(n_dst * fanout, dtype=np.int64)
            edge_src[edge_mask] = inverse[n_dst:]
            edge_dst = np.repeat(np.arange(n_dst, dtype=np.int64), fanout)
            blocks.append(
                SampledBlock(
                    src_nodes=src_nodes,
                    dst_nodes=dst,
                    edge_src=edge_src,
                    edge_dst=edge_dst,
                    edge_mask=edge_mask,
                    src_mask=src_mask,
                )
            )
            dst = src_nodes
            dst_mask = src_mask
        blocks.reverse()
        return blocks

    @staticmethod
    def padded_layer_sizes(batch: int, fanouts: tuple[int, ...]) -> list[int]:
        """Upper-bound layer sizes used by input_specs() for jit-stable shapes."""
        sizes = [batch]
        for f in fanouts:
            sizes.append(sizes[-1] * (f + 1))  # dst nodes + sampled neighbors
        return sizes
