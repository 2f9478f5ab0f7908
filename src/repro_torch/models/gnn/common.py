"""Shared GNN substrate: flat padded graph batches + segment message passing.

The JAX package's ``repro.models.gnn.common`` in PyTorch. Message passing is
gather (``x[edge_src]``) -> per-edge compute -> segment sum / max into
destination nodes, and every one of those reductions, forward and backward,
runs on the hand-written segment kernel: ``agg_sum``, ``agg_mean``,
``segment_softmax``, ``graph_readout`` and ``gather`` go through the graph
entry of ``kernels/segment_agg`` (``graph_sum``, ``graph_max``,
``graph_gather``) over the ``EdgePlan`` of their index array, built once
per index tensor (``edge_plan``). No scatter-add and no atomic is on the
path: a gather's backward is the kernel's sum, and a sum's backward a
gather.

All four GNN shape regimes flatten to one ``GraphBatch``:
  full_graph_sm / ogb_products  one graph, all nodes/edges
  minibatch_lg                  sampled union subgraph (padded, masked)
  molecule                      B small graphs flattened with ``graph_ids``
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.kernels.segment_agg.ops import (
    edge_plan,
    graph_gather,
    graph_max,
    graph_sum,
)
from repro_torch.models.common import ParamSpec, at_least_fp32


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    """Flat padded graph. Edges are (src -> dst); aggregation is into dst."""

    x: torch.Tensor            # (N, F) node features (or positions for nequip)
    edge_src: torch.Tensor     # (E,) int32
    edge_dst: torch.Tensor     # (E,) int32
    edge_mask: torch.Tensor    # (E,) bool
    node_mask: torch.Tensor    # (N,) bool
    labels: torch.Tensor       # (N,) int32 node labels or (G,) graph targets
    label_mask: torch.Tensor   # same leading dim as labels
    graph_ids: torch.Tensor | None = None  # (N,) int32 for batched small graphs
    n_graphs: int = 1
    positions: torch.Tensor | None = None  # (N, 3) for geometric models
    species: torch.Tensor | None = None    # (N,) int32 atomic species

    def plans(self) -> list:
        """Build (or find) every plan the GNN models take over this batch:
        the edge sets' gather plans, the masked aggregation plan, and the
        readout's. A builder calls it once, so the batch carries its plans
        into every step."""
        n = self.x.shape[0]
        out = [edge_plan(self.edge_src, n), edge_plan(self.edge_dst, n),
               edge_plan(self.edge_dst, n, self.edge_mask)]
        if self.graph_ids is not None:
            out.append(edge_plan(self.graph_ids, self.n_graphs,
                                 self.node_mask))
        return out


def gather(h: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``h[index]``: a plain row gather whose backward is the kernel's sum
    over ``index``'s plan."""
    return graph_gather(h, edge_plan(index, h.shape[0]))


def mask_edges(vals: torch.Tensor, edge_mask: torch.Tensor) -> torch.Tensor:
    return vals * edge_mask.to(vals.dtype)[:, None]


def agg_sum(vals: torch.Tensor, edge_dst: torch.Tensor, n_nodes: int,
            edge_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Masked segment-sum of per-edge values into destination nodes: the
    masked edges are left out of the plan, which equals summing the values
    times the mask."""
    return graph_sum(vals, edge_plan(edge_dst, n_nodes, edge_mask))


def agg_mean(vals, edge_dst, n_nodes, edge_mask=None):
    plan = edge_plan(edge_dst, n_nodes, edge_mask)
    s = graph_sum(vals, plan)
    ones = torch.ones((vals.shape[0], 1), dtype=vals.dtype,
                      device=vals.device)
    deg = graph_sum(ones, plan)
    return s / deg.clamp_min(1.0)


def segment_softmax(scores: torch.Tensor, edge_dst: torch.Tensor,
                    n_nodes: int,
                    edge_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Numerically-stable softmax over the incoming edges of each node.
    scores: (E, H). Returns normalized weights (E, H); masked edges get 0.
    The shift (the per-node max, 0 for a node with no live edge) is taken
    without a gradient: the softmax does not depend on it, so the gradient
    is the JAX package's."""
    plan = edge_plan(edge_dst, n_nodes, edge_mask)
    if edge_mask is not None:
        scores = torch.where(edge_mask[:, None], scores, float("-inf"))
    smax = graph_max(scores, plan)
    ex = torch.exp(scores - graph_gather(smax, plan))
    if edge_mask is not None:
        ex = mask_edges(ex, edge_mask)
    denom = graph_sum(ex, plan)
    return ex / graph_gather(denom, plan).clamp_min(1e-9)


def graph_readout(node_vals: torch.Tensor, batch: GraphBatch) -> torch.Tensor:
    """Sum-pool node values per graph -> (n_graphs, F)."""
    if batch.graph_ids is None:
        vals = node_vals * batch.node_mask.to(node_vals.dtype)[:, None]
        return vals.sum(dim=0, keepdim=True)
    return graph_sum(node_vals, edge_plan(batch.graph_ids, batch.n_graphs,
                                          batch.node_mask))


def mlp_specs(dims: tuple[int, ...], prefix_axes=("embed", "mlp"),
              dtype=torch.float32):
    """ParamSpecs for a plain MLP: w{i} (d_in, d_out), b{i} (d_out,)."""
    specs = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        ax = (prefix_axes[0] if i == 0 else None,
              prefix_axes[1] if i == len(dims) - 2 else None)
        specs[f"w{i}"] = ParamSpec((a, b), ax, dtype)
        specs[f"b{i}"] = ParamSpec((b,), (None,), dtype, init_scale=0.0)
    return specs


def mlp_apply(p: dict, x: torch.Tensor, act=F.relu,
              final_act=False) -> torch.Tensor:
    n = len([k for k in p if k.startswith("w")])
    for i in range(n):
        x = x @ p[f"w{i}"].to(x.dtype) + p[f"b{i}"].to(x.dtype)
        if i < n - 1 or final_act:
            x = act(x)
    return x


def class_ce(logits: torch.Tensor, labels: torch.Tensor,
             label_mask: torch.Tensor) -> torch.Tensor:
    """Masked cross entropy in fp32 (fp64 for fp64 logits) over rows of
    ``logits``."""
    logp = torch.log_softmax(at_least_fp32(logits), dim=-1)
    ll = logp.gather(-1, labels.long()[:, None])[:, 0]
    m = label_mask.to(logp.dtype)
    return -(ll * m).sum() / m.sum().clamp_min(1.0)


def node_ce_loss(logits: torch.Tensor, batch: GraphBatch) -> torch.Tensor:
    """Masked node-classification cross entropy."""
    return class_ce(logits, batch.labels, batch.label_mask)
