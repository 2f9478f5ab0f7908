"""GAT (gat-cora): multi-head graph attention network [arXiv:1710.10903].

The JAX package's ``repro.models.gnn.gat`` in PyTorch. Kernel regime: SDDMM
(per-edge attention logits) -> segment-softmax -> SpMM (attention-weighted
neighbor sum): each layer reduces on the segment kernel three times (the
softmax's max and its denominator, then the messages), and its backward
reduces once for each gather.

Paper-exact Cora config: 2 layers, 8 hidden units per head, 8 heads (concat)
in layer 1; 1 output layer with n_classes units averaged over heads.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamSpec
from repro_torch.models.gnn.common import (
    GraphBatch,
    agg_sum,
    class_ce,
    gather,
    graph_readout,
    node_ce_loss,
    segment_softmax,
)


@dataclasses.dataclass(frozen=True)
class GATConfig:
    name: str = "gat-cora"
    n_layers: int = 2
    d_hidden: int = 8
    n_heads: int = 8
    d_in: int = 1433
    n_classes: int = 7
    task: str = "node"            # 'node' | 'graph'
    dropout: float = 0.0          # inference/smoke default; train examples set it
    compute_dtype: torch.dtype = torch.float32


def param_specs(cfg: GATConfig):
    specs = {}
    d = cfg.d_in
    for i in range(cfg.n_layers):
        last = i == cfg.n_layers - 1
        heads = 1 if last else cfg.n_heads
        out = cfg.n_classes if last else cfg.d_hidden
        specs[f"layer{i}"] = {
            "w": ParamSpec((d, heads, out), ("embed", "heads", None)),
            "a_src": ParamSpec((heads, out), ("heads", None)),
            "a_dst": ParamSpec((heads, out), ("heads", None)),
            "bias": ParamSpec((heads, out), ("heads", None), init_scale=0.0),
        }
        d = out * heads
    if cfg.task == "graph":
        specs["readout_w"] = ParamSpec((d, cfg.n_classes), ("embed", None))
        specs["readout_b"] = ParamSpec((cfg.n_classes,), (None,),
                                       init_scale=0.0)
    return specs


def _gat_layer(p, x, batch: GraphBatch, *, concat: bool, act) -> torch.Tensor:
    """x: (N, F). Returns (N, heads*out) if concat else (N, out)."""
    n = x.shape[0]
    h = torch.einsum("nf,fho->nho", x, p["w"].to(x.dtype))       # (N, H, O)
    e_src = torch.einsum("nho,ho->nh", h, p["a_src"].to(x.dtype))
    e_dst = torch.einsum("nho,ho->nh", h, p["a_dst"].to(x.dtype))
    scores = F.leaky_relu(gather(e_src, batch.edge_src)
                          + gather(e_dst, batch.edge_dst), 0.2)
    alpha = segment_softmax(scores, batch.edge_dst, n, batch.edge_mask)
    msgs = gather(h, batch.edge_src) * alpha[..., None]            # (E, H, O)
    agg = agg_sum(msgs.reshape(msgs.shape[0], -1), batch.edge_dst, n,
                  batch.edge_mask).reshape(n, *h.shape[1:])
    agg = agg + p["bias"].to(x.dtype)[None]
    if concat:
        return act(agg).reshape(n, -1)
    return agg.mean(dim=1)                                         # head average


def forward(params, batch: GraphBatch, cfg: GATConfig) -> torch.Tensor:
    x = batch.x.to(cfg.compute_dtype)
    for i in range(cfg.n_layers):
        last = i == cfg.n_layers - 1
        x = _gat_layer(params[f"layer{i}"], x, batch, concat=not last,
                       act=F.elu)
    if cfg.task == "graph":
        g = graph_readout(x, batch)
        return g @ params["readout_w"].to(x.dtype) + params["readout_b"]
    return x


def loss_fn(params, batch: GraphBatch, cfg: GATConfig):
    logits = forward(params, batch, cfg)
    if cfg.task == "graph":
        loss = class_ce(logits, batch.labels, batch.label_mask)
    else:
        loss = node_ce_loss(logits, batch)
    return loss, {"ce": loss}
