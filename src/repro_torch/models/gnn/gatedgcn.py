"""GatedGCN [arXiv:2003.00982 benchmark config; layer from arXiv:1711.07553].

The JAX package's ``repro.models.gnn.gatedgcn`` in PyTorch. Edge-featured
MPNN with dense gating:
  e'_ij = A h_i + B h_j + C e_ij                    (edge update)
  eta_ij = sigmoid(e'_ij) / (sum_j sigmoid(e'_ij) + eps)
  h'_i  = U h_i + sum_{j->i} eta_ij (.) (V h_j)     (gated aggregation)
with residual connections and layer norm on both node and edge streams.
The layers run as a loop over one ``unbind`` view per layer of each stacked
leaf (the backward stacks each leaf's gradient once), each layer under
``torch.utils.checkpoint`` when a gradient is taken (the JAX package's
``jax.checkpoint`` of its scan body).

Benchmark config: 16 layers, d_hidden = 70.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.common import ParamSpec, at_least_fp32, layer_norm
from repro_torch.models.gnn.common import (
    GraphBatch,
    agg_sum,
    class_ce,
    gather,
    graph_readout,
    node_ce_loss,
)


@dataclasses.dataclass(frozen=True)
class GatedGCNConfig:
    name: str = "gatedgcn"
    n_layers: int = 16
    d_hidden: int = 70
    d_in: int = 1433
    d_edge_in: int = 0            # 0 => learned constant edge init
    n_classes: int = 7
    task: str = "node"
    compute_dtype: torch.dtype = torch.float32


def param_specs(cfg: GatedGCNConfig):
    d = cfg.d_hidden
    layer = {
        "A": ParamSpec((cfg.n_layers, d, d), ("layers", "embed", None)),
        "B": ParamSpec((cfg.n_layers, d, d), ("layers", "embed", None)),
        "C": ParamSpec((cfg.n_layers, d, d), ("layers", "embed", None)),
        "U": ParamSpec((cfg.n_layers, d, d), ("layers", "embed", None)),
        "V": ParamSpec((cfg.n_layers, d, d), ("layers", "embed", None)),
        "ln_h_g": ParamSpec((cfg.n_layers, d), ("layers", None)),
        "ln_h_b": ParamSpec((cfg.n_layers, d), ("layers", None),
                            init_scale=0.0),
        "ln_e_g": ParamSpec((cfg.n_layers, d), ("layers", None)),
        "ln_e_b": ParamSpec((cfg.n_layers, d), ("layers", None),
                            init_scale=0.0),
    }
    return {
        "embed_in": ParamSpec((cfg.d_in, d), ("embed", None)),
        "edge_init": (ParamSpec((cfg.d_edge_in, d), ("embed", None))
                      if cfg.d_edge_in else ParamSpec((d,), (None,))),
        "layers": layer,
        "head_w": ParamSpec((d, cfg.n_classes), ("embed", None)),
        "head_b": ParamSpec((cfg.n_classes,), (None,), init_scale=0.0),
    }


def _layer(h, e, lp, batch: GraphBatch, cdt):
    n = h.shape[0]
    hs, hd = gather(h, batch.edge_src), gather(h, batch.edge_dst)
    e_new = hd @ lp["A"].to(cdt) + hs @ lp["B"].to(cdt) + e @ lp["C"].to(cdt)
    e_out = layer_norm(e + F.relu(e_new), lp["ln_e_g"], lp["ln_e_b"])
    sig = torch.sigmoid(at_least_fp32(e_new)).to(cdt)
    num = agg_sum(sig * (hs @ lp["V"].to(cdt)), batch.edge_dst, n,
                  batch.edge_mask)
    den = agg_sum(sig, batch.edge_dst, n, batch.edge_mask)
    h_new = h @ lp["U"].to(cdt) + num / (den + 1e-6)
    h_out = layer_norm(h + F.relu(h_new), lp["ln_h_g"], lp["ln_h_b"])
    return h_out, e_out


def forward(params, batch: GraphBatch, cfg: GatedGCNConfig) -> torch.Tensor:
    cdt = cfg.compute_dtype
    E = batch.edge_src.shape[0]
    h = batch.x.to(cdt) @ params["embed_in"].to(cdt)
    if cfg.d_edge_in:
        e = torch.zeros((E, cfg.d_hidden), dtype=cdt, device=h.device)
    else:
        e = params["edge_init"].to(cdt).expand(E, cfg.d_hidden)
    # one view a layer of every stacked leaf; the backward stacks them once
    layers = {k: v.unbind(0) for k, v in params["layers"].items()}
    remat = torch.is_grad_enabled()
    for l in range(cfg.n_layers):
        lp = {k: v[l] for k, v in layers.items()}
        if remat:
            h, e = checkpoint(_layer, h, e, lp, batch, cdt,
                              use_reentrant=False, preserve_rng_state=False)
        else:
            h, e = _layer(h, e, lp, batch, cdt)
    if cfg.task == "graph":
        h = graph_readout(h, batch)
    return h @ params["head_w"].to(cdt) + params["head_b"]


def loss_fn(params, batch: GraphBatch, cfg: GatedGCNConfig):
    logits = forward(params, batch, cfg)
    if cfg.task == "graph":
        loss = class_ce(logits, batch.labels, batch.label_mask)
    else:
        loss = node_ce_loss(logits, batch)
    return loss, {"ce": loss}
