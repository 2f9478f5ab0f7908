"""GraphCast-style encoder-processor-decoder mesh GNN [arXiv:2212.12794].

The JAX package's ``repro.models.gnn.graphcast`` in PyTorch. Three
bipartite/homogeneous message-passing stages, all with per-edge MLPs of
(src, dst, edge) features, sum aggregation, residual node/edge MLP updates:

  grid2mesh encoder : grid nodes (n_vars features) -> icosahedral mesh nodes
  processor (16x)   : multimesh message passing on mesh nodes
  mesh2grid decoder : mesh nodes -> grid nodes -> per-grid-node output (n_vars)

mesh_refinement=6 fixes the mesh statically: 10*4^6+2 = 40,962 mesh nodes and
sum_r 30*4^r (r=0..6) = 163,830 undirected multimesh edges (the multi-scale
edge set GraphCast uses) = 327,660 directed. Grid size and grid<->mesh edge
lists come from the input shape (they are data, not parameters).

Every sum aggregation and every gather's backward runs on the segment
kernel, over the plans of the six edge arrays (each bipartite set has a
plan into its source rows and one into its destination rows). In bf16
compute the messages are reduced in fp32 and cast back. The processor's
layers run as a loop over one ``unbind`` view per layer of each stacked
leaf, each under ``torch.utils.checkpoint`` when a gradient is taken (the
JAX package's ``jax.checkpoint`` of its scan body).

For the generic graph shapes (full_graph_sm etc.) the same model runs with the
shape's node/edge counts standing in for grid/mesh sizes.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.segment_agg.ops import edge_plan
from repro_torch.models.common import ParamSpec, at_least_fp32, layer_norm
from repro_torch.models.gnn.common import (
    agg_sum,
    gather,
    mlp_apply,
    mlp_specs,
)


def mesh_sizes(refinement: int) -> tuple[int, int]:
    """(n_mesh_nodes, n_directed_multimesh_edges) for an icosahedron refined
    ``refinement`` times, with the multimesh keeping every level's edges."""
    nodes = 10 * 4**refinement + 2
    und = sum(30 * 4**r for r in range(refinement + 1))
    return nodes, 2 * und


@dataclasses.dataclass(frozen=True)
class GraphCastConfig:
    name: str = "graphcast"
    n_layers: int = 16              # processor depth
    d_hidden: int = 512
    mesh_refinement: int = 6
    n_vars: int = 227               # input/output channels per grid node
    compute_dtype: torch.dtype = torch.bfloat16

    @property
    def n_mesh(self) -> int:
        return mesh_sizes(self.mesh_refinement)[0]

    @property
    def n_mesh_edges(self) -> int:
        return mesh_sizes(self.mesh_refinement)[1]


@dataclasses.dataclass(frozen=True)
class GraphCastBatch:
    """Inputs for one step. Grid->mesh and mesh->grid edges are data."""

    grid_x: torch.Tensor        # (G, n_vars)
    g2m_src: torch.Tensor       # (E_g2m,) grid ids
    g2m_dst: torch.Tensor       # (E_g2m,) mesh ids
    mesh_src: torch.Tensor      # (E_mesh,)
    mesh_dst: torch.Tensor      # (E_mesh,)
    m2g_src: torch.Tensor       # (E_m2g,) mesh ids
    m2g_dst: torch.Tensor       # (E_m2g,) grid ids
    targets: torch.Tensor       # (G, n_vars)
    grid_mask: torch.Tensor | None = None  # (G,) bool; padded grid rows False.
    # Padded EDGES point at the sink node (last padded slot) on both ends, so
    # they only pollute sink rows, which grid_mask excludes from the loss.
    n_mesh: int = 0             # 0 => cfg.n_mesh

    def plans(self, cfg: GraphCastConfig) -> list:
        """Build (or find) the plans of the six edge arrays, each into the
        rows it indexes. A builder calls it once, so the batch carries its
        plans into every step."""
        G, M = self.grid_x.shape[0], self.n_mesh or cfg.n_mesh
        return [edge_plan(self.g2m_src, G), edge_plan(self.g2m_dst, M),
                edge_plan(self.mesh_src, M), edge_plan(self.mesh_dst, M),
                edge_plan(self.m2g_src, M), edge_plan(self.m2g_dst, G)]


def _edge_mlp_specs(d):
    return mlp_specs((3 * d, d, d))


def _node_mlp_specs(d):
    return mlp_specs((2 * d, d, d))


def param_specs(cfg: GraphCastConfig):
    d = cfg.d_hidden

    def stacked(specs):
        return {k: ParamSpec((cfg.n_layers, *s.shape), ("layers", *s.axes),
                             s.dtype, s.init_scale)
                for k, s in specs.items()}

    proc_layer = {
        "edge": stacked(_edge_mlp_specs(d)),
        "node": stacked(_node_mlp_specs(d)),
        "ln_e_g": ParamSpec((cfg.n_layers, d), ("layers", None)),
        "ln_e_b": ParamSpec((cfg.n_layers, d), ("layers", None),
                            init_scale=0.0),
        "ln_n_g": ParamSpec((cfg.n_layers, d), ("layers", None)),
        "ln_n_b": ParamSpec((cfg.n_layers, d), ("layers", None),
                            init_scale=0.0),
    }
    return {
        "grid_embed": mlp_specs((cfg.n_vars, d, d)),
        "mesh_init": ParamSpec((d,), (None,)),
        "g2m_edge": _edge_mlp_specs(d),
        "g2m_node": _node_mlp_specs(d),
        "proc": proc_layer,
        "m2g_edge": _edge_mlp_specs(d),
        "m2g_node": _node_mlp_specs(d),
        "out": mlp_specs((d, d, cfg.n_vars)),
    }


def _mp_step(edge_p, node_p, h_src, h_dst, e, src, dst, n_dst):
    """One GraphCast message-passing block: edge MLP -> sum agg -> node MLP.
    Returns (new_dst_nodes, new_edges); caller applies residual/norm."""
    e_in = torch.cat([gather(h_src, src), gather(h_dst, dst), e], dim=-1)
    e_new = mlp_apply(edge_p, e_in, act=F.silu)
    agg = agg_sum(e_new, dst, n_dst)
    n_in = torch.cat([h_dst, agg], dim=-1)
    return mlp_apply(node_p, n_in, act=F.silu), e_new


def _proc_layer(hm, e, lp, src, dst, n_mesh):
    hm_new, e_new = _mp_step(lp["edge"], lp["node"], hm, hm, e, src, dst,
                             n_mesh)
    hm = layer_norm(hm + hm_new, lp["ln_n_g"], lp["ln_n_b"])
    e = layer_norm(e + e_new, lp["ln_e_g"], lp["ln_e_b"])
    return hm, e


def forward(params, batch: GraphCastBatch,
            cfg: GraphCastConfig) -> torch.Tensor:
    cdt = cfg.compute_dtype
    n_mesh = batch.n_mesh or cfg.n_mesh
    G = batch.grid_x.shape[0]
    d = cfg.d_hidden
    dev = batch.grid_x.device

    hg = mlp_apply(params["grid_embed"], batch.grid_x.to(cdt), act=F.silu)
    hm = params["mesh_init"].to(cdt).expand(n_mesh, d)

    # ---- grid2mesh encode
    e0 = torch.zeros((batch.g2m_src.shape[0], d), dtype=cdt, device=dev)
    hm_new, _ = _mp_step(params["g2m_edge"], params["g2m_node"], hg, hm, e0,
                         batch.g2m_src, batch.g2m_dst, n_mesh)
    hm = hm + hm_new

    # ---- processor: the multimesh layers
    e_mesh = torch.zeros((batch.mesh_src.shape[0], d), dtype=cdt, device=dev)
    layers = {k: _unbind(v) for k, v in params["proc"].items()}
    remat = torch.is_grad_enabled()
    for l in range(cfg.n_layers):
        lp = _take_layer(layers, l)
        args = (hm, e_mesh, lp, batch.mesh_src, batch.mesh_dst, n_mesh)
        if remat:
            hm, e_mesh = checkpoint(_proc_layer, *args, use_reentrant=False,
                                    preserve_rng_state=False)
        else:
            hm, e_mesh = _proc_layer(*args)

    # ---- mesh2grid decode
    e1 = torch.zeros((batch.m2g_src.shape[0], d), dtype=cdt, device=dev)
    hg_new, _ = _mp_step(params["m2g_edge"], params["m2g_node"], hm, hg, e1,
                         batch.m2g_src, batch.m2g_dst, G)
    hg = hg + hg_new
    return mlp_apply(params["out"], hg, act=F.silu)


def _unbind(tree):
    """One view a layer of every stacked leaf (the backward stacks them
    once)."""
    if isinstance(tree, dict):
        return {k: _unbind(v) for k, v in tree.items()}
    return tree.unbind(0)


def _take_layer(tree, l: int):
    if isinstance(tree, dict):
        return {k: _take_layer(v, l) for k, v in tree.items()}
    return tree[l]


def loss_fn(params, batch: GraphCastBatch, cfg: GraphCastConfig):
    pred = forward(params, batch, cfg)
    err = at_least_fp32(pred) - batch.targets.to(at_least_fp32(pred).dtype)
    if batch.grid_mask is not None:
        m = batch.grid_mask.to(err.dtype)[:, None]
        loss = (err * err * m).sum() / (m.sum() * err.shape[-1]).clamp_min(1.0)
    else:
        loss = (err * err).mean()
    return loss, {"mse": loss}
