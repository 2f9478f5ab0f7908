"""Shared cell builders for the four GNN architectures.

Shapes (assigned):
  full_graph_sm   n_nodes=2,708 n_edges=10,556 d_feat=1,433   (Cora full-batch)
  minibatch_lg    n_nodes=232,965 n_edges=114,615,892,
                  batch_nodes=1,024, fanout 15-10             (Reddit sampled)
  ogb_products    n_nodes=2,449,029 n_edges=61,859,140 d_feat=100
  molecule        n_nodes=30 n_edges=64 batch=128             (small graphs)

minibatch_lg runs the *sampled union subgraph* produced by
graphs/sampler.py (GraphSAINT-style: all fanout layers merged into one padded
subgraph so arbitrary-depth models train on it; the sampler itself is the
real neighbor sampler, exercised in tests).

Every shape is a train shape (a train step: forward, backward, optimizer).
The port's arch-module API: each GNN config module has ``FAMILY``, ``CFG``,
``SHAPE_DEFS``, ``build_smoke(shape, device=None)`` (the JAX package's
reduced cell) and ``build_train(shape, device=None, seed=0)`` (the cell at
full width), each returning ``{"cfg", "params", "opt_state", "batch",
"step", "lr", "optimizer"}``. Data are drawn from a seeded numpy generator
with the JAX package's structure, parameters from a seeded torch generator;
a built batch carries its segment plans (``GraphBatch.plans``).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.configs.cell import (
    ArchSpec,
    CellPlan,
    meta,
    on_meta,
    opt_state_specs,
)
from repro_torch.device import resolve_device
from repro_torch.models.common import init_from_specs, spec_to_meta
from repro_torch.models.gnn.common import GraphBatch
from repro_torch.train.optimizer import get_optimizer, tree_leaves
from repro_torch.train.trainer import make_train_step

FAMILY = "gnn"
GNN_SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")


def pad512(x: int) -> int:
    """Pad node/edge counts to a multiple of 512 (the JAX package's rule,
    so every mesh-axis combination divides evenly). Padded slots are
    masked."""
    return -(-x // 512) * 512


# minibatch union-subgraph sizes: seeds + 15 + 15*10 per seed
_MB_NODES = 1024 * (1 + 15 + 150)
_MB_EDGES = 1024 * (15 + 150)

SHAPE_DEFS = {
    "full_graph_sm": dict(n=2708, e=10556, d_feat=1433, classes=7, graphs=0,
                          kind="train"),
    "minibatch_lg": dict(n=_MB_NODES, e=_MB_EDGES, d_feat=602, classes=41,
                         graphs=0, kind="train"),
    "ogb_products": dict(n=2449029, e=61859140, d_feat=100, classes=47,
                         graphs=0, kind="train"),
    "molecule": dict(n=30 * 128, e=64 * 128, d_feat=16, classes=2,
                     graphs=128, kind="train"),
}


def smoke_dims(shape: str, n: int = 64, e: int = 256) -> dict:
    """The JAX package's smoke cut of a shape: at most ``n`` nodes, ``e``
    edges, 24 features and 4 graphs."""
    d = dict(SHAPE_DEFS[shape])
    d.update(n=min(d["n"], n), e=min(d["e"], e), d_feat=min(d["d_feat"], 24),
             graphs=min(d["graphs"], 4))
    return d


def random_graph_batch(rng: np.random.Generator, n: int, e: int, d_feat: int,
                       classes: int, *, graphs: int = 0,
                       geometric: bool = False, graph_task: bool = False,
                       device=None) -> GraphBatch:
    """A random ``GraphBatch`` drawn from ``rng`` with the JAX package's
    structure: uniform edges (for batched small graphs, each edge inside its
    graph), normal features, uniform labels, every mask set; with
    ``geometric`` normal positions (std 2) and species in [0, 10). On
    ``device`` (CUDA unless the caller names another)."""
    dev = resolve_device(device)
    lbl_n = graphs if graph_task and graphs else n
    if graphs:
        per = n // graphs
        gid = np.repeat(np.arange(graphs), per)
        off = np.repeat(np.arange(graphs), e // graphs) * per
        esrc = rng.integers(0, per, e) + off
        edst = rng.integers(0, per, e) + off
    else:
        gid = None
        esrc = rng.integers(0, n, e)
        edst = rng.integers(0, n, e)
    x = rng.standard_normal((n, d_feat), dtype=np.float32)
    labels = rng.integers(0, classes, lbl_n)
    pos = rng.standard_normal((n, 3), dtype=np.float32) * 2.0 \
        if geometric else None
    species = rng.integers(0, 10, n) if geometric else None

    def put(a, dt=torch.int32):
        return None if a is None else torch.as_tensor(
            np.asarray(a), device=dev).to(dt)

    return GraphBatch(
        x=put(x, torch.float32), edge_src=put(esrc), edge_dst=put(edst),
        edge_mask=torch.ones(e, dtype=torch.bool, device=dev),
        node_mask=torch.ones(n, dtype=torch.bool, device=dev),
        labels=put(labels),
        label_mask=torch.ones(lbl_n, dtype=torch.bool, device=dev),
        graph_ids=put(gid), n_graphs=max(graphs, 1),
        positions=put(pos, torch.float32), species=put(species))


def pad_graph_batch(b: GraphBatch, n_pad: int, e_pad: int) -> GraphBatch:
    """``b`` padded to ``n_pad`` nodes and ``e_pad`` edges (node labels to
    ``n_pad``): padded rows 0, padded edges 0 -> 0, every padded slot's
    mask False."""
    def pad(t, size):
        if t is None or t.shape[0] == size:
            return t
        fill = t.new_zeros((size - t.shape[0],) + t.shape[1:])
        return torch.cat([t, fill])

    node_lbl = b.labels.shape[0] == b.x.shape[0]
    return dataclasses.replace(
        b, x=pad(b.x, n_pad), edge_src=pad(b.edge_src, e_pad),
        edge_dst=pad(b.edge_dst, e_pad), edge_mask=pad(b.edge_mask, e_pad),
        node_mask=pad(b.node_mask, n_pad),
        labels=pad(b.labels, n_pad) if node_lbl else b.labels,
        label_mask=pad(b.label_mask, n_pad) if node_lbl else b.label_mask,
        graph_ids=pad(b.graph_ids, n_pad), positions=pad(b.positions, n_pad),
        species=pad(b.species, n_pad))


def train_cell(cfg, loss_fn, params, batch, *, lr: float = 1e-3,
               optimizer: str = "adamw") -> dict:
    """A train cell: the JAX package's train step (one microbatch, the
    trainer's default clip) with ``optimizer`` over ``loss_fn``."""
    opt = get_optimizer(optimizer)
    step = make_train_step(functools.partial(loss_fn, cfg=cfg), opt)
    return dict(cfg=cfg, params=params, opt_state=opt.init(params),
                batch=batch, step=step, lr=lr, optimizer=opt)


def build_graph_cell(shape: str, make_cfg, param_specs, loss_fn, *,
                     smoke: bool, device=None, seed: int = 0) -> dict:
    """The cell of a ``GraphBatch`` GNN (gat-cora, gatedgcn) at ``shape``:
    its smoke cut (``make_cfg`` the smoke config maker) or full size, the
    graph padded to multiples of 512 as the JAX package's cells are;
    ``make_cfg(dims, graph_task)`` scales the arch's config to the shape's
    features and classes (graph classification on ``molecule``)."""
    d = smoke_dims(shape) if smoke else dict(SHAPE_DEFS[shape])
    graph_task = shape == "molecule"
    cfg = make_cfg(d, graph_task)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = init_from_specs(param_specs(cfg), gen)
    batch = random_graph_batch(
        np.random.default_rng(seed + 1), d["n"], d["e"], d["d_feat"],
        d["classes"], graphs=d["graphs"], graph_task=graph_task, device=dev)
    if not smoke:
        batch = pad_graph_batch(batch, pad512(d["n"]), pad512(d["e"]))
    batch.plans()
    return train_cell(cfg, loss_fn, params, batch)


# ------------------------------------------------------------ the full cells
# the logical axes of a GraphBatch's fields (labels of a graph task: batch)
BATCH_AXES = dict(
    x=("nodes", None), edge_src=("edges",), edge_dst=("edges",),
    edge_mask=("edges",), node_mask=("nodes",), labels=("nodes",),
    label_mask=("nodes",), graph_ids=("nodes",),
    positions=("nodes", None), species=("nodes",),
)


def batch_axes(graph_task: bool) -> dict:
    if not graph_task:
        return BATCH_AXES
    return {**BATCH_AXES, "labels": ("batch",), "label_mask": ("batch",)}


def graph_batch_meta(d: dict, *, geometric: bool = False,
                     graph_task: bool = False) -> GraphBatch:
    """The JAX package's ``graph_batch_sds``: a ``GraphBatch`` of meta
    tensors, nodes and edges padded to multiples of 512."""
    n, e, g = pad512(d["n"]), pad512(d["e"]), d["graphs"]
    lbl_n = g if graph_task and g else n
    i32, b_ = torch.int32, torch.bool
    return GraphBatch(
        x=meta((n, d["d_feat"])), edge_src=meta((e,), i32),
        edge_dst=meta((e,), i32), edge_mask=meta((e,), b_),
        node_mask=meta((n,), b_), labels=meta((lbl_n,), i32),
        label_mask=meta((lbl_n,), b_),
        graph_ids=meta((n,), i32) if g else None, n_graphs=max(g, 1),
        positions=meta((n, 3)) if geometric else None,
        species=meta((n,), i32) if geometric else None)


def cut_layers(make_cfg, reduced: dict):
    """``make_cfg`` with the depth cut to ``reduced["n_layers"]`` where the
    cut names one."""
    if "n_layers" not in reduced:
        return make_cfg
    return lambda d, graph_task: dataclasses.replace(
        make_cfg(d, graph_task), n_layers=reduced["n_layers"])


def train_plan(arch_id: str, shape: str, cell: dict, *, reduced=None,
               arg_axes=None, notes: str = "", cut: bool = False) -> CellPlan:
    """A train cell's dict (``train_cell``) as a ``CellPlan``: ``(params,
    opt_state, batch, lr)``, lr a 0-d fp32 tensor on the parameters'
    device; ``cut``: its depth (the cell's ``cfg.n_layers``) may be
    cut."""
    lr = cell["lr"]
    if not isinstance(lr, torch.Tensor):
        lr = torch.tensor(lr, dtype=torch.float32,
                          device=tree_leaves(cell["params"])[0].device)
    return CellPlan(arch_id, shape, cell["step"],
                    (cell["params"], cell["opt_state"], cell["batch"], lr),
                    kind="train", notes=notes, reduced=dict(reduced or {}),
                    dims={"n_layers": cell["cfg"].n_layers} if cut else {},
                    arg_axes=arg_axes)


def meta_train_cell(cfg, loss_fn, specs, batch, *, lr: float = 1e-3,
                    optimizer: str = "adamw") -> dict:
    """``train_cell`` on the meta device: parameters, optimizer state and
    lr as meta tensors (nothing allocated, nothing run)."""
    opt = get_optimizer(optimizer)
    step = make_train_step(functools.partial(loss_fn, cfg=cfg), opt)
    return dict(cfg=cfg, params=spec_to_meta(specs),
                opt_state=spec_to_meta(opt_state_specs(optimizer, specs)),
                batch=batch, step=step, lr=meta(()), optimizer=opt)


def make_graph_arch(arch_id: str, make_cfg, make_smoke_cfg, param_specs,
                    loss_fn) -> ArchSpec:
    """The JAX package's ``make_gnn_arch`` for a ``GraphBatch`` GNN
    (gat-cora, gatedgcn): every shape a train step (AdamW, lr 1e-3) on the
    shape's graph padded to multiples of 512; ``reduced`` cuts the depth
    (``"n_layers"``)."""

    def build(shape, device=None, reduced=None, seed: int = 0):
        reduced = dict(reduced or {})
        d = SHAPE_DEFS[shape]
        graph_task = shape == "molecule"
        mk = cut_layers(make_cfg, reduced)
        cfg = mk(d, graph_task)
        specs = param_specs(cfg)
        axes = (specs, opt_state_specs("adamw", specs), batch_axes(graph_task),
                ())
        if on_meta(device):
            cell = meta_train_cell(cfg, loss_fn, specs, graph_batch_meta(
                d, graph_task=graph_task))
        else:
            cell = build_graph_cell(shape, mk, param_specs, loss_fn,
                                    smoke=False, device=device, seed=seed)
        return train_plan(arch_id, shape, cell, reduced=reduced,
                          arg_axes=axes, cut=True)

    def build_smoke(shape, device=None):
        return train_plan(arch_id, shape, build_graph_cell(
            shape, make_smoke_cfg, param_specs, loss_fn, smoke=True,
            device=device))

    return ArchSpec(arch_id=arch_id, family=FAMILY, shapes=GNN_SHAPES,
                    build=build, build_smoke=build_smoke)
