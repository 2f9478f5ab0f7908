"""nequip [arXiv:2101.03164]: 5 interaction layers, 32 channels/irrep,
l_max=2, 8 Bessel RBFs, cutoff 5 A, E(3) tensor-product messages.

molecule is the native shape (energies + forces, ``CFG`` in fp32); the giant
graph shapes (``_SHARDMAP_SHAPES``) run energy-only (no force supervision
exists there, and force training is grad-through-energy — double memory on
61.9M-edge graphs). The JAX package sends those shapes through its
destination-partitioned shard_map forward across a mesh of devices; on one
card that forward is ``forward_energy``, energy only, which these cells run
with ``CFG_BF16``."""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.configs.cell import (
    ArchSpec,
    meta,
    on_meta,
    opt_state_specs,
    replicated_specs,
)
from repro_torch.configs.gnn_common import (  # noqa: F401
    FAMILY,
    GNN_SHAPES,
    SHAPE_DEFS,
    meta_train_cell,
    pad512,
    random_graph_batch,
    smoke_dims,
    train_cell,
    train_plan,
)
from repro_torch.device import resolve_device
from repro_torch.kernels.segment_agg.ops import edge_plan
from repro_torch.models.common import init_from_specs
from repro_torch.models.gnn import nequip as m

CFG = m.NequIPConfig(name="nequip", n_layers=5, d_hidden=32, l_max=2,
                     n_rbf=8, cutoff=5.0, n_species=10)
# the 61.9M-edge shape runs the same architecture in bf16 (no force training
# there; fp32 equivariance is validated in tests on the molecule path)
CFG_BF16 = dataclasses.replace(CFG, compute_dtype=torch.bfloat16)
SMOKE_CFG = m.NequIPConfig(name="nequip", n_layers=2, d_hidden=8, l_max=2,
                           n_rbf=4, cutoff=5.0, n_species=4)

# huge single-graph shapes: energy only, CFG_BF16, ``forward_energy`` (the
# JAX package's shard_map path on one card); molecule keeps fp32 with forces
_SHARDMAP_SHAPES = ("ogb_products", "minibatch_lg", "full_graph_sm")


def batch_plans(batch: dict, cfg: m.NequIPConfig) -> list:
    """Build (or find) the plans a NequIP batch takes: its two edge
    arrays', its species' (into the embedding's rows) and its graph ids'."""
    n = batch["positions"].shape[0]
    return [edge_plan(batch["edge_src"], n), edge_plan(batch["edge_dst"], n),
            edge_plan(batch["species"], cfg.n_species),
            edge_plan(batch["graph_ids"], batch["energy_targets"].shape[0])]


def _batch(rng, d, cfg, *, targets: bool, device) -> dict:
    g = max(d["graphs"], 1)
    gb = random_graph_batch(rng, d["n"], d["e"], 4, 2, graphs=d["graphs"],
                            geometric=True, graph_task=bool(d["graphs"]),
                            device=device)
    n = d["n"]
    dev = gb.x.device
    if targets:
        e_t = torch.as_tensor(rng.standard_normal(g, dtype=np.float32),
                              device=dev)
        f_t = torch.as_tensor(rng.standard_normal((n, 3), dtype=np.float32),
                              device=dev)
    else:
        e_t = torch.zeros(g, device=dev)
        f_t = torch.zeros((n, 3), device=dev)
    return dict(
        positions=gb.positions,
        species=gb.species.clamp(0, cfg.n_species - 1),
        edge_src=gb.edge_src, edge_dst=gb.edge_dst, edge_mask=gb.edge_mask,
        node_mask=gb.node_mask,
        graph_ids=(gb.graph_ids if gb.graph_ids is not None
                   else torch.zeros(n, dtype=torch.int32, device=dev)),
        energy_targets=e_t, force_targets=f_t)


def _cell(cfg, batch, gen, use_forces: bool) -> dict:
    params = init_from_specs(m.param_specs(cfg), gen)
    batch_plans(batch, cfg)
    return train_cell(cfg, functools.partial(m.loss_fn,
                                             use_forces=use_forces),
                      params, batch)


def build_smoke(shape: str, device=None) -> dict:
    """The JAX package's reduced cell: ``SMOKE_CFG`` at every shape, at
    most 60 atoms, 200 edges and 4 graphs, zero targets; forces on
    ``molecule`` only."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    d = smoke_dims(shape, n=60, e=200)
    batch = _batch(np.random.default_rng(1), d, SMOKE_CFG, targets=False,
                   device=dev)
    return _cell(SMOKE_CFG, batch, gen, shape == "molecule")


def build_train(shape: str = "molecule", *, device=None,
                seed: int = 0) -> dict:
    """The cell at ``shape``'s full size, unpadded: ``molecule`` (128
    graphs of 30 atoms, 64 edges each) with ``CFG``, energies and forces,
    normal targets; the other shapes with ``CFG_BF16``, energy only."""
    d = SHAPE_DEFS[shape]
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    molecule = shape == "molecule"
    cfg = CFG if molecule else CFG_BF16
    batch = _batch(np.random.default_rng(seed + 1), d, cfg, targets=True,
                   device=dev)
    return _cell(cfg, batch, gen, molecule)


# the logical axes of a batch's fields
BATCH_AXES = dict(
    positions=("nodes", None), species=("nodes",), edge_src=("edges",),
    edge_dst=("edges",), edge_mask=("edges",), node_mask=("nodes",),
    graph_ids=("nodes",), energy_targets=("batch",),
    force_targets=("nodes", None),
)


def batch_meta(d: dict) -> dict:
    """The JAX package's ``_batch_sds``: atoms and edges padded to
    multiples of 512, as meta tensors."""
    n, e, g = pad512(d["n"]), pad512(d["e"]), max(d["graphs"], 1)
    i32 = torch.int32
    return dict(
        positions=meta((n, 3)), species=meta((n,), i32),
        edge_src=meta((e,), i32), edge_dst=meta((e,), i32),
        edge_mask=meta((e,), torch.bool), node_mask=meta((n,), torch.bool),
        graph_ids=meta((n,), i32), energy_targets=meta((g,)),
        force_targets=meta((n, 3)))


def _padded(batch: dict, n_pad: int, e_pad: int) -> dict:
    """``batch`` with atoms padded to ``n_pad`` and edges to ``e_pad``:
    padded slots 0, their masks False (graph 0, masked out of every sum)."""
    def pad(t, size):
        if t.shape[0] == size:
            return t
        return torch.cat([t, t.new_zeros((size - t.shape[0],) + t.shape[1:])])

    out = dict(batch)
    for k in ("positions", "species", "node_mask", "graph_ids",
              "force_targets"):
        out[k] = pad(batch[k], n_pad)
    for k in ("edge_src", "edge_dst", "edge_mask"):
        out[k] = pad(batch[k], e_pad)
    return out


def build(shape: str, device=None, reduced=None, seed: int = 0):
    """The JAX package's cell at ``shape``: atoms and edges padded to
    multiples of 512; ``molecule`` with ``CFG``, energies and forces; the
    single-graph shapes with ``CFG_BF16``, energy only, through
    ``forward_energy`` (the JAX package runs them through its shard_map
    forward over a mesh of devices, with parameters replicated: so they
    are placed here). ``reduced`` may cut the depth (``"n_layers"``)."""
    reduced = dict(reduced or {})
    d = SHAPE_DEFS[shape]
    molecule = shape == "molecule"
    cfg = dataclasses.replace(CFG if molecule else CFG_BF16, **reduced)
    specs = m.param_specs(cfg)
    o_specs = opt_state_specs("adamw", specs)
    if shape in _SHARDMAP_SHAPES:
        specs, o_specs = replicated_specs(specs), replicated_specs(o_specs)
        notes = ("energy-only: forward_energy on one card (the JAX "
                 "package's shard_map path)")
    else:
        notes = "" if molecule else "energy-only"
    loss = functools.partial(m.loss_fn, use_forces=molecule)
    if on_meta(device):
        cell = meta_train_cell(cfg, loss, specs, batch_meta(d))
    else:
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        batch = _padded(_batch(np.random.default_rng(seed + 1), d, cfg,
                               targets=True, device=dev),
                        pad512(d["n"]), pad512(d["e"]))
        cell = _cell(cfg, batch, gen, molecule)
    return train_plan("nequip", shape, cell, reduced=reduced, notes=notes,
                      arg_axes=(specs, o_specs, BATCH_AXES, ()), cut=True)


ARCH = ArchSpec(
    arch_id="nequip", family=FAMILY, shapes=GNN_SHAPES, build=build,
    build_smoke=lambda shape, device=None: train_plan(
        "nequip", shape, build_smoke(shape, device=device)))
