"""nequip [arXiv:2101.03164]: 5 interaction layers, 32 channels/irrep,
l_max=2, 8 Bessel RBFs, cutoff 5 A, E(3) tensor-product messages.

molecule is the native shape (energies + forces, ``CFG`` in fp32); the giant
graph shapes (``_SHARDMAP_SHAPES``) run energy-only with ``CFG_BF16`` (no
force supervision exists there, and force training is grad-through-energy —
double memory on 61.9M-edge graphs). As in the JAX package, those shapes go
through the destination-partitioned forward (``forward_energy_shardmap``)
when ``build`` runs inside a ``torch.distributed`` group, one node range a
rank, parameters and optimizer state replicated; the cell's batch is then
arranged to that forward's input contract (``arrange_to_contract``).
Outside a group (the JAX package's one-device mesh: one shard) they run
``forward_energy``."""
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

# huge single-graph shapes: energy only, CFG_BF16, the destination-
# partitioned forward inside a group (``forward_energy`` on one card);
# molecule keeps fp32 with forces
_SHARDMAP_SHAPES = ("ogb_products", "minibatch_lg", "full_graph_sm")


def _loss_shardmap(params, batch, cfg, mesh):
    """Energy-only loss over the destination-partitioned forward (EAGr
    reader partitioning applied to message passing)."""
    e = m.forward_energy_shardmap(
        params, batch["positions"], batch["species"], batch["edge_src"],
        batch["edge_dst"], batch["edge_mask"], batch["node_mask"],
        batch["graph_ids"], 1, cfg, mesh)
    e_loss = ((e - batch["energy_targets"].float()) ** 2).mean()
    return e_loss, {"e_mse": e_loss}


def group_mesh(device=None):
    """The ``ShardMesh`` of the running ``torch.distributed`` group, one
    node range a rank (this rank on ``device``, or on
    ``launch.mesh.make_shard_mesh``'s choice), or None outside a group."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_shard_mesh

    if not (dist.is_available() and dist.is_initialized()):
        return None
    return make_shard_mesh(dist.get_world_size(), device=device)


def arrange_to_contract(batch: dict, world: int) -> dict:
    """``batch`` with its edges arranged to ``forward_energy_shardmap``'s
    input contract over ``world`` ranks: grouped by the node range of
    their destination (the atoms split into ``world`` contiguous ranges),
    their relative order kept, each rank's slice padded with masked edges
    (each a self edge on its range's first atom) to a common length, a
    multiple of 512. The atoms and the rest of the batch stay as they
    are."""
    n = batch["positions"].shape[0]
    if n % world:
        raise ValueError(f"{n} atoms do not split into {world} node "
                         f"ranges: {(n, world)}")
    n_local = n // world
    dst = batch["edge_dst"]
    owner = (dst.long() // n_local).clamp(0, world - 1)
    order = torch.argsort(owner, stable=True)
    counts = torch.bincount(owner, minlength=world).tolist()
    e_local = pad512(max(max(counts), 1))
    slices = {k: [] for k in ("edge_src", "edge_dst", "edge_mask")}
    start = 0
    for r, c in enumerate(counts):
        take = order[start:start + c]
        start += c
        pad = e_local - c
        for k in slices:
            t = batch[k][take]
            if k == "edge_mask":
                fill = t.new_zeros(pad)
            else:
                fill = t.new_full((pad,), r * n_local)
            slices[k].append(torch.cat([t, fill]))
    return {**batch, **{k: torch.cat(v) for k, v in slices.items()}}


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
    single-graph shapes with ``CFG_BF16``, energy only, parameters and
    optimizer state replicated. Inside a ``torch.distributed`` group those
    run ``forward_energy_shardmap`` over the group (``group_mesh``), this
    rank's state on its device, the batch arranged to the input contract;
    outside one, ``forward_energy``. ``reduced`` may cut the depth
    (``"n_layers"``)."""
    reduced = dict(reduced or {})
    d = SHAPE_DEFS[shape]
    molecule = shape == "molecule"
    cfg = dataclasses.replace(CFG if molecule else CFG_BF16, **reduced)
    specs = m.param_specs(cfg)
    o_specs = opt_state_specs("adamw", specs)
    mesh = None
    if shape in _SHARDMAP_SHAPES:
        specs, o_specs = replicated_specs(specs), replicated_specs(o_specs)
        if not on_meta(device):
            mesh = group_mesh(device)
        notes = ("energy-only: " + (
            f"forward_energy_shardmap over {mesh.world} ranks "
            f"({mesh.backend}), destination-partitioned"
            if mesh is not None else
            "forward_energy on one card (one shard of the JAX package's "
            "shard_map path)"))
    else:
        notes = "" if molecule else "energy-only"
    loss = functools.partial(m.loss_fn, use_forces=molecule)
    if on_meta(device):
        cell = meta_train_cell(cfg, loss, specs, batch_meta(d))
    else:
        dev = resolve_device(device) if mesh is None else mesh.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        batch = _padded(_batch(np.random.default_rng(seed + 1), d, cfg,
                               targets=True, device=dev),
                        pad512(d["n"]), pad512(d["e"]))
        if mesh is None:
            cell = _cell(cfg, batch, gen, molecule)
        else:
            batch = arrange_to_contract(batch, mesh.world)
            m.shard_inputs(mesh, batch["species"], batch["edge_src"],
                           batch["edge_dst"], batch["edge_mask"],
                           batch["node_mask"], cfg)
            cell = train_cell(cfg, functools.partial(_loss_shardmap,
                                                     mesh=mesh),
                              init_from_specs(m.param_specs(cfg), gen),
                              batch)
    return train_plan("nequip", shape, cell, reduced=reduced, notes=notes,
                      arg_axes=(specs, o_specs, BATCH_AXES, ()), cut=True)


ARCH = ArchSpec(
    arch_id="nequip", family=FAMILY, shapes=GNN_SHAPES, build=build,
    build_smoke=lambda shape, device=None: train_plan(
        "nequip", shape, build_smoke(shape, device=device)))
