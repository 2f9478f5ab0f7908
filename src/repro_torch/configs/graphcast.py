"""graphcast [arXiv:2212.12794]: 16-layer encoder-processor-decoder mesh GNN,
d_hidden=512, mesh_refinement=6 (40,962 mesh nodes / 327,660 directed
multimesh edges — static constants of the refinement), n_vars=227, bf16
compute over fp32 parameters, AdamW at lr 1e-3.

The assigned shape's n_nodes plays the grid (padded to a multiple of 512);
grid<->mesh edges are ~4 per grid node, the multimesh edge count is padded
to a multiple of 512 (the JAX package's ``_batch_sds``). The edges are data:
drawn uniformly from a seed, as the JAX package's are (grid ends over the
shape's real grid nodes; padded grid rows are masked out of the loss)."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.cell import ArchSpec, meta, on_meta, opt_state_specs
from repro_torch.configs.gnn_common import (  # noqa: F401
    FAMILY,
    GNN_SHAPES,
    SHAPE_DEFS,
    meta_train_cell,
    pad512,
    train_cell,
    train_plan,
)
from repro_torch.device import resolve_device
from repro_torch.models.common import init_from_specs
from repro_torch.models.gnn import graphcast as m

CFG = m.GraphCastConfig(name="graphcast", n_layers=16, d_hidden=512,
                        mesh_refinement=6, n_vars=227)
SMOKE_CFG = m.GraphCastConfig(name="graphcast", n_layers=2, d_hidden=32,
                              mesh_refinement=1, n_vars=8,
                              compute_dtype=torch.float32)


def random_batch(rng: np.random.Generator, cfg: m.GraphCastConfig, *,
                 n_grid: int, n_real: int, e_gm: int, e_mesh: int,
                 device=None) -> m.GraphCastBatch:
    """A batch of ``n_grid`` grid nodes (the first ``n_real`` real, the
    rest masked out of the loss), ``e_gm`` grid-to-mesh and as many
    mesh-to-grid edges, ``e_mesh`` mesh edges, every edge end uniform over
    its real nodes; normal inputs and targets. On ``device`` (CUDA unless
    the caller names another)."""
    dev = resolve_device(device)
    M = cfg.n_mesh

    def ints(hi, n):
        return torch.as_tensor(rng.integers(0, hi, n), device=dev).to(
            torch.int32)

    grid_x = rng.standard_normal((n_grid, cfg.n_vars), dtype=np.float32)
    g2m_src, g2m_dst = ints(n_real, e_gm), ints(M, e_gm)
    mesh_src, mesh_dst = ints(M, e_mesh), ints(M, e_mesh)
    m2g_src, m2g_dst = ints(M, e_gm), ints(n_real, e_gm)
    targets = rng.standard_normal((n_grid, cfg.n_vars), dtype=np.float32)
    return m.GraphCastBatch(
        grid_x=torch.as_tensor(grid_x, device=dev), g2m_src=g2m_src,
        g2m_dst=g2m_dst, mesh_src=mesh_src, mesh_dst=mesh_dst,
        m2g_src=m2g_src, m2g_dst=m2g_dst,
        targets=torch.as_tensor(targets, device=dev),
        grid_mask=torch.arange(n_grid, device=dev) < n_real)


def _cell(cfg, batch, gen) -> dict:
    params = init_from_specs(m.param_specs(cfg), gen)
    batch.plans(cfg)
    return train_cell(cfg, m.loss_fn, params, batch)


def build_smoke(shape: str, device=None) -> dict:
    """The JAX package's reduced cell (the same at every shape):
    ``SMOKE_CFG`` (2 layers, d 32, refinement 1, 8 vars, fp32), a grid of
    48 nodes, 192 edges each way between grid and mesh, the multimesh's
    300 edges; AdamW, lr 1e-3."""
    SHAPE_DEFS[shape]
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cfg, n_grid = SMOKE_CFG, 48
    batch = random_batch(np.random.default_rng(1), cfg, n_grid=n_grid,
                         n_real=n_grid, e_gm=4 * n_grid,
                         e_mesh=cfg.n_mesh_edges, device=dev)
    return _cell(cfg, batch, gen)


def build_train(shape: str = "minibatch_lg", *, cfg: m.GraphCastConfig = CFG,
                device=None, seed: int = 0) -> dict:
    """The cell at ``shape`` with ``cfg`` (default the published ``CFG``):
    the shape's nodes as the grid, padded to a multiple of 512, 4 grid
    edges a padded grid node each way (padded to 512), the multimesh's
    edges padded to 512; parameters and data drawn from ``seed``."""
    d = SHAPE_DEFS[shape]
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    n_grid = pad512(d["n"])
    batch = random_batch(np.random.default_rng(seed + 1), cfg,
                         n_grid=n_grid, n_real=d["n"],
                         e_gm=pad512(4 * n_grid),
                         e_mesh=pad512(cfg.n_mesh_edges), device=dev)
    return _cell(cfg, batch, gen)


# the logical axes of a GraphCastBatch's fields
BATCH_AXES = dict(
    grid_x=("nodes", None), g2m_src=("edges",), g2m_dst=("edges",),
    mesh_src=("edges",), mesh_dst=("edges",), m2g_src=("edges",),
    m2g_dst=("edges",), targets=("nodes", None), grid_mask=("nodes",))


def batch_meta(cfg: m.GraphCastConfig, n_grid: int) -> m.GraphCastBatch:
    """The JAX package's ``_batch_sds``: the grid padded to a multiple of
    512, 4 grid edges a padded grid node each way and the multimesh's
    edges, each padded to 512, as meta tensors."""
    n_grid = pad512(n_grid)
    e_gm, e_mesh = pad512(4 * n_grid), pad512(cfg.n_mesh_edges)
    i32 = torch.int32
    return m.GraphCastBatch(
        grid_x=meta((n_grid, cfg.n_vars)),
        g2m_src=meta((e_gm,), i32), g2m_dst=meta((e_gm,), i32),
        mesh_src=meta((e_mesh,), i32), mesh_dst=meta((e_mesh,), i32),
        m2g_src=meta((e_gm,), i32), m2g_dst=meta((e_gm,), i32),
        targets=meta((n_grid, cfg.n_vars)),
        grid_mask=meta((n_grid,), torch.bool))


def build(shape: str, device=None, reduced=None, seed: int = 0):
    """The cell at ``shape`` with ``CFG`` (``reduced`` may cut its
    processor layers, ``"n_layers"``): :func:`build_train` on a real
    device, its meta twin on ``device="meta"``."""
    reduced = dict(reduced or {})
    cfg = dataclasses.replace(CFG, **reduced)
    specs = m.param_specs(cfg)
    axes = (specs, opt_state_specs("adamw", specs), BATCH_AXES, ())
    if on_meta(device):
        cell = meta_train_cell(cfg, m.loss_fn, specs,
                               batch_meta(cfg, SHAPE_DEFS[shape]["n"]))
    else:
        cell = build_train(shape, cfg=cfg, device=device, seed=seed)
    return train_plan("graphcast", shape, cell, reduced=reduced,
                      arg_axes=axes, cut=True)


ARCH = ArchSpec(
    arch_id="graphcast", family=FAMILY, shapes=GNN_SHAPES, build=build,
    build_smoke=lambda shape, device=None: train_plan(
        "graphcast", shape, build_smoke(shape, device=device)))
