"""The paper's own system config: EAGr continuous ego-centric aggregation
(the reference deployment of the examples and the paper-validation
benchmarks): an RMAT graph of 100,000 nodes and 800,000 edges, the
``vnm_n`` overlay (4 iterations), min-cut push/pull decisions under
Zipf(1.5) write frequencies with ``split_nodes``, a tuple window of 8.

Shapes:
  stream_mixed   write batches of 4,096 and read batches of 4,096
"""
from __future__ import annotations

import dataclasses

import numpy as np

import torch

from repro_torch.configs.cell import ArchSpec, CellPlan, meta, on_meta
from repro_torch.core import dataflow as D
from repro_torch.core.aggregates import make_aggregate
from repro_torch.core.bipartite import build_bipartite
from repro_torch.core.engine import EagrEngine, read_step, write_step_sum
from repro_torch.core.vnm import construct_vnm
from repro_torch.core.window import WindowSpec
from repro_torch.graphs.generators import rmat_graph

FAMILY = "graph-streams"


@dataclasses.dataclass(frozen=True)
class EagrSystemConfig:
    n_nodes: int = 100_000
    n_edges: int = 800_000
    aggregate: str = "sum"
    window: int = 8
    algorithm: str = "vnm_n"          # overlay construction algorithm
    write_batch: int = 4096
    read_batch: int = 4096
    write_read_ratio: float = 1.0
    zipf_a: float = 1.5
    seed: int = 0


CFG = EagrSystemConfig()
SMOKE_CFG = EagrSystemConfig(n_nodes=400, n_edges=2400, write_batch=128,
                             read_batch=128)

SHAPE_DEFS = {"stream_mixed": dict(kind="serve")}


def build_engine(cfg: EagrSystemConfig, device=None):
    """Host compile phase: graph -> bipartite -> overlay -> dataflow ->
    engine on ``device`` (CUDA unless the caller names another). Returns
    ``(engine, bipartite, (construction stats, decision stats))``."""
    g = rmat_graph(cfg.n_nodes, cfg.n_edges, seed=cfg.seed)
    bp = build_bipartite(g)
    ov, stats = construct_vnm(bp, variant=cfg.algorithm, max_iterations=4,
                              seed=cfg.seed)
    rng = np.random.default_rng(cfg.seed)
    wf = rng.zipf(cfg.zipf_a, g.n_nodes).clip(1, 10_000).astype(np.float64)
    rf = (wf * cfg.write_read_ratio)[rng.permutation(g.n_nodes)]
    cm = D.cost_model_for(cfg.aggregate, window=cfg.window)
    dec, dstats = D.decide_mincut(ov, wf, rf, cm, window=cfg.window)
    ov, dec, _ = D.split_nodes(ov, dec, wf, rf, cm, window=cfg.window)
    agg = make_aggregate(cfg.aggregate)
    eng = EagrEngine(ov, dec, agg, WindowSpec(kind="tuple", size=cfg.window),
                     device=device)
    return eng, bp, (stats, dstats)


def build_smoke(shape: str, device=None) -> dict:
    """``SMOKE_CFG``'s engine on ``device`` with one write batch and one
    read batch drawn as the JAX package's reduced cell draws them."""
    if shape not in SHAPE_DEFS:
        raise KeyError(f"unknown shape {shape!r}; eagr has {list(SHAPE_DEFS)}")
    cfg = SMOKE_CFG
    eng, bp, _ = build_engine(cfg, device=device)
    rng = np.random.default_rng(1)
    ids = rng.choice(bp.writers, cfg.write_batch)
    vals = rng.normal(size=cfg.write_batch).astype(np.float32)
    readers = rng.choice(list(bp.reader_inputs.keys()), cfg.read_batch)
    return dict(cfg=cfg, engine=eng, ids=ids, vals=vals, readers=readers)


# ------------------------------------------------------------ the full cell
def _as_meta(tree):
    if isinstance(tree, torch.Tensor):
        return meta(tree.shape, tree.dtype)
    return type(tree)(*(_as_meta(t) for t in tree))


def build(shape: str, device=None, reduced=None, seed: int = 1,
          cfg: EagrSystemConfig = CFG) -> CellPlan:
    """The JAX package's bonus cell: one write batch and one read batch of
    ``cfg``'s engine as one step, ``fn(state, rows, vals, wmask, rnodes,
    rmask) -> (state, answers)`` (the overlay, a compile-time constant,
    closed over). The engine is compiled on the host (on the CPU for
    ``device="meta"``, whose state and batches are meta tensors); on a
    real device the batches are ``cfg``'s Zipf-free uniform draws of
    writers and readers from ``seed``. Not one of the 40 assigned cells.
    ``reduced`` is not taken."""
    if shape not in SHAPE_DEFS:
        raise KeyError(f"unknown shape {shape!r}; eagr has {list(SHAPE_DEFS)}")
    if reduced:
        raise ValueError("the eagr cell takes no cut")
    eng, bp, _ = build_engine(cfg, device="cpu" if on_meta(device)
                              else device)
    plan = eng.plan

    def mixed(state, rows, vals, wmask, rnodes, rmask):
        state = write_step_sum(plan.meta, eng.agg, eng.spec, plan.arrays,
                               state, rows, vals, wmask)
        ans, _ = read_step(plan.meta, eng.agg, plan.arrays, state, rnodes,
                           rmask)
        return state, ans

    B, R = cfg.write_batch, cfg.read_batch
    if on_meta(device):
        args = (_as_meta(eng.state), meta((B,), torch.int32), meta((B,)),
                meta((B,), torch.bool), meta((R,), torch.int32),
                meta((R,), torch.bool))
    else:
        rng = np.random.default_rng(seed)
        rows, wmask = plan.routes.writer_rows(rng.choice(bp.writers, B))
        nodes, rmask = plan.routes.reader_nodes(
            rng.choice(list(bp.reader_inputs.keys()), R))
        dev = eng.device
        put = lambda a, dt: torch.as_tensor(np.asarray(a), device=dev).to(dt)
        args = (eng.state, put(rows, torch.int32),
                put(rng.normal(size=B), torch.float32), put(wmask, torch.bool),
                put(nodes, torch.int32), put(rmask, torch.bool))
    return CellPlan(
        "eagr", shape, mixed, args, kind="serve",
        notes="bonus cell: EAGr engine step (overlay = compile-time constant)",
        arg_axes=(_state_axes(eng.state),) + (("batch",),) * 5)


def _state_axes(tree):
    if isinstance(tree, torch.Tensor):
        return ()
    return type(tree)(*(_state_axes(t) for t in tree))


ARCH = ArchSpec(
    arch_id="eagr", family=FAMILY, shapes=tuple(SHAPE_DEFS), build=build,
    build_smoke=lambda shape, device=None: build(shape, device,
                                                 cfg=SMOKE_CFG),
    describe="the paper's system (reference implementation)")
