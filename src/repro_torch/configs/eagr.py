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

from repro_torch.core import dataflow as D
from repro_torch.core.aggregates import make_aggregate
from repro_torch.core.bipartite import build_bipartite
from repro_torch.core.engine import EagrEngine
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
