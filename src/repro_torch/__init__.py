"""EAGr continuous ego-centric aggregate queries, ported to PyTorch with
hand-written CUDA kernels for NVIDIA Hopper.

The package mirrors ``repro`` module for module and imports none of it (nor
JAX). Its public surface in this slice:

  * :class:`EagrSession` / :class:`Query` / :class:`QueryHandle` /
    :class:`SessionStats` — the declarative front door, one engine (or one
    stack of shards) per query group on one device;
  * :class:`WindowSpec`, :func:`make_aggregate` / :class:`Aggregate`;
  * the low-level tier: ``EagrEngine``, ``compile_plan``,
    ``build_bipartite``, ``construct_vnm``, ``decide_mincut``;
  * ``repro_torch.streams``: Zipf traces, the ingest ring and standing
    alerts (``EagrSession(ingest_depth=...)``, ``register_alert``);
  * ``repro_torch.distributed``: reader-partitioned shards stacked on the
    card (``EagrSession(shards=N)``), checkpoints in the JAX package's
    format (``save``, ``EagrSession.restore``, resharding) and the
    recovery drivers.

Everything runs on CUDA unless the caller passes ``device="cpu"``::

    import numpy as np
    from repro_torch import EagrSession, Query, WindowSpec

    session = EagrSession(graph)                  # on the card
    clicks = session.register(Query(agg="sum", window=WindowSpec("tuple", 8)))
    session.update(np.array([2, 5, 2]), np.array([1.0, 0.5, 2.0]))
    session.read(clicks, np.array([7]))
"""
from __future__ import annotations

from repro_torch.core.aggregates import Aggregate, make_aggregate
from repro_torch.core.bipartite import Bipartite, build_bipartite
from repro_torch.core.dataflow import cost_model_for, decide_mincut
from repro_torch.core.engine import EagrEngine, compile_plan
from repro_torch.core.overlay import Overlay
from repro_torch.core.vnm import construct_vnm
from repro_torch.core.window import WindowSpec
from repro_torch.session import EagrSession, Query, QueryHandle, SessionStats

__all__ = [
    "Aggregate",
    "Bipartite",
    "EagrEngine",
    "EagrSession",
    "Overlay",
    "Query",
    "QueryHandle",
    "SessionStats",
    "WindowSpec",
    "build_bipartite",
    "compile_plan",
    "construct_vnm",
    "cost_model_for",
    "decide_mincut",
    "make_aggregate",
]
