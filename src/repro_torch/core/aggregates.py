"""Aggregate functions and the user-defined aggregate API (paper §2.2.3).

A *PAO* (partial aggregate object) is a dense fp32 vector of ``pao_dim``
entries; every overlay node owns one row of the global ``(n_nodes, pao_dim)``
PAO tensor. The engine only needs four vectorized operations from an
aggregate, all torch functions on tensors of any device:

  lift(raw)            raw write values -> PAO contributions
  segment_merge(x,seg) merge many PAO rows by segment id (the MERGE of the
                       classic INITIALIZE/UPDATE/FINALIZE API, batched)
  subtract(a, b)       remove contribution b from a (only if invertible)
  finalize(pao)        PAO -> user-facing answer

Duplicate-insensitive aggregates (MAX/MIN) tolerate multiple overlay paths
per writer; subtractable aggregates (SUM/COUNT/AVG/TOP-K) tolerate negative
edges (§2.2.1). TOP-K keeps a dense count vector over a bounded topic domain.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.device import resolve_device

NEG_INF = -3.0e38  # representable in fp32/bf16; used as the MAX identity


@dataclasses.dataclass(frozen=True, eq=False)
class Aggregate:
    """Vectorized user-defined aggregate (paper §2.2.3 API, batched).

    ``combine`` is either 'sum' (signed, supports negative edges) or 'max' /
    'min' (duplicate-insensitive, recompute-on-write in the engine).

    ``cache_key`` (set by the built-in constructors to name + parameters)
    gives two equivalent instances value equality, so queries with equal
    specs share one engine group. Custom aggregates leave it None ->
    identity semantics.
    """

    name: str
    pao_dim: int
    combine: str                      # 'sum' | 'max' | 'min'
    lift: Callable[[torch.Tensor], torch.Tensor]        # (B,) raw -> (B, pao_dim)
    finalize: Callable[[torch.Tensor], torch.Tensor]    # (..., pao_dim) -> answer
    dup_insensitive: bool = False
    supports_subtraction: bool = False
    value_dim: int = 1                # raw write arity lift consumes: scalar
                                      # streams = 1, vector payloads match
                                      # WindowSpec(value_dim=...)
    cache_key: tuple | None = None

    def __eq__(self, other):
        if (self.cache_key is None or not isinstance(other, Aggregate)
                or other.cache_key is None):
            return self is other
        return self.cache_key == other.cache_key

    def __hash__(self):
        return hash(self.cache_key) if self.cache_key is not None else id(self)

    # ------------------------------------------------------------- identities
    @property
    def identity(self) -> float:
        if self.combine == "sum":
            return 0.0
        return NEG_INF if self.combine == "max" else -NEG_INF

    def init_pao(self, n_rows: int, device=None) -> torch.Tensor:
        """``n_rows`` PAO rows at the merge identity on ``device`` (CUDA
        unless the caller names another)."""
        return torch.full((n_rows, self.pao_dim), self.identity,
                          dtype=torch.float32, device=resolve_device(device))

    # ------------------------------------------------------------- merge ops
    def segment_merge(self, x: torch.Tensor, seg: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
        """MERGE many PAO rows grouped by segment id. x: (E, pao_dim).
        Segments with no rows hold the merge identity."""
        out = torch.full((num_segments, x.shape[1]), self.identity,
                         dtype=torch.float32, device=x.device)
        reduce = {"sum": "sum", "max": "amax", "min": "amin"}[self.combine]
        return out.scatter_reduce_(0, seg.long()[:, None].expand_as(x), x,
                                   reduce=reduce)

    def merge(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.combine == "sum":
            return a + b
        return torch.maximum(a, b) if self.combine == "max" \
            else torch.minimum(a, b)

    def subtract(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if not self.supports_subtraction:
            raise ValueError(f"{self.name} does not support subtraction")
        return a - b

    # ------------------------------------------------- scalar reference (UDF)
    # The classic per-event API, used by tests as an oracle and available for
    # user-defined aggregates that want event-at-a-time semantics.
    def INITIALIZE(self) -> np.ndarray:
        return np.full((self.pao_dim,), self.identity, dtype=np.float64)

    def _lift_one(self, v) -> np.ndarray:
        raw = torch.as_tensor(np.asarray([v], np.float32))
        return self.lift(raw)[0].numpy()

    def UPDATE(self, pao: np.ndarray, old, new) -> np.ndarray:
        lifted_new = self._lift_one(new)
        if self.combine == "sum":
            out = pao + lifted_new
            if old is not None:
                out = out - self._lift_one(old)
            return out
        fn = np.maximum if self.combine == "max" else np.minimum
        if old is not None:
            raise ValueError("non-invertible aggregate cannot UPDATE out an old value")
        return fn(pao, lifted_new)

    def FINALIZE(self, pao: np.ndarray):
        return self.finalize(torch.as_tensor(
            np.asarray(pao, np.float32))).numpy()


# --------------------------------------------------------------------- built-ins
def _as_rows(v: torch.Tensor) -> torch.Tensor:
    return v.reshape(v.shape[0], -1).to(torch.float32)


def sum_aggregate(value_dim: int = 1) -> Aggregate:
    return Aggregate(
        name="sum", pao_dim=value_dim, combine="sum",
        cache_key=("sum", value_dim),
        lift=_as_rows,
        finalize=lambda p: p,
        supports_subtraction=True,
        value_dim=value_dim,
    )


def count_aggregate() -> Aggregate:
    return Aggregate(
        name="count", pao_dim=1, combine="sum", cache_key=("count",),
        lift=lambda v: torch.ones((v.shape[0], 1), dtype=torch.float32,
                                  device=v.device),
        finalize=lambda p: p,
        supports_subtraction=True,
    )


def _avg_lift(v: torch.Tensor) -> torch.Tensor:
    v = v.reshape(-1).to(torch.float32)
    return torch.stack([v, torch.ones_like(v)], dim=-1)


def avg_aggregate() -> Aggregate:
    return Aggregate(
        name="avg", pao_dim=2, combine="sum", cache_key=("avg",),
        lift=_avg_lift,
        finalize=lambda p: p[..., 0] / torch.clamp(p[..., 1], min=1.0),
        supports_subtraction=True,
    )


def max_aggregate(value_dim: int = 1) -> Aggregate:
    return Aggregate(
        name="max", pao_dim=value_dim, combine="max",
        cache_key=("max", value_dim),
        lift=_as_rows,
        finalize=lambda p: p,
        dup_insensitive=True,
        value_dim=value_dim,
    )


def min_aggregate(value_dim: int = 1) -> Aggregate:
    return Aggregate(
        name="min", pao_dim=value_dim, combine="min",
        cache_key=("min", value_dim),
        lift=_as_rows,
        finalize=lambda p: p,
        dup_insensitive=True,
        value_dim=value_dim,
    )


def topk_aggregate(k: int = 3, domain: int = 64) -> Aggregate:
    """Paper's TOP-K: the k most *frequent* values (generalized mode, §5.1).
    PAO = dense count vector over a bounded topic-id domain; finalize returns
    the top-k topic ids (most-frequent first, lower id first on ties)."""

    def lift(v: torch.Tensor) -> torch.Tensor:
        # float -> int truncates toward zero, as the JAX package's astype
        ids = torch.clamp(v.reshape(-1).to(torch.int32), 0, domain - 1)
        return torch.nn.functional.one_hot(ids.long(), domain).to(
            torch.float32)

    def finalize(p: torch.Tensor) -> torch.Tensor:
        # a stable descending sort keeps the lower index first on ties, the
        # order jax.lax.top_k gives; torch.topk promises no tie order
        _, idx = torch.sort(p, dim=-1, descending=True, stable=True)
        return idx[..., :k].to(torch.int32)

    return Aggregate(
        name="topk", pao_dim=domain, combine="sum", cache_key=("topk", k, domain),
        lift=lift, finalize=finalize, supports_subtraction=True,
    )


BUILTINS: dict[str, Callable[..., Aggregate]] = {
    "sum": sum_aggregate,
    "count": count_aggregate,
    "avg": avg_aggregate,
    "max": max_aggregate,
    "min": min_aggregate,
    "topk": topk_aggregate,
}


def make_aggregate(name: "str | Aggregate", **kwargs) -> Aggregate:
    """Resolve an aggregate by name (case/hyphen-insensitive: 'TOP-K' ->
    'topk'). An ``Aggregate`` instance passes through unchanged so APIs can
    accept either form. Unknown or non-string names raise a ``ValueError``
    naming the valid set; bad constructor kwargs raise a ``ValueError``
    naming the aggregate and its signature."""
    if isinstance(name, Aggregate):
        if kwargs:
            raise ValueError(
                f"aggregate {name.name!r} is already constructed; "
                f"constructor kwargs {sorted(kwargs)} cannot be applied")
        return name
    if not isinstance(name, str):
        raise ValueError(f"aggregate name must be a string or Aggregate, "
                         f"got {type(name).__name__}; "
                         f"built-ins: {sorted(BUILTINS)}")
    try:
        ctor = BUILTINS[name.strip().lower().replace("-", "").replace("_", "")]
    except KeyError:
        raise ValueError(f"unknown aggregate {name!r}; "
                         f"built-ins: {sorted(BUILTINS)}") from None
    try:
        return ctor(**kwargs)
    except TypeError as e:
        raise ValueError(f"bad arguments for aggregate {name!r}: {e}") from None
