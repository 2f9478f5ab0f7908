"""Vectorized execution engine over a compiled overlay (paper §2.2.2), in
PyTorch.

The paper's runtime is event-at-a-time; here it is *batched dataflow*: a
batch of writes (or reads) is one pass of tensor operations over dense
tables. The overlay is compiled (host-side, once) into a leveled, tile-padded
``ExecPlan``; at runtime the plan only reacts — no per-event reasoning.

Substrate layout. The plan is split into a ``PlanMeta`` of static sizes and a
``PlanArrays`` NamedTuple of tensors on the engine's device: stacked,
tile-padded per-level routing tables built through
``segment_agg.ops.make_leveled_plan``. The step bodies loop in Python over
the overlay's real levels (``PlanMeta.depth``; the padded levels past it hold
no edge and are skipped), taking one level's tables per iteration; each level
is one reduce-by-destination, ``segment_agg_level``. The tensors' device
picks its implementation: on the card the hand-written CUDA kernel, on the
CPU the plain PyTorch version.

Write path (combine='sum', invertible aggregates):
    window append -> per-writer PAO delta -> per-level
    ``delta[dst] += segment_sum(sign * delta[src])`` restricted to *push* dsts.

Write path (combine='max'/'min', non-invertible):
    window append -> recompute written writers from their windows -> per-level
    recompute of push nodes (``segment_max`` over all in-edges; idempotent).

Read path (the *pull* sweep):
    demand up-sweep from requested pull readers through pull ancestors ->
    per-level masked compute down-sweep -> gather + FINALIZE at readers.

Every step is deterministic on the card: float values are only combined by
the segment kernel (fixed slot order) and by ``index_put_(accumulate=True)``
(sorted indices, lane order); the other scatters write unique indices or
reduce integers. No step runs a matrix
product, so TF32 rounding (``torch.backends.cuda.matmul.allow_tf32``) cannot
reach the results; a matmul added here must run with it off, since the
parity bar against the JAX package is 1e-4.
"""
from __future__ import annotations

import dataclasses
import heapq
import os
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.aggregates import Aggregate
from repro_torch.core.dataflow import PULL, PUSH
from repro_torch.core.overlay import Overlay
from repro_torch.core.window import (
    WindowSpec,
    WindowState,
    apply_writes,
    init_windows,
    stale_rows,
    window_pao,
)
from repro_torch.device import resolve_device
from repro_torch.kernels.segment_agg.ops import (
    E_BLK,
    R_BLK,
    leveled_plan_blocks,
    make_leveled_plan,
    segment_agg_level,
)


def not_ported(feature: str, item: str) -> NotImplementedError:
    """The error every feature outside this slice of the port raises."""
    return NotImplementedError(
        f"{feature} is not ported to repro_torch yet: ROADMAP.md, "
        f"'Modules to port', item {item}")


def bucket_batch(n: int, floor: int = 16) -> int:
    """Power-of-two batch bucketing: varying user batch sizes land on a
    handful of padded shapes."""
    return max(floor, 1 << (max(1, int(n)) - 1).bit_length())


class BaseRoutes:
    """Dense base-id -> (writer row, reader node) routing tables.

    The steady-state event routing path: :meth:`writer_rows` /
    :meth:`reader_nodes` are O(B) vectorized numpy (clip + gather + validity
    mask) with zero Python work per event. Capacity grows in power-of-two
    buckets; absent entries are ``-1``.
    """

    __slots__ = ("writer_row", "reader_node")

    def __init__(self, cap: int = 1):
        cap = self._bucket(cap)
        self.writer_row = np.full(cap, -1, np.int32)
        self.reader_node = np.full(cap, -1, np.int32)

    @staticmethod
    def _bucket(n: int) -> int:
        return max(256, 1 << (max(1, int(n)) - 1).bit_length())

    @property
    def cap(self) -> int:
        return len(self.writer_row)

    @classmethod
    def from_maps(cls, writer_row_of_base: dict, reader_node_of_base: dict
                  ) -> "BaseRoutes":
        top = max((max(m) for m in (writer_row_of_base, reader_node_of_base)
                   if m), default=0)
        routes = cls(top + 1)
        for table, m in ((routes.writer_row, writer_row_of_base),
                         (routes.reader_node, reader_node_of_base)):
            if m:
                table[np.fromiter(m.keys(), np.int64, len(m))] = \
                    np.fromiter(m.values(), np.int64, len(m))
        return routes

    def writer_rows(self, base_ids) -> tuple[np.ndarray, np.ndarray]:
        """Route one batch: ``(rows, mask)`` with masked lanes pinned to row
        0 — the padding pattern the masked write bodies drop."""
        ids = np.asarray(base_ids, np.int64).reshape(-1)
        rows = self.writer_row[np.clip(ids, 0, self.cap - 1)]
        mask = (ids >= 0) & (ids < self.cap) & (rows >= 0)
        return np.where(mask, rows, 0).astype(np.int32), mask

    def reader_nodes(self, base_ids) -> tuple[np.ndarray, np.ndarray]:
        ids = np.asarray(base_ids, np.int64).reshape(-1)
        nodes = self.reader_node[np.clip(ids, 0, self.cap - 1)]
        mask = (ids >= 0) & (ids < self.cap) & (nodes >= 0)
        return np.where(mask, nodes, 0).astype(np.int32), mask


class LevelTables(NamedTuple):
    """One edge set (push or pull) as stacked per-level kernel-layout tables.

    All tables are (L, e_pad) / (L, n_blocks) with padding slots ``seg == -1``
    (source 0, sign 0) so a padded slot contributes nothing.
    ``touched`` marks, per level, the destination rows the level recomputes.
    """

    seg: torch.Tensor            # (L, e_pad) int32 destination rows, -1 pad
    src: torch.Tensor            # (L, e_pad) int32 source rows, 0 pad
    sign: torch.Tensor           # (L, e_pad) f32 edge signs, 0 pad
    tile_of_block: torch.Tensor  # (L, n_blocks) int32
    first_of_tile: torch.Tensor  # (L, n_blocks) int32
    touched: torch.Tensor        # (L, n_nodes) bool


class PlanArrays(NamedTuple):
    """Runtime half of the plan: tensors on the engine's device."""

    decision: torch.Tensor       # (n_nodes,) int32 PUSH/PULL
    writer_node: torch.Tensor    # (n_writers,) int32; padding rows -> n_nodes
    push: LevelTables
    pull: LevelTables
    demand_dst: torch.Tensor     # (L, d_pad) int32 gather rows, pad -> n_nodes
    demand_src: torch.Tensor     # (L, d_pad) int32 scatter rows, pad -> n_nodes


@dataclasses.dataclass(frozen=True)
class PlanMeta:
    """Static half of the plan: the sizes the step bodies loop over."""

    n_nodes: int
    n_writers: int
    n_levels: int        # padded level count of the tables
    n_row_tiles: int
    depth: int           # real overlay depth: the step bodies' trip count;
                         # levels past it are all padding and are skipped


@dataclasses.dataclass
class ExecPlan:
    """Host-compiled execution plan: the overlay as dense leveled-CSR tables.

    The per-level structure lives in the stacked ``PlanArrays`` tables; only
    host-side id maps stay as dicts.
    """

    meta: PlanMeta
    arrays: PlanArrays
    decision: np.ndarray                 # (n,) PUSH/PULL (host copy)
    level: np.ndarray                    # (n,)
    writer_node: np.ndarray              # (n_writers,) overlay node per row
    writer_row_of_base: dict[int, int]   # base id -> window row
    reader_node_of_base: dict[int, int]  # base id -> overlay node
    routes: "BaseRoutes | None" = None   # dense mirror of the two dicts
    n_push_edges: int = 0
    n_pull_edges: int = 0
    patches_applied: int = 0

    @property
    def n_nodes(self) -> int:
        return self.meta.n_nodes

    @property
    def depth(self) -> int:
        return self.meta.depth

    @property
    def n_levels(self) -> int:
        return self.meta.depth

    @property
    def n_writers(self) -> int:
        return len(self.writer_node)


def _build_tables(per_level: list[list[tuple[int, int, int]]],
                  pad_levels: int | None, pad_blocks: int | None,
                  pad_nodes: int, device) -> LevelTables:
    """Stack one edge set's per-level (src, dst, sign) triples into padded
    kernel-layout tables via ``make_leveled_plan``."""
    segs, srcs, signs = [], [], []
    for tris in per_level:
        arr = np.asarray(tris, dtype=np.int64).reshape(-1, 3)
        segs.append(arr[:, 1])
        srcs.append(arr[:, 0])
        signs.append(arr[:, 2])
    lp = make_leveled_plan(segs, pad_nodes, pad_levels=pad_levels,
                           pad_blocks=pad_blocks)
    L, E = lp.n_levels, lp.e_pad
    src = np.zeros((L, E), np.int32)
    sign = np.zeros((L, E), np.float32)
    touched = np.zeros((L, pad_nodes), bool)
    for l in range(len(segs)):
        src[l] = lp.layout(l, srcs[l].astype(np.int32), fill=0)
        sign[l] = lp.layout(l, signs[l].astype(np.float32), fill=0.0)
        touched[l, segs[l]] = True
    put = lambda a: torch.as_tensor(a, device=device)
    return LevelTables(
        seg=put(lp.seg), src=put(src), sign=put(sign),
        tile_of_block=put(lp.tile_of_block),
        first_of_tile=put(lp.first_of_tile),
        touched=put(touched),
    )


@dataclasses.dataclass(frozen=True)
class PlanPad:
    """Explicit padding targets so several plans share one table shape. Any
    field left at 0 keeps the natural size."""

    n_nodes: int = 0
    n_writers: int = 0
    n_levels: int = 0
    push_blocks: int = 0
    pull_blocks: int = 0
    demand_edges: int = 0


def _collect_levels(overlay: Overlay, decision: np.ndarray, level: np.ndarray):
    """Split overlay edges into per-level push/pull/demand triples."""
    n_levels = int(level.max()) if overlay.n_nodes else 0
    per_level_push: list[list[tuple[int, int, int]]] = [[] for _ in range(n_levels)]
    per_level_pull: list[list[tuple[int, int, int]]] = [[] for _ in range(n_levels)]
    per_level_demand: list[list[tuple[int, int]]] = [[] for _ in range(n_levels)]
    for dst in range(overlay.n_nodes):
        l = int(level[dst]) - 1
        for src, sign in overlay.in_edges[dst]:
            if decision[dst] == PUSH:
                per_level_push[l].append((src, dst, sign))
            else:
                per_level_pull[l].append((src, dst, sign))
                if decision[src] == PULL:
                    per_level_demand[l].append((dst, src))
    return per_level_push, per_level_pull, per_level_demand, n_levels


def measure_plan(overlay: Overlay, decisions: np.ndarray) -> PlanPad:
    """The padded table dimensions ``compile_plan`` would produce, computed
    host-side without building any tables — equal to
    ``plan_dims(compile_plan(overlay, decisions))``."""
    decision = np.asarray(decisions, dtype=np.int64)
    level = overlay.levels()
    push, pull, demand, n_levels = _collect_levels(overlay, decision, level)

    def bucket_blocks(per_level):
        nb = leveled_plan_blocks(
            [np.asarray(t, np.int64).reshape(-1, 3)[:, 1] for t in per_level])
        return 1 << (nb - 1).bit_length()

    d_real = max((len(p) for p in demand), default=0)
    return PlanPad(
        n_nodes=overlay.n_nodes,
        n_writers=len(overlay.writer_nodes()),
        n_levels=max(1, -(-n_levels // 4) * 4),
        push_blocks=bucket_blocks(push),
        pull_blocks=bucket_blocks(pull),
        demand_edges=max(1, -(-d_real // 256) * 256),
    )


def compile_plan(overlay: Overlay, decisions: np.ndarray, *,
                 pad: PlanPad | None = None, device=None) -> ExecPlan:
    """Compile the overlay + decisions into stacked level tables on
    ``device`` (CUDA unless the caller names another). The numpy tables are
    bit-equal to the JAX package's."""
    if os.environ.get("EAGR_SEGAGG_BF16", "0").strip() == "1":
        raise not_ported("EAGR_SEGAGG_BF16 (bf16 edge values)", "12")
    device = resolve_device(device)
    pad = pad or PlanPad()
    level = overlay.levels()
    decision = np.asarray(decisions, dtype=np.int64)
    n_nodes = max(overlay.n_nodes, pad.n_nodes)

    writers = overlay.writer_nodes()
    writer_node = np.array(writers, dtype=np.int64)
    writer_row_of_base = {overlay.origin[v]: i for i, v in enumerate(writers)}
    reader_node_of_base = {overlay.origin[v]: v for v in overlay.reader_nodes()}

    per_level_push, per_level_pull, per_level_demand, n_levels = \
        _collect_levels(overlay, decision, level)

    pad_levels = pad.n_levels or None
    push = _build_tables(per_level_push, pad_levels,
                         pad.push_blocks or None, n_nodes, device)
    pull = _build_tables(per_level_pull, pad_levels,
                         pad.pull_blocks or None, n_nodes, device)
    L = push.seg.shape[0]

    d_real = max((len(p) for p in per_level_demand), default=0)
    d_pad = max(pad.demand_edges, max(1, -(-d_real // 256) * 256))
    demand_dst = np.full((L, d_pad), n_nodes, np.int32)
    demand_src = np.full((L, d_pad), n_nodes, np.int32)
    for l, pairs in enumerate(per_level_demand):
        if pairs:
            arr = np.asarray(pairs, dtype=np.int64)
            demand_dst[l, : len(pairs)] = arr[:, 0]
            demand_src[l, : len(pairs)] = arr[:, 1]

    n_writers = max(len(writer_node), pad.n_writers)
    wnode = np.full(n_writers, n_nodes, np.int32)
    wnode[: len(writer_node)] = writer_node

    dec_pad = np.full(n_nodes, PULL, np.int64)
    dec_pad[: overlay.n_nodes] = decision

    meta = PlanMeta(
        n_nodes=n_nodes,
        n_writers=n_writers,
        n_levels=L,
        n_row_tiles=max(1, -(-n_nodes // R_BLK)),
        depth=n_levels,
    )
    put = lambda a: torch.as_tensor(a, device=device)
    arrays = PlanArrays(
        decision=put(dec_pad.astype(np.int32)),
        writer_node=put(wnode),
        push=push,
        pull=pull,
        demand_dst=put(demand_dst),
        demand_src=put(demand_src),
    )
    return ExecPlan(
        meta=meta,
        arrays=arrays,
        decision=decision,
        level=level,
        writer_node=writer_node,
        writer_row_of_base=writer_row_of_base,
        reader_node_of_base=reader_node_of_base,
        routes=BaseRoutes.from_maps(writer_row_of_base, reader_node_of_base),
        n_push_edges=sum(len(p) for p in per_level_push),
        n_pull_edges=sum(len(p) for p in per_level_pull),
    )


def plan_dims(plan: ExecPlan) -> PlanPad:
    """The plan's padded table dimensions, as alignment targets."""
    return PlanPad(
        n_nodes=plan.meta.n_nodes,
        n_writers=plan.meta.n_writers,
        n_levels=plan.meta.n_levels,
        push_blocks=plan.arrays.push.seg.shape[1] // E_BLK,
        pull_blocks=plan.arrays.pull.seg.shape[1] // E_BLK,
        demand_edges=plan.arrays.demand_dst.shape[1],
    )


def grow_pad(pad: PlanPad, growth: float = 2.0) -> PlanPad:
    """Scale padding targets by ``growth`` so a plan compiled now has slot /
    node / level headroom for structural churn (§3.3)."""
    g = max(1.0, float(growth))

    def up(x, mult):
        x = max(1, int(np.ceil(x * g)))
        return -(-x // mult) * mult

    blocks = lambda x: 1 << (max(1, int(np.ceil(x * g))) - 1).bit_length()
    return PlanPad(
        n_nodes=up(pad.n_nodes, R_BLK),
        n_writers=up(pad.n_writers, 8),
        n_levels=up(pad.n_levels, 4),
        push_blocks=blocks(pad.push_blocks),
        pull_blocks=blocks(pad.pull_blocks),
        demand_edges=up(pad.demand_edges, 256),
    )


class EngineState(NamedTuple):
    windows: WindowState
    pao: torch.Tensor      # (n_nodes, pao_dim) fp32
    now: torch.Tensor      # () fp32 logical clock


# ------------------------------------------------------------ level execution
def _level_reduce(meta: PlanMeta, tables: LevelTables, l: int,
                  val: torch.Tensor, op: str) -> torch.Tensor:
    """Reduce-by-destination of one level's edge contributions gathered from
    ``val`` (n_nodes, F). Rows outside the level's touched set are undefined
    — callers mask. op: 'sum' (signed) | 'max' | 'min' (as -max(-x))."""
    x = val.index_select(0, tables.src[l])
    if op == "sum":
        x = x * tables.sign[l][:, None]
    elif op == "min":
        x = -x
    out = segment_agg_level(
        x, tables.seg[l], tables.tile_of_block[l], tables.first_of_tile[l],
        n_rows=meta.n_nodes, n_row_tiles=meta.n_row_tiles,
        op="sum" if op == "sum" else "max")
    return -out if op == "min" else out


def _scatter_rows(n_rows: int, idx: torch.Tensor, vals: torch.Tensor,
                  base: torch.Tensor | None = None) -> torch.Tensor:
    """``base[idx] = vals`` for indices that are unique below ``n_rows``;
    entries at ``idx >= n_rows`` (padding) go to a sentinel row that is cut
    off, so only they may repeat. Returns a new (n_rows, ...) tensor."""
    if base is None:
        base = vals.new_zeros((n_rows,) + vals.shape[1:])
    ext = torch.cat([base, base.new_zeros((1,) + base.shape[1:])])
    ext[torch.clamp(idx.to(torch.int64), max=n_rows)] = vals
    return ext[:n_rows]


# ---------------------------------------------------------------- step bodies
# The write/read bodies are functions of ``(meta, agg, spec, arrays, state,
# batch) -> state`` with no per-engine Python state; they return new state
# tensors and leave their inputs unchanged.
def write_step_sum(meta: PlanMeta, agg: Aggregate, spec: WindowSpec,
                   arrays: PlanArrays, state: EngineState, rows, vals, mask):
    windows, evicted, evicted_valid = apply_writes(
        state.windows, spec, rows, vals, state.now.expand(rows.shape), mask)
    delta_w = agg.lift(vals) * mask[:, None].to(torch.float32)
    delta_w = delta_w - agg.lift(evicted) \
        * evicted_valid[:, None].to(torch.float32)
    # duplicate writers in one batch: index_put_ with accumulate sums them.
    # On CUDA it sorts the indices stably and adds each index's lanes in lane
    # order, so unlike the atomic index_add_ it gives the same sum from run
    # to run. Masked lanes and padding writer rows land on a sentinel row.
    node = torch.where(mask, arrays.writer_node[rows.to(torch.int64)],
                       meta.n_nodes).to(torch.int64)
    delta = delta_w.new_zeros((meta.n_nodes + 1, delta_w.shape[1]))
    delta = delta.index_put_((node,), delta_w, accumulate=True)[:meta.n_nodes]

    for l in range(meta.depth):
        contrib = _level_reduce(meta, arrays.push, l, delta, "sum")
        # untouched rows are undefined kernel output (unwritten tiles) —
        # only the level's destinations may accumulate
        delta = delta + torch.where(arrays.push.touched[l][:, None],
                                    contrib, 0.0)
    return EngineState(windows, state.pao + delta, state.now + 1.0)


def write_step_extremal(meta: PlanMeta, agg: Aggregate, spec: WindowSpec,
                        arrays: PlanArrays, state: EngineState, rows, vals,
                        mask, prev_now):
    """Non-invertible write path, restricted to the *touched* writer set: the
    rows written this batch plus (time windows) the rows with an entry that
    expired since ``prev_now``. Untouched rows keep their stored PAO, and the
    level sweep only overwrites destinations downstream of a touched
    writer."""
    windows, _, _ = apply_writes(
        state.windows, spec, rows, vals, state.now.expand(rows.shape), mask)
    wp = window_pao(windows, spec, agg, now=state.now)
    n_w, n = meta.n_writers, meta.n_nodes
    written = torch.zeros(n_w + 1, dtype=torch.uint8, device=rows.device)
    written[torch.where(mask, rows.to(torch.int64), n_w)] = 1  # OR: one value
    touched_w = written[:n_w].bool()
    if spec.kind == "time":
        touched_w = touched_w | stale_rows(state.windows, spec, prev_now,
                                           state.now)
    wnode = arrays.writer_node
    old_w = state.pao[torch.clamp(wnode, max=n - 1)]
    new_w = torch.where(touched_w[:, None], wp, old_w)
    pao = _scatter_rows(n, wnode, new_w, base=state.pao)
    # (n, 1) 0/1 flags of the rows whose PAO changed this step
    changed = _scatter_rows(n, wnode, touched_w.to(torch.float32)[:, None],
                            base=pao.new_zeros((n, 1)))

    for l in range(meta.depth):
        new = _level_reduce(meta, arrays.push, l, pao, agg.combine)
        # a destination is recomputed when one of its sources changed: the
        # max of the sources' flags, over the same tables by the same kernel
        ch = _level_reduce(meta, arrays.push, l, changed, "max")
        upd = arrays.push.touched[l][:, None] & (ch > 0)
        pao = torch.where(upd, new, pao)
        changed = torch.where(upd, 1.0, changed)
    return EngineState(windows, pao, state.now + 1.0)


def refresh_pao_step(meta: PlanMeta, agg: Aggregate, spec: WindowSpec,
                     arrays: PlanArrays, windows: WindowState, now
                     ) -> torch.Tensor:
    """Recompute the full PAO tensor from the writer windows through the push
    tables: writer rows from their windows, push nodes level by level, pull
    rows left at the identity for the read-path demand sweep."""
    wp = window_pao(windows, spec, agg, now=now)
    pao = agg.init_pao(meta.n_nodes, device=wp.device)
    pao = _scatter_rows(meta.n_nodes, arrays.writer_node,
                        wp[: meta.n_writers], base=pao)
    for l in range(meta.depth):
        new = _level_reduce(meta, arrays.push, l, pao, agg.combine)
        pao = torch.where(arrays.push.touched[l][:, None], new, pao)
    return pao


def read_step(meta: PlanMeta, agg: Aggregate, arrays: PlanArrays,
              state: EngineState, reader_nodes, mask):
    n = meta.n_nodes
    decision = arrays.decision
    nodes = reader_nodes.to(torch.int64)
    # demand: (n + 1,) uint8, the last entry the sentinel that padding pairs
    # of the demand tables read and write; all scatters are integer maxima
    demand = torch.zeros(n + 1, dtype=torch.uint8, device=nodes.device)
    is_pull_target = mask & (decision[nodes] == PULL)
    demand.scatter_reduce_(0, nodes, is_pull_target.to(torch.uint8),
                           reduce="amax")
    for l in range(meta.depth - 1, -1, -1):  # dst level descending
        demand.scatter_reduce_(0, arrays.demand_src[l].to(torch.int64),
                               demand[arrays.demand_dst[l]], reduce="amax")
    take = ((demand[:n] > 0) & (decision == PULL))[:, None]
    val = state.pao
    for l in range(meta.depth):  # level ascending
        computed = _level_reduce(meta, arrays.pull, l, val, agg.combine)
        # only overwrite rows that this level actually computed
        val = torch.where(take & arrays.pull.touched[l][:, None], computed,
                          val)
    answers = val[nodes]
    return agg.finalize(answers), answers


# ------------------------------------------------------------ serialization
def _plan_array_leaves(arrays: PlanArrays):
    """Deterministic (name, leaf) walk of ``PlanArrays`` with dotted names
    (``push.seg`` ...) — the snapshot's key space, shared with the JAX
    package's ``plan_snapshot``."""
    for name, val in arrays._asdict().items():
        if isinstance(val, LevelTables):
            for f, sub in val._asdict().items():
                yield f"{name}.{f}", sub
        else:
            yield name, val


def _map_to_pairs(m: dict[int, int]) -> np.ndarray:
    """A host id map as one (2, len) int64 array (keys row, values row)."""
    out = np.empty((2, len(m)), np.int64)
    if m:
        out[0] = np.fromiter(m.keys(), np.int64, len(m))
        out[1] = np.fromiter(m.values(), np.int64, len(m))
    return out


def plan_snapshot(plan: ExecPlan) -> tuple[dict, dict]:
    """Serialize a live ``ExecPlan`` to ``(arrays, objs)``: a flat dict of
    host numpy arrays plus a JSON-safe object dict. Derived caches (the
    routes LUT) are rebuilt on the other side."""
    arrays = {f"pa.{name}": leaf.cpu().numpy()
              for name, leaf in _plan_array_leaves(plan.arrays)}
    arrays.update({
        "decision": np.asarray(plan.decision, np.int64),
        "level": np.asarray(plan.level, np.int64),
        "writer_node": np.asarray(plan.writer_node, np.int64),
        "wrob": _map_to_pairs(plan.writer_row_of_base),
        "rnob": _map_to_pairs(plan.reader_node_of_base),
    })
    objs = {
        "meta": dataclasses.asdict(plan.meta),
        "depth": int(plan.depth),
        "n_push_edges": int(plan.n_push_edges),
        "n_pull_edges": int(plan.n_pull_edges),
        "patches_applied": int(plan.patches_applied),
    }
    return arrays, objs


def plan_from_snapshot(arrays: dict, objs: dict, device=None) -> ExecPlan:
    """Rebuild an ``ExecPlan`` on ``device`` (CUDA unless the caller names
    another) from :func:`plan_snapshot` output without compiling anything."""
    device = resolve_device(device)
    meta = PlanMeta(**{**objs["meta"], "depth": int(objs["depth"])})

    def put(name):
        return torch.as_tensor(np.array(arrays[f"pa.{name}"]), device=device)

    pa = PlanArrays(
        decision=put("decision"), writer_node=put("writer_node"),
        push=LevelTables(**{f: put(f"push.{f}")
                            for f in LevelTables._fields}),
        pull=LevelTables(**{f: put(f"pull.{f}")
                            for f in LevelTables._fields}),
        demand_dst=put("demand_dst"), demand_src=put("demand_src"))
    wrob = {int(k): int(v) for k, v in zip(*arrays["wrob"])}
    rnob = {int(k): int(v) for k, v in zip(*arrays["rnob"])}
    return ExecPlan(
        meta=meta, arrays=pa,
        decision=np.asarray(arrays["decision"], np.int64),
        level=np.asarray(arrays["level"], np.int64),
        writer_node=np.asarray(arrays["writer_node"], np.int64),
        writer_row_of_base=wrob, reader_node_of_base=rnob,
        routes=BaseRoutes.from_maps(wrob, rnob),
        n_push_edges=int(objs["n_push_edges"]),
        n_pull_edges=int(objs["n_pull_edges"]),
        patches_applied=int(objs["patches_applied"]))


# ----------------------------------------------------------------------- API
class EagrEngine:
    """Runtime for one compiled ego-centric aggregate query, on one device
    (CUDA unless the caller passes ``device="cpu"``)."""

    def __init__(self, overlay: Overlay, decisions: np.ndarray, aggregate: Aggregate,
                 window: WindowSpec | None = None, *, device=None,
                 plan: ExecPlan | None = None, headroom: float | None = None):
        if aggregate.combine != "sum":
            neg = any(s < 0 for ins in overlay.in_edges for _, s in ins)
            if neg and not aggregate.supports_subtraction:
                raise ValueError("overlay has negative edges but aggregate is not subtractable")
        self.device = resolve_device(device)
        self.overlay = overlay
        self.agg = aggregate
        self.spec = window or WindowSpec(kind="tuple", size=1)
        if plan is None:
            pad = (grow_pad(measure_plan(overlay, decisions), headroom)
                   if headroom and headroom > 1.0 else None)
            plan = compile_plan(overlay, decisions, pad=pad,
                                device=self.device)
        self.plan = plan
        self.state = self.init_state()
        # host-side logical clock mirror + extremal-path eviction bookkeeping:
        # `_expiry` holds the eval times of batches whose entries are still
        # inside the time window; an all-dropped batch only needs the device
        # step when one of them crosses the expiry boundary.
        self._now_host = 0.0
        self._last_eval_now = 0.0
        self._expiry: list[float] = []

    def init_state(self) -> EngineState:
        windows = init_windows(self.plan.meta.n_writers, self.spec,
                               device=self.device)
        pao = self.agg.init_pao(self.plan.meta.n_nodes, device=self.device)
        return EngineState(windows, pao,
                           torch.zeros((), dtype=torch.float32,
                                       device=self.device))

    def adopt_state(self, state: EngineState, *, now_host: float,
                    last_eval_now: float, expiry=()) -> None:
        """Adopt an ``EngineState`` plus the host-side clock mirror and
        extremal expiry bookkeeping, verbatim (no PAO refresh)."""
        self.state = state
        self._now_host = float(now_host)
        self._last_eval_now = float(last_eval_now)
        self._expiry = sorted(float(t) for t in expiry)

    def _advance_clock(self) -> None:
        self.state = self.state._replace(now=self.state.now + 1.0)
        self._now_host += 1.0

    # ------------------------------------------------------------- execution
    def write_batch(self, base_ids: np.ndarray, values: np.ndarray,
                    batch_size: int | None = None) -> None:
        """Apply a batch of writes (base node ids + raw values). Values are
        (B,) scalars or (B, value_dim) vectors matching the window spec.
        Writes to nodes that feed no reader are masked out. Without an
        explicit ``batch_size`` the batch pads to its ``bucket_batch``
        bucket."""
        base_ids = np.asarray(base_ids)
        values = np.asarray(values, np.float32)
        rows, mask = self.plan.routes.writer_rows(base_ids)
        n_live = int(np.count_nonzero(mask))
        if n_live == 0 and batch_size is None:
            if self.agg.combine == "sum" or self.spec.kind == "tuple":
                # every write was dropped: the masked step would change
                # nothing but the clock
                self._advance_clock()
                return
            if not (self._expiry
                    and self._expiry[0] < self._now_host - self.spec.size):
                # extremal + time window, but no live entry crosses the
                # expiry boundary at this instant
                self._advance_clock()
                return
            # an entry expires at this evaluation instant: one all-masked
            # lane refreshes the touched writer PAOs at the new `now`
            rows, mask = np.zeros(1, np.int32), np.zeros(1, bool)
            values = np.zeros((1,) + values.shape[1:], np.float32)
        B = batch_size or bucket_batch(len(rows))
        if B < len(rows):
            # legacy callers size the batch to the *kept* count — compact the
            # live lanes instead of rejecting the batch
            if n_live > B:
                raise ValueError(f"batch_size={B} < {n_live} routed writes")
            live = np.flatnonzero(mask)
            rows, values, mask = rows[live], values[live], mask[live]
        elif not mask.all():
            # dropped lanes must not contribute: zero them so non-finite
            # garbage (inf * 0) can't leak through the masked multiply
            m = mask.reshape((-1,) + (1,) * (values.ndim - 1))
            values = np.where(m, values, 0.0).astype(np.float32)
        pad = B - len(rows)
        if pad:
            mask = np.concatenate([mask, np.zeros(pad, bool)])
            rows = np.concatenate([rows, np.zeros(pad, np.int32)])
            values = np.concatenate(
                [values, np.zeros((pad,) + values.shape[1:], np.float32)])
        self.write_rows(rows, values, mask, n_live=n_live)

    def write_rows(self, rows: np.ndarray, vals: np.ndarray,
                   mask: np.ndarray, *, n_live: int | None = None,
                   active=None) -> None:
        """Pre-routed write dispatch: ``rows`` are window rows (see
        ``ExecPlan.routes``), masked lanes carry row 0 / value 0 and the
        batch is already padded. The step is queued on the device and the
        call returns without waiting for it. Only the dense sweep is ported
        (``active`` must be ``None``)."""
        if active is not None:
            raise not_ported("frontier-sparse write steps", "5")
        if n_live is None:
            n_live = int(np.count_nonzero(mask))
        dev = self.device
        rows_d = torch.as_tensor(np.ascontiguousarray(rows, np.int32),
                                 device=dev)
        vals_d = torch.as_tensor(np.ascontiguousarray(vals, np.float32),
                                 device=dev)
        mask_d = torch.as_tensor(np.ascontiguousarray(mask, bool), device=dev)
        meta, arrays = self.plan.meta, self.plan.arrays
        if self.agg.combine == "sum":
            self.state = write_step_sum(meta, self.agg, self.spec, arrays,
                                        self.state, rows_d, vals_d, mask_d)
        else:
            if self.spec.kind == "time":
                if n_live:
                    heapq.heappush(self._expiry, self._now_host)
                boundary = self._now_host - self.spec.size
                while self._expiry and self._expiry[0] < boundary:
                    heapq.heappop(self._expiry)  # reflected by this refresh
            prev = torch.tensor(self._last_eval_now, dtype=torch.float32,
                                device=dev)
            self._last_eval_now = self._now_host
            self.state = write_step_extremal(meta, self.agg, self.spec,
                                             arrays, self.state, rows_d,
                                             vals_d, mask_d, prev)
        self._now_host += 1.0

    def read_batch(self, base_ids: np.ndarray, batch_size: int | None = None):
        """Answer a batch of reads. Returns finalized answers (B, ...) as
        numpy. The batch pads to the ``bucket_batch`` bucket unless
        ``batch_size`` pins the shape."""
        base_ids = np.asarray(base_ids)
        nodes, known = self.plan.routes.reader_nodes(base_ids)
        if not known.all():
            bad = np.asarray(base_ids, np.int64).reshape(-1)[~known]
            raise ValueError(
                f"read_batch: base ids {sorted(set(map(int, bad)))[:8]} are "
                f"not readers of this overlay (no reader node registered)")
        B = batch_size or bucket_batch(len(nodes))
        if B < len(nodes):
            raise ValueError(f"batch_size={B} < batch of {len(nodes)}")
        pad = B - len(nodes)
        mask = np.concatenate([np.ones(len(nodes), bool), np.zeros(pad, bool)])
        nodes = np.concatenate([nodes, np.zeros(pad, np.int32)])
        ans, _ = read_step(self.plan.meta, self.agg, self.plan.arrays,
                           self.state,
                           torch.as_tensor(nodes, device=self.device),
                           torch.as_tensor(mask, device=self.device))
        return ans.cpu().numpy()[: len(base_ids)]

    # ------------------------------------------------ outside this slice
    def apply_delta(self, delta, *, growth: float = 2.0):
        raise not_ported("structural churn (apply_delta / plan_patch)", "6")

    def adopt_decisions(self, decisions: np.ndarray):
        raise not_ported("adaptive re-decision (adopt_decisions)", "6")

    def attach_alerts(self, alerts) -> None:
        raise not_ported("standing alerts", "8")

    # --------------------------------------------------------------- oracle
    def oracle_read(self, base_id: int, reader_inputs: dict[int, set[int]]):
        """Reference answer computed directly from the writer windows
        (independent of the overlay) — the ground truth for tests."""
        wp = window_pao(self.state.windows, self.spec, self.agg,
                        now=self.state.now).cpu().numpy()
        acc = self.agg.INITIALIZE()
        count = self.state.windows.count.cpu().numpy()
        for w in reader_inputs[base_id]:
            row = self.plan.writer_row_of_base[w]
            if count[row] == 0:
                continue
            if self.agg.combine == "sum":
                acc = acc + wp[row]
            elif self.agg.combine == "max":
                acc = np.maximum(acc, wp[row])
            else:
                acc = np.minimum(acc, wp[row])
        return self.agg.FINALIZE(acc)
