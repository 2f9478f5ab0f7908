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

Given an ``active`` tuple, the write and read bodies run frontier-sparse:
each level over only the edge blocks the batch can reach (``core/
frontier.py`` expands them on the host), through the segment kernel's active
entry, bit-equal to the dense sweep (the JAX package's ``*_sparse`` twins).
Structural churn patches the plan tables in place (``core/plan_patch.py``).

Stacked shards (``distributed/stacked.py``): aligned per-shard plans stack
along a leading shard axis (``stack_plan_arrays``), and the ``*_stacked``
step bodies run every shard at once, each level one launch of the segment
kernel's stacked entry over all shards; per shard they compute exactly what
the single-engine bodies compute on that shard's slice.

A plan compiled with ``EAGR_SEGAGG_BF16=1`` (``PlanMeta.bf16``, as in the
JAX package) rounds each slot's edge value to bfloat16 before the level
reduces it in fp32: every level of its steps runs a fused entry's bf16
instance, a dense level the stacked dense entry at S = 1.

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
    flat_windows,
    init_windows,
    pad_window_rows,
    reset_window_rows,
    stale_rows,
    unflat_windows,
    window_pao,
)
from repro_torch.device import resolve_device
from repro_torch.kernels.segment_agg.ops import (
    E_BLK,
    R_BLK,
    leveled_plan_blocks,
    make_leveled_plan,
    segment_agg_active,
    segment_agg_active_stacked,
    segment_agg_level,
    segment_agg_level_stacked,
)


def bucket_batch(n: int, floor: int = 16) -> int:
    """Power-of-two batch bucketing: varying user batch sizes land on a
    handful of padded shapes."""
    return max(floor, 1 << (max(1, int(n)) - 1).bit_length())


class BaseRoutes:
    """Dense base-id -> (writer row, reader node) routing tables.

    The steady-state event routing path: :meth:`writer_rows` /
    :meth:`reader_nodes` are O(B) vectorized numpy (clip + gather + validity
    mask) with zero Python work per event. The ``ExecPlan`` dicts stay
    authoritative for churn bookkeeping; ``plan_patch`` mirrors each of
    their edits here (one table edit per delta entry). Capacity grows in
    power-of-two buckets; absent entries are ``-1``.
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

    def _grow(self, top: int) -> None:
        if top < self.cap:
            return
        cap = self._bucket(top + 1)
        for name in ("writer_row", "reader_node"):
            old = getattr(self, name)
            new = np.full(cap, -1, np.int32)
            new[: len(old)] = old
            setattr(self, name, new)

    # ------------------------------------------- churn maintenance (per delta)
    def set_writer(self, base: int, row: int) -> None:
        self._grow(int(base))
        self.writer_row[int(base)] = row

    def clear_writer(self, base: int) -> None:
        if 0 <= int(base) < self.cap:
            self.writer_row[int(base)] = -1

    def set_reader(self, base: int, node: int) -> None:
        self._grow(int(base))
        self.reader_node[int(base)] = node

    def clear_reader(self, base: int) -> None:
        if 0 <= int(base) < self.cap:
            self.reader_node[int(base)] = -1

    # ------------------------------------------------- hot path (per batch)
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
    bf16: bool = False   # EAGR_SEGAGG_BF16: each slot's edge value is
                         # rounded to bfloat16; reductions stay fp32


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
    host: object | None = None           # plan_patch.PlanHost (lazy); owned
                                         # by the incremental patch path
    patches_applied: int = 0
    frontier: object | None = None       # frontier.FrontierIndex, built on
                                         # the first sparse write
    reader_frontier: object | None = None  # frontier.ReaderFrontierIndex;
                                           # dropped by any structural patch
    write_costs: "StepCosts | None" = None  # auto's measured costs on the
    read_costs: "StepCosts | None" = None   # card, one set per plan

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
    bit-equal to the JAX package's. ``EAGR_SEGAGG_BF16=1`` compiles a plan
    in bf16 mode (``PlanMeta.bf16``), as the JAX package reads it."""
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
        bf16=os.environ.get("EAGR_SEGAGG_BF16", "0").strip() == "1",
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
    — callers mask. op: 'sum' (signed) | 'max' | 'min' (as -max(-x)). A
    bf16 plan's level is one call of the fused dense entry at S = 1, whose
    bf16 instance rounds each gathered value (the only bf16 dense path)."""
    if meta.bf16:
        tabs = (tables.seg[l], tables.src[l], tables.sign[l],
                tables.tile_of_block[l], tables.first_of_tile[l])
        return segment_agg_level_stacked(
            val.contiguous()[None], *(t[None] for t in tabs),
            n_rows=meta.n_nodes, n_row_tiles=meta.n_row_tiles, op=op,
            bf16=True)[0]
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


# ------------------------------------------------------- frontier-sparse levels
# A step runs each real level either densely (every slot of the level's
# tables) or frontier-sparse: over only the batch frontier's active edge
# blocks (``active`` is the ragged per-level tuple of (K,) int32 ascending
# block indices padded with the level's block count, expanded on the host by
# ``core/frontier.py``). A sparse level is one call of the segment kernel's
# active entry, which gathers, signs and reduces the active blocks' slots
# and marks the destinations it reaches; it adds an active row's values in
# the dense pass's order, and the index guarantees every block that matters
# is active, so a sparse step is bit-equal to the dense one. Levels with no
# active block cost nothing; no step reads a device value back to the host.
def _level_reduce_active(meta: PlanMeta, tables: LevelTables, l: int,
                         active_l: torch.Tensor, val: torch.Tensor, op: str):
    """``_level_reduce`` over a level's active blocks, with the rows it
    recomputes: ``(out, rows)``, ``rows`` the level's touched destinations
    with at least one active slot (the sparse twin of ``touched``; the index
    guarantees any destination with a nonzero or changed contribution has
    every slot active, so masking to these rows is exact). Rows outside
    ``rows`` are undefined — callers mask."""
    out, hit = segment_agg_active(
        val.contiguous(), tables.seg[l], tables.src[l], tables.sign[l],
        tables.tile_of_block[l], tables.first_of_tile[l], active_l,
        n_rows=meta.n_nodes, n_row_tiles=meta.n_row_tiles, op=op,
        bf16=meta.bf16)
    return out, tables.touched[l] & hit


def _levels(meta: PlanMeta, tables: LevelTables, active=None):
    """The real levels in ascending order, each as a ``reduce(val, op) ->
    (out, rows)``: the level's reduce-by-destination of ``val`` (whose rows
    outside ``rows`` are undefined) and the (n_nodes,) destinations it
    recomputes. Dense with ``active=None``; otherwise over the level's
    active blocks, skipping levels with none."""
    for l in range(meta.depth):
        if active is None:
            yield lambda val, op, l=l: (
                _level_reduce(meta, tables, l, val, op), tables.touched[l])
        elif active[l].shape[0]:
            yield lambda val, op, l=l: _level_reduce_active(
                meta, tables, l, active[l], val, op)


# ---------------------------------------------------------------- step bodies
# The write/read bodies are functions of ``(meta, agg, spec, arrays, state,
# batch) -> state`` with no per-engine Python state; they return new state
# tensors and leave their inputs unchanged. ``active=None`` runs the dense
# sweep, a per-level active tuple the frontier-sparse one (bit-equal).
def write_step_sum(meta: PlanMeta, agg: Aggregate, spec: WindowSpec,
                   arrays: PlanArrays, state: EngineState, rows, vals, mask,
                   active=None):
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

    for reduce in _levels(meta, arrays.push, active):
        # rows the level does not recompute are undefined kernel output
        # (unwritten tiles) — only its destinations may accumulate
        contrib, rows_l = reduce(delta, "sum")
        delta = delta + torch.where(rows_l[:, None], contrib, 0.0)
    return EngineState(windows, state.pao + delta, state.now + 1.0)


def write_step_extremal(meta: PlanMeta, agg: Aggregate, spec: WindowSpec,
                        arrays: PlanArrays, state: EngineState, rows, vals,
                        mask, prev_now, active=None):
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
    written.index_fill_(0, torch.where(mask, rows.to(torch.int64), n_w),
                        1)  # OR: one value
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

    for reduce in _levels(meta, arrays.push, active):
        new, rows_l = reduce(pao, agg.combine)
        # a destination is recomputed when one of its sources changed: the
        # max of the sources' flags, over the same tables by the same kernel
        upd = rows_l[:, None] & (reduce(changed, "max")[0] > 0)
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
    for reduce in _levels(meta, arrays.push):
        new, rows_l = reduce(pao, agg.combine)
        pao = torch.where(rows_l[:, None], new, pao)
    return pao


DEM_CHUNK = 256  # demand slots per active chunk (d_pad is a multiple of 256)


def read_step(meta: PlanMeta, agg: Aggregate, arrays: PlanArrays,
              state: EngineState, reader_nodes, mask, active=None):
    """The pull sweep. ``active=None`` runs it densely; ``active =
    (dem_active, pull_active)`` (expanded on the host from
    ``ReaderFrontierIndex``) restricts the demand up-sweep to active
    DEM_CHUNK-slot chunks and the pull down-sweep to active edge blocks."""
    n = meta.n_nodes
    decision = arrays.decision
    nodes = reader_nodes.to(torch.int64)
    # demand: (n + 1,) uint8, the last entry the sentinel that padding pairs
    # of the demand tables read and write; all scatters are integer maxima
    demand = torch.zeros(n + 1, dtype=torch.uint8, device=nodes.device)
    is_pull_target = mask & (decision[nodes] == PULL)
    demand.scatter_reduce_(0, nodes, is_pull_target.to(torch.uint8),
                           reduce="amax")
    nc = arrays.demand_dst.shape[1] // DEM_CHUNK
    for l in range(meta.depth - 1, -1, -1):  # dst level descending
        dsts, srcs = arrays.demand_dst[l], arrays.demand_src[l]
        if active is not None:
            # d_pad below one chunk: the plan has no demand pair at all
            if nc == 0 or active[0][l].shape[0] == 0:
                continue
            a = active[0][l].to(torch.int64)
            ac, valid = torch.clamp(a, max=nc - 1), (a < nc)[:, None]
            dsts = torch.where(valid, dsts.view(nc, DEM_CHUNK)[ac],
                               n).reshape(-1)
            srcs = torch.where(valid, srcs.view(nc, DEM_CHUNK)[ac],
                               n).reshape(-1)
        demand.scatter_reduce_(0, srcs.to(torch.int64), demand[dsts],
                               reduce="amax")
    take = ((demand[:n] > 0) & (decision == PULL))[:, None]
    val = state.pao
    for reduce in _levels(meta, arrays.pull,
                          None if active is None else active[1]):
        # only overwrite rows that this level actually computed
        new, rows_l = reduce(val, agg.combine)
        val = torch.where(take & rows_l[:, None], new, val)
    answers = val[nodes]
    return agg.finalize(answers), answers


# ------------------------------------------------------------ stacked shards
def _map_arrays(fn, *arrays: PlanArrays) -> PlanArrays:
    """``fn`` applied leaf by leaf across ``PlanArrays`` of one structure."""
    out = []
    for vals in zip(*arrays):
        if isinstance(vals[0], LevelTables):
            out.append(LevelTables._make(fn(*xs) for xs in zip(*vals)))
        else:
            out.append(fn(*vals))
    return PlanArrays._make(out)


def stack_plan_arrays(arrays: list[PlanArrays]) -> PlanArrays:
    """Stack aligned per-shard ``PlanArrays`` along a new leading shard axis.
    All inputs must share one table shape (``align_shard_plans``)."""
    shapes = {tuple(tuple(x.shape) for _, x in _plan_array_leaves(a))
              for a in arrays}
    if len(shapes) != 1:
        raise ValueError(f"cannot stack misaligned plan arrays: {shapes}")
    return _map_arrays(lambda *xs: torch.stack(xs), *arrays)


def plan_arrays_shard(stacked: PlanArrays, s: int) -> PlanArrays:
    """One shard's slice of stacked ``PlanArrays``: views of the stack, so
    an in-place patch of the slice patches the stack."""
    return _map_arrays(lambda x: x[s], stacked)


def _offsets(S: int, n: int, device) -> torch.Tensor:
    """(S, 1) int64 row offsets of S shards of ``n`` rows each."""
    return (torch.arange(S, dtype=torch.int64, device=device) * n)[:, None]


def _stacked_levels(meta: PlanMeta, tables: LevelTables, active=None):
    """``_levels`` over stacked (S, L, ...) tables: each real level as a
    ``reduce(val, op) -> (out, rows)``, the level's reduce-by-destination
    of ``val`` (S, n, F) for every shard in one launch and the (S, n)
    destinations it recomputes. Dense, each level is one call of the fused
    stacked dense entry, which gathers each shard's sources from its own
    slice of ``val``. ``active``, when given, is the per-level tuple of
    (S, K) active-block lists (each shard's padded with the level's block
    count), each level one call of the fused active entry; levels no shard
    has an active block in are skipped."""
    kw = dict(n_rows=meta.n_nodes, n_row_tiles=meta.n_row_tiles,
              bf16=meta.bf16)
    for l in range(meta.depth):
        tabs = (tables.seg[:, l], tables.src[:, l], tables.sign[:, l],
                tables.tile_of_block[:, l], tables.first_of_tile[:, l])
        if active is None:
            def reduce(val, op, l=l, tabs=tabs):
                return (segment_agg_level_stacked(val.contiguous(), *tabs,
                                                  op=op, **kw),
                        tables.touched[:, l])
        elif active[l].shape[1] == 0:
            continue
        else:
            def reduce(val, op, l=l, tabs=tabs):
                out, hit = segment_agg_active_stacked(
                    val.contiguous(), *tabs, active[l], op=op, **kw)
                return out, tables.touched[:, l] & hit

        yield reduce


def _stacked_batch(state: EngineState, n_writers: int, rows, vals, mask):
    """A global batch as the flat single-engine batch over the stacked
    windows' (S * n_writers) rows: every shard sees every lane (write
    replication), shard s's lanes at s * B + i, its rows offset by
    s * n_writers and stamped with its own clock."""
    S, B = rows.shape
    rows_f = (rows.to(torch.int64) + _offsets(S, n_writers, rows.device)
              ).reshape(-1)
    vals_f = vals.unsqueeze(0).expand((S,) + tuple(vals.shape)) \
        .reshape((S * B,) + tuple(vals.shape[1:]))
    stamps = state.now[:, None].expand(S, B).reshape(-1)
    return rows_f, vals_f, mask.reshape(-1), stamps


def write_step_sum_stacked(meta: PlanMeta, agg: Aggregate, spec: WindowSpec,
                           arrays: PlanArrays, state: EngineState, rows,
                           vals, mask, active=None) -> EngineState:
    """``write_step_sum`` for S stacked shards: ``rows``/``mask`` (S, B) are
    each shard's routing of one global batch ``vals`` (B[, d]), ``state``
    the stacked state (windows (S, n_writers, cap), pao (S, n, d), now
    (S,)). The duplicate-writer scatter totals over the flattened (shard,
    node) index with ``index_put_(accumulate=True)`` (lane order, as the
    single engine); per shard the result equals the single-engine step."""
    S = rows.shape[0]
    n, nw = meta.n_nodes, meta.n_writers
    rows_f, vals_f, mask_f, stamps = _stacked_batch(state, nw, rows, vals,
                                                    mask)
    windows, evicted, evicted_valid = apply_writes(
        flat_windows(state.windows), spec, rows_f, vals_f, stamps, mask_f)
    delta_w = agg.lift(vals_f) * mask_f[:, None].to(torch.float32)
    delta_w = delta_w - agg.lift(evicted) \
        * evicted_valid[:, None].to(torch.float32)
    wn = arrays.writer_node.gather(1, rows.to(torch.int64)).to(torch.int64)
    node = torch.where(mask, wn + _offsets(S, n, rows.device), S * n) \
        .reshape(-1)
    d = delta_w.shape[1]
    delta = delta_w.new_zeros((S * n + 1, d))
    delta = delta.index_put_((node,), delta_w, accumulate=True)[: S * n] \
        .view(S, n, d)
    for reduce in _stacked_levels(meta, arrays.push, active):
        contrib, rows_l = reduce(delta, "sum")
        delta = delta + torch.where(rows_l[..., None], contrib, 0.0)
    return EngineState(unflat_windows(windows, S), state.pao + delta,
                       state.now + 1.0)


def write_step_extremal_stacked(meta: PlanMeta, agg: Aggregate,
                                spec: WindowSpec, arrays: PlanArrays,
                                state: EngineState, rows, vals, mask,
                                prev_now, active=None) -> EngineState:
    """``write_step_extremal`` for S stacked shards (``prev_now`` (S,) each
    shard's previous eval instant); per shard the result equals the
    single-engine step."""
    S = rows.shape[0]
    n, nw = meta.n_nodes, meta.n_writers
    rows_f, vals_f, mask_f, stamps = _stacked_batch(state, nw, rows, vals,
                                                    mask)
    old = flat_windows(state.windows)
    windows, _, _ = apply_writes(old, spec, rows_f, vals_f, stamps, mask_f)
    now_r = state.now.repeat_interleave(nw)[:, None]
    wp = window_pao(windows, spec, agg, now=now_r)
    written = torch.zeros(S * nw + 1, dtype=torch.uint8, device=rows.device)
    written.index_fill_(0, torch.where(mask_f, rows_f, S * nw), 1)
    touched_w = written[: S * nw].bool()
    if spec.kind == "time":
        touched_w = touched_w | stale_rows(
            old, spec, prev_now.repeat_interleave(nw)[:, None], now_r)
    wnode = arrays.writer_node.to(torch.int64)
    wflat = torch.where(wnode < n, wnode + _offsets(S, n, rows.device),
                        S * n).reshape(-1)
    pao_f = state.pao.reshape(S * n, -1)
    old_w = pao_f[torch.clamp(wflat, max=S * n - 1)]
    new_w = torch.where(touched_w[:, None], wp, old_w)
    pao = _scatter_rows(S * n, wflat, new_w, base=pao_f).view(S, n, -1)
    changed = _scatter_rows(S * n, wflat,
                            touched_w.to(torch.float32)[:, None],
                            base=pao.new_zeros((S * n, 1))).view(S, n, 1)
    for reduce in _stacked_levels(meta, arrays.push, active):
        new, rows_l = reduce(pao, agg.combine)
        upd = rows_l[..., None] & (reduce(changed, "max")[0] > 0)
        pao = torch.where(upd, new, pao)
        changed = torch.where(upd, 1.0, changed)
    return EngineState(unflat_windows(windows, S), pao, state.now + 1.0)


def read_step_stacked(meta: PlanMeta, agg: Aggregate, arrays: PlanArrays,
                      state: EngineState, nodes, own):
    """The pull sweep over S stacked shards, then the gather by owner:
    ``nodes``/``own`` (S, B) route each lane of a global batch to its
    reader node on the one shard that owns it. Returns ``(finalized,
    answers)`` (B, ...): lane i is the owning shard's answer, which is the
    JAX package's sum over shards of the answers masked to zero. Lanes no
    shard owns (padding) hold shard 0's value at node 0."""
    S, B = nodes.shape
    n = meta.n_nodes
    dev = nodes.device
    off1 = _offsets(S, n + 1, dev)
    idx = nodes.to(torch.int64)
    decision = arrays.decision
    demand = torch.zeros(S * (n + 1), dtype=torch.uint8, device=dev)
    is_pull = own & (decision.gather(1, idx) == PULL)
    demand.scatter_reduce_(0, (idx + off1).reshape(-1),
                           is_pull.to(torch.uint8).reshape(-1), reduce="amax")
    for l in range(meta.depth - 1, -1, -1):
        dsts = (arrays.demand_dst[:, l].to(torch.int64) + off1).reshape(-1)
        srcs = (arrays.demand_src[:, l].to(torch.int64) + off1).reshape(-1)
        demand.scatter_reduce_(0, srcs, demand[dsts], reduce="amax")
    take = ((demand.view(S, n + 1)[:, :n] > 0) & (decision == PULL))[..., None]
    val = state.pao
    for reduce in _stacked_levels(meta, arrays.pull):
        new, rows_l = reduce(val, agg.combine)
        val = torch.where(take & rows_l[..., None], new, val)
    d = val.shape[-1]
    answers = val.gather(1, idx[..., None].expand(S, B, d))
    owner = (own.to(torch.int64)
             * torch.arange(S, dtype=torch.int64, device=dev)[:, None]).sum(0)
    answers = answers[owner, torch.arange(B, device=dev)]
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


# PlanMeta fields of the JAX package that choose its backend. The port picks
# its kernel by the tensors' device; a snapshot carries the values of the
# JAX package's looped 'xla' backend, which its restore accepts anywhere.
REFERENCE_BACKEND_META = {"unroll_levels": 0, "backend": "xla",
                          "interpret": False}


def _meta_to_snapshot(meta: PlanMeta) -> dict:
    """``PlanMeta`` in the JAX package's key set (its real depth travels as
    the snapshot's ``depth``), with the plan's own bf16 flag."""
    return {"n_nodes": meta.n_nodes, "n_writers": meta.n_writers,
            "n_levels": meta.n_levels,
            "unroll_levels": REFERENCE_BACKEND_META["unroll_levels"],
            "n_row_tiles": meta.n_row_tiles,
            **{k: v for k, v in REFERENCE_BACKEND_META.items()
               if k != "unroll_levels"},
            "bf16": bool(meta.bf16)}


def _meta_from_snapshot(meta: dict, depth: int) -> PlanMeta:
    """A snapshot's meta dict, in the JAX package's key set or the port's,
    as a ``PlanMeta``: the backend fields are dropped, the bf16 flag kept
    (a snapshot without one is fp32), and plans of the unrolled backend,
    which has no counterpart, raise."""
    meta = dict(meta)
    meta["bf16"] = bool(meta.get("bf16", False))
    if meta.get("unroll_levels"):
        raise ValueError("plans of the 'xla_unrolled' backend have no "
                         "counterpart in the port; compile with 'xla' or "
                         "'pallas'")
    for f in REFERENCE_BACKEND_META:
        meta.pop(f, None)
    meta["depth"] = int(depth)
    extra = set(meta) - set(PlanMeta.__dataclass_fields__)
    if extra:
        raise ValueError(f"unknown PlanMeta fields {sorted(extra)}")
    return PlanMeta(**meta)


def plan_snapshot_parts(plan: ExecPlan) -> tuple[dict, dict, dict]:
    """:func:`plan_snapshot` before its readback: ``(tensors, arrays,
    objs)``, the device tables by snapshot key, the host arrays and the
    object dict. A caller snapshotting many plans copies every table to
    the host behind one wait (``to_host``)."""
    tensors = {f"pa.{name}": leaf
               for name, leaf in _plan_array_leaves(plan.arrays)}
    host = plan.host
    if host is not None:  # the patch bookkeeping's, churn since compile in
        decision = np.asarray(host.decision[: host.n_real], np.int64)
        level = np.asarray(host.level[: host.n_real], np.int64)
    else:
        decision = np.asarray(plan.decision, np.int64)
        level = np.asarray(plan.level, np.int64)
    arrays = {
        "decision": decision,
        "level": level,
        "writer_node": np.asarray(plan.writer_node, np.int64),
        "wrob": _map_to_pairs(plan.writer_row_of_base),
        "rnob": _map_to_pairs(plan.reader_node_of_base),
    }
    objs = {
        "meta": _meta_to_snapshot(plan.meta),
        "depth": int(plan.depth),
        "n_push_edges": int(plan.n_push_edges),
        "n_pull_edges": int(plan.n_pull_edges),
        "patches_applied": int(plan.patches_applied),
    }
    return tensors, arrays, objs


def plan_snapshot(plan: ExecPlan) -> tuple[dict, dict]:
    """Serialize a live ``ExecPlan`` to ``(arrays, objs)``: a flat dict of
    host numpy arrays plus a JSON-safe object dict, in the JAX package's
    format (its ``plan_from_snapshot`` restores it). Derived caches (the
    routes LUT, ``PlanHost``, frontier indices) are rebuilt on the other
    side."""
    tensors, arrays, objs = plan_snapshot_parts(plan)
    out = dict(zip(tensors, to_host(*tensors.values())))
    out.update(arrays)
    return out, objs


def plan_from_snapshot(arrays: dict, objs: dict, device=None) -> ExecPlan:
    """Rebuild an ``ExecPlan`` on ``device`` (CUDA unless the caller names
    another) from :func:`plan_snapshot` output, the port's or the JAX
    package's, without compiling anything."""
    meta = _meta_from_snapshot(objs["meta"], objs["depth"])
    device = resolve_device(device)

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
def stage(arrays, device: torch.device) -> list[torch.Tensor]:
    """Host arrays onto ``device`` as explicit copies: ``arrays`` is a list
    of ``(array, dtype)``. To a CUDA device they travel packed in ONE pinned
    host buffer by ONE non-blocking copy (a step's rows, mask, values and
    active-block lists; a patch's edits), and come back as views of the
    device buffer: the host never waits on the device (no implicit sync:
    steady-state steps run clean under
    ``torch.cuda.set_sync_debug_mode("error")``). Elsewhere each becomes a
    tensor on ``device``."""
    arrays = [np.ascontiguousarray(a, dt) for a, dt in arrays]
    if device.type != "cuda":
        return [torch.from_numpy(a).to(device) for a in arrays]
    offs, off = [], 0
    for a in arrays:
        offs.append(off)
        off += -(-a.nbytes // 16) * 16   # 16-byte aligned views
    buf = torch.empty(max(off, 16), dtype=torch.uint8, pin_memory=True)
    host = buf.numpy()
    for o, a in zip(offs, arrays):
        host[o: o + a.nbytes] = a.reshape(-1).view(np.uint8)
    dev = buf.to(device, non_blocking=True)
    return [dev[o: o + a.nbytes]
            .view(torch.from_numpy(np.empty(0, a.dtype)).dtype).view(a.shape)
            for o, a in zip(offs, arrays)]


# ------------------------------------------------------ auto's step choice
SLEEP_CYCLES = 50_000_000   # ~25 ms of the card held while a timed step
                            # is enqueued, so its events time the device only
SPARSE_MARGIN = 0.8         # sparse only where predicted 20% below dense:
                            # a near tie goes to the step with no expansion


@dataclasses.dataclass(frozen=True)
class StepCosts:
    """What one step of a plan costs on its card, measured once (seconds):
    the frontier expansion's host time per row; the dense step's host
    dispatch and device time; the sparse step's host dispatch (expansion
    excluded) and device time at ``blocks`` active blocks. A step costs the
    larger of its host and device times (the host enqueues while the card
    runs). ``auto`` then decides by a fixed function of the batch's live
    rows and active blocks, so one run's choices are reproducible; sparse
    must come out below ``SPARSE_MARGIN`` times the dense step."""

    per_row: float
    dense_host: float
    dense_dev: float
    sparse_host: float
    sparse_dev: float
    blocks: int

    @property
    def dense(self) -> float:
        return max(self.dense_host, self.dense_dev)

    def worth_expanding(self, n: int) -> bool:
        """Can a sparse step of ``n`` rows win at all (expansion and its
        host dispatch below the dense step)?"""
        return self.per_row * n + self.sparse_host < \
            SPARSE_MARGIN * self.dense

    def sparse_wins(self, n: int, k: int) -> bool:
        """Sparse for ``n`` rows over ``k`` active blocks against dense."""
        dev = self.sparse_dev * k / max(1, self.blocks)
        return max(self.per_row * n + self.sparse_host, dev) < \
            SPARSE_MARGIN * self.dense


TIMED_REPS = 5               # timed rounds of each step (after one warm)


def _timed(device, *runs) -> list[tuple[float, float]]:
    """For each of ``runs``: (host seconds to enqueue ``run()``, device
    seconds it ran), the card held by a sleep kernel while the host enqueues
    so that the events time the device work alone. The runs take turns
    round by round, so a slow moment of the host falls on all of them;
    each value is the median of TIMED_REPS rounds after a warm one (which
    loads the kernels)."""
    import time

    samples = [[] for _ in runs]
    for rep in range(TIMED_REPS + 1):
        for out, run in zip(samples, runs):
            torch.cuda.synchronize(device)
            torch.cuda._sleep(SLEEP_CYCLES)
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            t0 = time.perf_counter()
            run()
            host = time.perf_counter() - t0
            ev1.record()
            ev1.synchronize()
            if rep:
                out.append((host, ev0.elapsed_time(ev1) / 1e3))
    return [tuple(float(np.median(col)) for col in zip(*out))
            for out in samples]


def _host_median(run):
    """(median host seconds of TIMED_REPS calls of ``run()``, its last
    result)."""
    import time

    secs = []
    for _ in range(TIMED_REPS):
        t0 = time.perf_counter()
        out = run()
        secs.append(time.perf_counter() - t0)
    return float(np.median(secs)), out


def _real_blocks(active, n_units: int) -> int:
    return int(sum(np.count_nonzero(a < n_units) for a in active))


def _reader_blocks(rf, act) -> int:
    """Active demand chunks plus pull blocks of a read's active pair."""
    return _real_blocks(act[0], rf.n_chunks) + \
        _real_blocks(act[1], rf.n_blocks)


def to_host(*tensors) -> list[np.ndarray]:
    """Device tensors as host numpy copies. From a CUDA device through
    pinned buffers by non-blocking copies behind one event that the host
    waits on: an explicit wait, never an implicit sync."""
    if not tensors or tensors[0].device.type != "cuda":
        return [t.detach().cpu().numpy().copy() for t in tensors]
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in tensors]
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    ev.synchronize()
    return [h.numpy() for h in host]


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
        # continuous groups pin every churn-added node PUSH through patches
        # (always-fresh readers; alert evaluation depends on it)
        self.pin_push = False
        # standing alerts (streams.alerts.AlertSet); None keeps the plain
        # write bodies
        self.alerts = None
        self.state = self.init_state()
        # host-side logical clock mirror + extremal-path eviction bookkeeping:
        # `_expiry` holds the eval times of batches whose entries are still
        # inside the time window; an all-dropped batch only needs the device
        # step when one of them crosses the expiry boundary.
        self._now_host = 0.0
        self._last_eval_now = 0.0
        self._expiry: list[float] = []
        # per write step: the active-block count for sparse steps, -1 for
        # dense — the frontier-size distribution (frontier_summary)
        self.frontier_log: list[int] = []

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

    def frontier_active(self, rows: np.ndarray, mask: np.ndarray,
                        n_live: int | None = None):
        """Decide and expand this batch's frontier: the ragged per-level
        active-block tuple for the sparse write bodies, or ``None`` for the
        dense sweep. ``None`` whenever sparseness can't be exact (an
        extremal time window with entries expiring outside the batch) or
        can't pay (EAGR_SPARSE_WRITE=0; under auto, a step the rule says
        the dense sweep does faster). Auto's rule on CPU tensors is the JAX
        package's (a large batch or a frontier past the density threshold
        goes dense); on the card it compares the plan's measured
        :class:`StepCosts` (see :meth:`_auto_write`). Builds the plan's
        ``FrontierIndex`` on first use."""
        from repro_torch.core import frontier as F

        mode = F.sparse_mode()
        meta = self.plan.meta
        if mode == "0":
            return None
        if self.agg.combine != "sum" and self.spec.kind == "time" and \
                self._expiry and \
                self._expiry[0] < self._now_host - self.spec.size:
            # rows expire at this eval instant: the touched set exceeds the
            # batch frontier, only the dense sweep sees all of it
            return None
        if n_live is None:
            n_live = int(np.count_nonzero(mask))
        if n_live == 0:
            return None
        density = None
        on_card = self.device.type == "cuda"
        if mode == "auto":
            nb = self.plan.arrays.push.tile_of_block.shape[1]
            if nb < 8 or (not on_card and
                          n_live > F.sparse_rowfrac() * meta.n_writers):
                return None  # frontier ~ overlay: expansion can't win
            if not on_card:
                density = F.sparse_density()
        exact = self.agg.combine == "sum"
        if self.plan.frontier is None or self.plan.frontier.exact != exact:
            self.plan.frontier = F.FrontierIndex.build(self.plan,
                                                       exact=exact)
        if mode == "auto" and on_card:
            return self._auto_write(rows, mask, n_live)
        rows_u = np.unique(np.asarray(rows)[np.asarray(mask, bool)])
        return self.plan.frontier.expand(rows_u, density=density)

    def _auto_write(self, rows, mask, n_live: int):
        """Auto's write-step choice on the card: the plan's ``write_costs``
        (measured on this batch the first time) say whether a sparse step
        of ``n_live`` rows over the batch's active blocks beats the dense
        one. EAGR_SPARSE_ROWFRAC and EAGR_SPARSE_DENSITY, where set, cap it
        as on the CPU."""
        from repro_torch.core import frontier as F

        fi = self.plan.frontier
        if self.plan.write_costs is None:
            self.plan.write_costs = self._calibrate_write(rows, mask, n_live)
        costs = self.plan.write_costs
        if not costs.worth_expanding(n_live):
            return None
        if "EAGR_SPARSE_ROWFRAC" in os.environ and \
                n_live > F.sparse_rowfrac() * self.plan.meta.n_writers:
            return None
        rows_u = np.unique(np.asarray(rows)[np.asarray(mask, bool)])
        act = fi.expand(rows_u, density=F.sparse_density()
                        if "EAGR_SPARSE_DENSITY" in os.environ else None)
        if act is None or not costs.sparse_wins(
                n_live, _real_blocks(act, fi.n_blocks)):
            return None
        return act

    def _calibrate_write(self, rows, mask, n_live: int) -> StepCosts:
        """Time this batch's expansion on the host, then its dense and its
        sparse step (results dropped: the step bodies are pure)."""
        sec, act = _host_median(lambda: self.plan.frontier.expand(
            np.unique(np.asarray(rows)[np.asarray(mask, bool)]),
            density=None))
        per_row = sec / max(1, n_live)
        vals = np.zeros((len(rows),) + ((self.spec.value_dim,)
                                        if self.spec.value_dim > 1 else ()),
                        np.float32)
        prev = self._last_eval_now
        dense = lambda: self._write_body(rows, vals, mask, n_live, None,
                                         prev)
        if act is None:  # a row the index cannot bound: never sparse
            ((dh, dd),) = _timed(self.device, dense)
            return StepCosts(per_row, dh, dd, float("inf"), 0.0, 1)
        (dh, dd), (sh, sd) = _timed(self.device, dense, lambda: (
            self._write_body(rows, vals, mask, n_live, act, prev)))
        return StepCosts(per_row, dh, dd, sh, sd,
                         _real_blocks(act, self.plan.frontier.n_blocks))

    def write_rows(self, rows: np.ndarray, vals, mask: np.ndarray, *,
                   n_live: int | None = None, active="auto") -> None:
        """Pre-routed write dispatch: ``rows`` are window rows (see
        ``ExecPlan.routes``), masked lanes carry row 0 and the batch is
        already padded. ``vals`` is a host array (dead lanes already 0) or
        a tensor, pinned on the host or on the device, whose dead lanes are
        zeroed on the device (the ingest ring passes its pinned slot). The
        rows, mask, host values and active tuple travel as one explicit
        copy and the step is queued on the device; the call returns without
        waiting for it. ``active`` selects the step: ``"auto"`` asks
        :meth:`frontier_active`, ``None`` forces the dense sweep, and a
        per-level active-block tuple runs the frontier-sparse bodies over
        exactly those edge blocks. With standing alerts attached, their
        evaluation runs right after the step on the device (fused
        write-and-evaluate) and the step's fired buffers wait for
        readback."""
        if n_live is None:
            n_live = int(np.count_nonzero(mask))
        if isinstance(active, str):
            active = self.frontier_active(rows, mask, n_live=n_live)
        self.frontier_log.append(
            -1 if active is None else sum(a.shape[0] for a in active))
        if len(self.frontier_log) > (1 << 20):
            del self.frontier_log[: (1 << 19)]
        prev = None
        if self.agg.combine != "sum":
            if self.spec.kind == "time":
                if n_live:
                    heapq.heappush(self._expiry, self._now_host)
                boundary = self._now_host - self.spec.size
                while self._expiry and self._expiry[0] < boundary:
                    heapq.heappop(self._expiry)  # reflected by this refresh
            prev = self._last_eval_now
            self._last_eval_now = self._now_host
        self.state = self._write_body(rows, vals, mask, n_live, active, prev)
        al = self.alerts
        if al is not None and al.enabled and al.n_placed:
            from repro_torch.streams.alerts import alert_eval

            # the post-step PAO at the step's own eval instant (the step
            # advanced the clock); the alert columns update in place
            out = alert_eval(self.agg, al.state, self.state.pao,
                             self.state.now - 1.0, al.cap)
            al.push_pending(self._now_host, *out)
        self._now_host += 1.0

    def _write_body(self, rows, vals, mask, n_live: int, active, prev):
        """Stage one pre-routed batch and queue its step body; returns the
        new ``EngineState`` (``self.state`` is left as it is). ``prev`` is
        the extremal path's previous eval instant."""
        dev = self.device
        host = [(rows, np.int32), (mask, bool)]
        given = torch.is_tensor(vals)
        if not given:
            host.append((vals, np.float32))
        if active is not None:
            host.extend((a, np.int32) for a in active)
        staged = stage(host, dev)
        rows_d, mask_d, rest = staged[0], staged[1], staged[2:]
        if given:
            vals_d = vals.to(dev, non_blocking=True)
            if n_live < mask_d.shape[0]:
                # dead lanes to 0, as write_batch does on the host: keeps
                # non-finite garbage out of the masked multiply
                vals_d = torch.where(
                    mask_d.view((-1,) + (1,) * (vals_d.dim() - 1)), vals_d,
                    0.0)
        else:
            vals_d, rest = rest[0], rest[1:]
        act_d = None if active is None else tuple(rest)
        args = (self.plan.meta, self.agg, self.spec, self.plan.arrays,
                self.state, rows_d, vals_d, mask_d)
        if self.agg.combine == "sum":
            return write_step_sum(*args, active=act_d)
        # a fill, not a copy from the host
        prev_d = torch.full((), prev, dtype=torch.float32, device=dev)
        return write_step_extremal(*args, prev_d, active=act_d)

    def read_batch(self, base_ids: np.ndarray, batch_size: int | None = None):
        """Answer a batch of reads. Returns finalized answers (B, ...) as
        numpy. The batch pads to the ``bucket_batch`` bucket unless
        ``batch_size`` pins the shape; small reader batches run the
        frontier-sparse read (:meth:`_reader_active`). The answers come back
        through pinned memory behind one event: no implicit sync."""
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
        mask_p = np.concatenate([np.ones(len(nodes), bool),
                                 np.zeros(pad, bool)])
        nodes_p = np.concatenate([nodes, np.zeros(pad, np.int32)])
        act = self._reader_active(nodes, (nodes_p, mask_p))
        ans, _ = self._read_body(nodes_p, mask_p, act)
        (out,) = to_host(ans)
        return out[: len(base_ids)]

    def _read_body(self, nodes, mask, act):
        """Stage one padded reader batch (and its active tuple) as one copy
        and queue the read step; returns ``read_step``'s output."""
        host = [(nodes, np.int32), (mask, bool)]
        if act is not None:
            host.extend((a, np.int32) for side in act for a in side)
        staged = stage(host, self.device)
        act_d = None
        if act is not None:
            n_dem = len(act[0])
            act_d = (tuple(staged[2: 2 + n_dem]), tuple(staged[2 + n_dem:]))
        return read_step(self.plan.meta, self.agg, self.plan.arrays,
                         self.state, staged[0], staged[1], active=act_d)

    def _reader_active(self, nodes: np.ndarray, padded=None):
        """Read-path twin of :meth:`frontier_active`: ``(dem_active,
        pull_active)`` chunk/block arrays for the sparse demand and pull
        sweeps, or ``None`` for the dense read. Auto on CPU tensors expands
        only small reader batches (the JAX package's rule); on the card it
        compares the plan's measured ``read_costs``, timed the first time
        on this batch (``padded``: the batch's padded nodes and mask)."""
        from repro_torch.core import frontier as F

        mode = F.sparse_mode()
        if mode == "0":
            return None
        on_card = self.device.type == "cuda"
        density = None
        if mode == "auto" and not on_card:
            if len(nodes) > F.sparse_rowfrac() * self.plan.meta.n_nodes:
                return None
            density = F.sparse_density()
        if self.plan.reader_frontier is None:
            self.plan.reader_frontier = F.ReaderFrontierIndex.build(self.plan)
        rf = self.plan.reader_frontier
        if mode != "auto" or not on_card:
            return rf.expand(np.unique(nodes), density=density)
        n = len(nodes)
        if self.plan.read_costs is None:
            if padded is None:
                B = bucket_batch(n)
                padded = (np.concatenate([nodes, np.zeros(B - n, np.int32)]),
                          np.arange(B) < n)
            self.plan.read_costs = self._calibrate_read(nodes, padded)
        costs = self.plan.read_costs
        if not costs.worth_expanding(n):
            return None
        if "EAGR_SPARSE_ROWFRAC" in os.environ and \
                n > F.sparse_rowfrac() * self.plan.meta.n_nodes:
            return None
        act = rf.expand(np.unique(nodes), density=F.sparse_density()
                        if "EAGR_SPARSE_DENSITY" in os.environ else None)
        if act is None or not costs.sparse_wins(n, _reader_blocks(rf, act)):
            return None
        return act

    def _calibrate_read(self, nodes, padded) -> StepCosts:
        """Time this batch's reader expansion on the host, then its dense
        and its sparse read step."""
        rf = self.plan.reader_frontier
        sec, act = _host_median(lambda: rf.expand(np.unique(nodes),
                                                  density=None))
        per_row = sec / max(1, len(nodes))
        dense = lambda: self._read_body(*padded, None)
        if act is None:  # the index stayed dense-only
            ((dh, dd),) = _timed(self.device, dense)
            return StepCosts(per_row, dh, dd, float("inf"), 0.0, 1)
        (dh, dd), (sh, sd) = _timed(self.device, dense,
                                    lambda: self._read_body(*padded, act))
        return StepCosts(per_row, dh, dd, sh, sd, _reader_blocks(rf, act))

    # -------------------------------------------------- structural updates
    def _refresh(self, windows: WindowState) -> None:
        """Adopt resized windows and recompute every PAO through the current
        push tables (the state repair after a patch or a plan swap)."""
        pao = refresh_pao_step(self.plan.meta, self.agg, self.spec,
                               self.plan.arrays, windows, self.state.now)
        self.state = EngineState(windows, pao, self.state.now)
        self._last_eval_now = self._now_host

    def apply_delta(self, delta, *, growth: float = 2.0):
        """Apply a ``DynamicOverlay.drain_delta()`` mutation log to the live
        plan (§3.3 end to end). In-capacity updates lower the delta to a
        ``plan_patch.PatchProgram`` whose edits are written into the live
        ``PlanArrays`` tensors in place (their storage is kept); a
        tile/level/capacity overflow falls back to ``compile_plan`` with
        ``growth`` headroom. Engine state is migrated: new writer rows are
        live immediately, retired writer windows are zeroed, and all push
        PAOs are refreshed. Returns the ``plan_patch.PatchResult``."""
        from repro_torch.core.plan_patch import patch_plan

        res = patch_plan(self.plan, delta, overlay=self.overlay,
                         growth=growth, pin_push=self.pin_push)
        if res.reason == "empty delta":
            return res  # nothing changed: skip the state refresh entirely
        self.plan = res.plan
        if res.recompiled and res.overlay is not None:
            self.overlay = res.overlay
        windows = pad_window_rows(self.state.windows, self.plan.meta.n_writers)
        if res.retired_writer_rows:
            windows = reset_window_rows(windows, res.retired_writer_rows)
        self._refresh(windows)
        if self.alerts is not None:
            # carry alert rows through churn: retired readers drop, moved
            # readers follow their node, query-wide alerts adopt new readers
            self.alerts.sync(self, retired=res.retired_reader_bases)
        return res

    def adopt_decisions(self, decisions: np.ndarray) -> ExecPlan:
        """Recompile the live plan with new push/pull decisions (§4.8
        adaptive re-decision) and migrate engine state: the overlay is
        unchanged, so writer rows keep their positions and the windows
        survive untouched; PAOs are refreshed for the new push set. Padded
        dims are floored at the current plan's and grown where the new
        decisions need more. Host patch bookkeeping is re-seeded so
        structural churn keeps patching in place afterwards. Returns the
        adopted plan."""
        from repro_torch.core.plan_patch import carry_plan_bookkeeping

        host = self.plan.host
        ov = host.export_overlay() if host is not None else self.overlay
        decisions = np.asarray(decisions, dtype=np.int64)
        # floored at the current plan's dims, grown where the new push/pull
        # split needs more (the JAX package passes the current dims alone,
        # and its compile raises when a level then needs more blocks)
        cur, need = plan_dims(self.plan), measure_plan(ov, decisions)
        pad = PlanPad(**{f: max(getattr(cur, f), getattr(need, f))
                         for f in PlanPad.__dataclass_fields__})
        new = compile_plan(ov, decisions, pad=pad, device=self.device)
        carry_plan_bookkeeping(new, self.plan, ov)
        self.overlay = ov
        self.adopt_plan(new)
        return new

    def adopt_plan(self, plan: ExecPlan) -> None:
        """Swap in a structurally equivalent recompiled plan and migrate
        engine state: windows resize to the new writer capacity, PAOs are
        refreshed."""
        self.plan = plan
        self._refresh(pad_window_rows(self.state.windows, plan.meta.n_writers))
        if self.alerts is not None:
            self.alerts.sync(self)

    def attach_alerts(self, alerts) -> None:
        """Attach an ``AlertSet``: resolve its reader rows against the live
        plan; from the next write on every step carries its alert
        evaluation (see :meth:`write_rows`)."""
        self.alerts = alerts
        try:
            alerts.sync(self)
        except Exception:
            self.alerts = None
            raise

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
