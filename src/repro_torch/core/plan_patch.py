"""Incremental ExecPlan maintenance: patch ``PlanArrays`` in place (§3.3).

The full-rebuild path (``compile_plan``) re-derives and re-uploads every
stacked level table — seconds of latency per structural update at scale.
This module consumes the structured mutation log a ``DynamicOverlay``
journals (``OverlayDelta``) and patches the *live* plan instead, in three
escalating tiers:

  1. **slot patch** — a retired edge's slot is neutralized in place
     (``seg=-1, src=0, sign=0``: the padding pattern every backend drops);
     a new edge claims a free slot inside the owning row tile's block range.
  2. **level relayout** — when a tile's occupancy counter overflows its slot
     range (or a destination moved into a previously-empty tile) the whole
     level row is rebuilt from the graph mirror (``ops.relayout_level``) —
     still inside the plan's padded block budget, so no table changes shape.
  3. **recompile fallback** — a genuine capacity overflow (nodes, writers,
     levels, blocks, demand slots) falls back to ``compile_plan`` with a
     ``growth``-factor ``PlanPad`` so the *next* churn burst patches cheaply.

Tiers 1 and 2 are **device-resident**: the delta is lowered to a
``PatchProgram`` — shape-bucketed arrays of (level, slot) edits, touched-mask
point edits, whole-row relayouts, and decision / writer-row / demand-row
updates, the same arrays the JAX package lowers — and ``apply_patch_step``
writes every edit into the live ``PlanArrays`` tensors with ``index_put_``.
The tables keep their storage (``data_ptr()``) across in-capacity patches:
the port's analogue of the JAX package's one donated trace. Only the edits
travel to the device, as explicit copies; the tables never leave device
memory. Shape-bucket padding entries write nothing new
(``ops.scatter_slots``).

The host side (``PlanHost``) is a *bookkeeping index*, not a table mirror:
the overlay graph (in-edges, kinds, decisions, levels), per-(level, tile)
free-slot pools and occupancy counters (the host twin of
``ops.tile_occupancy``), and per-destination slot assignments. Full numpy
table mirrors exist only as a parity oracle behind the ``EAGR_PATCH_PARITY``
debug flag, which replays every edit host-side
and asserts the device tables bit-identical after each patch.

Node ids are kept stable by operating on the **unpruned** overlay export
(``DynamicOverlay.to_overlay(prune=False)``): dead nodes linger edgeless and
writer rows are append-only, which is what makes window state migration a
pad-and-zero instead of a reshuffle.
"""
from __future__ import annotations

import dataclasses
import os
from collections import Counter, deque
from typing import NamedTuple

import numpy as np

from repro_torch.core.dataflow import PULL, PUSH
from repro_torch.core.dynamic import OverlayDelta
from repro_torch.core.engine import (
    ExecPlan,
    LevelTables,
    PlanArrays,
    PlanMeta,
    compile_plan,
    grow_pad,
    measure_plan,
    stage,
)
from repro_torch.core.overlay import Overlay
from repro_torch.kernels.segment_agg.ops import (
    E_BLK,
    R_BLK,
    relayout_level,
    scatter_rows,
    scatter_slots,
    tile_slot_ranges,
)


class CapacityExceeded(Exception):
    """An in-place patch does not fit the plan's padded capacity."""


# ------------------------------------------------------------- patch program
# Edit-array index value marking shape-bucket padding: out of every table's
# bounds, so the device scatters write nothing new for it.
_OOB = np.int32(2 ** 30)
_SLOT_BUCKET = 64  # slot-edit count floor; buckets grow by powers of 4, so
                   # the program's shapes are the JAX package's


def _bucket_class(counts_floors) -> int:
    """One shared ladder rung for a GROUP of edit fields: every field in the
    group is padded to ``floor * 4**class``, so the program's shapes move
    along a single ladder (one class for the whole program, as in the JAX
    package)."""
    c = 0
    for n, floor in counts_floors:
        k, b = 0, floor
        while b < n:
            b *= 4
            k += 1
        c = max(c, k)
    return c


class TablePatch(NamedTuple):
    """One edge set's device edits, shape-bucketed (``_bucket_class``)."""

    lvl: np.ndarray        # (P,) i32 slot-edit levels, _OOB padding
    slot: np.ndarray       # (P,) i32 slot-edit positions
    seg: np.ndarray        # (P,) i32 new destinations (-1 retires)
    src: np.ndarray        # (P,) i32 new sources
    sign: np.ndarray       # (P,) f32 new signs
    t_lvl: np.ndarray      # (T,) i32 touched-mask point edits, _OOB padding
    t_node: np.ndarray     # (T,) i32 destination whose touched bit flips
    t_val: np.ndarray      # (T,) bool new touched bit
    row_lvl: np.ndarray    # (R,) i32 relayout levels, _OOB padding
    row_seg: np.ndarray    # (R, e_pad) i32 replacement rows
    row_src: np.ndarray    # (R, e_pad) i32
    row_sign: np.ndarray   # (R, e_pad) f32
    row_tob: np.ndarray    # (R, n_blocks) i32
    row_fot: np.ndarray    # (R, n_blocks) i32
    row_touched: np.ndarray  # (R, cap) bool replacement touched rows


class PatchProgram(NamedTuple):
    """A lowered ``OverlayDelta``: every device-side effect of one in-capacity
    patch as shape-bucketed host arrays, applied by ``apply_patch_step``.
    Only these (edit-sized) arrays travel host->device."""

    push: TablePatch
    pull: TablePatch
    dec_idx: np.ndarray    # (C,) i32 nodes whose PUSH/PULL decision flipped
    dec_val: np.ndarray    # (C,) i32
    w_row: np.ndarray      # (W,) i32 newly claimed writer rows
    w_node: np.ndarray     # (W,) i32 their overlay nodes
    d_lvl: np.ndarray      # (D,) i32 demand levels rebuilt, _OOB padding
    d_dst: np.ndarray      # (D, d_pad) i32 replacement demand rows
    d_src: np.ndarray      # (D, d_pad) i32


def _apply_table(t: LevelTables, p: TablePatch) -> None:
    scatter_slots(t.seg, p.lvl, p.slot, p.seg)
    scatter_slots(t.src, p.lvl, p.slot, p.src)
    scatter_slots(t.sign, p.lvl, p.slot, p.sign)
    scatter_slots(t.touched, p.t_lvl, p.t_node, p.t_val)
    scatter_rows(t.seg, p.row_lvl, p.row_seg)
    scatter_rows(t.src, p.row_lvl, p.row_src)
    scatter_rows(t.sign, p.row_lvl, p.row_sign)
    scatter_rows(t.tile_of_block, p.row_lvl, p.row_tob)
    scatter_rows(t.first_of_tile, p.row_lvl, p.row_fot)
    scatter_rows(t.touched, p.row_lvl, p.row_touched)


def apply_patch_program(arrays: PlanArrays, prog: PatchProgram) -> None:
    """Write one uploaded program's edits into the live tables in place:
    slot edits, then touched-mask point edits, then whole-row relayouts, per
    edge set; then decisions, new writer rows and demand rows."""
    _apply_table(arrays.push, prog.push)
    _apply_table(arrays.pull, prog.pull)
    scatter_rows(arrays.decision, prog.dec_idx, prog.dec_val)
    scatter_rows(arrays.writer_node, prog.w_row, prog.w_node)
    scatter_rows(arrays.demand_dst, prog.d_lvl, prog.d_dst)
    scatter_rows(arrays.demand_src, prog.d_lvl, prog.d_src)


def apply_patch_step(meta: PlanMeta, arrays: PlanArrays,
                     prog: PatchProgram) -> PlanArrays:
    """The device-resident table update: uploads one lowered delta and
    writes it into the live ``PlanArrays`` tensors in place (no table is
    reallocated or copied through the host). Returns ``arrays``."""
    del meta  # the tables carry their own shapes
    rest = PatchProgram._fields[2:]
    host = list(prog.push) + list(prog.pull) + [getattr(prog, f)
                                                for f in rest]
    dev = iter(stage([(a, a.dtype) for a in host], arrays.decision.device))
    n = len(TablePatch._fields)
    apply_patch_program(arrays, PatchProgram(
        push=TablePatch(*(next(dev) for _ in range(n))),
        pull=TablePatch(*(next(dev) for _ in range(n))),
        **{f: next(dev) for f in rest}))
    return arrays


def _host(t) -> np.ndarray:
    """A device table as a fresh host numpy array."""
    return t.cpu().numpy().copy()


# --------------------------------------------------------------- host mirrors
@dataclasses.dataclass
class TableMirror:
    """Full numpy twin of one ``LevelTables`` — the parity oracle. Maintained
    only under ``EAGR_PATCH_PARITY``; the hot
    path never reads or uploads it."""

    seg: np.ndarray
    src: np.ndarray
    sign: np.ndarray
    touched: np.ndarray

    @staticmethod
    def from_tables(t: LevelTables) -> "TableMirror":
        return TableMirror(seg=_host(t.seg), src=_host(t.src),
                           sign=_host(t.sign), touched=_host(t.touched))


class _FreePools(dict):
    """(level, tile) -> that tile's free slots, highest first (claims pop
    from the end). A level's pools are cut from its free-slot array only
    when a tile of the level is first touched: a relayout of a level with
    millions of padding slots then builds no list it does not use."""

    def __init__(self):
        super().__init__()
        self.src: dict[int, tuple] = {}   # level -> (free slots, lo, hi)

    def set_level(self, l: int, free: np.ndarray, lo: np.ndarray,
                  hi: np.ndarray) -> None:
        for key in [k for k in self if k[0] == l]:
            del self[key]
        self.src[l] = (free, lo, hi)

    def __missing__(self, key):
        free, lo, hi = self.src[key[0]]
        pool = self[key] = free[lo[key[1]]: hi[key[1]]][::-1].tolist()
        return pool


@dataclasses.dataclass
class TableHost:
    """Bookkeeping index of one ``LevelTables``: block routing, free-slot
    pools, per-tile occupancy counters (host twin of ``ops.tile_occupancy``)
    and per-destination slot assignments. Holds no authoritative copy of the
    device tables — mutations accumulate as edits for the patch program."""

    tob: np.ndarray               # (L, n_blocks) int32
    fot: np.ndarray               # (L, n_blocks) int32
    tile_slots: np.ndarray        # (L, n_row_tiles, 2) [start, stop) per tile
    occ: np.ndarray               # (L, n_row_tiles) int32 live slots per tile
    e_pad: int
    # d -> [(slot, src, sign)], and d -> level
    slots_of: dict[int, list[tuple[int, int, float]]] = \
        dataclasses.field(default_factory=dict)
    level_of: dict[int, int] = dataclasses.field(default_factory=dict)
    free: _FreePools = dataclasses.field(default_factory=_FreePools)
    mirror: TableMirror | None = None
    # edits of the in-flight patch, drained into a TablePatch
    edits: dict[tuple[int, int], tuple[int, int, float]] = \
        dataclasses.field(default_factory=dict)
    touched_edits: dict[tuple[int, int], bool] = \
        dataclasses.field(default_factory=dict)
    row_edits: dict[int, tuple] = dataclasses.field(default_factory=dict)

    @staticmethod
    def from_tables(t: LevelTables, n_row_tiles: int,
                    track_mirror: bool = False) -> "TableHost":
        seg = _host(t.seg)
        src = _host(t.src)
        sign = _host(t.sign)
        tob = _host(t.tile_of_block)
        L = seg.shape[0]
        th = TableHost(
            tob=tob, fot=_host(t.first_of_tile),
            tile_slots=np.stack([tile_slot_ranges(tob[l], n_row_tiles)
                                 for l in range(L)]),
            occ=np.zeros((L, n_row_tiles), np.int32),
            e_pad=seg.shape[1],
        )
        for l in range(L):
            th.index_level(l, seg[l], src[l], sign[l])
        if track_mirror:
            th.mirror = TableMirror.from_tables(t)
        return th

    def index_level(self, l: int, seg_row: np.ndarray, src_row: np.ndarray,
                    sign_row: np.ndarray) -> None:
        """Rebuild slot occupancy and the free pools of one level row."""
        for d in [d for d, lv in self.level_of.items() if lv == l]:
            self.slots_of.pop(d, None)
            self.level_of.pop(d, None)
        occupied = np.flatnonzero(seg_row >= 0)
        # group occupied slots by destination (vectorized: sort-then-split)
        dsts = seg_row[occupied]
        order = np.argsort(dsts, kind="stable")
        sorted_slots = occupied[order]
        uniq, starts = np.unique(dsts[order], return_index=True)
        bounds = np.append(starts, len(order)).tolist()
        entries = list(zip(sorted_slots.tolist(),
                           src_row[sorted_slots].tolist(),
                           sign_row[sorted_slots].astype(np.float64).tolist()))
        for i, d in enumerate(uniq.tolist()):
            self.slots_of[d] = entries[bounds[i]: bounds[i + 1]]
            self.level_of[d] = l
        # each tile's free slots: the range [a, b) of its blocks
        free = np.flatnonzero(seg_row < 0)
        a, b = self.tile_slots[l, :, 0], self.tile_slots[l, :, 1]
        lo, hi = np.searchsorted(free, a), np.searchsorted(free, b)
        self.occ[l] = (b - a) - (hi - lo)
        self.free.set_level(l, free, lo, hi)

    def record(self, l: int, slot: int, seg_v: int, src_v: int,
               sign_v: float) -> None:
        """Log one slot edit for the patch program (last write wins); replay
        it on the parity mirror when tracking."""
        self.edits[(l, slot)] = (seg_v, src_v, sign_v)
        if self.mirror is not None:
            self.mirror.seg[l, slot] = seg_v
            self.mirror.src[l, slot] = src_v
            self.mirror.sign[l, slot] = sign_v

    def n_edges(self) -> int:
        return int(self.occ.sum())  # live slots, one per edge

    def drain_patch(self, cap: int, cls_idx: int, cls_row: int) -> TablePatch:
        """Drain the accumulated edits into numpy program arrays, padded to
        the shared bucket classes (see ``_bucket_class``), and replay touched
        changes on the parity mirror when tracking."""
        items = sorted(self.edits.items())
        k = _SLOT_BUCKET * 4 ** cls_idx
        lvl = _OOB + np.arange(k, dtype=np.int32)  # distinct OOB padding
        # (scatters promise unique_indices; dropped entries stay unique)
        slot = np.zeros(k, np.int32)
        seg_v = np.zeros(k, np.int32)
        src_v = np.zeros(k, np.int32)
        sign_v = np.zeros(k, np.float32)
        for i, ((l, s), (sv, rv, gv)) in enumerate(items):
            lvl[i], slot[i] = l, s
            seg_v[i], src_v[i], sign_v[i] = sv, rv, gv
        touches = sorted(self.touched_edits.items())
        tk = _SLOT_BUCKET * 4 ** cls_idx
        t_lvl = _OOB + np.arange(tk, dtype=np.int32)
        t_node = np.zeros(tk, np.int32)
        t_val = np.zeros(tk, bool)
        for i, ((l, d), v) in enumerate(touches):
            t_lvl[i], t_node[i], t_val[i] = l, d, v
        rows = sorted(self.row_edits.items())
        # never pad the relayout group past the level count: a slot-heavy
        # burst (high shared class) must not upload megabytes of all-padding
        # (R, e_pad) rows
        rk = min(4 ** cls_row, self.tob.shape[0])
        nb = self.tob.shape[1]
        row_lvl = _OOB + np.arange(rk, dtype=np.int32)
        row_seg = np.zeros((rk, self.e_pad), np.int32)
        row_src = np.zeros((rk, self.e_pad), np.int32)
        row_sign = np.zeros((rk, self.e_pad), np.float32)
        row_tob = np.zeros((rk, nb), np.int32)
        row_fot = np.zeros((rk, nb), np.int32)
        row_touched = np.zeros((rk, cap), bool)
        for i, (l, (sr, rr, gr, tr, fr, trow)) in enumerate(rows):
            row_lvl[i] = l
            row_seg[i], row_src[i], row_sign[i] = sr, rr, gr
            row_tob[i], row_fot[i] = tr, fr
            row_touched[i] = trow
        if self.mirror is not None:
            for (l, d), v in touches:
                self.mirror.touched[l, d] = v
            for l, (*_, trow) in rows:
                self.mirror.touched[l] = trow
        self.edits.clear()
        self.touched_edits.clear()
        self.row_edits.clear()
        return TablePatch(lvl=lvl, slot=slot, seg=seg_v, src=src_v,
                          sign=sign_v, t_lvl=t_lvl, t_node=t_node,
                          t_val=t_val, row_lvl=row_lvl, row_seg=row_seg,
                          row_src=row_src, row_sign=row_sign, row_tob=row_tob,
                          row_fot=row_fot, row_touched=row_touched)


@dataclasses.dataclass
class PlanHost:
    """Host-side bookkeeping index of a live plan: the (unpruned) overlay
    graph plus slot-pool state — NOT a table mirror (see module docstring)."""

    kinds: list[str]
    origin: list[int]
    in_edges: list[list[tuple[int, int]]]
    out: list[list[int]]          # src -> consumer nodes (multiset as list)
    decision: np.ndarray          # (>=n_real,) int64
    level: np.ndarray             # (>=n_real,) int64
    push: TableHost
    pull: TableHost
    demand: list[list[tuple[int, int]]]   # per padded level: (dst, src) pairs
    n_real: int
    dup_insensitive: bool = False
    retired_writer_bases: set[int] = dataclasses.field(default_factory=set)
    track_mirror: bool = False
    auto_verify: bool = False

    @staticmethod
    def from_plan(plan: ExecPlan, overlay: Overlay, *,
                  mirror: bool | None = None) -> "PlanHost":
        if overlay.n_nodes != len(plan.level):
            raise ValueError(
                f"overlay has {overlay.n_nodes} nodes but the plan was "
                f"compiled over {len(plan.level)} — pass the (unpruned) "
                f"overlay the plan was compiled from")
        parity_env = os.environ.get("EAGR_PATCH_PARITY", "") not in ("", "0")
        track = parity_env if mirror is None else mirror
        meta = plan.meta
        cap = meta.n_nodes
        in_edges = [list(e) for e in overlay.in_edges]
        out: list[list[int]] = [[] for _ in range(cap)]
        for dst, ins in enumerate(in_edges):
            for s, _ in ins:
                out[s].append(dst)
        level = np.zeros(cap, np.int64)
        level[: overlay.n_nodes] = plan.level
        dd = _host(plan.arrays.demand_dst)
        ds = _host(plan.arrays.demand_src)
        demand = [[(int(a), int(b)) for a, b in zip(dd[l], ds[l]) if a < cap]
                  for l in range(dd.shape[0])]
        kinds = list(overlay.kinds) + ["I"] * (cap - overlay.n_nodes)
        origin = list(overlay.origin) + [-1] * (cap - overlay.n_nodes)
        in_edges += [[] for _ in range(cap - overlay.n_nodes)]
        return PlanHost(
            kinds=kinds, origin=origin, in_edges=in_edges, out=out,
            decision=_host(plan.arrays.decision).astype(np.int64),
            level=level,
            push=TableHost.from_tables(plan.arrays.push, meta.n_row_tiles,
                                       track),
            pull=TableHost.from_tables(plan.arrays.pull, meta.n_row_tiles,
                                       track),
            demand=demand, n_real=overlay.n_nodes,
            dup_insensitive=overlay.dup_insensitive,
            track_mirror=track, auto_verify=parity_env if mirror is None
            else False,
        )

    def export_overlay(self) -> Overlay:
        return Overlay(kinds=list(self.kinds[: self.n_real]),
                       origin=list(self.origin[: self.n_real]),
                       in_edges=[list(e) for e in self.in_edges[: self.n_real]],
                       dup_insensitive=self.dup_insensitive)

    def verify_device(self, plan: ExecPlan) -> None:
        """Parity oracle: assert the device ``PlanArrays`` are bit-identical
        to the host-side expectation (mirrored tables + bookkeeping). Needs
        mirror tracking (``EAGR_PATCH_PARITY``)."""
        if self.push.mirror is None or self.pull.mirror is None:
            raise RuntimeError("parity check needs mirror tracking — set "
                               "EAGR_PATCH_PARITY=1 before the first patch")
        a = plan.arrays
        cap = plan.meta.n_nodes
        bad = []
        for name, th in (("push", self.push), ("pull", self.pull)):
            t = getattr(a, name)
            m = th.mirror
            for f, dev, want in (("seg", t.seg, m.seg), ("src", t.src, m.src),
                                 ("sign", t.sign, m.sign),
                                 ("touched", t.touched, m.touched),
                                 ("tile_of_block", t.tile_of_block, th.tob),
                                 ("first_of_tile", t.first_of_tile, th.fot)):
                if not np.array_equal(_host(dev), want):
                    bad.append(f"{name}.{f}")
        if not np.array_equal(_host(a.decision),
                              self.decision[:cap].astype(np.int32)):
            bad.append("decision")
        wn = np.full(plan.meta.n_writers, cap, np.int32)
        wn[: len(plan.writer_node)] = plan.writer_node
        if not np.array_equal(_host(a.writer_node), wn):
            bad.append("writer_node")
        L, d_pad = a.demand_dst.shape
        dd = np.full((L, d_pad), cap, np.int32)
        ds = np.full((L, d_pad), cap, np.int32)
        for l, pairs in enumerate(self.demand):
            if pairs:
                arr = np.asarray(pairs, np.int64)
                dd[l, : len(pairs)] = arr[:, 0]
                ds[l, : len(pairs)] = arr[:, 1]
        if not np.array_equal(_host(a.demand_dst), dd):
            bad.append("demand_dst")
        if not np.array_equal(_host(a.demand_src), ds):
            bad.append("demand_src")
        routes = plan.routes
        for name, m in (("writer", plan.writer_row_of_base),
                        ("reader", plan.reader_node_of_base)):
            table = getattr(routes, f"{name}_row" if name == "writer"
                            else "reader_node")
            if m and max(m) >= len(table):
                bad.append(f"routes.{name}")
                continue
            want = np.full(len(table), -1, np.int32)
            if m:
                want[np.fromiter(m.keys(), np.int64, len(m))] = \
                    np.fromiter(m.values(), np.int64, len(m))
            if not np.array_equal(table, want):
                bad.append(f"routes.{name}")
        if bad:
            raise AssertionError(
                f"device/host parity broken after patch: {bad}")


# ------------------------------------------------------------------- results
@dataclasses.dataclass
class PatchResult:
    plan: ExecPlan
    recompiled: bool
    reason: str | None
    overlay: Overlay | None                  # fresh export iff recompiled
    retired_writer_rows: list[int]
    stats: dict
    program: PatchProgram | None = None      # the lowered program (host
                                             # arrays) of an in-capacity patch
    retired_reader_bases: list[int] = dataclasses.field(default_factory=list)
                                             # reader bases this delta removed
                                             # (standing alerts on them drop)

    @property
    def kind(self) -> str:
        """How this delta landed: ``'recompiled'`` (capacity overflow fell
        back to compile_plan), ``'relayout'`` (in-capacity but at least one
        level was rebuilt wholesale), or ``'patched'`` (slot/point edits
        only) — the categories ``FlushReport`` counts per flush."""
        if self.recompiled:
            return "recompiled"
        if self.stats.get("levels_rebuilt"):
            return "relayout"
        return "patched"


# ------------------------------------------------------------ graph updating
def _relax_levels(host: PlanHost, seeds: set[int]) -> set[int]:
    """Longest-path level relaxation from the nodes whose in-edges changed.
    Returns every node whose level moved (their edges must re-home)."""
    changed: set[int] = set()
    q = deque(sorted(seeds))
    inq = set(q)
    while q:
        v = q.popleft()
        inq.discard(v)
        nl = max((int(host.level[s]) + 1 for s, _ in host.in_edges[v]),
                 default=0)
        if nl != int(host.level[v]):
            host.level[v] = nl
            changed.add(v)
            for c in host.out[v]:
                if c not in inq:
                    q.append(c)
                    inq.add(c)
    return changed


def _update_decisions(host: PlanHost, delta: OverlayDelta, *,
                      pin_push: bool = False) -> set[int]:
    """Default decisions for new nodes (writers PUSH; interiors PUSH iff all
    inputs are PUSH; readers PULL), then enforce the dataflow invariant —
    no PULL upstream of a PUSH — by flipping violators PULL and cascading
    downstream. ``pin_push`` pins every new node PUSH — the continuous-query
    class (always-fresh readers; what standing alerts predicate on), where
    churn-added readers must stay push-maintained like their compile-time
    peers. Returns every node whose decision changed."""
    changed: set[int] = set()
    for nid in range(delta.n_nodes_before, delta.n_nodes_after):
        k = host.kinds[nid]
        if pin_push or k == "W":
            d = PUSH
        elif k == "R":
            d = PULL
        else:
            ins = host.in_edges[nid]
            d = PUSH if ins and all(host.decision[s] == PUSH for s, _ in ins) \
                else PULL
        if int(host.decision[nid]) != d:
            host.decision[nid] = d
            changed.add(nid)
    q = deque(sorted(set(delta.nodes) | changed,
                     key=lambda v: int(host.level[v])))
    while q:
        v = q.popleft()
        if host.decision[v] == PUSH and any(
                host.decision[s] == PULL for s, _ in host.in_edges[v]):
            host.decision[v] = PULL
            changed.add(v)
            q.extend(host.out[v])
    return changed


# ------------------------------------------------------------- table patching
def _table_of(host: PlanHost, d: int) -> str | None:
    if not host.in_edges[d]:
        return None
    return "push" if host.decision[d] == PUSH else "pull"


def _slot_tile(th: TableHost, l: int, slot: int) -> int:
    return int(th.tob[l, slot // E_BLK])


def _free_slots(th: TableHost, d: int, stats: dict) -> None:
    entries = th.slots_of.pop(d, None)
    if entries is None:
        return
    l = th.level_of.pop(d)
    for slot, _, _ in entries:
        t = _slot_tile(th, l, slot)
        th.free[(l, t)].append(slot)
        th.occ[l, t] -= 1
        th.record(l, slot, -1, 0, 0.0)
    th.touched_edits[(l, d)] = False  # d left the level entirely
    stats["edges_removed"] += len(entries)


def _claim_slots(th: TableHost, d: int, edges, l: int, rebuild: set,
                 stats: dict) -> None:
    """Place ``edges`` (src, sign) of destination ``d`` into free slots of its
    owning tile at level ``l``; escalate the level to a relayout when the
    tile's occupancy counter overflows its slot range."""
    if l in rebuild:
        return  # the level row is being rebuilt from the graph mirror anyway
    t = d // R_BLK
    a, b = int(th.tile_slots[l, t, 0]), int(th.tile_slots[l, t, 1])
    if int(th.occ[l, t]) + len(edges) > b - a:
        rebuild.add(l)
        return
    pool = th.free[(l, t)]
    for s_, sg in edges:
        slot = pool.pop()
        th.occ[l, t] += 1
        th.record(l, slot, d, int(s_), float(sg))
        th.slots_of.setdefault(d, []).append((slot, int(s_), float(sg)))
        th.level_of[d] = l
    if edges:
        th.touched_edits[(l, d)] = True
    stats["edges_added"] += len(edges)


def _diff_in_place(th: TableHost, d: int, new_edges, l: int,
                   rebuild: set, stats: dict) -> None:
    """Destination stays in the same table and level: free only the removed
    edges' slots and claim slots only for the added ones."""
    entries = th.slots_of.get(d, [])
    need = Counter((int(s), float(g)) for s, g in new_edges)
    keep, freed = [], []
    for slot, s, g in entries:
        if need[(s, g)] > 0:
            need[(s, g)] -= 1
            keep.append((slot, s, g))
        else:
            freed.append(slot)
    for slot in freed:
        t = _slot_tile(th, l, slot)
        th.free[(l, t)].append(slot)
        th.occ[l, t] -= 1
        th.record(l, slot, -1, 0, 0.0)
    stats["edges_removed"] += len(freed)
    th.slots_of[d] = keep
    if not keep:
        th.slots_of.pop(d, None)
        th.level_of.pop(d, None)
        th.touched_edits[(l, d)] = False
    missing = [e for e, c in need.items() for _ in range(c)]
    if missing:
        _claim_slots(th, d, missing, l, rebuild, stats)


def _rebuild_level(host: PlanHost, th: TableHost, table: str, l: int,
                   cap: int, n_row_tiles: int) -> None:
    at = np.flatnonzero(host.level[: host.n_real] == l + 1)
    push = host.decision[at] == PUSH
    at = at[push if table == "push" else ~push].tolist()
    edges = [(d, s, sg) for d in at for s, sg in host.in_edges[d]]
    dst_l, src_l, sign_l = zip(*edges) if edges else ((), (), ())
    rl = relayout_level(np.asarray(dst_l, np.int64),
                        np.asarray(src_l, np.int64),
                        np.asarray(sign_l, np.float64), cap,
                        th.tob.shape[1], th.e_pad)
    if rl is None:
        raise CapacityExceeded(f"{table} level {l} exceeds the block budget")
    seg_row, src_row, sign_row, tob_row, fot_row = rl
    th.tob[l] = tob_row
    th.fot[l] = fot_row
    th.tile_slots[l] = tile_slot_ranges(tob_row, n_row_tiles)
    for key in [k for k in th.edits if k[0] == l]:
        del th.edits[key]  # superseded by the whole-row rewrite
    for key in [k for k in th.touched_edits if k[0] == l]:
        del th.touched_edits[key]
    trow = np.zeros(cap, bool)
    trow[seg_row[seg_row >= 0]] = True
    th.row_edits[l] = (seg_row, src_row, sign_row, tob_row, fot_row, trow)
    th.index_level(l, seg_row, src_row, sign_row)
    if th.mirror is not None:
        th.mirror.seg[l] = seg_row
        th.mirror.src[l] = src_row
        th.mirror.sign[l] = sign_row


# --------------------------------------------------------------------- patch
def patch_plan(plan: ExecPlan, delta: OverlayDelta, *,
               overlay: Overlay | None = None,
               growth: float = 2.0,
               pin_push: bool = False) -> PatchResult:
    """Apply one ``OverlayDelta`` to a live plan.

    In-capacity updates lower the delta to a ``PatchProgram`` and write it
    into the live ``PlanArrays`` tensors in place (``apply_patch_step``: same
    shapes, same storage, zero table uploads); overflows recompile with
    ``growth`` headroom.
    ``overlay`` is only needed on the first patch of a plan, to seed the host
    bookkeeping; it must be the (unpruned) overlay the plan was compiled
    from. ``pin_push`` keeps churn-added nodes PUSH-decided (continuous
    groups)."""
    if delta.empty:
        return PatchResult(plan, False, "empty delta", None, [], {})
    host: PlanHost = plan.host  # type: ignore[assignment]
    if host is None:
        if overlay is None:
            raise ValueError("first patch_plan call needs overlay= to seed "
                             "the host mirror")
        host = PlanHost.from_plan(plan, overlay)
        plan.host = host
    meta = plan.meta
    cap = meta.n_nodes
    stats = {"edges_added": 0, "edges_removed": 0, "levels_rebuilt": 0,
             "demand_levels": 0, "slot_levels": 0}

    # ---------------------------------------------- phase A: graph mirror
    for _ in range(delta.n_nodes_after - len(host.kinds)):
        host.kinds.append("I")
        host.origin.append(-1)
        host.in_edges.append([])
        host.out.append([])
    if delta.n_nodes_after > len(host.decision):
        extra = delta.n_nodes_after - len(host.decision)
        host.decision = np.concatenate(
            [host.decision, np.full(extra, PULL, np.int64)])
        host.level = np.concatenate([host.level, np.zeros(extra, np.int64)])
    # pre-patch in-edges of the re-homed nodes: frontier maintenance walks
    # *up* through both the old and new parents so writers that lost a path
    # to a destination are re-indexed too
    old_in = {nid: list(host.in_edges[nid]) for nid in delta.nodes}
    for nid, patch in delta.nodes.items():
        for s, _ in host.in_edges[nid]:
            host.out[s].remove(nid)
        host.in_edges[nid] = list(patch.edges)
        for s, _ in patch.edges:
            host.out[s].append(nid)
        host.kinds[nid] = patch.kind
        host.origin[nid] = patch.origin
    host.n_real = max(host.n_real, delta.n_nodes_after)
    host.retired_writer_bases |= delta.retired_writers
    host.retired_writer_bases -= set(delta.new_writers)

    changed_level = _relax_levels(host, set(delta.nodes))
    changed_dec = _update_decisions(host, delta, pin_push=pin_push)
    depth = int(host.level[: host.n_real].max()) if host.n_real else 0

    retired_rows = [plan.writer_row_of_base[b] for b in delta.retired_writers
                    if b in plan.writer_row_of_base]
    retired_bases = sorted(
        set(delta.retired_readers) - set(delta.new_readers))

    # ---------------------------------------------- phase B: capacity gates
    def fallback(reason: str) -> PatchResult:
        new_plan, new_overlay = _recompile(plan, host, growth)
        _apply_base_maps(new_plan, host, delta)
        stats["reason"] = reason
        return PatchResult(new_plan, True, reason, new_overlay,
                           retired_rows, stats,
                           retired_reader_bases=retired_bases)

    if host.n_real > cap:
        return fallback("node capacity")
    if len(plan.writer_node) + len(delta.new_writer_nodes) > meta.n_writers:
        return fallback("writer capacity")
    if depth > meta.n_levels:
        return fallback("level capacity")

    # ---------------------------------------------- phase C: table patching
    rehome = set(delta.nodes) | changed_level | changed_dec
    rebuild = {"push": set(), "pull": set()}
    demand_levels: set[int] = set()
    try:
        for d in sorted(rehome):
            new_table = _table_of(host, d)
            new_l = int(host.level[d]) - 1 if new_table else -1
            old = None
            for name in ("push", "pull"):
                th = getattr(host, name)
                if d in th.level_of:
                    old = (name, th.level_of[d])
                    break
            if old and old[0] == "pull":
                demand_levels.add(old[1])
            if new_table == "pull":
                demand_levels.add(new_l)
            if old == (new_table, new_l):
                _diff_in_place(getattr(host, new_table), d,
                               host.in_edges[d], new_l,
                               rebuild[new_table], stats)
            else:
                if old:
                    _free_slots(getattr(host, old[0]), d, stats)
                if new_table:
                    _claim_slots(getattr(host, new_table), d,
                                 host.in_edges[d], new_l,
                                 rebuild[new_table], stats)
        for v in changed_dec:
            for c in host.out[v]:
                if host.level[c] >= 1 and host.decision[c] == PULL:
                    demand_levels.add(int(host.level[c]) - 1)
        for name in ("push", "pull"):
            th = getattr(host, name)
            for l in sorted(rebuild[name]):
                _rebuild_level(host, th, name, l, cap, meta.n_row_tiles)
                stats["levels_rebuilt"] += 1
        # demand rows
        d_pad = plan.arrays.demand_dst.shape[1]
        new_demand_rows = {}
        for l in sorted(demand_levels):
            pairs = []
            for d in np.flatnonzero(host.level[: host.n_real] == l + 1):
                if host.decision[d] != PULL:
                    continue
                for s, _ in host.in_edges[int(d)]:
                    if host.decision[s] == PULL:
                        pairs.append((int(d), int(s)))
            if len(pairs) > d_pad:
                raise CapacityExceeded(f"demand level {l} needs {len(pairs)} "
                                       f"> {d_pad} slots")
            new_demand_rows[l] = pairs
    except CapacityExceeded as e:
        return fallback(str(e))

    # -------------------------------- phase D: lower + run the patch program
    stats["slot_levels"] = len({l for l, _ in host.push.edits}
                               | {l for l, _ in host.pull.edits})
    stats["demand_levels"] = len(new_demand_rows)
    # every new W-kind node claims a row (id order), even if it was deleted
    # within this epoch — keeps row positions identical to what a recompile
    # over the unpruned overlay would assign, so window state migrates by
    # position safely
    first_new_row = len(plan.writer_node)
    for nid in sorted(delta.new_writer_nodes):
        plan.writer_node = np.append(plan.writer_node, nid)
    n_new = len(plan.writer_node) - first_new_row
    decs = sorted(int(v) for v in changed_dec)
    # ONE shared class for every edit field, as the JAX package lowers it
    cls = _bucket_class([
        (len(host.push.edits), _SLOT_BUCKET),
        (len(host.pull.edits), _SLOT_BUCKET),
        (len(host.push.touched_edits), _SLOT_BUCKET),
        (len(host.pull.touched_edits), _SLOT_BUCKET),
        (len(decs), 32), (n_new, 8),
        (len(host.push.row_edits), 1), (len(host.pull.row_edits), 1),
        (len(new_demand_rows), 4)])
    cls_idx = cls_row = cls
    # like the relayout group, demand rows never pad past the level count
    dk = min(4 * 4 ** cls_row, int(plan.arrays.demand_dst.shape[0]))
    d_lvl = _OOB + np.arange(dk, dtype=np.int32)  # distinct OOB padding
    d_dst = np.zeros((dk, d_pad), np.int32)
    d_src = np.zeros((dk, d_pad), np.int32)
    for i, (l, pairs) in enumerate(sorted(new_demand_rows.items())):
        host.demand[l] = pairs
        d_lvl[i] = l
        d_dst[i] = cap
        d_src[i] = cap
        if pairs:
            arr = np.asarray(pairs, np.int64)
            d_dst[i, : len(pairs)] = arr[:, 0]
            d_src[i, : len(pairs)] = arr[:, 1]
    ck = 32 * 4 ** cls_idx
    dec_idx = _OOB + np.arange(ck, dtype=np.int32)
    dec_val = np.zeros(ck, np.int32)
    dec_idx[: len(decs)] = decs
    if decs:
        dec_val[: len(decs)] = host.decision[decs].astype(np.int32)
    wk = 8 * 4 ** cls_idx
    w_row = _OOB + np.arange(wk, dtype=np.int32)
    w_node = np.zeros(wk, np.int32)
    w_row[:n_new] = np.arange(first_new_row, len(plan.writer_node))
    w_node[:n_new] = plan.writer_node[first_new_row:]
    prog = PatchProgram(
        push=host.push.drain_patch(cap, cls_idx, cls_row),
        pull=host.pull.drain_patch(cap, cls_idx, cls_row),
        dec_idx=dec_idx, dec_val=dec_val, w_row=w_row, w_node=w_node,
        d_lvl=d_lvl, d_dst=d_dst, d_src=d_src)
    apply_patch_step(meta, plan.arrays, prog)

    # ---------------------------------------------- phase E: plan metadata
    plan.meta = dataclasses.replace(meta, depth=depth)
    plan.level = host.level[: host.n_real].copy()
    plan.decision = host.decision[: host.n_real].copy()
    plan.n_push_edges = host.push.n_edges()
    plan.n_pull_edges = host.pull.n_edges()
    plan.patches_applied += 1
    _apply_base_maps(plan, host, delta)
    # frontier bookkeeping: the reader index is cheap to rebuild and hard to
    # maintain (demand chunk positions move) — drop it on any patch. The
    # write index survives slot-level patches via exact per-writer overrides;
    # a level relayout moves every slot of that level wholesale, so it
    # invalidates the whole index (rebuilt lazily on the next sparse write).
    plan.reader_frontier = None
    if plan.frontier is not None:
        if rebuild["push"]:
            plan.frontier = None
        else:
            from repro_torch.core.frontier import maintain_frontier
            maintain_frontier(plan.frontier, plan, host, rehome, old_in)
            if host.auto_verify:
                plan.frontier.verify(plan, host)
    if host.auto_verify:
        host.verify_device(plan)
    return PatchResult(plan, False, None, None, retired_rows, stats,
                       program=prog, retired_reader_bases=retired_bases)


def _apply_base_maps(plan: ExecPlan, host: PlanHost,
                     delta: OverlayDelta) -> None:
    """Reconcile base-id -> row/node maps with the delta (both patch and
    recompile paths). The dense ``plan.routes`` tables — the vectorized
    hot-path router — mirror every dict edit, so steady-state writes/reads
    never consult the dicts."""
    routes = plan.routes
    for b in delta.retired_writers:
        if b not in delta.new_writers:
            plan.writer_row_of_base.pop(b, None)
            routes.clear_writer(b)
    for b, nid in delta.new_writers.items():
        row = int(np.flatnonzero(plan.writer_node == nid)[0]) \
            if (plan.writer_node == nid).any() else None
        if row is not None:
            plan.writer_row_of_base[b] = row
            routes.set_writer(b, row)
    for b in delta.retired_readers:
        if b not in delta.new_readers:
            plan.reader_node_of_base.pop(b, None)
            routes.clear_reader(b)
    for nid, patch in delta.nodes.items():
        o = patch.origin
        if patch.kind == "R":
            plan.reader_node_of_base[o] = nid
            routes.set_reader(o, nid)
        elif o >= 0 and plan.reader_node_of_base.get(o) == nid:
            plan.reader_node_of_base.pop(o, None)
            routes.clear_reader(o)
    for b in host.retired_writer_bases:
        plan.writer_row_of_base.pop(b, None)
        routes.clear_writer(b)


def carry_plan_bookkeeping(new: ExecPlan, old: ExecPlan,
                           overlay: Overlay) -> ExecPlan:
    """Carry patch bookkeeping across a recompile of the same live plan (the
    growth fallback, a shard realign, or a decision re-adoption): the patch
    counter survives, retired writer rows stay retired (the unpruned overlay
    keeps their lingering W nodes, so ``compile_plan`` re-registers them),
    and — when the old plan had host state — the new plan gets a fresh
    ``PlanHost`` with the parity mirror/verify flags preserved."""
    new.patches_applied = old.patches_applied
    host: PlanHost | None = old.host  # type: ignore[assignment]
    if host is not None:
        for b in host.retired_writer_bases:
            new.writer_row_of_base.pop(b, None)
            new.routes.clear_writer(b)
        new.host = PlanHost.from_plan(new, overlay, mirror=host.track_mirror)
        new.host.auto_verify = host.auto_verify
        new.host.retired_writer_bases = set(host.retired_writer_bases)
    return new


def _recompile(plan: ExecPlan, host: PlanHost,
               growth: float) -> tuple[ExecPlan, Overlay]:
    """Capacity-overflow fallback: a fresh ``compile_plan`` over the host
    mirror's (unpruned) overlay with ``growth`` headroom on every padded
    dimension, so the following churn burst patches in place again."""
    ov = host.export_overlay()
    dec = host.decision[: host.n_real].copy()
    pad = grow_pad(measure_plan(ov, dec), growth)
    new = compile_plan(ov, dec, pad=pad, device=plan.arrays.decision.device)
    carry_plan_bookkeeping(new, plan, ov)
    return new, ov
