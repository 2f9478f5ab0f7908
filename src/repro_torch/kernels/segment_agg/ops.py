"""Plan builders and the checked wrapper for the segment_agg CUDA kernel.

The kernel requires edges sorted by destination and padded so no E_BLK edge
block straddles an R_BLK row tile. For static graph structure (EAGr overlay
levels) that plan is built once on the host (``make_plan``) and reused every
step; only the edge *values* are runtime data. The builders are numpy and
produce tables bit-equal to the JAX package's (same E_BLK / R_BLK).

``segment_agg_level`` is the entry point the single engine calls per dense
level on gathered edge values, and ``segment_agg_active`` computes a whole
frontier-sparse level (gather, sign, reduce and row mask over the level's
active blocks) in one launch; ``segment_agg_level_stacked`` (a dense
level: gather, sign and reduce) and ``segment_agg_active_stacked`` run one
level of S aligned shards in one launch (the stacked shard engine,
``distributed/stacked.py``). Each picks
the implementation by the tensors' device: CUDA tensors launch the
hand-written kernel in ``csrc/segment_agg.cu`` (or raise), CPU tensors run
the plain PyTorch version in ``ref.py``. The three fused entries take
``bf16``: each slot's edge value is rounded to bfloat16 (to nearest even)
before it is reduced in fp32, the JAX package's ``EAGR_SEGAGG_BF16`` mode;
on the card that is the kernel's own ``BF16`` instance. ``LAUNCHES`` counts
kernel launches per entry (the bf16 instances under their own ``*_bf16``
keys), so a run can show that its path went through the kernel; ``WORK``
counts each call's operations and bytes (``level_cost``, ``active_cost``,
``stacked_cost``, ``graph_cost``) on either path while
``cost.counting()`` is on, under the same keys.

The graph entry (``segment_agg_graph``) is the GNN path's reduce: edge
values (E, F), fp32 or bf16, by an edge index array, through a kernel of
its own (``csrc/segment_graph.cu``) over an ``EdgePlan`` built once per
index array on the host (``edge_plan``), bit-equal to the stacked dense
entry at S = 1 over the same layout. ``graph_sum``, ``graph_gather`` and
``graph_max`` wrap it for autograd: the sum's backward is the gather and
the gather's backward is the sum, so every derivative of every order on
the GNN path reduces on the kernel, without float atomics.

``patch_level``, ``scatter_slots``, ``scatter_rows`` and ``tile_occupancy``
edit and measure the stacked level tables in place, for the plan patch path
(``core/plan_patch.py``): churn inside the plan's capacity never reallocates
a table.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import weakref

import numpy as np
import torch

from repro_torch.kernels.cost import Work, WorkCounter, counted
from repro_torch.kernels.segment_agg.ref import (
    segment_agg_active_ref,
    segment_agg_active_stacked_ref,
    segment_agg_graph_ref,
    segment_agg_level_ref,
    segment_agg_level_stacked_ref,
)

E_BLK = 256     # edges per block
R_BLK = 128     # output rows per tile
# blocks per window of the CUDA kernel, which runs one CTA per window of
# blocks aligned to the absolute block index, so a tile's long run of blocks
# spreads over one CTA per window (see csrc/segment_agg.cu). Each block of a
# window takes a copy of its tile's rows in shared memory: FC x 128 floats
# (FC <= 4) for F <= 4, where a window holds 4 to 16 blocks, at least 256
# windows a level; 128 x 32 for F > 4, where it holds 4
RUN_CHUNK_MIN, RUN_CHUNK_MAX, RUN_WINDOWS = 4, 16, 256

# kernel launches per op since the last reset (plain Python ints; the CPU
# path never counts)
LAUNCHES = {"sum": 0, "max": 0, "sum_active": 0, "max_active": 0,
            "sum_stacked": 0, "max_stacked": 0, "sum_active_stacked": 0,
            "max_active_stacked": 0, "sum_active_bf16": 0,
            "max_active_bf16": 0, "sum_stacked_bf16": 0,
            "max_stacked_bf16": 0, "sum_active_stacked_bf16": 0,
            "max_active_stacked_bf16": 0, "sum_gnn": 0, "max_gnn": 0}


# each call's work, on either path (cost.py)
WORK = WorkCounter(LAUNCHES)


def reset_launches() -> None:
    """Zero ``LAUNCHES`` and ``WORK``."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    WORK.reset()


# -------------------------------------------------------------- each call's work
def level_cost(n_slots: int, n_live: int, n_blocks: int, rows_out: int,
               F: int) -> Work:
    """One dense level (``segment_agg_level``): seg (4 B a slot) and the
    block tables (8 B a block) read once, x read for each live slot, the
    output written for each row of a visited tile (``rows_out``); one add
    or max per live slot and feature."""
    nbytes = n_slots * 4 + n_blocks * 8 + n_live * 4 * F + rows_out * 4 * F
    return Work(n_live * F, nbytes)


def _slot_ops(op: str, bf16: bool) -> int:
    """Operations per live slot and feature: an add or a max, for sum a
    multiply by the sign, with ``bf16`` a rounding to bfloat16."""
    return (2 if op == "sum" else 1) + bool(bf16)


def active_cost(n_active: int, n_live: int, n_src: int, tiles: int, F: int,
                n_rows: int, op: str, bf16: bool = False) -> Work:
    """One call of the fused active entry on one shard: each of the
    ``n_active`` active blocks' seg and src rows (8 B a slot; sum also its
    sign row, 4 B more), its active entry and tob/fot (12 B) read once, the
    ``val`` row of each of ``n_src`` distinct sources among the active live
    slots read once, the output written for each row of the ``tiles`` row
    tiles an active block routes to, and the row mask (``n_rows`` bytes)
    written once."""
    slot_b = 12 if op == "sum" else 8
    nbytes = n_active * (E_BLK * slot_b + 12) + n_src * 4 * F \
        + tiles * R_BLK * 4 * F + n_rows
    return Work(n_live * F * _slot_ops(op, bf16), nbytes)


def stacked_cost(n_slots: int, live_blocks: int, n_src: int, n_blocks: int,
                 rows_out: int, n_live: int, F: int, op: str,
                 bf16: bool = False) -> Work:
    """One shard of a call of the fused stacked dense entry (the graph
    entry's kernel too): every slot's seg (4 B), the src rows (and for sum
    the sign rows) of the ``live_blocks`` blocks holding a live slot (1 or
    2 KB a block), the ``val`` row of each of ``n_src`` distinct sources
    once, tob and fot (8 B a block) and the output of each row of a visited
    tile (``rows_out``); the bytes are fp32's with ``bf16`` (``val`` is
    fp32 state)."""
    row_b = 2 * E_BLK * 4 if op == "sum" else E_BLK * 4
    nbytes = n_slots * 4 + live_blocks * row_b + n_src * 4 * F \
        + n_blocks * 8 + rows_out * 4 * F
    return Work(n_live * F * _slot_ops(op, bf16), nbytes)


def graph_cost(n_live: int, n_rows: int, F: int, itemsize: int = 4) -> Work:
    """One graph-entry call (``segment_agg_graph``): 8 B of slot table a
    live edge (its edge and destination), ``itemsize`` F B of each live
    edge's values read and of each output row written (4 for fp32, 2 for
    bf16); one add or max a live value and feature."""
    return Work(n_live * F, 8 * n_live + itemsize * F * (n_live + n_rows))


@dataclasses.dataclass(frozen=True, eq=False)
class SegmentPlan:
    """Host-compiled routing plan for one static (seg, n_rows) structure."""

    perm: np.ndarray            # (E,) original edge -> slot in padded layout
    seg_padded: np.ndarray      # (E_pad,) int32, -1 padding
    tile_of_block: np.ndarray   # (n_edge_blocks,) int32
    first_of_tile: np.ndarray   # (n_edge_blocks,) int32
    n_rows: int
    n_row_tiles: int
    e_pad: int

    @property
    def pad_overhead(self) -> float:
        return self.e_pad / max(1, len(self.perm)) - 1.0


def make_plan(seg: np.ndarray, n_rows: int) -> SegmentPlan:
    """Group edges by row tile, pad each tile's edge count to a multiple of
    E_BLK, and record block->tile routing."""
    seg = np.asarray(seg, dtype=np.int64)
    order = np.argsort(seg, kind="stable")
    n_row_tiles = max(1, -(-n_rows // R_BLK))

    tile = seg[order] // R_BLK   # ascending: each tile's edges are a run
    bounds = np.searchsorted(tile, np.arange(n_row_tiles + 1))
    slots = []
    seg_chunks = []
    tob, fot = [], []
    e_cursor = 0
    for t in np.flatnonzero(np.diff(bounds)).tolist():
        idx = order[bounds[t]: bounds[t + 1]]
        n_blocks = -(-idx.size // E_BLK)
        padded = n_blocks * E_BLK
        slots.append((idx, e_cursor))
        chunk = np.full(padded, -1, dtype=np.int32)
        chunk[: idx.size] = seg[idx]
        seg_chunks.append(chunk)
        tob.extend([t] * n_blocks)
        fot.extend([1] + [0] * (n_blocks - 1))
        e_cursor += padded
    if e_cursor == 0:  # no edges at all: one dummy block routed to tile 0
        seg_chunks.append(np.full(E_BLK, -1, dtype=np.int32))
        tob, fot = [0], [1]
        e_cursor = E_BLK

    perm = np.zeros(len(seg), dtype=np.int64)
    for idx, base in slots:
        perm[idx] = base + np.arange(idx.size)
    return SegmentPlan(
        perm=perm,
        seg_padded=np.concatenate(seg_chunks),
        tile_of_block=np.asarray(tob, dtype=np.int32),
        first_of_tile=np.asarray(fot, dtype=np.int32),
        n_rows=n_rows,
        n_row_tiles=n_row_tiles,
        e_pad=e_cursor,
    )


def segment_agg(x: torch.Tensor, plan: SegmentPlan, *,
                op: str = "sum") -> torch.Tensor:
    """Aggregate edge values x (E, F) by the plan's destination rows.
    Returns (n_rows, F) fp32. Rows with no edges are 0 (both ops)."""
    if x.ndim == 1:
        x = x[:, None]
    dev = x.device
    F = x.shape[1]
    xp = torch.zeros((plan.e_pad, F), dtype=torch.float32, device=dev)
    xp[torch.as_tensor(plan.perm, device=dev)] = x.to(torch.float32)
    seg = torch.as_tensor(plan.seg_padded, device=dev)
    out = segment_agg_level(
        xp, seg, torch.as_tensor(plan.tile_of_block, device=dev),
        torch.as_tensor(plan.first_of_tile, device=dev),
        n_rows=plan.n_rows, n_row_tiles=plan.n_row_tiles, op=op)
    # rows of tiles no block visits are unwritten; rows without an edge in a
    # visited tile hold the op's identity — both read as 0 here
    hit = torch.zeros(plan.n_rows + 1, dtype=torch.bool, device=dev)
    hit[torch.where(seg >= 0, seg.long(), plan.n_rows)] = True
    return torch.where(hit[: plan.n_rows, None], out, 0.0)


# --------------------------------------------------------------- leveled plans
@dataclasses.dataclass(frozen=True, eq=False)
class LeveledPlan:
    """A stack of per-level ``SegmentPlan`` routings padded to one shape.

    All levels share the same edge-slot capacity (``e_pad``) and block count.
    Padding slots carry ``seg == -1`` (dropped by the kernel); padding
    *blocks* are routed to the last real block's output tile so a tile's
    blocks stay consecutive.
    """

    seg: np.ndarray             # (L, e_pad) int32, -1 padding
    tile_of_block: np.ndarray   # (L, n_blocks) int32
    first_of_tile: np.ndarray   # (L, n_blocks) int32
    perms: tuple                # per level: original edge index -> padded slot
    tile_slots: np.ndarray      # (L, n_row_tiles, 2) int32 [start, stop) slot
                                # range routed to each row tile (free-slot pool)
    n_rows: int
    n_row_tiles: int
    n_levels: int
    e_pad: int

    def layout(self, level: int, values: np.ndarray, fill=0,
               dtype=None) -> np.ndarray:
        """Place a per-edge companion array (e.g. sources, signs) of one level
        into that level's padded kernel slot order."""
        values = np.asarray(values)
        out = np.full((self.e_pad,) + values.shape[1:], fill,
                      dtype=dtype or values.dtype)
        out[self.perms[level]] = values
        return out


def tile_slot_ranges(tob_row: np.ndarray, n_row_tiles: int) -> np.ndarray:
    """Per-tile claimable slot ranges of one level's block routing.

    Blocks routed to the same tile are consecutive, so each tile owns at most
    one run of blocks; padding blocks are routed to the last real tile and
    therefore extend its run. Returns (n_row_tiles, 2) int32 [start, stop)
    slot ranges; tiles with no blocks get an empty range. A slot is *free*
    iff it lies in its tile's range and currently holds ``seg == -1``.
    """
    tob_row = np.asarray(tob_row, dtype=np.int64)
    out = np.zeros((n_row_tiles, 2), dtype=np.int32)
    tiles, first = np.unique(tob_row, return_index=True)
    _, back = np.unique(tob_row[::-1], return_index=True)
    keep = (tiles >= 0) & (tiles < n_row_tiles)
    out[tiles[keep], 0] = first[keep] * E_BLK
    out[tiles[keep], 1] = (len(tob_row) - back[keep]) * E_BLK
    return out


def relayout_level(dst: np.ndarray, src: np.ndarray, sign: np.ndarray,
                   n_rows: int, n_blocks: int, e_pad: int):
    """Rebuild one level's full kernel-layout rows from its current edge set.

    Returns ``(seg_row, src_row, sign_row, tob_row, fot_row)`` padded to
    ``(e_pad,)`` / ``(n_blocks,)``, or ``None`` if the level needs more than
    ``n_blocks`` blocks (caller falls back to a full recompile).
    """
    p = make_plan(np.asarray(dst, dtype=np.int64), n_rows)
    k = p.tile_of_block.size
    if k > n_blocks:
        return None
    seg_row = np.full(e_pad, -1, dtype=np.int32)
    src_row = np.zeros(e_pad, dtype=np.int32)
    sign_row = np.zeros(e_pad, dtype=np.float32)
    seg_row[: p.e_pad] = p.seg_padded
    src_row[p.perm] = np.asarray(src, dtype=np.int32)
    sign_row[p.perm] = np.asarray(sign, dtype=np.float32)
    tob_row = np.zeros(n_blocks, dtype=np.int32)
    fot_row = np.zeros(n_blocks, dtype=np.int32)
    tob_row[:k] = p.tile_of_block
    tob_row[k:] = p.tile_of_block[-1] if k else 0  # keep revisits consecutive
    fot_row[:k] = p.first_of_tile
    if k == 0:
        fot_row[0] = 1  # empty level: init tile 0, aggregate nothing
    return seg_row, src_row, sign_row, tob_row, fot_row


def patch_level(seg: torch.Tensor, src: torch.Tensor, sign: torch.Tensor,
                level: int, slots, seg_vals, src_vals, sign_vals):
    """Rewrite individual edge slots of one level of the stacked tables, in
    place. Retiring an edge writes ``seg=-1, src=0, sign=0`` (the padding
    pattern the kernel drops); a new edge claims a free slot inside the
    owning tile's block range. ``slots`` must be unique. Returns the three
    (same) tables."""
    dev = seg.device
    sl = torch.as_tensor(np.asarray(slots, np.int64), device=dev)
    lv = torch.full_like(sl, int(level))
    seg.index_put_((lv, sl), torch.as_tensor(
        np.asarray(seg_vals, np.int32), device=dev))
    src.index_put_((lv, sl), torch.as_tensor(
        np.asarray(src_vals, np.int32), device=dev))
    sign.index_put_((lv, sl), torch.as_tensor(
        np.asarray(sign_vals, np.float32), device=dev))
    return seg, src, sign


def _anchor_pads(table: torch.Tensor, lvl: torch.Tensor, *idx):
    """Shape-bucket padding of an edit list carries a level past the table
    (``lvl >= L``). CUDA's ``index_put_`` writes duplicates in no fixed
    order, so each pad is pointed at the list's first entry, writing its
    value again — or, when the list holds no real edit, at the table's
    first element, writing the value it already holds. Every duplicate then
    writes one value. Real edits come first and are unique. Returns the pad
    mask, whether the first entry is a real edit, and the [level, column
    indices...] to write; no host sync."""
    L = table.shape[0]
    lvl = lvl.to(torch.int64)
    pad = lvl >= L
    real0 = lvl[:1] < L
    a_lvl = torch.where(real0, lvl[:1], 0)
    out = [torch.where(pad, a_lvl, lvl)]
    for ix in idx:
        ix = ix.to(torch.int64)
        out.append(torch.where(pad, torch.where(real0, ix[:1], 0), ix))
    return pad, real0, out


def scatter_slots(table: torch.Tensor, lvl: torch.Tensor, slot: torch.Tensor,
                  vals: torch.Tensor) -> torch.Tensor:
    """Scatter individual (level, column) edits into one stacked (L, X)
    table, in place. Padding entries carry an out-of-bounds level and write
    nothing new (``_anchor_pads``). Returns ``table``."""
    if lvl.numel() == 0:
        return table
    pad, real0, (lv, sl) = _anchor_pads(table, lvl, slot)
    first = torch.where(real0, vals[:1].to(table.dtype), table[0, :1])
    table.index_put_((lv, sl), torch.where(pad, first, vals.to(table.dtype)))
    return table


def scatter_rows(table: torch.Tensor, lvl: torch.Tensor,
                 rows: torch.Tensor) -> torch.Tensor:
    """Replace whole level rows of a stacked table (the relayout tier), or
    single entries of a 1-D table, in place. Out-of-bounds ``lvl`` entries (shape-bucket padding) write
    nothing new (``_anchor_pads``). Returns ``table``."""
    if lvl.numel() == 0:
        return table
    pad, real0, (lv,) = _anchor_pads(table, lvl)
    first = torch.where(real0, rows[:1].to(table.dtype), table[:1])
    pad = pad.view((-1,) + (1,) * (rows.ndim - 1))
    table.index_put_((lv,), torch.where(pad, first, rows.to(table.dtype)))
    return table


def tile_occupancy(seg: torch.Tensor, tile_of_block: torch.Tensor,
                   n_row_tiles: int) -> torch.Tensor:
    """Per-(level, row-tile) count of live edge slots, computed on the
    tables' device: the occupancy counters the patch path keeps on the host
    (a tile whose occupancy plus an incoming claim exceeds its slot range
    forces a level relayout). Integer scatter-adds: exact in any order."""
    L = seg.shape[0]
    tob = tile_of_block.to(torch.int64).repeat_interleave(E_BLK, dim=1)
    t = torch.where(seg >= 0, tob, n_row_tiles)
    out = torch.zeros((L, n_row_tiles + 1), dtype=torch.int32,
                      device=seg.device)
    out.scatter_add_(1, t, torch.ones_like(t, dtype=torch.int32))
    return out[:, :n_row_tiles]


def count_blocks(seg: np.ndarray) -> int:
    """Edge blocks ``make_plan`` would emit for one segment list: per-tile
    edge counts rounded up to E_BLK blocks (>=1, the dummy block)."""
    seg = np.asarray(seg, dtype=np.int64)
    if seg.size == 0:
        return 1
    _, counts = np.unique(seg // R_BLK, return_counts=True)
    return int(sum(-(-c // E_BLK) for c in counts))


def leveled_plan_blocks(segs: list[np.ndarray]) -> int:
    """The (pre-bucketing) per-level block count ``make_leveled_plan`` pads
    to — without building any tables. Bucket with the same next-power-of-two
    rule to predict the final shape."""
    return max((count_blocks(s) for s in segs), default=1)


def make_leveled_plan(segs: list[np.ndarray], n_rows: int, *,
                      pad_levels: int | None = None,
                      pad_blocks: int | None = None) -> LeveledPlan:
    """Route each level's destination segments through ``make_plan`` and stack
    the results into one padded (L, e_pad) table set.

    ``pad_levels`` / ``pad_blocks`` optionally force the padded level count and
    per-level block count (must be >= the natural sizes). Defaults bucket
    levels to a multiple of 4 and blocks to the next power of two, as the
    JAX package does, so the tables match its bit for bit.
    """
    plans = [make_plan(np.asarray(s), n_rows) for s in segs]
    nb_real = max((p.e_pad // E_BLK for p in plans), default=1)
    nb = pad_blocks or max(1, 1 << (nb_real - 1).bit_length())
    if nb < nb_real:
        raise ValueError(f"pad_blocks={nb} < required {nb_real}")
    L_real = len(plans)
    L = pad_levels or max(1, -(-L_real // 4) * 4)
    if L < L_real:
        raise ValueError(f"pad_levels={L} < required {L_real}")
    e_pad = nb * E_BLK

    seg = np.full((L, e_pad), -1, dtype=np.int32)
    tob = np.zeros((L, nb), dtype=np.int32)
    fot = np.zeros((L, nb), dtype=np.int32)
    perms = []
    for l, p in enumerate(plans):
        k = p.tile_of_block.size
        seg[l, : p.e_pad] = p.seg_padded
        tob[l, :k] = p.tile_of_block
        tob[l, k:] = p.tile_of_block[-1] if k else 0  # keep revisits consecutive
        fot[l, :k] = p.first_of_tile
        perms.append(p.perm.copy())
    for l in range(L_real, L):
        fot[l, 0] = 1  # dummy level: init tile 0, aggregate nothing
        perms.append(np.zeros(0, dtype=np.int64))
    n_row_tiles = max(1, -(-n_rows // R_BLK))
    tile_slots = np.stack([tile_slot_ranges(tob[l], n_row_tiles)
                           for l in range(L)])
    return LeveledPlan(
        seg=seg, tile_of_block=tob, first_of_tile=fot, perms=tuple(perms),
        tile_slots=tile_slots, n_rows=n_rows, n_row_tiles=n_row_tiles,
        n_levels=L, e_pad=e_pad,
    )


# ----------------------------------------------------------------- the kernel
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def run_chunk(n_blocks: int, F: int) -> int:
    """Blocks per window of the CUDA kernel for a level of ``n_blocks``
    blocks and ``F`` features a slot."""
    if F > 4:
        return RUN_CHUNK_MIN
    return min(RUN_CHUNK_MAX, max(RUN_CHUNK_MIN, n_blocks // RUN_WINDOWS))


def n_windows(n_blocks: int, F: int) -> int:
    """The CUDA kernel's windows over one level: a function of the block
    count and F alone."""
    return -(-n_blocks // run_chunk(n_blocks, F))


_ENTRIES: dict = {}


def _entry(key: str, argtypes=None):
    """The library's C entry ``segment_agg_{key}_f32`` (``key``: op, then
    ``_active`` and/or ``_stacked``), bound with its argument types on
    first use (which builds the library)."""
    fn = _ENTRIES.get(key)
    if fn is None:
        from repro_torch.kernels import _build

        fn = getattr(_build.library("segment_agg"), f"segment_agg_{key}_f32")
        fn.argtypes = argtypes or _ARGTYPES
        fn.restype = ctypes.c_int
        _ENTRIES[key] = fn
    return fn


def _check(x, seg, tob, fot, n_rows, n_row_tiles, op):
    """The dense wrappers' argument checks: x (n_blocks*E_BLK, F) float32,
    one row per slot of the level (seg, tob, fot)."""
    if op not in ("sum", "max"):
        raise ValueError(f"unknown op {op!r}; choose 'sum' or 'max'")
    if x.dtype != torch.float32:
        raise TypeError(f"segment_agg takes float32 edge values, got "
                        f"{x.dtype}")
    for name, t in (("seg", seg), ("tile_of_block", tob),
                    ("first_of_tile", fot)):
        if t.dtype != torch.int32 or t.ndim != 1:
            raise TypeError(f"{name} must be a 1-D int32 tensor, got "
                            f"{t.dtype} {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.ndim != 2 or x.shape[1] < 1:
        raise ValueError(f"x must be (E_pad, F) with F >= 1, got "
                         f"{tuple(x.shape)}")
    n_blocks = tob.shape[0]
    if n_blocks < 1 or x.shape[0] != n_blocks * E_BLK \
            or seg.shape[0] != n_blocks * E_BLK or fot.shape[0] != n_blocks:
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)} for {n_blocks} blocks, seg "
            f"{tuple(seg.shape)}, {n_blocks} blocks of {E_BLK} slots, fot "
            f"{tuple(fot.shape)}")
    if not 0 < n_rows <= n_row_tiles * R_BLK:
        raise ValueError(f"n_rows={n_rows} outside (0, {n_row_tiles}*{R_BLK}]")


def _on_cuda(name: str, t: torch.Tensor) -> bool:
    """Whether ``t`` lies on the card (the kernel's side) rather than the
    CPU (the plain version's); raises for any other device."""
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, got "
                         f"{t.device}")
    return t.device.type == "cuda"


def segment_agg_level(x: torch.Tensor, seg: torch.Tensor, tob: torch.Tensor,
                      fot: torch.Tensor, *, n_rows: int, n_row_tiles: int,
                      op: str = "sum") -> torch.Tensor:
    """Run the reduce on one level of a ``LeveledPlan``.

    ``x`` is (e_pad, F) float32 edge values already in the level's padded
    slot order, ``seg`` (e_pad,) and ``tob``/``fot`` (n_blocks,) int32, all on
    one device. Returns (n_rows, F) float32; rows the level never touches are
    undefined on the card (unwritten), so callers mask by their touched set.
    CUDA tensors launch the hand-written kernel, CPU tensors run the plain
    version; any other device raises.
    """
    _check(x, seg, tob, fot, n_rows, n_row_tiles, op)
    # shapes only (the wrapper reads no table back): every slot live, every
    # row written
    return counted(WORK, lambda: (op, level_cost(
        seg.shape[0], seg.shape[0], tob.shape[0], n_rows, x.shape[1])),
        _level, x, seg, tob, fot, n_rows, n_row_tiles, op)


def _level(x, seg, tob, fot, n_rows, n_row_tiles, op):
    if not _on_cuda("segment_agg_level", x):
        return segment_agg_level_ref(x, seg, n_rows, op)
    n_blocks, F = tob.shape[0], x.shape[1]
    with torch.cuda.device(x.device):
        out = torch.empty((n_row_tiles * R_BLK, F), dtype=torch.float32,
                          device=x.device)
        # per window, the partial rows of its two pieces that may belong to
        # a run crossing the window's edge, and their live flags
        n_win = n_windows(n_blocks, F)
        part = torch.empty((2 * n_win * R_BLK * F,), dtype=torch.float32,
                           device=x.device)
        flag = torch.empty((2 * n_win,), dtype=torch.int32, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _entry(op)(x.data_ptr(), seg.data_ptr(), tob.data_ptr(),
                        fot.data_ptr(), part.data_ptr(), flag.data_ptr(),
                        out.data_ptr(), n_blocks, F, n_row_tiles,
                        run_chunk(n_blocks, F), stream)
    if rc != 0:
        raise RuntimeError(f"segment_agg_{op} kernel launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES[op] += 1
    return out[:n_rows]


# ------------------------------------------------------------ fused entries
# op codes of the fused C entries (``segment_agg_active_f32``,
# ``segment_agg_dense_stacked_f32``, each taking the op and then a bf16
# flag); min runs the max kernel's arithmetic on negated values, so it
# counts as a max launch
_OPS = {"sum": 0, "max": 1, "min": 2}
_ACTIVE_ARGTYPES = ([ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                     ctypes.c_longlong]
                    + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
                    + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                    + [ctypes.c_longlong] * 2 + [ctypes.c_void_p])
_DENSE_STACKED_ARGTYPES = ([ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                            ctypes.c_longlong]
                           + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                           + [ctypes.c_longlong] * 2 + [ctypes.c_void_p])
# the fused entries' scratch, per (device, stream): part (float32) and flag
# (a run's pieces: two slots for each window a launch can open), ticket
# (zero before and after every launch, so made with zeros) and run; each
# grown to the largest call and never shrunk, so a call allocates only its
# outputs
_SCRATCH: dict = {}


def _scratch(device, stream: int, *sizes: int) -> list:
    bufs = _SCRATCH.setdefault((device, stream), [None] * 4)
    for i, n in enumerate(sizes):
        if bufs[i] is None or bufs[i].numel() < n:
            make = torch.zeros if i == 2 else torch.empty
            bufs[i] = make(n, dtype=torch.float32 if i == 0 else torch.int32,
                           device=device)
    return bufs


def _check_fused(val, seg, src, sign, tob, fot, n_rows, n_row_tiles, op,
                 active=None) -> None:
    """The fused wrappers' checks on one shard's slices: val (n_val, F)
    float32, the level's seg/src (int32) and sign (float32) tables of
    n_blocks * E_BLK slots and its tob/fot, and for the active entry active
    (K,) int32, all on val's device, the tables' rows contiguous."""
    if op not in _OPS:
        raise ValueError(f"unknown op {op!r}; choose 'sum', 'max' or 'min'")
    if val.dtype != torch.float32:
        raise TypeError(f"the fused segment entries take float32 values, "
                        f"got {val.dtype}")
    if val.ndim != 2 or val.shape[0] < 1 or val.shape[1] < 1:
        raise ValueError(f"val must be (n, F) with n, F >= 1, got "
                         f"{tuple(val.shape)}")
    tables = [("seg", seg, torch.int32), ("src", src, torch.int32),
              ("sign", sign, torch.float32),
              ("tile_of_block", tob, torch.int32),
              ("first_of_tile", fot, torch.int32)]
    if active is not None:
        tables.append(("active", active, torch.int32))
    for name, t, dt in tables:
        if t.dtype != dt or t.ndim != 1 or t.shape[0] < 1:
            raise TypeError(f"{name} must be a non-empty 1-D {dt} tensor, "
                            f"got {t.dtype} {tuple(t.shape)}")
        if t.device != val.device:
            raise ValueError(f"{name} is on {t.device}, val on {val.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n_blocks = tob.shape[0]
    if any(t.shape[0] != n_blocks * E_BLK for t in (seg, src, sign)) \
            or fot.shape[0] != n_blocks:
        raise ValueError(
            f"shape mismatch: seg/src/sign {tuple(seg.shape)}/"
            f"{tuple(src.shape)}/{tuple(sign.shape)} for {n_blocks} blocks "
            f"of {E_BLK} slots, fot {tuple(fot.shape)}")
    if not 0 < n_rows <= n_row_tiles * R_BLK:
        raise ValueError(f"n_rows={n_rows} outside (0, {n_row_tiles}*{R_BLK}]")


def _fused_launch(val, seg, src, sign, tob, fot, n_row_tiles, op, bf16,
                  active=None, strides=(0, 0)):
    """One launch of a fused entry, its bf16 instance with ``bf16``: the
    active entry with ``active``, else the stacked dense entry; one shard
    (1-D tables) or S shards (val (S, n, F), active (S, K), the tables'
    shard ``strides`` (seg/src/sign, tob/fot) in elements). Returns out
    (and for the active entry hit) with a leading shard axis and every row
    tile."""
    S = val.shape[0] if val.ndim == 3 else 1
    n_val, F = val.shape[-2], val.shape[-1]
    n_blocks = tob.shape[-1]
    for t in (seg, src, sign):
        if t.data_ptr() % 16:
            raise ValueError("seg, src and sign must be 16-byte aligned")
    dev = val.device
    with torch.cuda.device(dev):
        out = torch.empty((S, n_row_tiles * R_BLK, F), dtype=torch.float32,
                          device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        win = run_chunk(n_blocks, F)
        n_win = n_windows(n_blocks, F)
        # the windows a launch can open: every one (dense), or at most one
        # per active entry
        n_slot = n_win if active is None else min(active.shape[-1], n_win)
        part, flag, ticket, run = _scratch(
            dev, stream, S * 2 * n_slot * R_BLK * F, S * 2 * n_slot,
            S * n_row_tiles, S * 3 * n_row_tiles)
        head = (_OPS[op], int(bool(bf16)), val.data_ptr(), n_val,
                seg.data_ptr(), src.data_ptr(), sign.data_ptr(),
                tob.data_ptr(), fot.data_ptr())
        shape = (n_blocks, F, n_row_tiles, win, S, *strides, stream)
        scratch = (part.data_ptr(), flag.data_ptr(), ticket.data_ptr(),
                   run.data_ptr())
        if active is None:
            rc = _entry("dense_stacked", _DENSE_STACKED_ARGTYPES)(
                *head, out.data_ptr(), *scratch, *shape)
            hit = None
        else:
            # cleared by the entry (an async memset before its kernel)
            hit = torch.empty((S, n_row_tiles * R_BLK), dtype=torch.bool,
                              device=dev)
            rc = _entry("active", _ACTIVE_ARGTYPES)(
                *head, active.data_ptr(), active.shape[-1], n_slot,
                out.data_ptr(), hit.data_ptr(), *scratch, *shape)
    if rc != 0:
        entry = "dense_stacked" if active is None else "active"
        raise RuntimeError(f"segment_agg_{entry} ({op}{', bf16' * bf16}) "
                           f"kernel launch failed: CUDA error {rc}")
    return out, hit


def _key(op: str, entry: str, bf16: bool) -> str:
    """A fused entry's key in ``LAUNCHES`` and ``WORK``: min counts as max,
    a bf16 instance under its ``_bf16`` key."""
    key = f"{'sum' if op == 'sum' else 'max'}_{entry}"
    return key + "_bf16" if bf16 else key


def _count(op: str, entry: str, bf16: bool) -> None:
    """One launch of a fused entry's kernel in ``LAUNCHES``."""
    LAUNCHES[_key(op, entry, bf16)] += 1


def _fused_work(val, seg, tob, n_rows, n_row_tiles, op, bf16,
                active=None) -> Work:
    """A fused call's work from its shapes alone, summed over its shards:
    every slot (of every active block) live with a distinct source, up to
    the ``val`` rows there are, every row (of every tile an active block
    may route to) written."""
    S = val.shape[0] if val.ndim == 3 else 1
    n_val, F = val.shape[-2], val.shape[-1]
    n_slots, n_blocks = seg.shape[-1], tob.shape[-1]
    if active is None:
        one = stacked_cost(n_slots, n_blocks, min(n_slots, n_val), n_blocks,
                           n_rows, n_slots, F, op, bf16)
    else:
        K = active.shape[-1]
        one = active_cost(K, K * E_BLK, min(K * E_BLK, n_val),
                          min(K, n_row_tiles), F, n_rows, op, bf16)
    return Work(one.ops * S, one.bytes * S)


# ------------------------------------------------------------ the active entry
def segment_agg_active(val: torch.Tensor, seg: torch.Tensor,
                       src: torch.Tensor, sign: torch.Tensor,
                       tob: torch.Tensor, fot: torch.Tensor,
                       active: torch.Tensor, *, n_rows: int,
                       n_row_tiles: int, op: str = "sum",
                       bf16: bool = False):
    """One frontier-sparse level in one call: over the level's active
    blocks, each live slot's value gathered from ``val`` (n_val, F) float32
    by ``src``, times ``sign`` for sum, reduced by ``seg``; op ``"sum"``,
    ``"max"`` or ``"min"`` (``-max(-x)``, as the engine takes min).

    ``seg``, ``src`` (int32), ``sign`` (float32) (e_pad,) and
    ``tob``/``fot`` (n_blocks,) are the whole level's tables; ``active``
    (K,) int32 holds the active blocks' indices in ascending order, padded
    at the end with ``n_blocks`` (pads are ignored). Returns ``(out, hit)``:
    ``out`` (n_rows, F) float32, on every row an active block routes to
    bit-equal to ``segment_agg_level`` over the level's gathered values
    with the other blocks' set to the op's identity, rows of tiles with no
    active block undefined on the card (unwritten), so callers mask; ``hit``
    (n_rows,) bool, the rows with an active live slot. ``bf16`` rounds
    each slot's value (after the sign, before min's negation) to bfloat16
    before it is reduced. CUDA tensors launch the fused kernel (one launch;
    ``LAUNCHES["sum_active"]``, or ``["max_active"]`` for max and min, with
    ``_bf16`` appended for the bf16 instance), CPU tensors run the plain
    version."""
    _check_fused(val, seg, src, sign, tob, fot, n_rows, n_row_tiles, op,
                 active)
    return counted(WORK, lambda: (_key(op, "active", bf16), _fused_work(
        val, seg, tob, n_rows, n_row_tiles, op, bf16, active)),
        _active, val, seg, src, sign, tob, fot, active, n_rows, n_row_tiles,
        op, bf16)


def _active(val, seg, src, sign, tob, fot, active, n_rows, n_row_tiles, op,
            bf16):
    if not _on_cuda("segment_agg_active", val):
        return segment_agg_active_ref(val, seg, src, sign, active, n_rows,
                                      op, bf16)
    out, hit = _fused_launch(val, seg, src, sign, tob, fot, n_row_tiles, op,
                             bf16, active)
    _count(op, "active", bf16)
    return out[0, :n_rows], hit[0, :n_rows]


# ------------------------------------------------------------ stacked shards
def _check_stacked(val, seg, src, sign, tob, fot, n_rows, n_row_tiles, op,
                   active=None) -> None:
    """The stacked wrappers' checks: val (S, n_val, F) contiguous, the
    tables (S, ...) with a unit last stride (a level of stacked (S, L, ...)
    tables is a strided view), seg, src and sign sharing one shard stride
    and so tob and fot; active, when given, contiguous (S, K). Each shard's
    slice passes the single-shard checks."""
    S = val.shape[0] if val.ndim == 3 else -1
    if S < 1:
        raise ValueError(f"val must be (S, n, F), got {tuple(val.shape)}")
    for name, t in (("seg", seg), ("src", src), ("sign", sign),
                    ("tile_of_block", tob), ("first_of_tile", fot)):
        if t.ndim != 2 or t.shape[0] != S or t.stride(1) != 1:
            raise ValueError(f"{name} must be (S={S}, n) with a unit last "
                             f"stride, got {tuple(t.shape)} strides "
                             f"{t.stride()}")
    if src.stride(0) != seg.stride(0) or sign.stride(0) != seg.stride(0) \
            or fot.stride(0) != tob.stride(0):
        raise ValueError("seg, src and sign must share their shard stride, "
                         "and so must tile_of_block and first_of_tile")
    if not val.is_contiguous():
        raise ValueError("val must be contiguous")
    if active is not None and (active.ndim != 2 or active.shape[0] != S
                               or not active.is_contiguous()):
        raise ValueError(f"active must be contiguous (S={S}, K), got "
                         f"{tuple(active.shape)}")
    _check_fused(val[0], seg[0], src[0], sign[0], tob[0], fot[0], n_rows,
                 n_row_tiles, op, None if active is None else active[0])


def segment_agg_level_stacked(val: torch.Tensor, seg: torch.Tensor,
                              src: torch.Tensor, sign: torch.Tensor,
                              tob: torch.Tensor, fot: torch.Tensor, *,
                              n_rows: int, n_row_tiles: int,
                              op: str = "sum",
                              bf16: bool = False) -> torch.Tensor:
    """One dense level of S aligned shards in one call: for each shard s,
    each live slot's value gathered from ``val[s]`` by ``src[s]``, times
    ``sign[s]`` for sum, reduced by ``seg[s]``; op ``"sum"``, ``"max"`` or
    ``"min"`` (``-max(-x)``).

    ``val`` (S, n_val, F) float32 contiguous; ``seg``/``src``/``sign``
    (S, e_pad) and ``tob``/``fot`` (S, n_blocks) a level of the stacked
    (S, L, ...) tables (strided along the shard axis; seg, src and sign
    sharing one shard stride). Returns (S, n_rows, F); shard s equals
    ``segment_agg_level`` on that shard's gathered values
    (``val[s][src[s]] * sign[s]`` for sum, ``val[s][src[s]]`` for max,
    ``-val[s][src[s]]`` negated back for min) bit for bit; rows of tiles no
    block visits are undefined on the card (unwritten), so callers mask.
    ``bf16`` rounds each gathered (and signed) value to bfloat16 before it
    is reduced, as ``segment_agg_active`` does; at S = 1 it is the single
    engine's dense level in bf16 mode. CUDA tensors launch the fused kernel
    once for all shards (``LAUNCHES["sum_stacked"]``, or ``["max_stacked"]``
    for max and min, with ``_bf16`` appended for the bf16 instance), CPU
    tensors run the plain version shard by shard."""
    _check_stacked(val, seg, src, sign, tob, fot, n_rows, n_row_tiles, op)
    return counted(WORK, lambda: (_key(op, "stacked", bf16), _fused_work(
        val, seg, tob, n_rows, n_row_tiles, op, bf16)),
        _level_stacked, val, seg, src, sign, tob, fot, n_rows, n_row_tiles,
        op, bf16)


def _level_stacked(val, seg, src, sign, tob, fot, n_rows, n_row_tiles, op,
                   bf16):
    if not _on_cuda("segment_agg_level_stacked", val):
        return segment_agg_level_stacked_ref(val, seg, src, sign, n_rows, op,
                                             bf16)
    out, _ = _fused_launch(val, seg, src, sign, tob, fot, n_row_tiles, op,
                           bf16, strides=(seg.stride(0), tob.stride(0)))
    _count(op, "stacked", bf16)
    return out[:, :n_rows]


def segment_agg_active_stacked(val: torch.Tensor, seg: torch.Tensor,
                               src: torch.Tensor, sign: torch.Tensor,
                               tob: torch.Tensor, fot: torch.Tensor,
                               active: torch.Tensor, *, n_rows: int,
                               n_row_tiles: int, op: str = "sum",
                               bf16: bool = False):
    """``segment_agg_active`` over one level of S aligned shards at once:
    ``val`` (S, n_val, F) contiguous, ``seg``/``src``/``sign`` (S, e_pad)
    and ``tob``/``fot`` (S, n_blocks) a level of the stacked tables
    (strided along the shard axis; seg, src and sign sharing one shard
    stride), ``active`` (S, K) int32, each shard's ascending active blocks
    padded at the end with ``n_blocks`` to the widest shard's K. Returns
    ``(out (S, n_rows, F), hit (S, n_rows))``; shard s equals
    ``segment_agg_active`` on shard s's slices (``bf16`` included), bit
    for bit. CUDA tensors launch the fused kernel once for all shards
    (``LAUNCHES["{sum,max}_active_stacked"]``, with ``_bf16`` appended for
    the bf16 instance), CPU tensors run the plain version shard by
    shard."""
    _check_stacked(val, seg, src, sign, tob, fot, n_rows, n_row_tiles, op,
                   active)
    return counted(WORK, lambda: (_key(op, "active_stacked", bf16),
                                  _fused_work(val, seg, tob, n_rows,
                                              n_row_tiles, op, bf16, active)),
                   _active_stacked, val, seg, src, sign, tob, fot, active,
                   n_rows, n_row_tiles, op, bf16)


def _active_stacked(val, seg, src, sign, tob, fot, active, n_rows,
                    n_row_tiles, op, bf16):
    if not _on_cuda("segment_agg_active_stacked", val):
        return segment_agg_active_stacked_ref(val, seg, src, sign, active,
                                              n_rows, op, bf16)
    out, hit = _fused_launch(val, seg, src, sign, tob, fot, n_row_tiles, op,
                             bf16, active, (seg.stride(0), tob.stride(0)))
    _count(op, "active_stacked", bf16)
    return out[:, :n_rows], hit[:, :n_rows]


# ------------------------------------------------------------- the graph entry
# the graph kernel's slot word (csrc/segment_graph.cu): the edge in bits
# 0-29, bit 31 on the last slot of a segment (one row's slots in one block)
LAST_SEG, SRC_BITS = 1 << 31, 30
TASK_SLOTS = 32   # slots a task holds, about: whole segments
IN_FLIGHT = 8     # slots a lane group loads at once (U in the kernel)
CHUNK_ENDS = 3    # crossing rows' segments that end in IN_FLIGHT slots, at
                  # most (the kernel's partials pending: CHUNK_ENDS + 1)


@dataclasses.dataclass(frozen=True, eq=False)
class GraphTables:
    """The graph kernel's tables of one ``EdgePlan`` (numpy int32; see
    ``csrc/segment_graph.cu``): the live slots in layout order, cut into
    segments (a row's slots inside one block), tasks of whole segments,
    the partials of the rows whose slots span blocks, and the rows no live
    edge reaches."""

    slots: np.ndarray   # (n_live, 2): edge | LAST_SEG, destination (the
                        # row, or -1 - p for partial p)
    task: np.ndarray    # (n_task + 1,) slot offsets
    blocks: np.ndarray  # (n_blocks + 1,) slot offsets of the blocks with a
                        # live slot (a prefix of each)
    part: np.ndarray    # (n_part, 4): per partial its row's first partial
                        # and count, the row's first block (its blocks are
                        # consecutive, one partial each), the row
    empty: np.ndarray   # (n_empty,) rows with no live edge

    def fields(self) -> tuple:
        return self.slots, self.task, self.blocks, self.part, self.empty


def graph_tables(pos: np.ndarray, edge: np.ndarray, rows: np.ndarray,
                 n_rows: int) -> GraphTables:
    """The graph kernel's tables from ``make_plan``'s layout of the live
    edges: ``pos`` each live edge's padded slot, ``edge`` its index in the
    edge array (< 2^30), ``rows`` its row."""
    if edge.size and int(edge.max()) >> SRC_BITS:
        raise ValueError(f"the graph entry takes at most 2^{SRC_BITS} edges")
    order = np.argsort(pos, kind="stable")
    pos = pos[order].astype(np.int64)
    edge = edge[order].astype(np.int64)
    rows = rows[order].astype(np.int64)
    n = pos.size
    blk = pos // E_BLK
    new = np.ones(n, bool)
    new[1:] = (rows[1:] != rows[:-1]) | (blk[1:] != blk[:-1])
    first = np.flatnonzero(new)             # each segment's first slot
    seg_row, seg_blk = rows[first], blk[first]
    segs = np.bincount(seg_row, minlength=n_rows)
    cross = segs[seg_row] > 1
    p = np.cumsum(cross) - 1
    dst = np.where(cross, -1 - p, seg_row)
    prow, pblk = seg_row[cross], seg_blk[cross]
    lo = np.zeros(prow.size, np.int64)      # each partial's row's first
    if prow.size:
        head = np.ones(prow.size, bool)
        head[1:] = prow[1:] != prow[:-1]
        lo = np.flatnonzero(head)[np.cumsum(head) - 1]
    last = np.zeros(n, bool)
    last[first[1:] - 1] = True
    last[n - 1:] = True
    slots = np.empty((n, 2), np.int32)
    slots[:, 0] = (edge | np.where(last, LAST_SEG, 0)).astype(
        np.uint32).view(np.int32)
    slots[:, 1] = dst[np.cumsum(new) - 1]
    tb = first // TASK_SLOTS
    tnew = np.ones(first.size, bool)
    tnew[1:] = tb[1:] != tb[:-1]
    part = np.stack([lo, segs[prow], pblk[lo], prow], 1).astype(np.int32)
    # a crossing segment ends at a full block's last slot or is the first
    # segment of the next block; a block of fewer than IN_FLIGHT slots is
    # its tile's last, which no row leaves, so IN_FLIGHT slots hold at most
    # CHUNK_ENDS such ends: the kernel's pending partials fit its array
    ends = np.convolve(last & cross[np.cumsum(new) - 1], np.ones(IN_FLIGHT,
                                                                 int)) \
        if n else np.zeros(1, int)
    if int(ends.max()) > CHUNK_ENDS:
        raise AssertionError(f"{int(ends.max())} crossing segments end in "
                             f"{IN_FLIGHT} slots (at most {CHUNK_ENDS})")
    bnew = np.ones(n, bool)
    bnew[1:] = blk[1:] != blk[:-1]
    return GraphTables(
        slots=slots, task=np.append(first[tnew], n).astype(np.int32),
        blocks=np.append(np.flatnonzero(bnew), n).astype(np.int32),
        part=part.reshape(-1, 4),
        empty=np.flatnonzero(segs == 0).astype(np.int32))


class _GraphPlanC(ctypes.Structure):
    """``GraphPlan`` of ``csrc/segment_graph.cu``: the tables' device
    addresses and counts."""

    _fields_ = ([(k, ctypes.c_void_p) for k in (
        "slots", "task", "blocks", "part", "empty")]
        + [(k, ctypes.c_int) for k in (
            "n_live", "n_task", "n_blocks", "n_part", "n_empty", "n_rows",
            "win_narrow", "win_wide", "device")])


def _upload_tables(t: GraphTables, dev, n_rows: int, n_blocks: int):
    """The tables in one int32 tensor on ``dev`` (each 16-byte aligned),
    and on the card their ``_GraphPlanC``."""
    parts = [np.ascontiguousarray(a, np.int32).ravel() for a in t.fields()]
    offs = np.cumsum([0] + [-(-a.size // 4) * 4 for a in parts])
    flat = np.zeros(max(4, int(offs[-1])), np.int32)
    for a, o in zip(parts, offs):
        flat[o:o + a.size] = a
    packed = torch.as_tensor(flat, device=dev)
    if dev.type != "cuda":
        return packed, None
    base = packed.data_ptr()
    c = _GraphPlanC(*[base + 4 * int(o) for o in offs[:-1]],
                    t.slots.shape[0], t.task.size - 1, t.blocks.size - 1,
                    t.part.shape[0], t.empty.size, n_rows,
                    # the stacked route's windows at F <= 4 and F > 4
                    run_chunk(n_blocks, 4), run_chunk(n_blocks, 5),
                    dev.index)
    return packed, c


@dataclasses.dataclass(frozen=True, eq=False)
class EdgePlan:
    """The graph entry's plan for one edge index array: edge e goes to row
    ``index[e]`` of ``n_rows``; edges whose mask is False, and edges whose
    row lies outside [0, n_rows) (which ``jax.ops.segment_sum`` drops), are
    left out: their values are never read, and their gathers read 0. Slots
    are ``make_plan``'s layout of the live edges (sorted stably by row,
    256-slot blocks routed to 128-row tiles), ``n_slots`` slots in
    ``n_blocks`` blocks; ``tables`` are the graph kernel's
    (``graph_tables``), uploaded once into ``packed`` on the index's
    device."""

    index: torch.Tensor          # (E,) int64, the edges' rows (clamped)
    live: torch.Tensor | None    # (E,) bool, None when every edge is live
    tables: GraphTables          # the graph kernel's, on the host
    packed: torch.Tensor         # the same, one int32 tensor on the device
    n_rows: int
    n_live: int
    n_slots: int                 # the layout's slots, padding included
    n_blocks: int
    cplan: _GraphPlanC | None    # the kernel's view of ``packed`` (card)

    @property
    def n_edges(self) -> int:
        return int(self.index.shape[0])


def make_edge_plan(index: torch.Tensor, n_rows: int,
                   mask: torch.Tensor | None = None) -> EdgePlan:
    """Build the ``EdgePlan`` of ``index`` (E,) into ``n_rows`` rows, the
    edges with ``mask`` (E,) False left out, on ``index``'s device. It reads
    ``index`` and ``mask`` on the host: one device-to-host copy (and wait)
    for tensors on the card, which only a batch whose plans were not built
    with it pays (a redrawn smoke batch, at its first use)."""
    if index.ndim != 1:
        raise ValueError(f"index must be 1-D, got {tuple(index.shape)}")
    if n_rows < 1:
        raise ValueError(f"n_rows must be >= 1, got {n_rows}")
    dev = index.device
    idx = index.detach().cpu().numpy().astype(np.int64)
    live = (idx >= 0) & (idx < n_rows)
    if mask is not None:
        if mask.shape != index.shape:
            raise ValueError(f"mask {tuple(mask.shape)} does not match index "
                             f"{tuple(index.shape)}")
        live &= mask.detach().cpu().numpy().astype(bool)
    if live.all():
        live = None
    keep = np.arange(idx.size) if live is None else np.flatnonzero(live)
    rows = idx[keep]
    p = make_plan(rows, n_rows)
    n_blocks = p.tile_of_block.size
    tables = graph_tables(p.perm, keep, rows, n_rows)
    packed, cplan = _upload_tables(tables, dev, n_rows, n_blocks)
    return EdgePlan(
        index=index.detach().to(torch.int64).clamp(0, n_rows - 1),
        live=None if live is None else torch.as_tensor(live, device=dev),
        tables=tables, packed=packed, n_rows=int(n_rows),
        n_live=int(rows.size), n_slots=int(p.e_pad), n_blocks=int(n_blocks),
        cplan=cplan)


# what is made from tensors (edge plans, a rank's slices of a batch and
# their plans), by a tag and the tensors' ids, with the tensors' weak
# references and versions beside each entry: an entry dies with its
# tensors, and a tensor edited in place gets a new one
_MEMO: dict = {}


def _drop_entry(key, ref) -> None:
    got = _MEMO.get(key)
    if got is not None and ref in got[0]:
        del _MEMO[key]


def tensor_memo(tag: tuple, tensors: tuple, make):
    """``make()``, made once per ``tag`` and set of ``tensors`` (None
    allowed among them) and kept while they live unedited."""
    key = tag + tuple(id(t) for t in tensors)
    vers = tuple(None if t is None else t._version for t in tensors)
    got = _MEMO.get(key)
    if got is not None and got[1] == vers and all(
            r is None if t is None else r() is t
            for r, t in zip(got[0], tensors)):
        return got[2]
    out = make()
    drop = functools.partial(_drop_entry, key)
    _MEMO[key] = (tuple(None if t is None else weakref.ref(t, drop)
                        for t in tensors), vers, out)
    return out


def edge_plan(index: torch.Tensor, n_rows: int,
              mask: torch.Tensor | None = None) -> EdgePlan:
    """``make_edge_plan(index, n_rows, mask)``, built once per index tensor
    (and mask tensor) and kept while they live (``tensor_memo``): a
    batch's plans are built with the batch (the config builders ask for
    them) or at their first use, and every later aggregation over the same
    tensors reuses them. A mask that keeps every edge shares the unmasked
    plan."""
    def make():
        if mask is not None and bool(mask.all()):
            return edge_plan(index, n_rows)
        return make_edge_plan(index, n_rows, mask)

    return tensor_memo(("edge_plan", int(n_rows)), (index, mask), make)


_GRAPH_DTYPES = (torch.float32, torch.bfloat16)


def segment_agg_graph(val: torch.Tensor, plan: EdgePlan,
                      op: str = "sum") -> torch.Tensor:
    """Reduce edge values ``val`` (E, F) float32 or bfloat16, one row per
    edge of ``plan``, into ``plan.n_rows`` rows of val's dtype: ``out[r]``
    is the sum (op ``"sum"``) or the max (``"max"``) of ``val[e]`` over the
    live edges e with ``index[e] == r``; rows with no live edge read 0. CUDA
    tensors launch the graph kernel (``csrc/segment_graph.cu``) once, which
    accumulates in fp32 and rounds bf16 rows once, and writes every row
    (``LAUNCHES["sum_gnn"]`` or ``["max_gnn"]``); CPU tensors run the plain
    version in fp32 (bf16 cast to fp32 and back; also float64, for a
    reference run in fp64). Deterministic: a row's values are added in the
    plan's slot order, per block, per window of blocks, then across
    windows, bit-equal to the stacked dense entry at S = 1 over the same
    layout."""
    if op not in ("sum", "max"):
        raise ValueError(f"unknown op {op!r}; choose 'sum' or 'max'")
    cpu64 = val.dtype == torch.float64 and val.device.type == "cpu"
    if not (val.dtype in _GRAPH_DTYPES or cpu64) or val.ndim != 2:
        raise TypeError(f"val must be (E, F) float32 or bfloat16 (float64 "
                        f"on the CPU), got {val.dtype} {tuple(val.shape)} "
                        f"on {val.device}")
    if val.shape[0] != plan.n_edges:
        raise ValueError(f"val has {val.shape[0]} rows for a plan of "
                         f"{plan.n_edges} edges")
    if val.device != plan.packed.device:
        raise ValueError(f"val is on {val.device}, the plan on "
                         f"{plan.packed.device}")
    return counted(WORK, lambda: (f"{op}_gnn", graph_cost(
        plan.n_live, plan.n_rows, val.shape[1], val.element_size())),
        _graph, val, plan, op)


_GRAPH_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int] \
    + [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]


def _graph(val, plan, op):
    if not _on_cuda("segment_agg_graph", val):
        v = val.float() if val.dtype == torch.bfloat16 else val
        return segment_agg_graph_ref(v, plan.index, plan.live, plan.n_rows,
                                     op).to(val.dtype)
    val = val.contiguous()
    F = val.shape[1]
    dev = val.device
    out = torch.empty((plan.n_rows, F), dtype=val.dtype, device=dev)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    t = plan.tables
    n_part = t.part.shape[0]
    part, _, ticket, _ = _scratch(dev, stream, n_part * F, 0,
                                  n_part * max(1, -(-F // 32)))
    rc = _graph_entry()(ctypes.addressof(plan.cplan), _OPS[op],
                        int(val.dtype == torch.bfloat16), val.data_ptr(),
                        out.data_ptr(), part.data_ptr(), ticket.data_ptr(),
                        F, stream)
    if rc != 0:
        raise RuntimeError(f"segment_agg_graph ({op}, {val.dtype}) kernel "
                           f"launch failed: CUDA error {rc}")
    LAUNCHES[f"{op}_gnn"] += 1
    return out


def _graph_entry():
    """``segment_agg_graph_run`` of ``csrc/segment_graph.cu``, bound on
    first use (which builds the library)."""
    fn = _ENTRIES.get("graph")
    if fn is None:
        from repro_torch.kernels import _build

        fn = _build.library("segment_graph").segment_agg_graph_run
        fn.argtypes = _GRAPH_ARGTYPES
        fn.restype = ctypes.c_int
        _ENTRIES["graph"] = fn
    return fn


def _reduce(x: torch.Tensor, plan: EdgePlan, op: str) -> torch.Tensor:
    """``segment_agg_graph`` on x (E, ...) of any float dtype, (n_rows,
    ...) in x's dtype: float32 and bfloat16 (and float64 on the CPU) as
    they are, any other dtype reduced in fp32 and cast back."""
    v = x.reshape(x.shape[0], -1)
    if not (x.dtype in _GRAPH_DTYPES
            or (x.dtype == torch.float64 and x.device.type == "cpu")):
        v = v.to(torch.float32)
    out = segment_agg_graph(v, plan, op)
    return out.to(x.dtype).reshape((plan.n_rows,) + x.shape[1:])


def _take(h: torch.Tensor, plan: EdgePlan) -> torch.Tensor:
    """``h[index]``, the left-out edges' rows 0."""
    if h.shape[0] != plan.n_rows:
        raise ValueError(f"h has {h.shape[0]} rows for a plan into "
                         f"{plan.n_rows}")
    y = h.index_select(0, plan.index)
    if plan.live is not None:
        y = torch.where(plan.live.view((-1,) + (1,) * (y.ndim - 1)), y, 0)
    return y


class _GraphSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plan):
        ctx.plan = plan
        return _reduce(x, plan, "sum")

    @staticmethod
    def backward(ctx, g):
        return _GraphGather.apply(g, ctx.plan), None


class _GraphGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, plan):
        ctx.plan = plan
        return _take(h, plan)

    @staticmethod
    def backward(ctx, g):
        return _GraphSum.apply(g, ctx.plan), None


def graph_sum(x: torch.Tensor, plan: EdgePlan) -> torch.Tensor:
    """Sum edge values ``x`` (E, ...) into ``plan.n_rows`` rows over the
    plan's live edges (``jax.ops.segment_sum`` of the masked values), in
    x's dtype, accumulated in fp32 by the kernel. Its backward is
    ``graph_gather`` over the same plan, and so on for every order."""
    return _GraphSum.apply(x, plan)


def graph_gather(h: torch.Tensor, plan: EdgePlan) -> torch.Tensor:
    """``h[index]`` (E, ...), rows of left-out edges 0: a plain
    ``index_select``. Its backward is ``graph_sum`` over the same plan: the
    reduction goes through the kernel, not a scatter-add."""
    return _GraphGather.apply(h, plan)


def graph_max(x: torch.Tensor, plan: EdgePlan) -> torch.Tensor:
    """The max of edge values ``x`` (E, ...) per row over the plan's live
    edges, rows with none 0, in x's dtype; computed without a gradient. Its
    one use is the stability shift of a segment softmax, whose value does
    not depend on the shift: the softmax's gradient is the same with it
    held constant (``jax.ops.segment_max``'s gradient through the shift
    adds terms that cancel)."""
    with torch.no_grad():
        return _reduce(x.detach(), plan, "max")
