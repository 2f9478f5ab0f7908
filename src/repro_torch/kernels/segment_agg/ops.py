"""Plan builders and the checked wrapper for the segment_agg CUDA kernel.

The kernel requires edges sorted by destination and padded so no E_BLK edge
block straddles an R_BLK row tile. For static graph structure (EAGr overlay
levels) that plan is built once on the host (``make_plan``) and reused every
step; only the edge *values* are runtime data. The builders are numpy and
produce tables bit-equal to the JAX package's (same E_BLK / R_BLK).

``segment_agg_level`` is the entry point the engine calls per level, and
``segment_agg_active`` its twin over a level's active blocks (the
frontier-sparse steps); ``segment_agg_level_stacked`` and
``segment_agg_active_stacked`` run one level of S aligned shards in one
launch (the stacked shard engine, ``distributed/stacked.py``). Each picks the implementation by the tensors'
device: CUDA tensors launch the hand-written kernel in
``csrc/segment_agg.cu`` (or raise), CPU tensors run the plain PyTorch
version in ``ref.py``. ``LAUNCHES`` counts kernel launches per entry, so a
run can show that its path went through the kernel.

``patch_level``, ``scatter_slots``, ``scatter_rows`` and ``tile_occupancy``
edit and measure the stacked level tables in place, for the plan patch path
(``core/plan_patch.py``): churn inside the plan's capacity never reallocates
a table.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from repro_torch.kernels.segment_agg.ref import (
    segment_agg_active_ref,
    segment_agg_active_stacked_ref,
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
            "max_active_stacked": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


def _check(x, seg, tob, fot, n_rows, n_row_tiles, op, n_x_blocks=None):
    """The wrappers' argument checks: x (n_x_blocks*E_BLK, F) float32, by
    default one row per slot of the level (seg, tob, fot)."""
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
    n_x = n_blocks if n_x_blocks is None else n_x_blocks
    if n_blocks < 1 or x.shape[0] != n_x * E_BLK \
            or seg.shape[0] != n_blocks * E_BLK or fot.shape[0] != n_blocks:
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)} for {n_x} blocks, seg "
            f"{tuple(seg.shape)}, {n_blocks} blocks of {E_BLK} slots, fot "
            f"{tuple(fot.shape)}")
    if not 0 < n_rows <= n_row_tiles * R_BLK:
        raise ValueError(f"n_rows={n_rows} outside (0, {n_row_tiles}*{R_BLK}]")


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
    if x.device.type == "cpu":
        return segment_agg_level_ref(x, seg, n_rows, op)
    if x.device.type != "cuda":
        raise ValueError(f"segment_agg_level runs on cuda or cpu tensors, "
                         f"got {x.device}")
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


def _check_active(x, seg, tob, fot, active, n_rows, n_row_tiles, op) -> None:
    if active.dtype != torch.int32 or active.ndim != 1 \
            or active.shape[0] < 1:
        raise TypeError(f"active must be a non-empty 1-D int32 tensor, got "
                        f"{active.dtype} {tuple(active.shape)}")
    if active.device != x.device or not active.is_contiguous():
        raise ValueError(f"active must be contiguous on {x.device}")
    _check(x, seg, tob, fot, n_rows, n_row_tiles, op,
           n_x_blocks=active.shape[0])


_ACTIVE_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int]
                    + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                    + [ctypes.c_void_p])


def segment_agg_active(x: torch.Tensor, seg: torch.Tensor, tob: torch.Tensor,
                       fot: torch.Tensor, active: torch.Tensor, *,
                       n_rows: int, n_row_tiles: int,
                       op: str = "sum") -> torch.Tensor:
    """Run the reduce on the active blocks of one level.

    ``seg`` (e_pad,), ``tob``/``fot`` (n_blocks,) are the whole level's
    tables; ``active`` (K,) int32 holds the active blocks' indices in
    ascending order, padded at the end with ``n_blocks`` (pads are
    ignored); ``x`` (K*E_BLK, F) float32 holds the active blocks' slot
    values in that order (a pad's rows are never read). Returns (n_rows, F)
    float32: on every row an active block routes to, bit-equal to
    ``segment_agg_level`` over the whole level with the other blocks'
    values set to the op's identity; rows of tiles with no active block
    are undefined on the card (unwritten), so callers mask. CUDA tensors
    launch the kernel's active entry, CPU tensors run the plain version.
    """
    _check_active(x, seg, tob, fot, active, n_rows, n_row_tiles, op)
    if x.device.type == "cpu":
        return segment_agg_active_ref(x, seg, active, n_rows, op)
    if x.device.type != "cuda":
        raise ValueError(f"segment_agg_active runs on cuda or cpu tensors, "
                         f"got {x.device}")
    n_blocks, F, K = tob.shape[0], x.shape[1], active.shape[0]
    with torch.cuda.device(x.device):
        out = torch.empty((n_row_tiles * R_BLK, F), dtype=torch.float32,
                          device=x.device)
        # two partial-row slots and two flags per active entry (the window
        # an entry opens)
        part = torch.empty((2 * K * R_BLK * F,), dtype=torch.float32,
                           device=x.device)
        flag = torch.empty((2 * K,), dtype=torch.int32, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _entry(f"{op}_active", _ACTIVE_ARGTYPES)(
            x.data_ptr(), seg.data_ptr(), tob.data_ptr(), fot.data_ptr(),
            active.data_ptr(), K, part.data_ptr(), flag.data_ptr(),
            out.data_ptr(), n_blocks, F, n_row_tiles, run_chunk(n_blocks, F),
            stream)
    if rc != 0:
        raise RuntimeError(f"segment_agg_{op}_active kernel launch failed: "
                           f"CUDA error {rc}")
    LAUNCHES[f"{op}_active"] += 1
    return out[:n_rows]


# ------------------------------------------------------------ stacked shards
_STACKED_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                     + [ctypes.c_longlong] * 2 + [ctypes.c_void_p])
_ACTIVE_STACKED_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int]
                            + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                            + [ctypes.c_longlong] * 2 + [ctypes.c_void_p])


def _check_stacked(x, seg, tob, fot, n_rows, n_row_tiles, op,
                   active=None) -> None:
    """The stacked wrappers' checks: every argument carries the shard axis
    first; x and active are contiguous, the tables only along their last
    axis (a level of (S, L, ...) tables is a strided view). Each shard's
    slice passes the single-shard checks."""
    S = x.shape[0] if x.ndim == 3 else -1
    if S < 1:
        raise ValueError(f"x must be (S, E, F), got {tuple(x.shape)}")
    for name, t in (("seg", seg), ("tile_of_block", tob),
                    ("first_of_tile", fot)):
        if t.ndim != 2 or t.shape[0] != S or t.stride(1) != 1:
            raise ValueError(f"{name} must be (S={S}, n) with a unit last "
                             f"stride, got {tuple(t.shape)} strides "
                             f"{t.stride()}")
    if tob.stride(0) != fot.stride(0):
        raise ValueError("tile_of_block and first_of_tile must share their "
                         "shard stride")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if active is None:
        _check(x[0], seg[0], tob[0], fot[0], n_rows, n_row_tiles, op)
    else:
        if active.ndim != 2 or active.shape[0] != S \
                or not active.is_contiguous():
            raise ValueError(f"active must be contiguous (S={S}, K), got "
                             f"{tuple(active.shape)}")
        _check_active(x[0], seg[0], tob[0], fot[0], active[0], n_rows,
                      n_row_tiles, op)


def _launch_stacked(x, seg, tob, fot, active, n_rows, n_row_tiles, op):
    S, F, n_blocks = x.shape[0], x.shape[2], tob.shape[1]
    sparse = active is not None
    grid = active.shape[1] if sparse else n_windows(n_blocks, F)
    with torch.cuda.device(x.device):
        out = torch.empty((S, n_row_tiles * R_BLK, F), dtype=torch.float32,
                          device=x.device)
        part = torch.empty((S * 2 * grid * R_BLK * F,), dtype=torch.float32,
                           device=x.device)
        flag = torch.empty((S * 2 * grid,), dtype=torch.int32,
                           device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        tail = (n_blocks, F, n_row_tiles, run_chunk(n_blocks, F), S,
                seg.stride(0), tob.stride(0), stream)
        if sparse:
            key = f"{op}_active_stacked"
            rc = _entry(key, _ACTIVE_STACKED_ARGTYPES)(
                x.data_ptr(), seg.data_ptr(), tob.data_ptr(), fot.data_ptr(),
                active.data_ptr(), grid, part.data_ptr(), flag.data_ptr(),
                out.data_ptr(), *tail)
        else:
            key = f"{op}_stacked"
            rc = _entry(key, _STACKED_ARGTYPES)(
                x.data_ptr(), seg.data_ptr(), tob.data_ptr(), fot.data_ptr(),
                part.data_ptr(), flag.data_ptr(), out.data_ptr(), *tail)
    if rc != 0:
        raise RuntimeError(f"segment_agg_{key} kernel launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES[key] += 1
    return out[:, :n_rows]


def segment_agg_level_stacked(x: torch.Tensor, seg: torch.Tensor,
                              tob: torch.Tensor, fot: torch.Tensor, *,
                              n_rows: int, n_row_tiles: int,
                              op: str = "sum") -> torch.Tensor:
    """``segment_agg_level`` over one level of S aligned shards at once:
    ``x`` (S, e_pad, F) float32, ``seg`` (S, e_pad), ``tob``/``fot``
    (S, n_blocks) int32 (a level of stacked (S, L, ...) tables, strided
    along the shard axis). Returns (S, n_rows, F); shard s equals
    ``segment_agg_level`` on shard s's slices, bit for bit. CUDA tensors
    launch the kernel's stacked entry (one launch for all S shards), CPU
    tensors run the plain version shard by shard."""
    _check_stacked(x, seg, tob, fot, n_rows, n_row_tiles, op)
    if x.device.type == "cpu":
        return segment_agg_level_stacked_ref(x, seg, n_rows, op)
    if x.device.type != "cuda":
        raise ValueError(f"segment_agg_level_stacked runs on cuda or cpu "
                         f"tensors, got {x.device}")
    return _launch_stacked(x, seg, tob, fot, None, n_rows, n_row_tiles, op)


def segment_agg_active_stacked(x: torch.Tensor, seg: torch.Tensor,
                               tob: torch.Tensor, fot: torch.Tensor,
                               active: torch.Tensor, *, n_rows: int,
                               n_row_tiles: int,
                               op: str = "sum") -> torch.Tensor:
    """``segment_agg_active`` over one level of S aligned shards at once:
    ``active`` (S, K) int32, each shard's ascending active blocks padded at
    the end with ``n_blocks`` to the widest shard's K; ``x`` (S, K*E_BLK,
    F). Returns (S, n_rows, F); shard s equals ``segment_agg_active`` on
    shard s's slices, bit for bit. CUDA tensors launch the kernel's stacked
    active entry, CPU tensors run the plain version shard by shard."""
    _check_stacked(x, seg, tob, fot, n_rows, n_row_tiles, op, active=active)
    if x.device.type == "cpu":
        return segment_agg_active_stacked_ref(x, seg, active, n_rows, op)
    if x.device.type != "cuda":
        raise ValueError(f"segment_agg_active_stacked runs on cuda or cpu "
                         f"tensors, got {x.device}")
    return _launch_stacked(x, seg, tob, fot, active, n_rows, n_row_tiles, op)
