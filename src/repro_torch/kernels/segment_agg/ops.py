"""Plan builders and the checked wrapper for the segment_agg CUDA kernel.

The kernel requires edges sorted by destination and padded so no E_BLK edge
block straddles an R_BLK row tile. For static graph structure (EAGr overlay
levels) that plan is built once on the host (``make_plan``) and reused every
step; only the edge *values* are runtime data. The builders are numpy and
produce tables bit-equal to the JAX package's (same E_BLK / R_BLK).

``segment_agg_level`` is the one entry point the engine calls per level. It
picks the implementation by the tensors' device: CUDA tensors launch the
hand-written kernel in ``csrc/segment_agg.cu`` (or raise), CPU tensors run
the plain PyTorch version in ``ref.py``. ``LAUNCHES`` counts kernel launches
per op, so a run can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from repro_torch.kernels.segment_agg.ref import segment_agg_level_ref

E_BLK = 256     # edges per block
R_BLK = 128     # output rows per tile

# kernel launches per op since the last reset (plain Python ints; the CPU
# path never counts)
LAUNCHES = {"sum": 0, "max": 0}


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

    tile = seg[order] // R_BLK
    slots = []
    seg_chunks = []
    tob, fot = [], []
    e_cursor = 0
    for t in range(n_row_tiles):
        idx = order[tile == t]
        if idx.size == 0:
            continue
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
    for t in range(n_row_tiles):
        hit = np.flatnonzero(tob_row == t)
        if hit.size:
            out[t, 0] = hit[0] * E_BLK
            out[t, 1] = (hit[-1] + 1) * E_BLK
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
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


_ENTRIES: dict = {}


def _entry(op: str):
    fn = _ENTRIES.get(op)
    if fn is None:
        from repro_torch.kernels import _build

        fn = getattr(_build.library("segment_agg"), f"segment_agg_{op}_f32")
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _ENTRIES[op] = fn
    return fn


def _check(x, seg, tob, fot, n_rows, n_row_tiles, op) -> None:
    if op not in ("sum", "max"):
        raise ValueError(f"unknown op {op!r}; choose 'sum' or 'max'")
    if x.dtype != torch.float32:
        raise TypeError(f"segment_agg_level takes float32 edge values, got "
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
            or seg.shape[0] != x.shape[0] or fot.shape[0] != n_blocks:
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, seg {tuple(seg.shape)}, "
            f"{n_blocks} blocks of {E_BLK} slots, fot {tuple(fot.shape)}")
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
        live = torch.empty((n_blocks,), dtype=torch.int32, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _entry(op)(x.data_ptr(), seg.data_ptr(), tob.data_ptr(),
                        fot.data_ptr(), live.data_ptr(), out.data_ptr(),
                        n_blocks, F, n_row_tiles, stream)
    if rc != 0:
        raise RuntimeError(f"segment_agg_{op} kernel launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES[op] += 1
    return out[:n_rows]
