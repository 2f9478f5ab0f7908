"""Plain PyTorch version of sorted-segment aggregation.

The wrapper in ``ops.py`` runs these for CPU tensors; on the card they are
only the yardstick the CUDA kernel is compared with.
"""
from __future__ import annotations

import torch

NEG = -3.0e38  # the kernel's max identity


def segment_agg_ref(x: torch.Tensor, seg: torch.Tensor, n_rows: int,
                    op: str = "sum") -> torch.Tensor:
    """x: (E, F) edge values; seg: (E,) destination rows (entries < 0 are
    padding and contribute nothing). Returns (n_rows, F) fp32; rows with no
    edges are 0 for both ops."""
    out = segment_agg_level_ref(x, seg, n_rows, op)
    if op == "max":
        hit = torch.zeros(n_rows + 1, dtype=torch.bool, device=x.device)
        hit[torch.where(seg >= 0, seg.long(), n_rows)] = True
        out = torch.where(hit[:n_rows, None], out, 0.0)
    return out


def segment_agg_level_ref(x: torch.Tensor, seg: torch.Tensor, n_rows: int,
                          op: str = "sum") -> torch.Tensor:
    """One level's reduce-by-destination in fp32: every row starts at the
    op's identity (0 for sum, -3e38 for max), ``seg == -1`` slots go to a
    sentinel row that is cut off. Returns (n_rows, F)."""
    if op not in ("sum", "max"):
        raise ValueError(f"unknown op {op!r}; choose 'sum' or 'max'")
    x = x.to(torch.float32)
    if x.ndim == 1:
        x = x[:, None]
    F = x.shape[1]
    init = 0.0 if op == "sum" else NEG
    out = torch.full((n_rows + 1, F), init, dtype=torch.float32,
                     device=x.device)
    dst = torch.where(seg >= 0, seg.long(), n_rows)
    out.scatter_reduce_(0, dst[:, None].expand(-1, F), x,
                        reduce="sum" if op == "sum" else "amax")
    return out[:n_rows]


def segment_agg_active_ref(x: torch.Tensor, seg: torch.Tensor,
                           active: torch.Tensor, n_rows: int,
                           op: str = "sum") -> torch.Tensor:
    """One level's reduce over its active blocks: ``x`` (K*256, F) holds
    the values of the blocks ``active`` (K,) names, in that order (entries
    past the level's block count are padding: their slots are dropped);
    ``seg`` is the whole level's. Each row adds its active slots in slot
    order from the op's identity, which on the rows an active block routes
    to is bit-equal to ``segment_agg_level_ref`` with every other block's
    values set to the identity. Returns (n_rows, F)."""
    E_BLK = 256
    nb = seg.shape[0] // E_BLK
    a = active.long()
    seg_c = seg.reshape(nb, E_BLK)[torch.clamp(a, max=nb - 1)]
    seg_c = torch.where((a < nb)[:, None], seg_c, -1).reshape(-1)
    return segment_agg_level_ref(x, seg_c, n_rows, op)
