"""Plain PyTorch version of sorted-segment aggregation.

The wrapper in ``ops.py`` runs these for CPU tensors; on the card they are
only the yardstick the CUDA kernel is compared with.

The fused versions take ``bf16``: each slot's edge value (``val[src] *
sign`` for sum, ``val[src]`` for max and min) is rounded to bfloat16, to
nearest even, before its row reduces it in fp32, as the JAX package's
``EAGR_SEGAGG_BF16`` mode does (``_round_bf16``).
"""
from __future__ import annotations

import torch

NEG = -3.0e38  # the kernel's max identity


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to bfloat16 (to nearest even) and back."""
    return x.to(torch.bfloat16).to(torch.float32)


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


def segment_agg_active_ref(val: torch.Tensor, seg: torch.Tensor,
                           src: torch.Tensor, sign: torch.Tensor,
                           active: torch.Tensor, n_rows: int,
                           op: str = "sum", bf16: bool = False):
    """One frontier-sparse level, fused: over the blocks ``active`` (K,)
    names (entries past the level's block count are padding, their slots
    dropped), gather each slot's values ``val[src]`` (n_val, F), times
    ``sign`` for sum, negated for min, and reduce them by ``seg``; ``seg``,
    ``src`` and ``sign`` are the whole level's (e_pad,). Each row adds its
    active slots in slot order from the op's identity, which on the rows an
    active block routes to is bit-equal to ``segment_agg_level_ref`` over
    the level's gathered values with every other block's set to the
    identity; min is ``-max(-x)``. Returns ``(out (n_rows, F), hit
    (n_rows,) bool)``, ``hit`` the rows with an active live slot."""
    if op not in ("sum", "max", "min"):
        raise ValueError(f"unknown op {op!r}; choose 'sum', 'max' or 'min'")
    E_BLK = 256
    nb = seg.shape[0] // E_BLK
    a = active.long()
    ab = torch.clamp(a, max=nb - 1)
    seg_c = torch.where((a < nb)[:, None], seg.view(nb, E_BLK)[ab],
                        -1).reshape(-1)
    x = val.index_select(0, src.view(nb, E_BLK)[ab].reshape(-1).long())
    if op == "sum":
        x = x * sign.view(nb, E_BLK)[ab].reshape(-1)[:, None]
    if bf16:
        x = _round_bf16(x)
    if op == "min":
        x = -x
    out = segment_agg_level_ref(x, seg_c, n_rows,
                                "sum" if op == "sum" else "max")
    hit = torch.zeros(n_rows + 1, dtype=torch.bool, device=val.device)
    hit.index_fill_(0, torch.where(seg_c >= 0, seg_c.long(), n_rows), True)
    return (-out if op == "min" else out), hit[:n_rows]


def segment_agg_level_stacked_ref(val: torch.Tensor, seg: torch.Tensor,
                                  src: torch.Tensor, sign: torch.Tensor,
                                  n_rows: int, op: str = "sum",
                                  bf16: bool = False) -> torch.Tensor:
    """One dense level of S shards, shard by shard: gather each slot's
    values ``val[s][src[s]]`` (val (S, n_val, F)), times ``sign[s]`` for
    sum, negated for min, then ``segment_agg_level_ref`` by ``seg[s]``
    (seg, src and sign (S, e_pad)); min is ``-max(-x)``; ``bf16`` rounds
    each slot's value as ``segment_agg_active_ref`` does. Returns
    (S, n_rows, F)."""
    if op not in ("sum", "max", "min"):
        raise ValueError(f"unknown op {op!r}; choose 'sum', 'max' or 'min'")
    outs = []
    for s in range(val.shape[0]):
        x = val[s].index_select(0, src[s].long())
        if op == "sum":
            x = x * sign[s][:, None]
        if bf16:
            x = _round_bf16(x)
        if op == "min":
            x = -x
        out = segment_agg_level_ref(x, seg[s], n_rows,
                                    "sum" if op == "sum" else "max")
        outs.append(-out if op == "min" else out)
    return torch.stack(outs)


def segment_agg_active_stacked_ref(val: torch.Tensor, seg: torch.Tensor,
                                   src: torch.Tensor, sign: torch.Tensor,
                                   active: torch.Tensor, n_rows: int,
                                   op: str = "sum", bf16: bool = False):
    """``segment_agg_active_ref`` shard by shard: val (S, n_val, F), seg,
    src and sign (S, e_pad), active (S, K). Returns ``(out (S, n_rows, F),
    hit (S, n_rows))``."""
    outs, hits = zip(*(
        segment_agg_active_ref(val[s], seg[s], src[s], sign[s], active[s],
                               n_rows, op, bf16)
        for s in range(val.shape[0])))
    return torch.stack(outs), torch.stack(hits)


def segment_agg_graph_ref(val: torch.Tensor, index: torch.Tensor,
                          live: torch.Tensor | None, n_rows: int,
                          op: str = "sum") -> torch.Tensor:
    """The graph entry's function, plainly: ``out[r]`` the sum or max of
    ``val[e]`` (val (E, F) float32) over the edges e with ``index[e] == r``
    and ``live[e]`` (every edge when ``live`` is None), in edge order; rows
    with no such edge read 0. Returns (n_rows, F), in float64 for float64
    values."""
    if op not in ("sum", "max"):
        raise ValueError(f"unknown op {op!r}; choose 'sum' or 'max'")
    idx = index.long()
    x = val if val.dtype == torch.float64 else val.to(torch.float32)
    if live is not None:
        keep = live.nonzero()[:, 0]
        idx, x = idx[keep], x[keep]
    F = x.shape[1]
    out = torch.full((n_rows, F), 0.0 if op == "sum" else NEG,
                     dtype=x.dtype, device=val.device)
    out.scatter_reduce_(0, idx[:, None].expand(-1, F), x,
                        reduce="sum" if op == "sum" else "amax")
    if op == "sum":
        return out
    hit = torch.zeros(n_rows, dtype=torch.bool, device=val.device)
    hit.index_fill_(0, idx, True)
    return torch.where(hit[:, None], out, 0.0)
