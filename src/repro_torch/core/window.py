"""Sliding windows over per-writer content streams (paper §2.1).

Tuple-based (last ``c`` updates) and time-based (last ``T`` time units)
windows, stored as fixed-capacity ring buffers so the whole writer state is
four dense tensors on one device:

  values (n_writers, cap)   raw written values (NaN-free; ``count`` masks)
  stamps (n_writers, cap)   arrival timestamps (time windows only)
  head   (n_writers,)       next write slot
  count  (n_writers,)       number of live entries (<= cap)

``window_pao`` evaluates the aggregate over each writer's current window —
used to (re)compute writer PAOs. Every scatter here writes unique indices or
reduces integers, so the results are the same from run to run on any device.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.aggregates import Aggregate
from repro_torch.device import resolve_device


class WindowState(NamedTuple):
    values: torch.Tensor   # (n_writers, cap[, value_dim]) fp32
    stamps: torch.Tensor   # (n_writers, cap) fp32
    head: torch.Tensor     # (n_writers,) int32
    count: torch.Tensor    # (n_writers,) int32


@dataclasses.dataclass(frozen=True)
class WindowSpec:
    kind: str = "tuple"      # 'tuple' | 'time'
    size: float = 1          # c for tuple windows, T for time windows
    capacity: int = 0        # ring capacity; defaults to c (tuple) / provided (time)
    value_dim: int = 1       # raw values per write: scalar (1) or vector (>1)

    @property
    def cap(self) -> int:
        if self.capacity:
            return int(self.capacity)
        if self.kind == "tuple":
            return max(1, int(self.size))
        raise ValueError("time windows need an explicit ring capacity")


def _vshape(cond: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Broadcast a (B,)-shaped condition against values with trailing dims."""
    return cond.reshape(cond.shape + (1,) * (like.ndim - cond.ndim))


def init_windows(n_writers: int, spec: WindowSpec,
                 device=None) -> WindowState:
    """Empty ring buffers for ``n_writers`` rows on ``device`` (CUDA unless
    the caller names another)."""
    device = resolve_device(device)
    cap = spec.cap
    vshape = (n_writers, cap) if spec.value_dim == 1 else (
        n_writers, cap, spec.value_dim)
    return WindowState(
        values=torch.zeros(vshape, dtype=torch.float32, device=device),
        stamps=torch.full((n_writers, cap), -torch.inf, dtype=torch.float32,
                          device=device),
        head=torch.zeros((n_writers,), dtype=torch.int32, device=device),
        count=torch.zeros((n_writers,), dtype=torch.int32, device=device),
    )


def apply_writes(
    state: WindowState,
    spec: WindowSpec,
    writer_rows: torch.Tensor,   # (B,) int rows into the window arrays
    values: torch.Tensor,        # (B,) or (B, value_dim) fp32
    stamps: torch.Tensor,        # (B,) fp32
    mask: torch.Tensor,          # (B,) bool — padding lanes are False
) -> tuple[WindowState, torch.Tensor, torch.Tensor]:
    """Vectorized batch append with event-at-a-time semantics.

    Sorts the batch by row (stable), computes each write's rank within its
    row group, and derives ring slots and evictions in closed form:

      slot_i     = (head[row] + rank_i) % cap
      evicted_i  = ring[row, slot_i]          if rank_i <  cap
                   in-batch value rank_i-cap  if rank_i >= cap  (wrapped)
      valid_i    = count[row] + rank_i >= cap
      final ring = scatter of lanes with rank >= k_row - cap

    The kept lanes of a row hold distinct slots, so the final scatter writes
    unique (row, slot) pairs; dropped lanes land on a sentinel row that is
    cut off. Returns ``(state, evicted, evicted_valid)`` in batch order.
    """
    cap = spec.cap
    dev = state.head.device
    B = writer_rows.shape[0]
    n_rows = state.values.shape[0]
    rows = writer_rows.to(torch.int64)
    vals_in = values.to(torch.float32)
    stamps_in = stamps.to(torch.float32)
    lanes = torch.arange(B, dtype=torch.int64, device=dev)

    key = torch.where(mask, rows, n_rows)          # masked lanes sort last
    order = torch.argsort(key, stable=True)
    r_s = key[order]
    v_s = vals_in[order]
    t_s = stamps_in[order]
    m_s = mask[order]

    start = torch.searchsorted(r_s, r_s, side="left")
    rank = lanes - start

    r_safe = torch.where(m_s, r_s, 0)
    head_r = state.head[r_safe].to(torch.int64)
    count_r = state.count[r_safe].to(torch.int64)
    slot = (head_r + rank) % cap

    # ------------------------------------------------------------ evictions
    ring_evict = state.values[r_safe, slot]
    wrapped = rank >= cap
    # in-batch predecessor (same row, rank - cap); index i - cap is in range
    prev_idx = torch.clamp(lanes - cap, min=0)
    batch_evict = v_s[prev_idx]
    evicted_s = torch.where(_vshape(wrapped, ring_evict), batch_evict,
                            ring_evict)
    evicted_valid_s = m_s & (count_r + rank >= cap)
    evicted_s = torch.where(_vshape(evicted_valid_s, evicted_s), evicted_s,
                            0.0)
    # back to original batch order
    inv = torch.empty_like(order)
    inv[order] = lanes
    evicted = evicted_s[inv]
    evicted_valid = evicted_valid_s[inv]

    # ------------------------------------------------------- final ring state
    k_row = torch.zeros(n_rows + 1, dtype=torch.int64, device=dev)
    k_row.scatter_reduce_(0, r_safe, torch.where(m_s, rank + 1, 0),
                          reduce="amax")           # integer max: order-free
    keep = m_s & (rank >= k_row[r_safe] - cap)     # last cap writes per row
    scatter_row = torch.where(keep, r_safe, n_rows)  # sentinel absorbs rest
    new_vals = torch.cat([state.values,
                          state.values.new_zeros((1,) + state.values.shape[1:])])
    new_stms = torch.cat([state.stamps,
                          state.stamps.new_full((1, cap), -torch.inf)])
    new_vals[scatter_row, slot] = v_s
    new_stms[scatter_row, slot] = t_s
    k_real = k_row[:n_rows]
    new_head = ((state.head.to(torch.int64) + k_real) % cap).to(torch.int32)
    new_count = torch.clamp(state.count.to(torch.int64) + k_real,
                            max=cap).to(torch.int32)
    return (WindowState(new_vals[:n_rows], new_stms[:n_rows], new_head,
                        new_count),
            evicted, evicted_valid)


def stale_rows(state: WindowState, spec: WindowSpec, prev_now, now
               ) -> torch.Tensor:
    """(n_writers,) bool — rows holding an entry that was inside the time
    window at ``prev_now`` but has expired by ``now``. The union of these
    rows with the written rows is exactly the set whose window aggregate can
    have changed between two evaluations."""
    if spec.kind != "time":
        return torch.zeros((state.stamps.shape[0],), dtype=torch.bool,
                           device=state.stamps.device)
    f32 = dict(dtype=torch.float32, device=state.stamps.device)
    lo = torch.as_tensor(prev_now, **f32) - spec.size
    hi = torch.as_tensor(now, **f32) - spec.size
    return ((state.stamps >= lo) & (state.stamps < hi)).any(dim=1)


def pad_window_rows(state: WindowState, n_rows: int) -> WindowState:
    """Resize the window arrays to ``n_rows`` writer rows. Existing rows keep
    their ids, new rows start empty, and shrinking only ever drops
    never-written padding rows."""
    cur = state.values.shape[0]
    if cur == n_rows:
        return state
    if cur > n_rows:
        return WindowState(*(x[:n_rows] for x in state))
    pad = n_rows - cur
    return WindowState(
        values=torch.cat([state.values, state.values.new_zeros(
            (pad,) + state.values.shape[1:])]),
        stamps=torch.cat([state.stamps, state.stamps.new_full(
            (pad,) + state.stamps.shape[1:], -torch.inf)]),
        head=torch.cat([state.head, state.head.new_zeros((pad,))]),
        count=torch.cat([state.count, state.count.new_zeros((pad,))]),
    )


def reset_window_rows(state: WindowState, rows) -> WindowState:
    """Zero the given writer rows (retired writers: their content leaves every
    window immediately, per §3.3 node deletion). Returns new tensors."""
    idx = torch.as_tensor(rows, dtype=torch.int64, device=state.head.device)
    values, stamps = state.values.clone(), state.stamps.clone()
    head, count = state.head.clone(), state.count.clone()
    values[idx] = 0.0
    stamps[idx] = -torch.inf
    head[idx] = 0
    count[idx] = 0
    return WindowState(values, stamps, head, count)


def live_mask(state: WindowState, spec: WindowSpec, now) -> torch.Tensor:
    """(n_writers, cap) bool — which ring slots are inside the window."""
    cap = spec.cap
    slot = torch.arange(cap, dtype=torch.int32,
                        device=state.head.device)[None, :]
    # slot age: 0 = most recent. head points at the *next* slot to write.
    age = (state.head[:, None] - 1 - slot) % cap
    occupied = age < state.count[:, None]
    if spec.kind == "tuple":
        return occupied & (age < int(spec.size))
    lo = torch.as_tensor(now, dtype=torch.float32,
                         device=state.stamps.device) - spec.size
    return occupied & (state.stamps >= lo)


def window_pao(state: WindowState, spec: WindowSpec, agg: Aggregate,
               now=0.0) -> torch.Tensor:
    """Evaluate ``agg`` over every writer's current window -> (n_writers, pao_dim)."""
    m = live_mask(state, spec, now)
    n, cap = state.values.shape[:2]
    raw = state.values.reshape(n * cap, -1)
    if raw.shape[1] == 1:
        raw = raw[:, 0]  # scalar aggregates keep their (B,) lift contract
    lifted = agg.lift(raw).reshape(n, cap, agg.pao_dim)
    lifted = torch.where(m[:, :, None], lifted, agg.identity)
    if agg.combine == "sum":
        return lifted.sum(dim=1)
    return lifted.amax(dim=1) if agg.combine == "max" else lifted.amin(dim=1)


# ----------------------------------------------------------------- shard axis
# A stacked engine keeps every shard's window state in one WindowState with a
# leading shard axis: values (S, n_writers, cap[, value_dim]), etc. The
# helpers above work on axis 0 = writer rows, so the stacked step bodies run
# them on the (S * n_writers, ...) view of the stack.
def window_state_to_host(state: WindowState) -> dict:
    """One window state as a ``{field: numpy}`` dict (the checkpoint codec):
    values travel verbatim, ring heads and partial occupancy included."""
    from repro_torch.core.engine import to_host

    return dict(zip(WindowState._fields, to_host(*state)))


def window_state_from_host(arrs: dict, device=None) -> WindowState:
    """The inverse of :func:`window_state_to_host`, on ``device`` (CUDA
    unless the caller names another); fields keep the JAX package's dtypes
    (values/stamps fp32, head/count int32)."""
    device = resolve_device(device)
    dtypes = (torch.float32, torch.float32, torch.int32, torch.int32)
    return WindowState(*(
        torch.as_tensor(np.ascontiguousarray(arrs[f]), device=device)
        .to(dt) for f, dt in zip(WindowState._fields, dtypes)))


def take_window_rows(arrs: dict, rows) -> dict:
    """Host-side row gather of a window snapshot: output row i is input row
    ``rows[i]``, or an empty ring for ``rows[i] < 0`` (a padding or fresh
    writer row). The reshard primitive: write replication keeps a writer's
    ring identical on every shard that owns it, so any layout reassembles
    into any other by base id."""
    idx = np.asarray(rows, np.int64).reshape(-1)
    live = idx >= 0
    out = {}
    for f in WindowState._fields:
        src = np.asarray(arrs[f])
        fill = -np.inf if f == "stamps" else 0
        dst = np.full((len(idx),) + src.shape[1:], fill, src.dtype)
        dst[live] = src[idx[live]]
        out[f] = dst
    return out


def stack_windows(states: list[WindowState]) -> WindowState:
    """Stack aligned per-shard window states along a new leading axis."""
    shapes = {tuple(tuple(x.shape) for x in s) for s in states}
    if len(shapes) != 1:
        raise ValueError(f"cannot stack misaligned window states: {shapes}")
    return WindowState(*[torch.stack(xs) for xs in zip(*states)])


def window_shard(state: WindowState, s: int) -> WindowState:
    """One shard's slice of a stacked window state (views, no copy)."""
    return WindowState(*[x[s] for x in state])


def place_window_shard(state: WindowState, s: int,
                       sub: WindowState) -> WindowState:
    """Write one shard's window state into the stack, in place; returns the
    stack."""
    for st, x in zip(state, sub):
        st[s].copy_(x)
    return state


def flat_windows(state: WindowState) -> WindowState:
    """A stacked (S, n_writers, ...) window state as one (S * n_writers, ...)
    state of views: the stacked steps run the single-engine window helpers
    on it, shard s owning rows [s * n_writers, (s + 1) * n_writers)."""
    return WindowState(*[x.reshape((-1,) + tuple(x.shape[2:]))
                         for x in state])


def unflat_windows(state: WindowState, n_shards: int) -> WindowState:
    return WindowState(*[x.reshape((n_shards, -1) + tuple(x.shape[1:]))
                         for x in state])
