"""The checked wrappers of the EmbeddingBag CUDA kernels.

``embedding_bag`` takes the torch-style calling convention of the JAX
package's ``ops.embedding_bag``: a flat id list, one start offset per bag
(the last bag ends at the list's end), optional per-id weights; negative ids
are padding and an empty bag gives zeros. It is differentiable in the table
(a ``torch.autograd.Function``): its backward is ``embedding_bag_backward``,
the dense table gradient. CUDA tensors launch the hand-written kernels in
``csrc/embedding_bag.cu`` (or raise), CPU tensors run the plain versions in
``ref.py``, forward and backward; any other device raises. The ids and the
weights get no gradient: weights that require one raise. ``LAUNCHES``
counts kernel launches, so a run can show that its path went through the
kernels; ``WORK`` counts each call's operations and bytes (``bag_cost``,
``bag_backward_cost``) on either path while ``cost.counting()`` is on.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.cost import Work, WorkCounter, counted
from repro_torch.kernels.embedding_bag.ref import (
    bags_of,
    embedding_bag_backward_ref,
    embedding_bag_ref,
)

# kernel launches since the last reset (the CPU path never counts)
LAUNCHES = {"embedding_bag": 0, "embedding_bag_backward": 0}
# each call's work, on either path (cost.py)
WORK = WorkCounter(LAUNCHES)


def reset_launches() -> None:
    """Zero ``LAUNCHES`` and ``WORK``."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    WORK.reset()


def bag_cost(n_live: int, n_ids: int, n_bags: int, D: int,
             weighted: bool) -> Work:
    """One forward call: each of ``n_live`` live ids' table rows read once,
    the ids, offsets and weights read once, the (n_bags, D) output written
    once; a multiply and an add per live id and feature (fp32)."""
    nbytes = n_live * D * 4 + n_ids * (8 if weighted else 4) + n_bags * 4 \
        + n_bags * D * 4
    return Work(2 * D * n_live, nbytes)


def bag_backward_cost(n_live: int, n_ids: int, n_bags: int, V: int, D: int,
                      weighted: bool) -> Work:
    """One backward call: the dense (V, D) fp32 gradient written once;
    grad_out, the ids, the offsets and the weights read once; a multiply
    and an add per live id and feature (fp32)."""
    nbytes = V * D * 4 + n_bags * D * 4 + n_ids * (8 if weighted else 4) \
        + n_bags * 4
    return Work(2 * D * n_live, nbytes)


_ENTRIES: dict = {}
# argument types of each C entry: pointers, then ints, then the stream
_ARGTYPES = {
    "embedding_bag_f32": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
    + [ctypes.c_void_p],
    "embedding_bag_backward_f32": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
    + [ctypes.c_void_p],
}


def _entry(name: str = "embedding_bag_f32"):
    if name not in _ENTRIES:
        from repro_torch.kernels import _build

        fn = getattr(_build.library("embedding_bag"), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _ENTRIES[name] = fn
    return _ENTRIES[name]


def _index(name: str, t: torch.Tensor, dev) -> torch.Tensor:
    if t.ndim != 1 or t.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{name} must be a 1-D int32 or int64 tensor, got "
                        f"{t.dtype} {tuple(t.shape)}")
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, table on {dev}")
    if t.numel() >= 2 ** 31:
        raise ValueError(f"{name} has {t.numel()} entries; the kernel "
                         f"indexes with int32")
    return t.to(torch.int32).contiguous()


def _checked(table, ids, offsets, n_bags, weights):
    """The forward's arguments checked as the kernel takes them: ids and
    offsets as int32, weights contiguous."""
    if table.dtype != torch.float32 or table.ndim != 2:
        raise TypeError(f"table must be a 2-D float32 tensor, got "
                        f"{table.dtype} {tuple(table.shape)}")
    dev = table.device
    ids = _index("ids", ids, dev)
    offsets = _index("offsets", offsets, dev)
    if offsets.shape[0] != n_bags:
        raise ValueError(f"offsets has {offsets.shape[0]} entries for "
                         f"n_bags={n_bags}")
    if weights is not None:
        if weights.dtype != torch.float32 or weights.shape != ids.shape:
            raise TypeError(f"weights must be float32 of shape "
                            f"{tuple(ids.shape)}, got {weights.dtype} "
                            f"{tuple(weights.shape)}")
        if weights.device != dev:
            raise ValueError(f"weights is on {weights.device}, table on {dev}")
        if weights.requires_grad and torch.is_grad_enabled():
            raise ValueError("embedding_bag gives no gradient to its weights; "
                             "pass them detached")
        weights = weights.contiguous()
    if table.shape[0] >= 2 ** 31 or table.shape[1] >= 2 ** 31:
        raise ValueError(f"table {tuple(table.shape)} is too large for the "
                         f"kernel's int32 sizes")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"embedding_bag runs on cuda or cpu tensors, got "
                         f"{dev}")
    return ids, offsets, weights


def _forward(table, ids, offsets, n_bags, weights):
    # the wrapper reads no id back to the host: it counts every id as live
    n = ids.shape[0]
    return counted(WORK, lambda: ("embedding_bag", bag_cost(
        n, n, n_bags, table.shape[1], weights is not None)),
        _forward_body, table, ids, offsets, n_bags, weights)


def _forward_body(table, ids, offsets, n_bags, weights):
    if table.device.type == "cpu":
        return embedding_bag_ref(table, ids, bags_of(offsets, ids.shape[0]),
                                 n_bags, weights=weights)
    dev = table.device
    table = table.contiguous()
    V, D = table.shape
    with torch.cuda.device(dev):
        out = torch.empty((n_bags, D), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _entry()(table.data_ptr(), ids.data_ptr(), offsets.data_ptr(),
                      None if weights is None else weights.data_ptr(),
                      out.data_ptr(), V, D, ids.shape[0], n_bags, stream)
    if rc != 0:
        raise RuntimeError(f"embedding_bag kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES["embedding_bag"] += 1
    return out


class _EmbeddingBag(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient in the
    table (the ids, offsets and weights get none)."""

    @staticmethod
    def forward(ctx, table, ids, offsets, weights, n_bags):
        ctx.save_for_backward(ids, offsets, weights)
        ctx.n_rows = table.shape[0]
        return _forward(table, ids, offsets, n_bags, weights)

    @staticmethod
    def backward(ctx, grad_out):
        ids, offsets, weights = ctx.saved_tensors
        grad = embedding_bag_backward(grad_out, ids, offsets,
                                      n_rows=ctx.n_rows, weights=weights) \
            if ctx.needs_input_grad[0] else None
        return grad, None, None, None, None


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  offsets: torch.Tensor, *, n_bags: int,
                  weights: torch.Tensor | None = None) -> torch.Tensor:
    """Sum-mode EmbeddingBag: ``out[b] = sum_{i in bag b} w_i *
    table[ids[i]]``. ``table`` (V, D) float32, ``ids`` (n_ids,) int,
    ``offsets`` (n_bags,) int non-decreasing, ``weights`` (n_ids,) float32 or
    None. Returns (n_bags, D) float32, differentiable in ``table``."""
    ids, offsets, weights = _checked(table, ids, offsets, n_bags, weights)
    return _EmbeddingBag.apply(table, ids, offsets, weights, n_bags)


def embedding_bag_backward(grad_out: torch.Tensor, ids: torch.Tensor,
                           offsets: torch.Tensor, *, n_rows: int,
                           weights: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """The table gradient of :func:`embedding_bag`: ``grad_table[v] =
    sum_{i : ids[i] = v} w_i * grad_out[bag(i)]``, dense (n_rows, D)
    float32 (every row written, zeros where no id points). ``grad_out``
    (n_bags, D) float32; ids, offsets and weights as the forward took them;
    ids outside [0, n_rows) are dropped. On CUDA the wrapper sorts the ids
    stably by row (preparation) and one launch of the backward kernel sums
    each row's run in id order, without atomics."""
    if grad_out.dtype != torch.float32 or grad_out.ndim != 2:
        raise TypeError(f"grad_out must be a 2-D float32 tensor, got "
                        f"{grad_out.dtype} {tuple(grad_out.shape)}")
    dev = grad_out.device
    n_bags, D = grad_out.shape
    ids = _index("ids", ids, dev)
    offsets = _index("offsets", offsets, dev)
    if offsets.shape[0] != n_bags:
        raise ValueError(f"offsets has {offsets.shape[0]} entries for "
                         f"{n_bags} bags of grad_out")
    if weights is not None:
        if weights.dtype != torch.float32 or weights.shape != ids.shape \
                or weights.device != dev:
            raise TypeError(f"weights must be float32 of shape "
                            f"{tuple(ids.shape)} on {dev}")
        weights = weights.detach().contiguous()
    if not 0 <= n_rows < 2 ** 31:
        raise ValueError(f"n_rows={n_rows} outside the kernel's int32 sizes")
    n = ids.shape[0]
    return counted(WORK, lambda: ("embedding_bag_backward", bag_backward_cost(
        n, n, n_bags, n_rows, D, weights is not None)),
        _backward, grad_out, ids, offsets, n_rows, weights)


def _backward(grad_out, ids, offsets, n_rows, weights):
    dev = grad_out.device
    n_bags, D = grad_out.shape
    bags = bags_of(offsets, ids.shape[0])
    if dev.type == "cpu":
        return embedding_bag_backward_ref(grad_out, ids, bags, n_rows,
                                          weights=weights)
    if dev.type != "cuda":
        raise ValueError(f"embedding_bag_backward runs on cuda or cpu "
                         f"tensors, got {dev}")
    grad_out = grad_out.contiguous()
    with torch.cuda.device(dev):
        # preparation: each id keyed by its row (n_rows for a dropped one),
        # sorted stably, and each row's run in the sorted keys
        valid = (ids >= 0) & (ids < n_rows) & (bags >= 0) & (bags < n_bags)
        keys = torch.where(valid, ids, n_rows)
        keys, perm = torch.sort(keys, stable=True)
        run_start = torch.searchsorted(
            keys, torch.arange(n_rows + 1, dtype=torch.int32, device=dev),
            out_int32=True)
        perm = perm.to(torch.int32)
        bags = bags.to(torch.int32)
        grad = torch.empty((n_rows, D), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _entry("embedding_bag_backward_f32")(
            grad_out.data_ptr(), perm.data_ptr(), bags.data_ptr(),
            None if weights is None else weights.data_ptr(),
            run_start.data_ptr(), grad.data_ptr(), n_rows, D, stream)
    if rc != 0:
        raise RuntimeError(f"embedding_bag_backward kernel launch failed: "
                           f"CUDA error {rc}")
    LAUNCHES["embedding_bag_backward"] += 1
    return grad
