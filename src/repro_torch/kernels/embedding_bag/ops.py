"""The checked wrapper of the EmbeddingBag CUDA kernel.

``embedding_bag`` takes the torch-style calling convention of the JAX
package's ``ops.embedding_bag``: a flat id list, one start offset per bag
(the last bag ends at the list's end), optional per-id weights; negative ids
are padding and an empty bag gives zeros. CUDA tensors launch the
hand-written kernel in ``csrc/embedding_bag.cu`` (or raise), CPU tensors run
the plain version in ``ref.py``; any other device raises. ``LAUNCHES``
counts kernel launches, so a run can show that its path went through the
kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.embedding_bag.ref import bags_of, embedding_bag_ref

# kernel launches since the last reset (the CPU path never counts)
LAUNCHES = {"embedding_bag": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_ENTRY = []


def _entry():
    if not _ENTRY:
        from repro_torch.kernels import _build

        fn = _build.library("embedding_bag").embedding_bag_f32
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _ENTRY.append(fn)
    return _ENTRY[0]


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


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  offsets: torch.Tensor, *, n_bags: int,
                  weights: torch.Tensor | None = None) -> torch.Tensor:
    """Sum-mode EmbeddingBag: ``out[b] = sum_{i in bag b} w_i *
    table[ids[i]]``. ``table`` (V, D) float32, ``ids`` (n_ids,) int,
    ``offsets`` (n_bags,) int non-decreasing, ``weights`` (n_ids,) float32 or
    None. Returns (n_bags, D) float32."""
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
        weights = weights.contiguous()
    if table.shape[0] >= 2 ** 31 or table.shape[1] >= 2 ** 31:
        raise ValueError(f"table {tuple(table.shape)} is too large for the "
                         f"kernel's int32 sizes")
    if dev.type == "cpu":
        return embedding_bag_ref(table, ids, bags_of(offsets, ids.shape[0]),
                                 n_bags, weights=weights)
    if dev.type != "cuda":
        raise ValueError(f"embedding_bag runs on cuda or cpu tensors, got "
                         f"{dev}")
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
