"""Plain PyTorch versions of the EmbeddingBag kernels: the forward, gather
plus weighted segment sum, as the JAX package's ``embedding_bag_ref``
computes it; and its backward, the dense table gradient, as JAX's gradient
of ``jnp.take`` computes it.

Ids outside ``[0, V)`` are padding (the JAX package names negative ids so;
the kernel skips ids past the table too, and so does this version, so that
both define every input). The wrapper in ``ops.py`` runs it for CPU tensors;
on the card it is the kernel's comparison.
"""
from __future__ import annotations

import torch


def bags_of(offsets: torch.Tensor, n_ids: int) -> torch.Tensor:
    """Bag index of every id position under torch-style start ``offsets``:
    the last bag whose offset is at or before the position (-1 before the
    first), as the JAX wrapper's ``searchsorted(..., side="right") - 1``."""
    pos = torch.arange(n_ids, device=offsets.device, dtype=offsets.dtype)
    return torch.searchsorted(offsets, pos, right=True) - 1


def embedding_bag_ref(table: torch.Tensor, ids: torch.Tensor,
                      bags: torch.Tensor, n_bags: int,
                      weights: torch.Tensor | None = None) -> torch.Tensor:
    """out[b] = sum over ids i of bag b of w_i * table[ids_i], fp32.
    ``bags`` (n_ids,) is each id's bag; ids outside [0, V) and bags outside
    [0, n_bags) are dropped. Returns (n_bags, D) float32. Memory is linear
    in the number of ids, whatever the bag sizes."""
    V, D = table.shape
    valid = (ids >= 0) & (ids < V) & (bags >= 0) & (bags < n_bags)
    keep = torch.nonzero(valid).flatten()
    rows = table.float().index_select(0, ids[keep].long())
    if weights is not None:
        rows = rows * weights.float()[keep, None]
    out = torch.zeros((n_bags, D), dtype=torch.float32, device=table.device)
    return out.index_add_(0, bags[keep].long(), rows)


def embedding_bag_backward_ref(grad_out: torch.Tensor, ids: torch.Tensor,
                               bags: torch.Tensor, n_rows: int,
                               weights: torch.Tensor | None = None
                               ) -> torch.Tensor:
    """The gradient of :func:`embedding_bag_ref` with respect to its table:
    grad_table[v] = sum over ids i = v of w_i * grad_out[bags_i], fp32,
    dense (n_rows, D). ``grad_out`` (n_bags, D); ids outside [0, n_rows)
    and bags outside [0, n_bags) are dropped. Each product is rounded, then
    the rows are added in id order (``index_add_`` on the CPU adds in index
    order), the kernel's order."""
    n_bags, D = grad_out.shape
    valid = (ids >= 0) & (ids < n_rows) & (bags >= 0) & (bags < n_bags)
    keep = torch.nonzero(valid).flatten()
    rows = grad_out.float().index_select(0, bags[keep].long())
    if weights is not None:
        rows = rows * weights.float()[keep, None]
    out = torch.zeros((n_rows, D), dtype=torch.float32,
                      device=grad_out.device)
    return out.index_add_(0, ids[keep].long(), rows)
