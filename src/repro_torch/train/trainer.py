"""Training step builder: microbatched gradient accumulation, a global-norm
clip and the optimizer.

The JAX package's ``repro.train.trainer`` in PyTorch.
``make_train_step(loss_fn, optimizer, accum_steps=...)`` returns
``step(params, opt_state, batch, lr) -> (params, opt_state, metrics)``;
loss and gradients come from ``torch.autograd``. With ``accum_steps`` > 1
the batch is split on its leading axis into that many microbatches, one
forward and backward each, the gradients summed in the accumulation dtype
and divided at the end: peak activation memory is one microbatch's. The
loss is the mean over microbatches, the other metrics are the last
microbatch's. The optimizer updates ``params`` and ``opt_state`` in place
(``train.optimizer``), so the step returns the tensors it was given.

The JAX package's ``unroll_accum`` (unrolling XLA's scan over
microbatches) has no meaning without a compiler and is not taken.

Placed (``CellPlan.on_mesh``: DTensor parameters, optimizer state and a
batch-sharded batch) the step is the JAX package's partitioned one: the
microbatches are the JAX package's rows (``_split_placed``), every
gradient comes back on its parameter's placements, the norm is summed
over the ranks' shards and the optimizer updates each rank's local
shards.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.distributed.sharding import is_placed
from repro_torch.train.optimizer import Optimizer
from repro_torch.tree import tree_leaves, tree_unflatten


def _split_batch(batch: dict, n: int) -> list[dict]:
    def rows(x):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch {b} not divisible by accum {n}")
        return _split_placed(x, n) if is_placed(x) else x.split(b // n)

    parts = {k: rows(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def _split_placed(x, n: int) -> list:
    """A batch-sharded DTensor cut into ``n`` microbatches as the JAX
    package's ``reshape(n, B / n, ...)`` cuts it: microbatch i the global
    rows ``[i B / n, (i + 1) B / n)``, each sharded as ``x`` is. The rows
    are gathered over the batch's mesh dims once and each microbatch
    sliced from them (no gradient: the batch holds token ids)."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed.sharding import from_local, redistribute

    whole = redistribute(x, [Replicate() if p == Shard(0) else p
                             for p in x.placements])
    b = x.shape[0] // n
    return [redistribute(from_local(part, x.device_mesh, whole.placements,
                                    (b,) + tuple(x.shape[1:])),
                         x.placements)
            for part in whole.to_local().split(b)]


def value_and_grad(loss_fn, params, batch):
    """``loss_fn(params, batch) -> (loss, metrics)`` and the gradient of the
    loss in every floating leaf of ``params`` (zeros for a leaf the loss
    does not reach, as JAX gives). The leaves enter the graph as detached
    aliases, so the caller's tensors gather no ``.grad``. Returns (loss,
    metrics, grads) detached, grads in ``tree_leaves(params)`` order.

    Placed leaves (DTensors): each gradient comes back on its leaf's
    placements (a partial one summed: all-reduced, or reduce-scattered
    where the leaf is sharded), zeros a DTensor like the leaf; a placed
    loss or metric is returned gathered, a plain tensor."""
    from repro_torch.distributed.sharding import gathered, redistribute

    leaves = tree_leaves(params)
    req = [p.detach().requires_grad_(p.is_floating_point()) for p in leaves]
    loss, metrics = loss_fn(tree_unflatten(params, req), batch)
    wrt = [r for r in req if r.requires_grad]
    got = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
    grads = []
    for r in req:
        g = next(got) if r.requires_grad else None
        if g is None:
            g = torch.zeros_like(r)
        elif is_placed(g) and tuple(g.placements) != tuple(r.placements):
            with torch.no_grad():
                g = redistribute(g, r.placements)
        grads.append(g)
    metrics = {k: (gathered(v.detach()) if torch.is_tensor(v) else v)
               for k, v in metrics.items()}
    return gathered(loss.detach()), metrics, grads


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32, without a squared
    copy of any leaf. Placed leaves: each rank's local sums of squares,
    grouped by the mesh dims that shard the leaf, each group's sum
    all-reduced over those dims and the groups added in a fixed order, so
    the norm is a plain tensor with the same bits on every rank."""
    sq = [torch.linalg.vector_norm(
        g.to_local() if is_placed(g) else g, dtype=torch.float32).square()
        for g in grads]
    placed = [g for g in grads if is_placed(g)]
    if not placed:
        return torch.sqrt(sum(sq))
    from repro_torch.launch.mesh import all_reduce_raw

    groups: dict = {}
    for g, s in zip(grads, sq):
        key = tuple(i for i, p in enumerate(g.placements) if p.is_shard()) \
            if is_placed(g) else ()
        groups[key] = groups[key] + s if key in groups else s
    mesh = placed[0].device_mesh
    return torch.sqrt(sum(all_reduce_raw(groups[k], mesh, k)
                          for k in sorted(groups)))


def make_train_step(
    loss_fn: Callable[..., tuple[torch.Tensor, dict]],
    optimizer: Optimizer,
    *,
    accum_steps: int = 1,
    accum_dtype: torch.dtype | None = None,
    grad_transform: Callable[[Any, Any], tuple[Any, Any]] | None = None,
    clip_norm: float | None = 1.0,
):
    """loss_fn(params, microbatch) -> (loss, metrics dict of scalars).

    accum_dtype: the dtype gradients are summed in across microbatches.
    None -> each parameter's dtype (bf16 params accumulate in bf16, as in
    the JAX package); torch.float32 forces fp32 accumulation.
    clip_norm: the global gradient norm (fp32, over every leaf) is clipped
    to it, scale ``min(1, clip / max(norm, 1e-9))``, and reported as the
    metric ``grad_norm``; None skips the clip. As in the JAX package, the
    clipped gradients are fp32 (``g * scale`` promotes a bf16 gradient):
    the scale goes to the optimizer, which applies it to each slice it
    casts to fp32, so no fp32 copy of a bf16 gradient tree is held.
    grad_transform(grads, opt_state) -> (grads, opt_state) runs between
    the clip and the update, on the gradient tree; it sees the clipped
    fp32 gradients, each taken to fp32 and scaled leaf by leaf."""

    @torch.no_grad()
    def step(params, opt_state, batch, lr):
        if accum_steps == 1:
            with torch.enable_grad():
                loss, metrics, grads = value_and_grad(loss_fn, params, batch)
        else:
            grads, loss = None, 0.0
            for mb in _split_batch(batch, accum_steps):
                with torch.enable_grad():
                    l_mb, metrics, g = value_and_grad(loss_fn, params, mb)
                if grads is None:
                    grads = [x.to(accum_dtype or p.dtype) for x, p in
                             zip(g, tree_leaves(params))]
                else:
                    for a, x in zip(grads, g):
                        a.add_(x.to(a.dtype))
                del g
                loss = loss + l_mb.float()
            for a in grads:
                a.div_(accum_steps)
            loss = loss / accum_steps

        scale = None
        if clip_norm is not None:
            gnorm = global_norm(grads)
            scale = (clip_norm / gnorm.clamp_min(1e-9)).clamp_max(1.0)
            metrics = {**metrics, "grad_norm": gnorm}
            if grad_transform is not None:
                for i, g in enumerate(grads):
                    grads[i] = g.float().mul_(scale)   # in place if fp32
                scale = None

        grads = tree_unflatten(params, grads)
        if grad_transform is not None:
            grads, opt_state = grad_transform(grads, opt_state)
        params, opt_state = optimizer.update(grads, opt_state, params, lr,
                                             grad_scale=scale)
        return params, opt_state, {**metrics, "loss": loss}

    return step


def make_eval_step(loss_fn):
    @torch.no_grad()
    def step(params, batch):
        loss, metrics = loss_fn(params, batch)
        return {**metrics, "loss": loss}
    return step

