"""Optimizers for the port's training path: AdamW, Adafactor, SGD.

The JAX package's ``repro.train.optimizer`` in PyTorch. Each optimizer is
an (init, update) pair over a parameter tree (nested dicts of tensors):

  init(params)                         -> opt_state
  update(grads, opt_state, params, lr, grad_scale=None)
                                       -> (params, opt_state)

with the JAX package's states (``AdamState(mu, nu, count)``,
``FactorState(vr, vc, count)``, SGD's tree of momenta), defaults and
arithmetic, each rounding where JAX rounds. Unlike JAX, ``update`` writes
the parameters and the state in place and returns the same tensors: a
state the caller must keep is the caller's to copy. The step count is a
0-d int32 tensor on the parameters' device, so an update never reads back
to the host; ``lr`` is a float or a 0-d tensor. ``grad_scale`` (a 0-d
fp32 tensor, the trainer's clip) multiplies each gradient slice after its
cast to fp32 (an fp32 gradient in place), where the JAX package's
``grads * scale`` promotes a bf16 gradient to fp32 before the update
sees it.

Placed parameters (DTensors, ``CellPlan.on_mesh``): every update runs on
each rank's local shards of the parameters, gradients and state, in
place. AdamW and SGD are elementwise, so a shard's update is one
device's on the same entries. Adafactor's statistics over a dim the mesh
shards (the row and column means of ``g^2``, the mean of the row
moments, the update's RMS for the relative-step clip) are each rank's
local sums all-reduced over the mesh dims that shard that dim
(``_Dims``), the JAX package's partitioned values up to fp32
reassociation. ``count`` and ``lr`` are replicated.

Memory: elementwise temporaries are taken one leading slice at a time on
layer-stacked (>= 3-D) leaves, so their size is one layer's (granite-3-2b's
``w_gate`` is 2.7 GB in fp32 as a whole, 67 MB a layer). For AdamW and SGD
that changes nothing but memory, so they slice only leaves of at least
2^24 elements. For Adafactor it is the JAX package's
``layer_chunked``: the factored moments and the relative-step clip are
taken per layer slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map  # noqa: F401


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Any], Any]
    update: Callable[..., tuple[Any, Any]]


def _device(params) -> torch.device:
    return tree_leaves(params)[0].device


def _local(t):
    """A DTensor's local shard (a view: in-place updates reach it); any
    other value as it is."""
    return t.to_local() if getattr(t, "device_mesh", None) is not None \
        else t


class _Dims:
    """The mesh dims that shard each dim of a placed leaf (none for a
    plain tensor), from dim ``lead`` on (a leading slice's dims): the
    means over a dim sharded on the mesh add the ranks' local sums."""

    def __init__(self, p, lead: int = 0):
        from torch.distributed.tensor import Shard

        self.mesh = getattr(p, "device_mesh", None)
        self.shape = tuple(p.shape[lead:])
        self.dims = [[] for _ in self.shape] if self.mesh is None else [
            [i for i, q in enumerate(p.placements) if q == Shard(d)]
            for d in range(lead, p.ndim)]

    def mean(self, t, dim: int, keepdim: bool = False,
             leaf_dim: int | None = None):
        """``t.mean(dim)``, ``t``'s dim ``dim`` being the leaf's dim
        ``leaf_dim`` (``dim`` unless given; both counted from the end when
        negative), over the whole of that dim."""
        leaf_dim = dim if leaf_dim is None else leaf_dim
        over = self.dims[leaf_dim]
        if not over:
            return t.mean(dim=dim, keepdim=keepdim)
        from repro_torch.launch.mesh import all_reduce_raw

        total = all_reduce_raw(t.sum(dim=dim, keepdim=keepdim), self.mesh,
                               over)
        return total.div_(self.shape[leaf_dim])

    def mean_all(self, t):
        """``t.mean()`` over the whole leaf."""
        over = sorted({i for d in self.dims for i in d})
        if not over:
            return t.mean()
        from repro_torch.launch.mesh import all_reduce_raw

        n = 1
        for x in self.shape:
            n *= x
        return all_reduce_raw(t.sum(), self.mesh, over).div_(n)


# AdamW and SGD take a >= 3-D leaf a leading slice at a time only from this
# many elements: their update is elementwise, so slicing changes memory and
# never a number, and a small 3-D leaf (GAT's (602, 8, 8) projection) cut
# into hundreds of slices would cost a dozen launches a slice
_SLICE_NUMEL = 1 << 24


def _slices(*ts, min_numel: int = 0):
    """One leading slice of each tensor at a time (views) for a
    layer-stacked (>= 3-D) leaf of at least ``min_numel`` elements, else
    the tensors whole."""
    if ts[0].ndim >= 3 and ts[0].numel() >= min_numel:
        return zip(*(t.unbind(0) for t in ts))
    return [ts]


def _moment(s, beta, term) -> torch.Tensor:
    """``s <- beta * s + term`` in fp32, stored in ``s``'s dtype; returns
    the fp32 value (the one JAX's update goes on with)."""
    if s.dtype == torch.float32:
        return s.mul_(beta).add_(term)
    new = s.float().mul_(beta).add_(term)
    s.copy_(new)
    return new


def _grad32(g, scale) -> torch.Tensor:
    """``g`` in fp32, times ``scale`` (fp32) unless it is None; an fp32
    ``g`` is scaled in place, so no copy of it is made."""
    return g.float() if scale is None else g.float().mul_(scale)


def _apply(p, step, lr) -> None:
    """``p <- p - lr * step`` (``step`` fp32, scaled in place), rounded to
    ``p``'s dtype once."""
    step.mul_(lr)
    if p.dtype == torch.float32:
        p.sub_(step)
    else:
        p.copy_(p.float().sub_(step))


# --------------------------------------------------------------------- adamw
class AdamState(NamedTuple):
    mu: Any
    nu: Any
    count: torch.Tensor


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1,
          state_dtype: torch.dtype = torch.float32) -> Optimizer:
    def init(params):
        z = lambda p: torch.zeros(p.shape, dtype=state_dtype, device=p.device)
        return AdamState(tree_map(z, params), tree_map(z, params),
                         torch.zeros((), dtype=torch.int32,
                                     device=_device(params)))

    @torch.no_grad()
    def update(grads, state: AdamState, params, lr, grad_scale=None):
        count, lr = _local(state.count), _local(lr)
        count.add_(1)
        c = count.float()
        bc1 = 1.0 - torch.pow(b1, c)
        bc2 = 1.0 - torch.pow(b2, c)
        for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state.mu),
                              tree_leaves(state.nu), tree_leaves(params)):
            g, m, v, p = (_local(t) for t in (g, m, v, p))
            for g, m, v, p in _slices(g, m, v, p, min_numel=_SLICE_NUMEL):
                g32 = _grad32(g, grad_scale)
                m32 = _moment(m, b1, torch.mul(g32, 1 - b1))
                v32 = _moment(v, b2, torch.mul(g32, 1 - b2).mul_(g32))
                step = (m32 / bc1).div_((v32 / bc2).sqrt_().add_(eps))
                if weight_decay:
                    step.add_(p.float() * weight_decay)
                _apply(p, step, lr)
        return params, state

    return Optimizer("adamw", init, update)


# ----------------------------------------------------------------- adafactor
class FactorState(NamedTuple):
    vr: Any       # row second moments (or full v for <2D params)
    vc: Any       # col second moments (a (1,) placeholder for <2D)
    count: torch.Tensor


def adafactor(decay: float = 0.8, eps: float = 1e-30, clip: float = 1.0,
              weight_decay: float = 0.0,
              layer_chunked: bool = True) -> Optimizer:
    """Factored RMS optimizer (Shazeer & Stern, arXiv:1804.04235),
    momentum-free, factored over the two trailing dims of >= 2-D params;
    1-D params keep a full v.

    ``layer_chunked``: update >= 3-D (layer-stacked) params one leading
    slice at a time, as the JAX package's ``lax.map``: the relative-step
    clip (RMS(update) <= clip) is then taken per layer, the per-tensor
    semantics of a framework that does not stack layers. Without it the
    clip is taken over the whole stacked tensor."""

    def _factored(p):
        return p.ndim >= 2

    def init(params):
        def vr(p):
            shape = p.shape[:-1] if _factored(p) else p.shape
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        def vc(p):
            shape = p.shape[:-2] + p.shape[-1:] if _factored(p) else (1,)
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        return FactorState(tree_map(vr, params), tree_map(vc, params),
                           torch.zeros((), dtype=torch.int32,
                                       device=_device(params)))

    def upd_one(g, vr, vc, p, beta, lr, scale, dims):
        g32 = _grad32(g, scale)
        g2 = torch.mul(g32, g32).add_(eps)
        if _factored(p):
            vr = _moment(vr, beta, dims.mean(g2, -1).mul_(1 - beta))
            vc = _moment(vc, beta, dims.mean(g2, -2).mul_(1 - beta))
            del g2
            row = dims.mean(vr, -1, keepdim=True, leaf_dim=-2)
            denom = (vr[..., None] * vc[..., None, :]).div_(
                row[..., None].clamp_min(eps)).sqrt_()
        else:
            denom = _moment(vr, beta, g2.mul_(1 - beta)).sqrt()
        step = g32 / denom.clamp_min_(eps)
        del denom
        rms = torch.sqrt(dims.mean_all(step.square()) + 1e-30)
        step.div_((rms / clip).clamp_min(1.0))
        if weight_decay:
            step.add_(p.float() * weight_decay)
        _apply(p, step, lr)

    @torch.no_grad()
    def update(grads, state: FactorState, params, lr, grad_scale=None):
        count, lr = _local(state.count), _local(lr)
        count.add_(1)
        beta = 1.0 - torch.pow(count.float(), -decay)
        for g, vr, vc, p in zip(tree_leaves(grads), tree_leaves(state.vr),
                                tree_leaves(state.vc), tree_leaves(params)):
            chunked = layer_chunked and p.ndim >= 3
            dims = _Dims(p, lead=1 if chunked else 0)
            g, vr, vc, p = (_local(t) for t in (g, vr, vc, p))
            parts = _slices(g, vr, vc, p) if chunked else [(g, vr, vc, p)]
            for part in parts:
                upd_one(*part, beta, lr, grad_scale, dims)
        return params, state

    return Optimizer("adafactor", init, update)


# ----------------------------------------------------------------------- sgd
def sgd(momentum: float = 0.9) -> Optimizer:
    def init(params):
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)

    @torch.no_grad()
    def update(grads, state, params, lr, grad_scale=None):
        lr = _local(lr)
        for g, m, p in zip(tree_leaves(grads), tree_leaves(state),
                           tree_leaves(params)):
            g, m, p = (_local(t) for t in (g, m, p))
            for g, m, p in _slices(g, m, p, min_numel=_SLICE_NUMEL):
                m.mul_(momentum).add_(_grad32(g, grad_scale))
                _apply(p, m.clone(), lr)
        return params, state

    return Optimizer("sgd", init, update)


def get_optimizer(name: str, **kw) -> Optimizer:
    return {"adamw": adamw, "adafactor": adafactor, "sgd": sgd}[name](**kw)
