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


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Any], Any]
    update: Callable[..., tuple[Any, Any]]


# ---------------------------------------------------------------- trees
def tree_leaves(tree) -> list:
    """The leaves of nested dicts, lists and tuples, dict keys in sorted
    order (the JAX package's tree order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def _device(params) -> torch.device:
    return tree_leaves(params)[0].device


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
        state.count.add_(1)
        c = state.count.float()
        bc1 = 1.0 - torch.pow(b1, c)
        bc2 = 1.0 - torch.pow(b2, c)
        for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state.mu),
                              tree_leaves(state.nu), tree_leaves(params)):
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

    def upd_one(g, vr, vc, p, beta, lr, scale):
        g32 = _grad32(g, scale)
        g2 = torch.mul(g32, g32).add_(eps)
        if _factored(p):
            vr = _moment(vr, beta, g2.mean(dim=-1).mul_(1 - beta))
            vc = _moment(vc, beta, g2.mean(dim=-2).mul_(1 - beta))
            del g2
            denom = (vr[..., None] * vc[..., None, :]).div_(
                vr.mean(dim=-1, keepdim=True)[..., None].clamp_min(eps)
            ).sqrt_()
        else:
            denom = _moment(vr, beta, g2.mul_(1 - beta)).sqrt()
        step = g32 / denom.clamp_min_(eps)
        del denom
        rms = torch.sqrt(step.square().mean() + 1e-30)
        step.div_((rms / clip).clamp_min(1.0))
        if weight_decay:
            step.add_(p.float() * weight_decay)
        _apply(p, step, lr)

    @torch.no_grad()
    def update(grads, state: FactorState, params, lr, grad_scale=None):
        state.count.add_(1)
        beta = 1.0 - torch.pow(state.count.float(), -decay)
        for g, vr, vc, p in zip(tree_leaves(grads), tree_leaves(state.vr),
                                tree_leaves(state.vc), tree_leaves(params)):
            parts = _slices(g, vr, vc, p) if layer_chunked \
                else [(g, vr, vc, p)]
            for part in parts:
                upd_one(*part, beta, lr, grad_scale)
        return params, state

    return Optimizer("adafactor", init, update)


# ----------------------------------------------------------------------- sgd
def sgd(momentum: float = 0.9) -> Optimizer:
    def init(params):
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)

    @torch.no_grad()
    def update(grads, state, params, lr, grad_scale=None):
        for g, m, p in zip(tree_leaves(grads), tree_leaves(state),
                           tree_leaves(params)):
            for g, m, p in _slices(g, m, p, min_numel=_SLICE_NUMEL):
                m.mul_(momentum).add_(_grad32(g, grad_scale))
                _apply(p, m.clone(), lr)
        return params, state

    return Optimizer("sgd", init, update)


def get_optimizer(name: str, **kw) -> Optimizer:
    return {"adamw": adamw, "adafactor": adafactor, "sgd": sgd}[name](**kw)
