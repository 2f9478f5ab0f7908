"""int8 gradient compression with error feedback: the JAX package's
``repro.distributed.compression`` in PyTorch.

For data parallelism over a slow interconnect the gradient all-reduce
dominates; int8 quantization cuts those bytes 4x (vs fp32). Error feedback
(Seide et al.; Karimireddy et al., arXiv:1901.09847) keeps the residual of
each quantization locally and adds it back next step.

``compressed_all_reduce(x, group)`` is the counterpart of the JAX
package's ``compressed_psum`` on a ``torch.distributed`` group: an
all-reduce MAX of the scales, then an all-reduce SUM in int32 of the values
re-quantized at that scale. (The JAX function also computes a first psum
that it discards; this one computes only the one it returns.) The functions
are bit-equal to the JAX package's: ``torch.round`` and ``jnp.round`` both
round half to even, and fp32 division is correctly rounded in both.
"""
from __future__ import annotations

import torch


def quantize_int8(x: torch.Tensor):
    """Symmetric per-tensor int8. Returns (q, scale). The divisor 127 is a
    tensor on ``x``'s device: CUDA divides by a host scalar as a multiply
    by its reciprocal, which can round differently from the division."""
    amax = x.abs().max() + 1e-12
    scale = amax / amax.new_full((), 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group`` with an int8 payload:
    every rank re-quantizes its dequantized values at the largest scale of
    the group, and the int32 sum of those is dequantized once."""
    import torch.distributed as dist

    q, scale = quantize_int8(x)
    smax = scale.clone()
    dist.all_reduce(smax, op=dist.ReduceOp.MAX, group=group)
    q2 = torch.clamp(torch.round(dequantize_int8(q, scale) / smax), -127, 127)
    total = q2.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return total.to(torch.float32) * smax


def _map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def init_error_state(params):
    """A zero fp32 error per leaf of ``params`` (a tensor or nested
    dicts)."""
    return _map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)


def compress_with_feedback(grads, err_state):
    """Quantize grads to int8 (plus the carried error); returns
    (dequantized grads, new error state), each a tree like ``grads``. The
    dequantized grads are what the optimizer consumes; the int8 payload is
    what would cross the wire."""
    def one(g, e):
        g32 = g.to(torch.float32) + e
        q, scale = quantize_int8(g32)
        deq = dequantize_int8(q, scale)
        return deq, g32 - deq

    out = _map(one, grads, err_state)
    first = _map(lambda t: t[0], out)
    second = _map(lambda t: t[1], out)
    return first, second
