"""Shared model substrate: parameter specs and their seeded init, RMS norm,
RoPE, and the plain blocked attention of the JAX package's production path.

The training half of the JAX module (``cross_entropy``, ``fused_ce_loss``)
waits with training (ROADMAP.md, 'Modules to port', item 13).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


# ------------------------------------------------------------- param specs
@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Shape + dtype + one logical axis name per dim (None = replicated). The
    axes document the layout; the port runs on one card and shards
    nothing."""

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    dtype: torch.dtype = torch.float32
    init_scale: float = 1.0

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ "
                             f"in rank")


def _leaves(tree, prefix=()):
    """(path, leaf) pairs of a nested dict, in sorted key order (the JAX
    package's tree order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def init_from_specs(tree, generator: torch.Generator,
                    depth: int | None = None):
    """Random init for smoke runs and examples, on ``generator``'s device:
    each leaf is normal * init_scale / sqrt(fan_in), fan_in being the first
    dim of a matrix and the length of a vector (the JAX package's rule, also
    for layer-stacked leaves). With ``depth``, a layer-stacked leaf (first
    axis "layers") takes fan_in = depth: a model cut in depth then draws
    each layer at the scale of its full depth. The numbers differ from the
    JAX init: a test that compares the two packages hands one parameter
    tree to both."""
    dev = generator.device
    out = {}
    for path, s in _leaves(tree):
        fan_in = s.shape[0] if len(s.shape) > 1 else max(1, s.shape[-1])
        if depth is not None and s.axes[0] == "layers":
            fan_in = depth
        scale = s.init_scale / math.sqrt(fan_in)
        x = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                        device=dev).mul_(scale)   # one fp32 transient
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = x.to(s.dtype)
    return out


# ------------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    x32 = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * gamma.float()).to(x.dtype)


# -------------------------------------------------------------------- rope
def rope_angles(positions: torch.Tensor, head_dim: int,
                base: float = 10000.0):
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / (base ** exps)
    ang = positions.float()[..., None] * freqs  # (..., half)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, d). cos/sin: (..., S, d/2), broadcast over heads."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# --------------------------------------------------------------- attention
def blocked_attention(q, k, v, *, causal: bool, q_chunk: int = 512,
                      lengths: torch.Tensor | None = None) -> torch.Tensor:
    """The JAX package's production attention, plainly: fp32 scores over
    chunks of ``q_chunk`` query rows, keys masked with -inf (causal with the
    offset ``Skv - Sq``; ``lengths`` (B,) masks keys at or past
    ``lengths[b]``), the normaliser guarded by 1e-30. A row with no live key
    comes out NaN here (0 from the flash kernel): compare the two on rows
    with a live key.

    q: (B, Hq, Sq, d); k, v: (B, Hkv, Skv, d). Returns q's dtype."""
    B, Hq, Sq, d = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = float(np.float32(1.0) / np.sqrt(np.float32(d)))
    qg = q.reshape(B, Hkv, group, Sq, d)
    k32, v32 = k.float(), v.float()
    kpos = torch.arange(Skv, device=q.device)[None, :]
    lmask = None if lengths is None else \
        (kpos < lengths.to(q.device)[:, None])  # (B, Skv)
    outs = []
    for c0 in range(0, Sq, q_chunk):
        qi = qg[:, :, :, c0:c0 + q_chunk].float()
        s = torch.einsum("bhgqd,bhkd->bhgqk", qi, k32) * scale
        if causal:
            qpos = c0 + torch.arange(qi.shape[3], device=q.device)[:, None] \
                + (Skv - Sq)
            s = s.masked_fill(qpos < kpos, float("-inf"))
        if lmask is not None:
            s = s.masked_fill(~lmask[:, None, None, None, :], float("-inf"))
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        o = torch.einsum("bhgqk,bhkd->bhgqd", p, v32)
        outs.append(o / p.sum(dim=-1, keepdim=True).clamp_min(1e-30))
    out = torch.cat(outs, dim=3) if outs else \
        q.new_zeros((B, Hkv, group, 0, d), dtype=torch.float32)
    return out.reshape(B, Hq, Sq, d).to(q.dtype)
