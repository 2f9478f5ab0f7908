"""Shared model substrate: parameter specs and their seeded init, RMS and
layer norm, RoPE, the plain blocked attention of the JAX package's
production path (the one it trains through), and the losses:
``cross_entropy`` and the chunked, recomputed ``fused_ce_loss``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint


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


def map_specs(fn, tree):
    """``fn`` over the ``ParamSpec`` leaves of a tree of nested dicts,
    tuples and NamedTuples (such as an optimizer state's), dict keys in
    sorted order (the JAX package's tree order)."""
    if isinstance(tree, ParamSpec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_specs(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_specs(fn, t) for t in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_specs(fn, t) for t in tree)
    raise TypeError(f"not a ParamSpec tree: {type(tree).__name__}")


def spec_to_meta(tree):
    """The JAX package's ``spec_to_sds``: a ``ParamSpec`` tree as a tree of
    ``torch.device("meta")`` tensors of the same shapes and dtypes. A meta
    tensor is PyTorch's ``ShapeDtypeStruct``: it allocates nothing."""
    return map_specs(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                           device="meta"), tree)


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


def at_least_fp32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in fp32, or kept in fp64 (an fp64 reference run)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Layer norm over the last axis in fp32 (fp64 for fp64 input), cast
    back to ``x``'s dtype."""
    x32 = at_least_fp32(x)
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps) * gamma + beta).to(x.dtype)


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
        m = s.amax(dim=-1, keepdim=True).detach()
        p = torch.exp(s - m)
        o = torch.einsum("bhgqk,bhkd->bhgqd", p, v32)
        outs.append(o / p.sum(dim=-1, keepdim=True).clamp_min(1e-30))
    out = torch.cat(outs, dim=3) if outs else \
        q.new_zeros((B, Hkv, group, 0, d), dtype=torch.float32)
    return out.reshape(B, Hq, Sq, d).to(q.dtype)


# -------------------------------------------------------------------- loss
def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Token-mean cross entropy in fp32. logits: (..., V); labels: (...)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return nll.mean()


def _ce_chunk(x, labels, lm_head, valid):
    """One chunk's (sum of nll, sum of lse^2): the fp32 vocab projection,
    padded columns at -inf."""
    logits = (x.float() @ lm_head.float()).masked_fill(~valid, float("-inf"))
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (lse - ll).sum(), (lse * lse).sum()


def fused_ce_loss(x: torch.Tensor, lm_head: torch.Tensor,
                  labels: torch.Tensor, *, n_valid_vocab: int,
                  z_loss: float = 0.0, chunk: int = 512
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Memory-efficient vocab projection + cross entropy + z-loss.

    The full (B, S, V) logits never materialize: the sequence is cut into
    ``chunk``-sized slices whose projection (fp32) is recomputed in the
    backward (``torch.utils.checkpoint``, the JAX package's
    ``jax.checkpoint``), so the live logits are (B, chunk, V). Padded vocab
    columns (>= n_valid_vocab) are masked to -inf. x: (B, S, D); lm_head
    (D, V); labels (B, S). Returns (mean nll, z_loss * mean lse^2)."""
    B, S, D = x.shape
    V = lm_head.shape[-1]
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of chunk {chunk}")
    valid = torch.arange(V, device=x.device) < n_valid_vocab
    nll_sum = z_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, S, chunk):
        args = (x[:, c0:c0 + chunk], labels[:, c0:c0 + chunk], lm_head, valid)
        if torch.is_grad_enabled():
            nll, z = checkpoint(_ce_chunk, *args, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            nll, z = _ce_chunk(*args)
        nll_sum = nll_sum + nll
        z_sum = z_sum + z
    n_tok = B * S
    return nll_sum / n_tok, z_loss * z_sum / n_tok
