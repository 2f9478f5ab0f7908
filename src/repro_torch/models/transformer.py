"""Decoder-only GQA transformer (granite / internlm2 family), serve path.

The JAX package's ``models/transformer.py`` in PyTorch, for serving only:

  prefill        tokens -> last-token logits + KV cache (L, B, Hkv, S, hd)
  decode_step    one new token per batch row against a live KV cache

Attention goes through the hand-written flash-attention kernels
(``kernels.flash_attention.ops``): ``flash_attention`` in prefill,
``flash_decode`` in decode. ``attention=`` runs a plain attention function
instead (``common.blocked_attention``, the JAX package's production path, or
the kernels' own plain version ``attention_ref``), so a caller can hold the
kernel path against a plain one on the card.

Parameters are a nested dict of tensors laid out as the JAX package's
(layer-stacked ``(L, ...)`` leaves under ``"layers"``). Matrices are cast to
the compute dtype at each use, as in JAX; ``serving_params`` casts them once
ahead (the same numbers, since a cast of a cast is the cast), and the casts
at use are then no-ops. The port runs on one card: the JAX package's
``constrain`` sharding hints do nothing without a mesh and are dropped.
Training (``loss_fn``, ``forward``, ``trunk``) and the MoE FFNs wait
(ROADMAP.md, 'Modules to port', item 13).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.engine import not_ported
from repro_torch.kernels.flash_attention import ops as flash
from repro_torch.models.common import (
    ParamSpec,
    apply_rope,
    rms_norm,
    rope_angles,
)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    rope_base: float = 10000.0
    # MoE (n_experts == 0 => dense FFN); the port raises on n_experts > 0
    n_experts: int = 0
    top_k: int = 2
    moe_dense_residual: bool = False
    # numerics
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    vocab_pad_to: int = 128

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def padded_vocab(self) -> int:
        return -(-self.vocab // self.vocab_pad_to) * self.vocab_pad_to


# ------------------------------------------------------------------ params
def param_specs(cfg: TransformerConfig):
    D, Fd, V = cfg.d_model, cfg.d_ff, cfg.padded_vocab
    Hq, Hkv, hd, L = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    pdt = cfg.param_dtype

    def lp(shape, axes, scale=1.0):   # layer-stacked param
        return ParamSpec((L, *shape), ("layers", *axes), pdt, scale)

    layers: dict[str, ParamSpec] = {
        "ln1": lp((D,), (None,)),
        "ln2": lp((D,), (None,)),
        "wq": lp((D, Hq, hd), ("embed", "heads", None)),
        "wk": lp((D, Hkv, hd), ("embed", "kv_heads", None)),
        "wv": lp((D, Hkv, hd), ("embed", "kv_heads", None)),
        "wo": lp((Hq, hd, D), ("heads", None, "embed")),
    }
    if cfg.is_moe:
        E = cfg.n_experts
        layers |= {
            "router": lp((D, E), ("embed", None)),
            "we_gate": lp((E, D, Fd), ("expert", "embed", None)),
            "we_up": lp((E, D, Fd), ("expert", "embed", None)),
            "we_down": lp((E, Fd, D), ("expert", None, "embed")),
        }
    if (not cfg.is_moe) or cfg.moe_dense_residual:
        layers |= {
            "w_gate": lp((D, Fd), ("embed", "mlp")),
            "w_up": lp((D, Fd), ("embed", "mlp")),
            "w_down": lp((Fd, D), ("mlp", "embed")),
        }
    return {
        "embed": ParamSpec((V, D), ("vocab", "embed"), pdt),
        "layers": layers,
        "final_norm": ParamSpec((D,), (None,), pdt),
        "lm_head": ParamSpec((D, V), ("embed", "vocab"), pdt),
    }


# leaves the JAX package casts to the compute dtype at every use; the norm
# gains stay in the parameter dtype (rms_norm reads them in fp32)
_COMPUTE_LEAVES = ("embed", "lm_head", "wq", "wk", "wv", "wo", "w_gate",
                   "w_up", "w_down")


def serving_params(params, cfg: TransformerConfig):
    """The parameters with every matrix cast once to the compute dtype (the
    norm gains as they are). The model gives the same numbers on either
    tree; this one spares a cast per use."""
    out = {k: v for k, v in params.items() if k != "layers"}
    for k in ("embed", "lm_head"):
        out[k] = params[k].to(cfg.compute_dtype)
    out["layers"] = {k: (v.to(cfg.compute_dtype) if k in _COMPUTE_LEAVES
                         else v) for k, v in params["layers"].items()}
    return out


# --------------------------------------------------------------------- ffn
def _swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def _ffn(x, lp, l: int, cfg: TransformerConfig):
    if cfg.is_moe:
        raise not_ported("MoE FFN (n_experts > 0: arctic, dbrx)", "13")
    cdt = cfg.compute_dtype
    return _swiglu(x, lp["w_gate"][l].to(cdt), lp["w_up"][l].to(cdt),
                   lp["w_down"][l].to(cdt))


# ------------------------------------------------------------------- layer
def _project(x, w, cdt):
    """einsum("bsd,dhk->bshk", x, w) as one matrix product."""
    D, H, hd = w.shape
    return (x @ w.to(cdt).reshape(D, H * hd)).unflatten(-1, (H, hd))


def _out_proj(o, wo, cdt):
    """einsum("bhsk,hkd->bsd", o, wo): o (B, Hq, S, hd)."""
    B, H, S, hd = o.shape
    return o.to(cdt).transpose(1, 2).reshape(B, S, H * hd) \
        @ wo.to(cdt).reshape(H * hd, -1)


def _attention(x, lp, l: int, cfg: TransformerConfig, cos, sin, *,
               attention):
    """Prefill attention of layer ``l``. x: (B, S, D). Returns
    (out (B, S, D), (k, v) each (B, Hkv, S, hd))."""
    cdt = cfg.compute_dtype
    q = apply_rope(_project(x, lp["wq"][l], cdt), cos, sin)
    kk = apply_rope(_project(x, lp["wk"][l], cdt), cos, sin)
    vv = _project(x, lp["wv"][l], cdt)
    q = q.transpose(1, 2).contiguous()       # (B, Hq, S, hd)
    kk = kk.transpose(1, 2).contiguous()
    vv = vv.transpose(1, 2).contiguous()
    if attention is None:
        o = flash.flash_attention(q, kk, vv, causal=True)
    else:
        o = attention(q, kk, vv, causal=True, lengths=None)
    return _out_proj(o, lp["wo"][l], cdt), (kk, vv)


def _logits(x, params, cfg: TransformerConfig):
    """Final norm, vocab projection, padded vocab masked to -1e9 so greedy
    decoding never picks a padded id. x: (B, D)."""
    cdt = cfg.compute_dtype
    x = rms_norm(x, params["final_norm"])
    logits = x @ params["lm_head"].to(cdt)
    valid = torch.arange(logits.shape[-1], device=logits.device) < cfg.vocab
    return logits.masked_fill(~valid, -1e9)


# ----------------------------------------------------------------- serving
def prefill(params, tokens: torch.Tensor, cfg: TransformerConfig, *,
            attention=None):
    """tokens (B, S) int -> (last-token logits (B, V_pad) in the compute
    dtype, KV cache (k, v) each (L, B, Hkv, S, hd)).

    ``attention``: None for the flash kernels, or a plain function
    ``(q, k, v, *, causal, lengths) -> out`` of the kernels' layout to call
    instead."""
    cdt = cfg.compute_dtype
    x = params["embed"][tokens.long()].to(cdt)
    S = tokens.shape[1]
    cos, sin = rope_angles(torch.arange(S, device=tokens.device),
                           cfg.head_dim, cfg.rope_base)
    lp = params["layers"]
    ks, vs = [], []
    for l in range(cfg.n_layers):
        a, (kk, vv) = _attention(rms_norm(x, lp["ln1"][l]), lp, l, cfg, cos,
                                 sin, attention=attention)
        x = x + a
        x = x + _ffn(rms_norm(x, lp["ln2"][l]), lp, l, cfg)
        ks.append(kk)
        vs.append(vv)
    return _logits(x[:, -1], params, cfg), (torch.stack(ks), torch.stack(vs))


def decode_step(params, cache, tokens: torch.Tensor, lengths: torch.Tensor,
                cfg: TransformerConfig, *, attention=None):
    """One new token per batch row against a live KV cache.

    cache: (k, v) each (L, B, Hkv, S_max, hd); tokens (B,); lengths (B,)
    live-prefix lengths. Returns (logits (B, V_pad), cache, lengths + 1).
    ``attention`` as in :func:`prefill` (called with one query row).

    The new token's k/v are written into ``cache`` in place at position
    ``lengths[b]``: the JAX package's ``.at[...].set`` on a cache it donates
    (``configs/lm_common.py`` jits decode with ``donate=(1,)``), so the
    caller gives up the old cache there too. The returned cache is the same
    tensors.
    """
    cdt = cfg.compute_dtype
    B = tokens.shape[0]
    k_cache, v_cache = cache
    x = params["embed"][tokens.long()][:, None, :].to(cdt)    # (B, 1, D)
    cos, sin = rope_angles(lengths[:, None], cfg.head_dim,
                           cfg.rope_base)                     # (B, 1, half)
    bidx = torch.arange(B, device=tokens.device)
    pos = lengths.long()
    live = lengths + 1
    lp = params["layers"]
    for l in range(cfg.n_layers):
        xn = rms_norm(x, lp["ln1"][l])
        q = apply_rope(_project(xn, lp["wq"][l], cdt), cos, sin)
        kk = apply_rope(_project(xn, lp["wk"][l], cdt), cos, sin)
        vv = _project(xn, lp["wv"][l], cdt)
        k_l, v_l = k_cache[l], v_cache[l]
        k_l[bidx, :, pos] = kk[:, 0].to(k_l.dtype)
        v_l[bidx, :, pos] = vv[:, 0].to(v_l.dtype)
        q = q.transpose(1, 2)                                 # (B, Hq, 1, hd)
        if attention is None:
            o = flash.flash_decode(q[:, :, 0].contiguous(), k_l, v_l,
                                   live)[:, :, None]
        else:
            o = attention(q, k_l, v_l, causal=False, lengths=live)
        x = x + _out_proj(o, lp["wo"][l], cdt)
        x = x + _ffn(rms_norm(x, lp["ln2"][l]), lp, l, cfg)
    return _logits(x[:, 0], params, cfg), cache, live
