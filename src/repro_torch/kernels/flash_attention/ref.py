"""Plain PyTorch versions of GQA attention, prefill and decode.

``attention_ref`` and ``decode_ref`` compute what the flash kernel computes,
in fp32, with the kernel's layout: q ``(B, Hq, Sq, d)``, k/v
``(B, Hkv, Skv, d)``, kv head of query head ``h`` = ``h // (Hq // Hkv)``.
The causal mask uses the offset ``Skv - Sq`` (query row ``i`` sits at key
position ``i + Skv - Sq``), ``lengths`` masks keys at or past ``lengths[b]``,
and a row with no live key gives 0 (the kernel's ``l > 0`` guard). On rows
with a live key they equal the JAX package's ``attention_ref``/``decode_ref``.
The wrapper in ``ops.py`` runs them for CPU tensors; on the card they are the
kernel's comparison.
"""
from __future__ import annotations

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  lengths: torch.Tensor | None = None) -> torch.Tensor:
    """fp32 softmax attention; the output takes q's dtype."""
    B, Hq, Sq, d = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, Hkv, Hq // Hkv, Sq, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float())
    s = s / torch.sqrt(torch.tensor(d, dtype=torch.float32))
    kpos = torch.arange(Skv, device=q.device)
    live = torch.ones((B, 1, 1, Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        qpos = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
        live = live & (qpos >= kpos)
    if lengths is not None:
        live = live & (kpos < lengths.to(q.device)[:, None]
                       )[:, None, None, None, :]
    s = s.masked_fill(~live, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0))
    l = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(l > 0, l, 1.0)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return out.reshape(B, Hq, Sq, d).to(q.dtype)


def decode_ref(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
               lengths: torch.Tensor) -> torch.Tensor:
    """One query row per (b, hq): q (B, Hq, d), caches (B, Hkv, S, d), keys
    at or past ``lengths[b]`` masked. Returns (B, Hq, d) in q's dtype."""
    return attention_ref(q[:, :, None, :], k_cache, v_cache, causal=False,
                         lengths=lengths)[:, :, 0, :]
