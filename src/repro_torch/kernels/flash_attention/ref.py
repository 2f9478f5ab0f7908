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

``decode_partial_ref`` and ``decode_merge_ref`` split ``decode_ref`` in two,
as a decode over a cache whose rows are spread over ranks does: each rank's
partial softmax state over its own rows, ``(acc, m, l)`` in the log2 units
the kernel keeps, then the merge of every rank's partial in rank order.
"""
from __future__ import annotations

import math

import torch

LOG2E = 1.4426950408889634
NEG = -3.0e38     # the kernels' mask value: an empty partial's m


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


def decode_partial_ref(q: torch.Tensor, k_cache: torch.Tensor,
                       v_cache: torch.Tensor,
                       lengths: torch.Tensor) -> torch.Tensor:
    """The partial softmax state of one query row per (b, hq) over the
    cache rows below ``lengths[b]``: (B, Hq, d + 2) fp32 holding ``acc``
    (d values: sum_j 2^(s_j - m) v_j, not normalised), ``m`` (the largest
    score s_j = q.k_j / sqrt(d) * log2(e)) and ``l`` (sum_j 2^(s_j - m)).
    A row with no live key is the empty partial (0, NEG, 0)."""
    B, Hq, d = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    qg = q.float().reshape(B, Hkv, Hq // Hkv, d)
    s = torch.einsum("bhgd,bhkd->bhgk", qg, k_cache.float()) \
        * (LOG2E / math.sqrt(d))
    live = torch.arange(S, device=q.device) < lengths.to(q.device)[:, None]
    s = s.masked_fill(~live[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1)
    m = torch.where(torch.isfinite(m), m, NEG)
    p = torch.exp2(s - m[..., None])
    acc = torch.einsum("bhgk,bhkd->bhgd", p, v_cache.float())
    out = torch.cat([acc, m[..., None], p.sum(-1)[..., None]], dim=-1)
    return out.reshape(B, Hq, d + 2)


def decode_merge_ref(parts: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The decode output from R partials (R, B, Hq, d + 2) of
    ``decode_partial_ref`` over disjoint rows, merged in order 0..R-1:
    empty partials (l == 0) skipped, a row with none live 0. Returns
    (B, Hq, d) in ``dtype``."""
    d = parts.shape[-1] - 2
    acc, m, l = parts[..., :d], parts[..., d], parts[..., d + 1]
    live = l > 0
    M = torch.where(live, m, NEG).amax(dim=0)
    a = torch.where(live, torch.exp2(m - M), 0.0)
    L = torch.zeros_like(M)
    O = torch.zeros_like(acc[0])
    for r in range(parts.shape[0]):
        L = L + l[r] * a[r]
        O = O + acc[r] * a[r][..., None]
    out = torch.where(L[..., None] > 0, O / torch.where(L > 0, L, 1.0)[
        ..., None], 0.0)
    return out.to(dtype)
