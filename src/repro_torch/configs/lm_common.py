"""Shared cell builders for the dense LM architectures: the assigned shapes
and the reduced (smoke) configuration the serve launcher runs.

Shapes (assigned):
  train_4k     seq 4,096   global_batch 256   -> train step (not ported)
  prefill_32k  seq 32,768  global_batch 32    -> prefill (logits + KV cache)
  decode_32k   seq 32,768  global_batch 128   -> decode_step (1 token vs cache)
  long_500k    seq 524,288 global_batch 1     -> decode_step
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.engine import not_ported
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.common import init_from_specs

FAMILY = "lm"

SHAPE_DEFS = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode"),
}


# -------------------------------------------------------------------- smoke
def smoke_config(cfg: T.TransformerConfig) -> T.TransformerConfig:
    return dataclasses.replace(
        cfg, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=128, head_dim=16,
        n_experts=(4 if cfg.is_moe else 0), top_k=min(cfg.top_k, 2),
        compute_dtype=torch.float32, param_dtype=torch.float32)


def build_smoke(cfg: T.TransformerConfig, shape: str, device=None) -> dict:
    """The inputs of the JAX package's reduced serve cell (same config and
    shapes; seeded torch init, so other numbers) on ``device`` (CUDA unless
    the caller names another): ``cfg`` (the smoke config), ``params`` and
    ``tokens``, plus ``cache`` and ``lengths`` for a decode shape."""
    cfg = smoke_config(cfg)
    kind = SHAPE_DEFS[shape]["kind"]
    if kind == "train":
        raise not_ported("LM training (train_4k)", "13")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = init_from_specs(T.param_specs(cfg), gen)
    if kind == "prefill":
        B, S = 2, 64
        tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                               device=dev, dtype=torch.int32)
        return dict(cfg=cfg, params=params, tokens=tokens)
    B, S = 2, 128
    kv = torch.zeros((cfg.n_layers, B, cfg.n_kv_heads, S, cfg.head_dim),
                     dtype=cfg.compute_dtype, device=dev)
    tokens = torch.randint(0, cfg.vocab, (B,), generator=gen, device=dev,
                           dtype=torch.int32)
    lengths = torch.full((B,), S // 2, dtype=torch.int32, device=dev)
    return dict(cfg=cfg, params=params, cache=(kv, kv.clone()), tokens=tokens,
                lengths=lengths)
