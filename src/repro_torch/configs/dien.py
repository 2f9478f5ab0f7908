"""dien [arXiv:1809.03672]: embed_dim=18, seq_len=100, gru_dim=108,
MLP 200-80, AUGRU interaction, 1M-item / 1k-category embedding tables and a
100k-feature multi-hot profile EmbeddingBag.

Shapes:
  train_batch     batch=65,536   train step (not ported)
  serve_p99       batch=512      online CTR scoring
  serve_bulk      batch=262,144  offline scoring
  retrieval_cand  batch=1, n_candidates=1,000,000
"""
from __future__ import annotations

import torch

from repro_torch.core.engine import not_ported
from repro_torch.device import resolve_device
from repro_torch.models.common import init_from_specs
from repro_torch.models.recsys import dien as m

FAMILY = "recsys"

CFG = m.DIENConfig()
SMOKE_CFG = m.DIENConfig(n_items=1000, n_cats=20, n_profile_feats=100,
                         seq_len=12, profile_bag_size=8)

SHAPE_DEFS = {
    "train_batch": dict(batch=65536, kind="train"),
    "serve_p99": dict(batch=512, kind="serve"),
    "serve_bulk": dict(batch=262144, kind="serve"),
    "retrieval_cand": dict(batch=1, n_cand=1_000_000, kind="retrieval"),
}


def rand_rank_batch(gen: torch.Generator, cfg: m.DIENConfig, B: int):
    """A random ranking batch on ``gen``'s device, drawn as the JAX
    package's ``_rand_rank_batch`` draws it (90% live behaviour steps, full
    profile bags)."""
    S, nb, dev = cfg.seq_len, cfg.profile_bag_size, gen.device

    def ints(hi, shape):
        return torch.randint(0, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    return dict(
        item_ids=ints(cfg.n_items, (B, S)), cat_ids=ints(cfg.n_cats, (B, S)),
        mask=torch.rand((B, S), generator=gen, device=dev) < 0.9,
        target_item=ints(cfg.n_items, (B,)), target_cat=ints(cfg.n_cats, (B,)),
        profile_ids=ints(cfg.n_profile_feats, (B, nb)),
        profile_mask=torch.ones((B, nb), dtype=torch.bool, device=dev))


def build_smoke(shape: str, device=None) -> dict:
    """The inputs of the JAX package's reduced cells on ``device`` (CUDA
    unless the caller names another): ``cfg`` (``SMOKE_CFG``), ``params``
    and a ``batch``: 8 users for a serve shape; for ``retrieval_cand`` one
    user without a target and 512 candidates (``cand_items``,
    ``cand_cats``)."""
    kind = SHAPE_DEFS[shape]["kind"]
    if kind == "train":
        raise not_ported("DIEN training (train_batch)", "13")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = init_from_specs(m.param_specs(SMOKE_CFG), gen)
    if kind == "serve":
        batch = rand_rank_batch(gen, SMOKE_CFG, 8)
        return dict(cfg=SMOKE_CFG, params=params, batch=batch)
    batch = rand_rank_batch(gen, SMOKE_CFG, 1)
    del batch["target_item"], batch["target_cat"]
    batch.update(rand_candidates(gen, SMOKE_CFG, 512))
    return dict(cfg=SMOKE_CFG, params=params, batch=batch)


def rand_candidates(gen: torch.Generator, cfg: m.DIENConfig, n: int) -> dict:
    """``n`` random candidates (item and category ids) on ``gen``'s
    device."""
    ints = dict(generator=gen, device=gen.device, dtype=torch.int32)
    return dict(cand_items=torch.randint(0, cfg.n_items, (n,), **ints),
                cand_cats=torch.randint(0, cfg.n_cats, (n,), **ints))
