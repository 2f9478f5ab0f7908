"""dien [arXiv:1809.03672]: embed_dim=18, seq_len=100, gru_dim=108,
MLP 200-80, AUGRU interaction, 1M-item / 1k-category embedding tables and a
100k-feature multi-hot profile EmbeddingBag.

Shapes:
  train_batch     batch=65,536   train step (CTR + DIEN auxiliary loss)
  serve_p99       batch=512      online CTR scoring
  serve_bulk      batch=262,144  offline scoring
  retrieval_cand  batch=1, n_candidates=1,000,000
"""
from __future__ import annotations

import functools

import torch

from repro_torch.configs.cell import (
    ArchSpec,
    CellPlan,
    meta,
    on_meta,
    opt_state_specs,
)
from repro_torch.device import resolve_device
from repro_torch.models.common import init_from_specs, spec_to_meta
from repro_torch.models.recsys import dien as m
from repro_torch.train.optimizer import get_optimizer
from repro_torch.train.trainer import make_train_step

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


def rand_rank_batch(gen: torch.Generator, cfg: m.DIENConfig, B: int, *,
                    train: bool = False):
    """A random ranking batch on ``gen``'s device, drawn as the JAX
    package's ``_rand_rank_batch`` draws it (90% live behaviour steps, full
    profile bags); with ``train`` also ``labels`` (B,) in {0, 1} and the
    sampled negatives ``neg_item_ids``, ``neg_cat_ids`` (B, S)."""
    S, nb, dev = cfg.seq_len, cfg.profile_bag_size, gen.device

    def ints(hi, shape):
        return torch.randint(0, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    batch = dict(
        item_ids=ints(cfg.n_items, (B, S)), cat_ids=ints(cfg.n_cats, (B, S)),
        mask=torch.rand((B, S), generator=gen, device=dev) < 0.9,
        target_item=ints(cfg.n_items, (B,)), target_cat=ints(cfg.n_cats, (B,)),
        profile_ids=ints(cfg.n_profile_feats, (B, nb)),
        profile_mask=torch.ones((B, nb), dtype=torch.bool, device=dev))
    if train:
        batch.update(labels=ints(2, (B,)),
                     neg_item_ids=ints(cfg.n_items, (B, S)),
                     neg_cat_ids=ints(cfg.n_cats, (B, S)))
    return batch


def _train_cell(cfg: m.DIENConfig, params, batch: dict, lr: float) -> dict:
    """The JAX package's DIEN train step: AdamW, one microbatch, the
    trainer's default clip."""
    opt = get_optimizer("adamw")
    step = make_train_step(functools.partial(m.loss_fn, cfg=cfg), opt)
    return dict(cfg=cfg, params=params, opt_state=opt.init(params),
                batch=batch, step=step, lr=lr, optimizer=opt)


def build_smoke(shape: str, device=None) -> dict:
    """The inputs of the JAX package's reduced cells on ``device`` (CUDA
    unless the caller names another): ``cfg`` (``SMOKE_CFG``), ``params``
    and a ``batch``: 8 users for a serve shape; for ``retrieval_cand`` one
    user without a target and 512 candidates (``cand_items``,
    ``cand_cats``); for ``train_batch`` 8 users with labels and negatives,
    and the train cell: ``opt_state``, ``step`` (AdamW), ``lr`` 1e-3,
    ``optimizer``."""
    kind = SHAPE_DEFS[shape]["kind"]
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = init_from_specs(m.param_specs(SMOKE_CFG), gen)
    if kind == "train":
        return _train_cell(SMOKE_CFG, params,
                           rand_rank_batch(gen, SMOKE_CFG, 8, train=True),
                           1e-3)
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


def build_train(*, batch: int, device=None, seed: int = 0) -> dict:
    """The ``train_batch`` cell at the full ``CFG`` (1M items, 100k profile
    features, sequence 100) and a batch of ``batch`` users (the assigned
    65,536 cut to what one card holds), on ``device`` (CUDA unless the
    caller names another); parameters and batch drawn from ``seed``.
    Returns the dict of :func:`build_smoke`'s train cell (lr 1e-3)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = init_from_specs(m.param_specs(CFG), gen)
    return _train_cell(CFG, params, rand_rank_batch(gen, CFG, batch,
                                                    train=True), 1e-3)


# ------------------------------------------------------------ the full cells
DIEN_SHAPES = tuple(SHAPE_DEFS)


def _serve_fn(params, batch, cfg):
    with torch.no_grad():
        return m.serve(params, batch, cfg)


def _retrieval_fn(params, batch, cfg):
    with torch.no_grad():
        return m.retrieval_score(params, batch, cfg)


def rank_batch_meta(cfg: m.DIENConfig, B: int, *, train: bool) -> dict:
    """The JAX package's ``_rank_batch_sds``: a ranking batch of meta
    tensors."""
    S, nb = cfg.seq_len, cfg.profile_bag_size
    i32, b_ = torch.int32, torch.bool
    batch = dict(
        item_ids=meta((B, S), i32), cat_ids=meta((B, S), i32),
        mask=meta((B, S), b_), target_item=meta((B,), i32),
        target_cat=meta((B,), i32), profile_ids=meta((B, nb), i32),
        profile_mask=meta((B, nb), b_))
    if train:
        batch.update(labels=meta((B,), i32), neg_item_ids=meta((B, S), i32),
                     neg_cat_ids=meta((B, S), i32))
    return batch


def _batch_axes(batch: dict) -> dict:
    return {k: (("candidates",) if k.startswith("cand") else
                ("batch",) + (None,) * (v.ndim - 1))
            for k, v in batch.items()}


def build(shape: str, device=None, reduced=None, seed: int = 0) -> CellPlan:
    """The JAX package's DIEN cell at ``shape`` with ``CFG``:
    ``train_batch`` a train step (AdamW, lr 1e-3), the serve shapes
    ``serve``, ``retrieval_cand`` ``retrieval_score`` of one user against
    1,000,000 candidates; ``reduced`` cuts the batch (``"batch"``)."""
    reduced = dict(reduced or {})
    d = SHAPE_DEFS[shape]
    B = reduced.get("batch", d["batch"])
    specs = m.param_specs(CFG)
    if on_meta(device):
        gen = None
        params = spec_to_meta(specs)
        if d["kind"] == "retrieval":
            batch = rank_batch_meta(CFG, B, train=False)
            del batch["target_item"], batch["target_cat"]
            batch.update(cand_items=meta((d["n_cand"],), torch.int32),
                         cand_cats=meta((d["n_cand"],), torch.int32))
        else:
            batch = rank_batch_meta(CFG, B, train=d["kind"] == "train")
    else:
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = init_from_specs(specs, gen)
        batch = rand_rank_batch(gen, CFG, B, train=d["kind"] == "train")
        if d["kind"] == "retrieval":
            del batch["target_item"], batch["target_cat"]
            batch.update(rand_candidates(gen, CFG, d["n_cand"]))
    axes = _batch_axes(batch)
    if d["kind"] == "train":
        o_specs = opt_state_specs("adamw", specs)
        if gen is None:
            step = make_train_step(functools.partial(m.loss_fn, cfg=CFG),
                                   get_optimizer("adamw"))
            cell = dict(params=params, opt_state=spec_to_meta(o_specs),
                        lr=meta(()), step=step)
        else:
            cell = _train_cell(CFG, params, batch, 1e-3)
            cell["lr"] = torch.tensor(1e-3, device=params["item_embed"].device)
        return CellPlan("dien", shape, cell["step"],
                        (cell["params"], cell["opt_state"], batch,
                         cell["lr"]), kind="train", reduced=reduced,
                        dims={"batch": B}, arg_axes=(specs, o_specs, axes, ()))
    fn = _serve_fn if d["kind"] == "serve" else _retrieval_fn
    return CellPlan("dien", shape, functools.partial(fn, cfg=CFG),
                    (params, batch), kind="serve", reduced=reduced,
                    dims={"batch": B}, arg_axes=(specs, axes))


def smoke_plan(shape: str, device=None) -> CellPlan:
    """:func:`build_smoke`'s cell as a ``CellPlan``."""
    c = build_smoke(shape, device=device)
    kind = SHAPE_DEFS[shape]["kind"]
    if kind == "train":
        lr = torch.tensor(c["lr"], device=c["params"]["item_embed"].device)
        return CellPlan("dien", shape, c["step"],
                        (c["params"], c["opt_state"], c["batch"], lr))
    fn = _serve_fn if kind == "serve" else _retrieval_fn
    return CellPlan("dien", shape, functools.partial(fn, cfg=c["cfg"]),
                    (c["params"], c["batch"]), kind="serve")


ARCH = ArchSpec(arch_id="dien", family=FAMILY, shapes=DIEN_SHAPES,
                build=build, build_smoke=smoke_plan)
