"""Shared cell builders for the LM architectures: the assigned shapes, each
arch's training setting, the reduced (smoke) configuration the launchers
run, the full-width train cell, and each arch's ``ArchSpec``
(``make_arch``: every shape's ``CellPlan`` at full size, on the meta device
for the dry run).

Shapes (assigned):
  train_4k     seq 4,096   global_batch 256   -> train step (fwd + bwd + optimizer)
  prefill_32k  seq 32,768  global_batch 32    -> prefill (logits + KV cache)
  decode_32k   seq 32,768  global_batch 128   -> decode_step (1 token vs cache)
  long_500k    seq 524,288 global_batch 1     -> decode_step
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

from repro_torch.configs.cell import (
    ArchSpec,
    CellPlan,
    generator,
    meta,
    on_meta,
    opt_state_specs,
)
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.common import init_from_specs, spec_to_meta
from repro_torch.train.optimizer import get_optimizer
from repro_torch.train.trainer import make_train_step

FAMILY = "lm"


@dataclasses.dataclass(frozen=True)
class TrainSetting:
    """An arch's training setting, the JAX package's ``LMArch`` fields:
    the optimizer's name, the microbatches of a step, the learning rate and
    the train cell's sharding-rule preset (``distributed.sharding.
    RULE_SETS``; None: the default rules)."""

    optimizer: str = "adamw"
    accum: int = 1
    lr: float = 3e-4
    train_rules: str | None = None

SHAPE_DEFS = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode"),
}


# -------------------------------------------------------------------- smoke
def smoke_config(cfg: T.TransformerConfig) -> T.TransformerConfig:
    """The JAX package's reduced config: 2 layers, d_model 64, 4 experts
    for an MoE arch (top k at most 2); ``moe_impl``, ``capacity_factor``
    and ``moe_dense_residual`` kept as the arch sets them."""
    return dataclasses.replace(
        cfg, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=128, head_dim=16,
        n_experts=(4 if cfg.is_moe else 0), top_k=min(cfg.top_k, 2),
        compute_dtype=torch.float32, param_dtype=torch.float32)


def _train_cell(cfg, train: TrainSetting, params, batch: dict, accum: int,
                lr: float) -> dict:
    opt = get_optimizer(train.optimizer)
    step = make_train_step(functools.partial(T.loss_fn, cfg=cfg), opt,
                           accum_steps=accum)
    return dict(cfg=cfg, params=params, opt_state=opt.init(params),
                batch=batch, step=step, lr=lr, optimizer=opt, accum=accum)


def _tokens_and_labels(gen, cfg, B: int, S: int) -> dict:
    ints = dict(generator=gen, device=gen.device, dtype=torch.int32)
    return {"tokens": torch.randint(0, cfg.vocab, (B, S), **ints),
            "labels": torch.randint(0, cfg.vocab, (B, S), **ints)}


def build_smoke(cfg: T.TransformerConfig, train: TrainSetting, shape: str,
                device=None) -> dict:
    """The inputs of the JAX package's reduced cell (same config and
    shapes; seeded torch init, so other numbers) on ``device`` (CUDA unless
    the caller names another): ``cfg`` (the smoke config) and ``params``;
    for a serve shape ``tokens``, plus ``cache`` and ``lengths`` for a
    decode shape; for ``train_4k`` the train cell: ``opt_state``,
    ``batch`` (``tokens``, ``labels``: B 4 x S 64), ``step`` (the arch's
    optimizer, ``accum`` = min(the arch's, 2) microbatches), ``lr`` 1e-3,
    ``optimizer``."""
    cfg = smoke_config(cfg)
    kind = SHAPE_DEFS[shape]["kind"]
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = init_from_specs(T.param_specs(cfg), gen)
    if kind == "train":
        return _train_cell(cfg, train, params,
                           _tokens_and_labels(gen, cfg, 4, 64),
                           min(train.accum, 2), 1e-3)
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


def build_train(cfg: T.TransformerConfig, train: TrainSetting, *,
                batch: int, device=None, seed: int = 0) -> dict:
    """The ``train_4k`` cell (seq 4,096) at full width and depth and a
    global batch of ``batch`` (the assigned 256 cut to what one card
    holds), on ``device`` (CUDA unless the caller names another): the
    arch's optimizer, its ``accum`` microbatches and learning rate,
    parameters drawn from ``seed``. Returns the dict of
    :func:`build_smoke`'s train cell."""
    if batch % train.accum:
        raise ValueError(f"batch {batch} is not a multiple of accum "
                         f"{train.accum}")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = init_from_specs(T.param_specs(cfg), gen)
    S = SHAPE_DEFS["train_4k"]["seq"]
    return _train_cell(cfg, train, params,
                       _tokens_and_labels(gen, cfg, batch, S), train.accum,
                       train.lr)


# ------------------------------------------------------------ the full cells
LM_SHAPES = tuple(SHAPE_DEFS)
# (L, B, Hkv, S, hd); cache_seq picks up every mesh axis batch leaves free
CACHE_AXES = ("layers", "batch", "kv_heads", "cache_seq", None)


def _prefill_fn(params, tokens, cfg):
    with torch.no_grad():
        return T.prefill(params, tokens, cfg)


def _decode_fn(params, cache, tokens, lengths, cfg):
    with torch.no_grad():
        return T.decode_step(params, cache, tokens, lengths, cfg)


def build_cell(cfg: T.TransformerConfig, train: TrainSetting, shape: str,
               device=None, reduced: dict | None = None,
               seed: int = 0) -> CellPlan:
    """The JAX package's ``lm_common.build_cell``: ``train_4k`` a train
    step ``(params, opt_state, batch, lr)``, ``prefill_32k`` ``(params,
    tokens)``, ``decode_32k`` and ``long_500k`` one decode step ``(params,
    (k, v), tokens, lengths)`` against an (L, B, Hkv, S, hd) cache in the
    compute dtype, every live row but the new token's. On ``device="meta"``
    nothing is allocated; on a real device the parameters are drawn from
    ``seed`` (each layer at its full depth's scale), tokens uniform, the
    cache normal. ``reduced`` cuts the batch (``"batch"``) and the depth
    (``"n_layers"``); a train cell's microbatches are then the gcd of the
    arch's and the batch."""
    d = SHAPE_DEFS[shape]
    reduced = dict(reduced or {})
    B, S = reduced.get("batch", d["batch"]), d["seq"]
    depth = cfg.n_layers
    if "n_layers" in reduced:
        cfg = dataclasses.replace(cfg, n_layers=reduced["n_layers"])
    dims = {"batch": B, "n_layers": cfg.n_layers}
    dev = None if on_meta(device) else resolve_device(device)
    gen = None if dev is None else generator(dev, seed)
    specs = T.param_specs(cfg)
    params = spec_to_meta(specs) if gen is None \
        else init_from_specs(specs, gen, depth=depth)

    def ints(hi, shape):
        if gen is None:
            return meta(shape, torch.int32)
        return torch.randint(0, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    if d["kind"] == "train":
        accum = math.gcd(train.accum, B)
        o_specs = opt_state_specs(train.optimizer, specs)
        opt = get_optimizer(train.optimizer)
        opt_state = spec_to_meta(o_specs) if gen is None \
            else opt.init(params)
        batch = {"labels": ints(cfg.vocab, (B, S)),
                 "tokens": ints(cfg.vocab, (B, S))}
        lr = meta(()) if gen is None else torch.tensor(train.lr, device=dev)
        step = make_train_step(functools.partial(T.loss_fn, cfg=cfg), opt,
                               accum_steps=accum)
        return CellPlan(
            cfg.name, shape, step, (params, opt_state, batch, lr),
            kind="train", notes=f"accum={accum} opt={train.optimizer}",
            reduced=reduced, dims=dims,
            arg_axes=(specs, o_specs, {"labels": ("batch", None),
                                       "tokens": ("batch", None)}, ()),
            rules=train.train_rules)
    if d["kind"] == "prefill":
        return CellPlan(
            cfg.name, shape, functools.partial(_prefill_fn, cfg=cfg),
            (params, ints(cfg.vocab, (B, S))), kind="serve", reduced=reduced,
            dims=dims,            arg_axes=(specs, ("batch", "sequence")))
    kv_shape = (cfg.n_layers, B, cfg.n_kv_heads, S, cfg.head_dim)
    if gen is None:
        cache = (meta(kv_shape, cfg.compute_dtype),
                 meta(kv_shape, cfg.compute_dtype))
        lengths = meta((B,), torch.int32)
    else:
        cache = tuple(torch.randn(kv_shape, generator=gen, device=dev,
                                  dtype=cfg.compute_dtype) for _ in range(2))
        lengths = torch.full((B,), S - 1, dtype=torch.int32, device=dev)
    return CellPlan(
        cfg.name, shape, functools.partial(_decode_fn, cfg=cfg),
        (params, cache, ints(cfg.vocab, (B,)), lengths), kind="serve",
        reduced=reduced, dims=dims,
        arg_axes=(specs, (CACHE_AXES, CACHE_AXES), ("batch",), ("batch",)))


def smoke_plan(cfg: T.TransformerConfig, train: TrainSetting, shape: str,
               device=None) -> CellPlan:
    """:func:`build_smoke`'s cell as a ``CellPlan``."""
    c = build_smoke(cfg, train, shape, device=device)
    kind = SHAPE_DEFS[shape]["kind"]
    name = c["cfg"].name
    if kind == "train":
        return CellPlan(name, shape, c["step"], (c["params"], c["opt_state"],
                                                 c["batch"], c["lr"]),
                        notes=f"accum={c['accum']} opt={train.optimizer}")
    if kind == "prefill":
        return CellPlan(name, shape,
                        functools.partial(_prefill_fn, cfg=c["cfg"]),
                        (c["params"], c["tokens"]), kind="serve")
    return CellPlan(name, shape, functools.partial(_decode_fn, cfg=c["cfg"]),
                    (c["params"], c["cache"], c["tokens"], c["lengths"]),
                    kind="serve")


def make_arch(arch_id: str, cfg: T.TransformerConfig,
              train: TrainSetting) -> ArchSpec:
    return ArchSpec(
        arch_id=arch_id, family=FAMILY, shapes=LM_SHAPES,
        build=functools.partial(build_cell, cfg, train),
        build_smoke=functools.partial(smoke_plan, cfg, train),
        describe=f"{cfg.n_layers}L d={cfg.d_model} "
                 f"{'MoE' if cfg.is_moe else 'dense'}")
