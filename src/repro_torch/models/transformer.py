"""Decoder-only GQA transformer family (granite / internlm2 / command-r /
arctic / dbrx) with optional Mixture-of-Experts FFNs.

The JAX package's ``models/transformer.py`` in PyTorch, with its entry
points:

  loss_fn        train_4k     tokens -> mean CE + z-loss + 0.01 * MoE aux
  forward        tokens -> logits (B, S, V) + MoE aux loss
  trunk          embedding + layers + final norm (no vocab projection)
  prefill        tokens -> last-token logits + KV cache (L, B, Hkv, S, hd)
  decode_step    one new token per batch row against a live KV cache

MoE has the JAX package's two dispatch implementations, with its capacity
formulas and drop rules: 'einsum' (GShard one-hot dispatch/combine
einsums) and 'sort' (per-row sort of the assignments by expert into
(E, C) slots, gathered back). The expert products are batched matmuls, as
in JAX (no Pallas kernel there either). Routing reproduces
``jax.lax.top_k``'s order, the lower expert first on equal probabilities.

Attention: ``prefill`` and ``decode_step`` go through the hand-written
flash-attention kernels (``kernels.flash_attention.ops``): ``flash_attention``
in prefill, ``flash_decode`` in decode. ``attention=`` runs a plain
attention function instead (``common.blocked_attention``, the JAX
package's production path, or the kernels' own plain version
``attention_ref``), so a caller can hold the kernel path against a plain
one on the card. The training entry points (``trunk``, ``forward``,
``loss_fn``) attend through ``common.blocked_attention`` with
``cfg.q_chunk``, as the JAX package trains: the kernels have no backward
(their wrappers raise rather than cut the graph). With ``remat == "full"``
each layer runs under ``torch.utils.checkpoint`` (the JAX package's
``jax.checkpoint`` of the scan body) and is recomputed in the backward;
the loss's vocab projection is ``common.fused_ce_loss``, in chunks of
``cfg.ce_chunk`` recomputed the same way. The layer-stacked leaves enter
the layer loop through ``unbind``, so their gradient is stacked once per
backward.

Parameters are a nested dict of tensors laid out as the JAX package's
(layer-stacked ``(L, ...)`` leaves under ``"layers"``). Matrices are cast to
the compute dtype at each use, as in JAX; ``serving_params`` casts them once
ahead (the same numbers, since a cast of a cast is the cast), and the casts
at use are then no-ops. The port runs on one card: the JAX package's
``constrain`` sharding hints do nothing without a mesh and are dropped.
``_ffn`` returns the MoE load-balance loss; ``prefill`` and
``decode_step`` drop it, as JAX does.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention import ops as flash
from repro_torch.models.common import (
    ParamSpec,
    apply_rope,
    blocked_attention,
    fused_ce_loss,
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
    # MoE (n_experts == 0 => dense FFN)
    n_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    moe_dense_residual: bool = False   # arctic: dense FFN in parallel with MoE
    moe_impl: str = "einsum"           # 'einsum' | 'sort'
    # numerics / memory
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    remat: str = "full"                # 'none' | 'full'
    q_chunk: int = 512
    ce_chunk: int = 512                # fused-CE sequence chunk
    z_loss: float = 1e-4
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
                   "w_up", "w_down", "router", "we_gate", "we_up", "we_down")
_MOE_LEAVES = ("router", "we_gate", "we_up", "we_down")


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


def _route(x, router, k: int):
    """Router logits in x's dtype, fp32 softmax, top ``k`` experts per token
    with their gates renormalised. x: (B, S, D). Returns (probs (B, S, E)
    fp32, gate_vals (B, S, k) fp32, gate_idx (B, S, k) int64).

    The top k come from a stable descending sort, so equal probabilities
    (router logits are rounded to the compute dtype before the softmax)
    keep the lower expert first, as ``jax.lax.top_k`` does; ``torch.topk``
    promises no order on ties."""
    logits = x @ router.to(x.dtype)
    probs = torch.softmax(logits.float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[..., :k], idx[..., :k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate_vals, gate_idx


def _capacity_einsum(cfg: TransformerConfig, S: int) -> int:
    return max(4, int(cfg.capacity_factor * S * cfg.top_k / cfg.n_experts
                      + 0.999) // 4 * 4)


def _capacity_sort(cfg: TransformerConfig, S: int) -> int:
    return max(4, int(cfg.capacity_factor * S * cfg.top_k / cfg.n_experts
                      + 3.0) // 4 * 4)


def _dispatch_einsum(gate_idx, gate_vals, E: int, C: int, dtype):
    """GShard one-hot dispatch and combine tensors, (B, S, E, C) each
    (dispatch in ``dtype``, combine fp32). Choice j of every token is placed
    before choice j + 1 of any token; within a choice, tokens in sequence
    order; an expert's assignments past C slots are dropped, per batch
    row."""
    B, S, k = gate_idx.shape
    disp = torch.zeros((B, S, E, C), dtype=dtype, device=gate_idx.device)
    comb = torch.zeros((B, S, E, C), dtype=torch.float32,
                       device=gate_idx.device)
    counts = torch.zeros((B, E), dtype=torch.int64, device=gate_idx.device)
    for j in range(k):
        mask_j = F.one_hot(gate_idx[..., j], E)                 # (B, S, E)
        pos_j = mask_j.cumsum(1) - 1 + counts[:, None, :]
        keep = (mask_j > 0) & (pos_j < C)
        slot = F.one_hot(torch.where(keep, pos_j, C), C + 1)[..., :C].to(
            dtype)                                              # (B,S,E,C)
        disp = disp + slot
        comb = comb + slot.float() * gate_vals[..., j][..., None, None]
        counts = counts + mask_j.sum(1)
    return disp, comb


def _moe_ffn_einsum(x, p, cfg: TransformerConfig):
    """GShard-style group-wise einsum dispatch. x: (B, S, D); p: one
    layer's ``router``, ``we_gate``, ``we_up``, ``we_down``. Returns
    (out (B, S, D), load-balance loss)."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    probs, gate_vals, gate_idx = _route(x, p["router"], k)
    disp, comb = _dispatch_einsum(gate_idx, gate_vals, E,
                                  _capacity_einsum(cfg, S), x.dtype)
    xd = torch.einsum("gsec,gsd->egcd", disp, x)
    h = F.silu(torch.einsum("egcd,edf->egcf", xd, p["we_gate"].to(x.dtype)))
    h = h * torch.einsum("egcd,edf->egcf", xd, p["we_up"].to(x.dtype))
    y = torch.einsum("egcf,efd->egcd", h, p["we_down"].to(x.dtype))
    out = torch.einsum("gsec,egcd->gsd", comb.to(x.dtype), y)
    aux = _load_balance_loss(probs.reshape(-1, E), gate_idx.reshape(-1, k), E)
    return out, aux


def _dispatch_sort(gate_idx, E: int, C: int):
    """Per batch row, the S * k assignments sorted stably by expert (the
    order ``jnp.argsort`` gives, which decides what an over-full expert
    drops); slot = rank within the expert's run, kept if below C. Returns
    (order, e_sorted, slot, keep) in sorted order, each (B, S * k), and
    (slot, keep) per assignment, each (B, S, k)."""
    B, S, k = gate_idx.shape
    dev = gate_idx.device
    flat_e = gate_idx.reshape(B, S * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    e_sorted = flat_e.gather(1, order)
    ar = torch.arange(S * k, device=dev)
    run_start = torch.searchsorted(
        e_sorted, torch.arange(E, device=dev).expand(B, E).contiguous(),
        side="left")
    slot = ar - run_start.gather(1, e_sorted)
    keep = slot < C
    inv = torch.empty_like(order).scatter_(1, order, ar.expand(B, -1))
    return (order, e_sorted, slot, keep,
            slot.gather(1, inv).reshape(B, S, k),
            keep.gather(1, inv).reshape(B, S, k))


def _moe_ffn_sort(x, p, cfg: TransformerConfig):
    """Per-row sort-based dispatch: no (B, S, E, C) dispatch tensors.
    x: (B, S, D); p as in :func:`_moe_ffn_einsum`.

    Every batch row is dispatched on its own (capacity C per row and
    expert, as JAX's vmap over rows), all rows at once. The expert
    buffers are one (E * B * C + 1, D) matrix, expert-major: each kept
    assignment writes its own row (kept (expert, row, slot) triples are
    unique), every dropped one the spare last row, which no expert reads
    (JAX adds zeros at slot 0 for them)."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = _capacity_sort(cfg, S)
    probs, gate_vals, gate_idx = _route(x, p["router"], k)
    order, e_sorted, slot, keep, slot_sk, keep_sk = _dispatch_sort(
        gate_idx, E, C)
    bidx = torch.arange(B, device=x.device)[:, None]
    rows = torch.where(keep, e_sorted * (B * C) + bidx * C + slot, E * B * C)
    buf = x.new_zeros((E * B * C + 1, D))
    buf[rows] = x[bidx, order // k]
    xe = buf[:-1].view(E, B * C, D)
    h = F.silu(torch.bmm(xe, p["we_gate"].to(x.dtype))) \
        * torch.bmm(xe, p["we_up"].to(x.dtype))
    y = torch.bmm(h, p["we_down"].to(x.dtype)).view(E * B * C, D)
    rows_sk = gate_idx * (B * C) + bidx[..., None] * C \
        + torch.where(keep_sk, slot_sk, 0)
    picked = y[rows_sk].masked_fill(~keep_sk[..., None], 0.0)  # (B,S,k,D)
    out = (picked * gate_vals[..., None].to(x.dtype)).sum(dim=2)
    aux = _load_balance_loss(probs.reshape(-1, E), gate_idx.reshape(-1, k), E)
    return out, aux


def _load_balance_loss(probs, gate_idx, E: int):
    """Switch-style aux loss: E * sum_e f_e * p_e."""
    f = F.one_hot(gate_idx[..., 0], E).float().mean(dim=0)
    return E * (f * probs.mean(dim=0)).sum()


_MOE_IMPLS = {"einsum": _moe_ffn_einsum, "sort": _moe_ffn_sort}


def _dense_ffn(x, lw, cdt):
    return _swiglu(x, lw["w_gate"].to(cdt), lw["w_up"].to(cdt),
                   lw["w_down"].to(cdt))


def _layer_weights(lp, l: int) -> dict:
    """Layer ``l``'s slice of every layer-stacked leaf."""
    return {k: v[l] for k, v in lp.items()}


def _layer_ffn(x, lw, cfg: TransformerConfig):
    """One layer's FFN on that layer's weights ``lw``: (out, load-balance
    loss; 0.0 for a dense FFN)."""
    if not cfg.is_moe:
        return _dense_ffn(x, lw, cfg.compute_dtype), 0.0
    if cfg.moe_impl not in _MOE_IMPLS:
        raise ValueError(f"moe_impl {cfg.moe_impl!r} not in "
                         f"{sorted(_MOE_IMPLS)}")
    out, aux = _MOE_IMPLS[cfg.moe_impl](x, lw, cfg)
    if cfg.moe_dense_residual:
        out = out + _dense_ffn(x, lw, cfg.compute_dtype)
    return out, aux


def _ffn(x, lp, l: int, cfg: TransformerConfig):
    """Layer ``l``'s FFN from the layer-stacked leaves ``lp``: (out,
    load-balance loss; 0.0 for a dense FFN)."""
    return _layer_ffn(x, _layer_weights(lp, l), cfg)


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


def _qkv(x, lw, cdt, cos, sin):
    """One layer's q, k (RoPE applied) and v, each (B, H, S, hd)
    contiguous. x: (B, S, D)."""
    q = apply_rope(_project(x, lw["wq"], cdt), cos, sin)
    kk = apply_rope(_project(x, lw["wk"], cdt), cos, sin)
    vv = _project(x, lw["wv"], cdt)
    return tuple(t.transpose(1, 2).contiguous() for t in (q, kk, vv))


def _attention(x, lp, l: int, cfg: TransformerConfig, cos, sin, *,
               attention):
    """Prefill attention of layer ``l``. x: (B, S, D). Returns
    (out (B, S, D), (k, v) each (B, Hkv, S, hd))."""
    cdt = cfg.compute_dtype
    q, kk, vv = _qkv(x, _layer_weights(lp, l), cdt, cos, sin)
    if attention is None:
        o = flash.flash_attention(q, kk, vv, causal=True)
    else:
        o = attention(q, kk, vv, causal=True, lengths=None)
    return _out_proj(o, lp["wo"][l], cdt), (kk, vv)


def _layer(x, lw, cfg: TransformerConfig, cos, sin):
    """One layer of the training forward on that layer's weights ``lw``:
    (x, MoE load-balance loss). Attention is ``blocked_attention``."""
    cdt = cfg.compute_dtype
    q, kk, vv = _qkv(rms_norm(x, lw["ln1"]), lw, cdt, cos, sin)
    o = blocked_attention(q, kk, vv, causal=True, q_chunk=cfg.q_chunk)
    x = x + _out_proj(o, lw["wo"], cdt)
    f, aux = _layer_ffn(rms_norm(x, lw["ln2"]), lw, cfg)
    return x + f, aux


def _logits(x, params, cfg: TransformerConfig):
    """Final norm, vocab projection, padded vocab masked to -1e9 so greedy
    decoding never picks a padded id. x: (B, D)."""
    cdt = cfg.compute_dtype
    x = rms_norm(x, params["final_norm"])
    logits = x @ params["lm_head"].to(cdt)
    valid = torch.arange(logits.shape[-1], device=logits.device) < cfg.vocab
    return logits.masked_fill(~valid, -1e9)


# ---------------------------------------------------------------- training
def trunk(params, tokens: torch.Tensor, cfg: TransformerConfig):
    """Embedding + all layers + final norm (no vocab projection). tokens
    (B, S) int -> (x (B, S, D) in the compute dtype, mean over layers of
    the MoE load-balance loss (0 for a dense model))."""
    cdt = cfg.compute_dtype
    x = params["embed"][tokens.long()].to(cdt)
    S = tokens.shape[1]
    cos, sin = rope_angles(torch.arange(S, device=tokens.device),
                           cfg.head_dim, cfg.rope_base)
    # one view a layer of every stacked leaf; the backward stacks them once
    layers = {k: v.unbind(0) for k, v in params["layers"].items()}
    remat = cfg.remat == "full" and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for l in range(cfg.n_layers):
        lw = {k: v[l] for k, v in layers.items()}
        if remat:
            x, a = checkpoint(_layer, x, lw, cfg, cos, sin,
                              use_reentrant=False, preserve_rng_state=False)
        else:
            x, a = _layer(x, lw, cfg, cos, sin)
        aux = aux + a
    return rms_norm(x, params["final_norm"]), aux / cfg.n_layers


def forward(params, tokens: torch.Tensor, cfg: TransformerConfig):
    """tokens (B, S) int -> (logits (B, S, V_pad) in the compute dtype,
    MoE aux loss)."""
    x, aux = trunk(params, tokens, cfg)
    return x @ params["lm_head"].to(cfg.compute_dtype), aux


def loss_fn(params, batch, cfg: TransformerConfig):
    """Fused vocab projection + CE: the (B, S, V) logits never
    materialize. batch: ``tokens``, ``labels`` (B, S) int. Returns (ce +
    z-loss + 0.01 * aux, {"ce", "aux"})."""
    x, aux = trunk(params, batch["tokens"], cfg)
    ce, zl = fused_ce_loss(
        x, params["lm_head"], batch["labels"], n_valid_vocab=cfg.vocab,
        z_loss=cfg.z_loss, chunk=cfg.ce_chunk)
    return ce + zl + 0.01 * aux, {"ce": ce, "aux": aux}


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
        x = x + _ffn(rms_norm(x, lp["ln2"][l]), lp, l, cfg)[0]
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
        x = x + _ffn(rms_norm(x, lp["ln2"][l]), lp, l, cfg)[0]
    return _logits(x[:, 0], params, cfg), cache, live
