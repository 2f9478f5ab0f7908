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
at use are then no-ops. ``_ffn`` returns the MoE load-balance loss;
``prefill`` and ``decode_step`` drop it, as JAX does.

The model calls ``distributed.sharding.constrain`` where the JAX package
does. Outside ``activation_sharding`` it returns its input, and every
path above runs as on one card. Inside one (``CellPlan.on_mesh``) the
serve path (``prefill``, ``decode_step``) runs on DTensors placed by
the sharding rules, as GSPMD partitions the JAX package's: each layer's
weights are gathered over the FSDP (``embed``) axes once per use
(``sharding.gather_dim``), the embedding lookup is vocab-parallel (a
rank's vocab rows, the others masked, summed over the vocab's mesh dims),
the padded-vocab mask takes the rank's vocab offset, the flash kernels run
on each rank's local heads (``flash_attention.ops``), a decode step writes
the new token's k/v on the rank that holds its cache row, and the
row-parallel products (attention out, FFN down) are all-reduced by the
``constrain`` that follows them, their partials in the compute dtype, as
GSPMD adds them; an MoE FFN runs on each rank's local rows and experts
(``_experts``: router and experts gathered over their FSDP axes, each
rank's ``expert`` shard of the experts; the sort dispatch all-gathers
the expert outputs over the experts' mesh dims, the einsum dispatch's
combine is a partial sum). The training path (``trunk``, ``forward``,
``loss_fn``) runs placed the same way, with gradients: the lookup
vocab-parallel, each layer ending on ``_RES_AXES`` (under
``residual_sp`` the sequence gathered into the layer and
reduce-scattered out of it), ``blocked_attention`` on each rank's local
heads, the fused cross entropy vocab-parallel, and a checkpointed layer
recomputed under the forward's ``activation_sharding``; an MoE FFN's
local views carry the gradient placements of their partial sums
(``_Experts.grads``, ``_Experts.once``), and its load-balance loss is
the global batch's (``_aux``).
"""
from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import (
    activation_sharding,
    constrain,
    constrain_to,
    current_sharding,
    dim_shard,
    from_local,
    gather_dim,
    is_placed,
    mesh_dims,
    redistribute,
    replicated_like,
)
from repro_torch.kernels.flash_attention import ops as flash
from repro_torch.models.common import (
    ParamSpec,
    apply_rope,
    blocked_attention,
    fused_ce_loss,
    leaf_sources,
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


def serving_sources(cfg: TransformerConfig, generator: torch.Generator,
                    depth: int | None = None):
    """``serving_params(init_from_specs(param_specs(cfg), generator,
    depth), cfg)`` a leaf at a time (``common.leaf_sources``): functions of
    no arguments, each drawing its leaf and casting it as
    ``serving_params`` does; ``sharding.place`` calls them in order, and a
    rank keeps only its shard of each."""
    src = leaf_sources(param_specs(cfg), generator, depth)

    def cast(f):
        return lambda: f().to(cfg.compute_dtype)

    out = {k: cast(f) if k in _COMPUTE_LEAVES else f
           for k, f in src.items() if k != "layers"}
    out["layers"] = {k: cast(f) if k in _COMPUTE_LEAVES else f
                     for k, f in src["layers"].items()}
    return out


# --------------------------------------------------------------------- ffn
def _swiglu(x, w_gate, w_up, w_down):
    h = F.silu(_col_product(x, w_gate)) * _col_product(x, w_up)
    h = constrain(h, ("act_batch", "act_seq", "act_mlp"))
    return _row_product(h, w_down)


def _col_product(x, w):
    """``x @ w`` where the mesh shards ``w``'s columns (the attention's
    q, k, v and the FFN's gate and up products): placed, each rank's
    cotangent of ``x`` is a partial sum over its columns, which the
    backward of the ``constrain`` before the product sums in the compute
    dtype."""
    return x @ w


def _row_product(h, w):
    """``h @ w`` where the contraction runs over a dim the mesh shards (the
    FFN's down and the attention's out products): placed, each rank's
    product is a partial sum in the compute dtype, and the ``constrain``
    that follows all-reduces the partials in that dtype, as GSPMD does."""
    return h @ w


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


# the JAX package's constraints on the dispatched tokens and the expert
# outputs: einsum (E, B, C, D), sort (B, E, C, D)
_EINSUM_AXES = ("act_expert", "act_batch", None, None)
_SORT_AXES = ("act_batch", "act_expert", None, None)


@dataclasses.dataclass(frozen=True)
class _Experts:
    """Where an MoE FFN runs: on one device every expert and every batch
    row (``mesh`` None); placed, this rank's batch rows (``B`` of them
    in all, sharded over the mesh dims ``rows``) and its experts ``lo``
    .. ``lo + n`` (of ``E``, sharded over the mesh dims ``experts``)."""

    mesh: object
    rows: tuple
    experts: tuple
    lo: int
    n: int
    B: int
    E: int

    def _placements(self, batch_dim: int, expert_dim: int | None,
                    partial: bool = False) -> list:
        from torch.distributed.tensor import Partial, Replicate, Shard

        out = []
        for i in range(self.mesh.ndim):
            if i in self.rows:
                out.append(Shard(batch_dim))
            elif i in self.experts and partial:
                out.append(Partial())
            elif i in self.experts and expert_dim is not None:
                out.append(Shard(expert_dim))
            else:
                out.append(Replicate())
        return out

    def hold(self, t, axes, batch_dim: int, expert_dim: int):
        """``constrain(t, axes)`` of this rank's local ``t`` (its batch rows
        at ``batch_dim``, its experts at ``expert_dim``): on one device a
        no-op; placed, the rules must place the whole tensor where the
        rank's slice already lies, so nothing moves."""
        if self.mesh is None:
            return constrain(t, axes)
        shape = list(t.shape)
        shape[batch_dim], shape[expert_dim] = self.B, self.E
        pl = self._placements(batch_dim, expert_dim)
        got = constrain(from_local(t, self.mesh, pl, shape), axes)
        if tuple(got.placements) != tuple(pl):
            raise NotImplementedError(
                f"the rules place {axes} on {got.placements}, not where the "
                f"rank's experts and rows lie ({pl})")
        return t

    def gathered(self, y, C: int):
        """The expert outputs ``y`` (this rank's experts, its rows' C slots
        each, D) with every expert's: all-gathered over the mesh dims that
        shard the experts, as GSPMD gathers the expert-sharded operand of
        a per-row gather."""
        if self.mesh is None or not self.experts:
            return y
        return gather_dim(from_local(y, self.mesh, self._placements(1, 0),
                                     (self.E, self.B * C, y.shape[2])),
                          0).to_local()

    def grads(self, t, experts: bool = True) -> list:
        """The gradient placements of this rank's local view of ``t``
        (``x``, the router or the experts, placed): its gradient comes from
        its own rows and, where ``experts``, its own experts, so it is a
        partial sum over those mesh dims where ``t`` is not sharded
        there."""
        from torch.distributed.tensor import Partial

        mine = set(self.rows) | (set(self.experts) if experts else set())
        return [Partial() if i in mine and not q.is_shard() else q
                for i, q in enumerate(t.placements)]

    def once(self, t):
        """``t`` as it is; placed, its cotangent kept on the first rank of
        the experts' mesh dims and zeroed on the others: a cotangent that
        every rank there computes alike (the routing's, where the combine
        is whole on every rank) counted once in a partial sum over those
        dims."""
        if self.mesh is None or not self.experts:
            return t
        coord = self.mesh.get_coordinate()
        return _Once.apply(t, any(coord[i] for i in self.experts))

    def out(self, t, partial: bool):
        """The FFN's output (this rank's rows, S, D) as the caller's
        tensor: placed, a DTensor on the rows' placements, Partial over
        the experts' mesh dims where each rank summed its own experts."""
        if self.mesh is None:
            return t
        return from_local(t, self.mesh, self._placements(0, None, partial),
                          (self.B,) + tuple(t.shape[1:]))


class _Once(torch.autograd.Function):
    """Forward ``t``; backward the cotangent, or zeros where ``zero``."""

    @staticmethod
    def forward(ctx, t, zero: bool):
        ctx.zero = zero
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return (torch.zeros_like(g) if ctx.zero else g), None


def _experts(x, p, router_partial: bool = False):
    """(x, one layer's MoE weights in x's dtype, ``_Experts``) of an MoE
    FFN. Placed, on this rank's local tensors, as GSPMD partitions the
    JAX package's FFN: the router gathered over its FSDP (``embed``) axes,
    the expert weights over theirs (each rank keeping the experts its
    ``expert`` axes give it; all of them where the divisibility guard
    replicates them), ``x`` this rank's batch rows (replicated over the
    other mesh dims, so every rank holding the same rows routes them
    alike).

    Their gradients (``_Experts.grads``): ``x``'s a partial sum over the
    experts' mesh dims (each rank dispatches to its own experts; the
    ``constrain`` before the FFN sums it), every weight's a partial over
    the rows' mesh dims (the FSDP gathers' backward reduce-scatters it),
    the router's also over the experts' dims where ``router_partial``
    (the einsum's gates see only the rank's experts), summed there once
    the gather's backward has reduce-scattered it."""
    cast = {k: p[k].to(x.dtype) for k in _MOE_LEAVES}
    E = p["we_gate"].shape[0]
    if not is_placed(x):
        return x, cast, _Experts(None, (), (), 0, E, x.shape[0], E)
    rows = tuple(mesh_dims(x, 0))
    if any(not (q.is_replicate() or i in rows)
           for i, q in enumerate(x.placements)):
        raise NotImplementedError(f"an MoE FFN on {x.placements}: only its "
                                  f"batch rows placed on the mesh are ported")
    router = cast["router"]
    if router_partial:
        router = constrain_to(router, router.placements)
    w = dict(router=gather_dim(router, 0),
             we_gate=gather_dim(cast["we_gate"], 1),
             we_up=gather_dim(cast["we_up"], 1),
             we_down=gather_dim(cast["we_down"], 2))
    experts = tuple(mesh_dims(w["we_gate"], 0))
    for k, t in w.items():
        held = [i for i, q in enumerate(t.placements) if not q.is_replicate()]
        want = [] if k == "router" else list(experts)
        if held != want or mesh_dims(t, 0) != want or set(experts) & set(rows):
            raise NotImplementedError(
                f"{k} on {t.placements} with the rows on mesh dims {rows}: "
                f"only experts sharded apart from the rows are ported")
    idx, n_shards = dim_shard(w["we_gate"], 0)
    n = E // n_shards
    ex = _Experts(x.device_mesh, rows, experts, idx * n, n, x.shape[0], E)
    return x.to_local(grad_placements=ex.grads(x)), {
        k: t.to_local(grad_placements=ex.grads(
            t, k != "router" or router_partial)) for k, t in w.items()}, ex


def _aux(probs, gate_idx, ex: _Experts, want: bool):
    """The load-balance loss of the batch (None unless ``want``): on one
    device its tokens'; placed, the JAX package's means over the global
    batch: each rank's fp32 sums of its rows' top-1 one-hot counts and
    probabilities summed over the rows' mesh dims and divided by the
    global token count, so the loss is the same on every rank and its
    gradient reaches each rank's probabilities."""
    if not want:
        return None
    E, k = probs.shape[-1], gate_idx.shape[-1]
    if ex.mesh is None:
        return _load_balance_loss(probs.reshape(-1, E),
                                  gate_idx.reshape(-1, k), E)
    from repro_torch.launch.mesh import all_reduce_sum

    counts = F.one_hot(gate_idx[..., 0].reshape(-1), E).float().sum(0)
    sums = all_reduce_sum(torch.stack([counts, probs.reshape(-1, E).sum(0)]),
                          ex.mesh, ex.rows)
    n = ex.B * probs.shape[1]
    return E * ((sums[0] / n) * (sums[1] / n)).sum()


def _moe_ffn_einsum(x, p, cfg: TransformerConfig, aux: bool = True):
    """GShard-style group-wise einsum dispatch. x: (B, S, D); p: one
    layer's ``router``, ``we_gate``, ``we_up``, ``we_down``. Returns
    (out (B, S, D), the load-balance loss; None unless ``aux``).

    Placed (:func:`_experts`): each rank dispatches its rows to its own
    experts (the dispatch and combine tensors sliced to them), and its
    combine is a partial sum over the experts' mesh dims, which the
    ``constrain`` after the FFN sums in the compute dtype, as GSPMD
    does. In the backward the gates' cotangent is then a partial over
    those dims too, the load-balance loss's counted once there."""
    x, p, ex = _experts(x, p, router_partial=True)
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    probs, gate_vals, gate_idx = _route(x, p["router"], k)
    disp, comb = _dispatch_einsum(gate_idx, gate_vals, E,
                                  _capacity_einsum(cfg, S), x.dtype)
    mine = slice(ex.lo, ex.lo + ex.n)
    disp, comb = disp[:, :, mine], comb[:, :, mine]
    xd = ex.hold(torch.einsum("gsec,gsd->egcd", disp, x), _EINSUM_AXES, 1, 0)
    h = F.silu(torch.einsum("egcd,edf->egcf", xd, p["we_gate"]))
    h = h * torch.einsum("egcd,edf->egcf", xd, p["we_up"])
    y = ex.hold(torch.einsum("egcf,efd->egcd", h, p["we_down"]),
                _EINSUM_AXES, 1, 0)
    out = torch.einsum("gsec,egcd->gsd", comb.to(x.dtype), y)
    return ex.out(out, partial=True), _aux(ex.once(probs), gate_idx, ex,
                                           aux)


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


def _moe_ffn_sort(x, p, cfg: TransformerConfig, aux: bool = True):
    """Per-row sort-based dispatch: no (B, S, E, C) dispatch tensors.
    x: (B, S, D); p as in :func:`_moe_ffn_einsum`.

    Every batch row is dispatched on its own (capacity C per row and
    expert, as JAX's vmap over rows), all rows at once. The expert
    buffers are one (E * B * C + 1, D) matrix, expert-major: each kept
    assignment writes its own row (kept (expert, row, slot) triples are
    unique), every dropped one the spare last row, which no expert reads
    (JAX adds zeros at slot 0 for them).

    Placed (:func:`_experts`): each rank writes only its own experts'
    slots of its rows (every other assignment goes to the spare row),
    runs its experts, and all-gathers their outputs over the experts'
    mesh dims; the pick and the combine then run as on one device, so the
    output is whole on every rank that holds the rows. In the backward
    every rank of the experts' dims computes the routing's cotangent
    alike (``_Experts.once`` counts it once in ``x``'s partial sum), the
    router's gradient is whole there, and the gathered outputs'
    cotangent is each rank's slice."""
    x, p, ex = _experts(x, p)
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = _capacity_sort(cfg, S)
    probs, gate_vals, gate_idx = _route(ex.once(x), p["router"], k)
    order, e_sorted, slot, keep, slot_sk, keep_sk = _dispatch_sort(
        gate_idx, E, C)
    bidx = torch.arange(B, device=x.device)[:, None]
    mine = keep & (e_sorted >= ex.lo) & (e_sorted < ex.lo + ex.n)
    rows = torch.where(mine, (e_sorted - ex.lo) * (B * C) + bidx * C + slot,
                       ex.n * B * C)
    buf = x.new_zeros((ex.n * B * C + 1, D))
    buf[rows] = _dispatched(x, bidx.expand_as(order), order // k, e_sorted)
    xe = buf[:-1].view(ex.n, B * C, D)
    ex.hold(xe.view(ex.n, B, C, D).transpose(0, 1), _SORT_AXES, 0, 1)
    h = F.silu(torch.bmm(xe, p["we_gate"])) * torch.bmm(xe, p["we_up"])
    y = torch.bmm(h, p["we_down"])
    ex.hold(y.view(ex.n, B, C, D).transpose(0, 1), _SORT_AXES, 0, 1)
    y = ex.gathered(y, C).reshape(E * B * C, D)
    rows_sk = gate_idx * (B * C) + bidx[..., None] * C \
        + torch.where(keep_sk, slot_sk, 0)
    picked = y[rows_sk].masked_fill(~keep_sk[..., None], 0.0)  # (B,S,k,D)
    out = (picked * gate_vals[..., None].to(x.dtype)).sum(dim=2)
    return ex.out(out, partial=False), _aux(probs, gate_idx, ex, aux)


def _dispatched(x, b, t, e):
    """``x[b, t]``: the tokens of the sort's assignments (batch row ``b``,
    token ``t``, expert ``e``). Placed, a rank's cotangent of ``x`` sums
    its own experts' assignments only, a partial over the experts' mesh
    dims."""
    return x[b, t]


def _load_balance_loss(probs, gate_idx, E: int):
    """Switch-style aux loss: E * sum_e f_e * p_e."""
    f = F.one_hot(gate_idx[..., 0], E).float().mean(dim=0)
    return E * (f * probs.mean(dim=0)).sum()


_MOE_IMPLS = {"einsum": _moe_ffn_einsum, "sort": _moe_ffn_sort}


def _dense_ffn(x, lw, cdt):
    return _swiglu(x, gather_dim(lw["w_gate"].to(cdt), 0),
                   gather_dim(lw["w_up"].to(cdt), 0),
                   gather_dim(lw["w_down"].to(cdt), 1))


def _layer_weights(lp, l: int) -> dict:
    """Layer ``l``'s slice of every layer-stacked leaf."""
    return {k: v[l] for k, v in lp.items()}


def _layer_ffn(x, lw, cfg: TransformerConfig, aux: bool = True):
    """One layer's FFN on that layer's weights ``lw``: (out, load-balance
    loss; 0.0 for a dense FFN, None for an MoE one unless ``aux``)."""
    if not cfg.is_moe:
        return _dense_ffn(x, lw, cfg.compute_dtype), 0.0
    if cfg.moe_impl not in _MOE_IMPLS:
        raise ValueError(f"moe_impl {cfg.moe_impl!r} not in "
                         f"{sorted(_MOE_IMPLS)}")
    out, aux = _MOE_IMPLS[cfg.moe_impl](x, lw, cfg, aux)
    if cfg.moe_dense_residual:
        dense = _dense_ffn(x, lw, cfg.compute_dtype)
        if is_placed(out) and not any(q.is_partial() for q in out.placements):
            # placed: the row-parallel partials summed (in the compute
            # dtype) before they meet the MoE output, whole on each rank
            dense = constrain(dense, _OUT_AXES)
        out = out + dense
    return out, aux


def _ffn(x, lp, l: int, cfg: TransformerConfig, aux: bool = True):
    """Layer ``l``'s FFN from the layer-stacked leaves ``lp``: (out,
    load-balance loss as :func:`_layer_ffn` gives it)."""
    return _layer_ffn(x, _layer_weights(lp, l), cfg, aux)


# ------------------------------------------------------------------- layer
def _project(x, w, cdt):
    """einsum("bsd,dhk->bshk", x, w) as one matrix product (w gathered
    over its FSDP axes when placed)."""
    D, H, hd = w.shape
    w = gather_dim(w.to(cdt), 0)
    return _col_product(x, w.reshape(D, H * hd)).unflatten(-1, (H, hd))


def _out_proj(o, wo, cdt):
    """einsum("bhsk,hkd->bsd", o, wo): o (B, Hq, S, hd)."""
    B, H, S, hd = o.shape
    return _row_product(o.to(cdt).transpose(1, 2).reshape(B, S, H * hd),
                        gather_dim(wo.to(cdt), 2).reshape(H * hd, -1))


_Q_AXES = ("act_batch", "act_seq", "act_heads", None)
_KV_AXES = ("act_batch", "act_seq", "act_kv_heads", None)
_O_AXES = ("act_batch", "act_heads", "act_seq", None)
_CACHE_AXES = ("act_batch", "act_kv_heads", "cache_seq", None)
_OUT_AXES = ("act_batch", "act_seq", "act_embed")
_RES_AXES = ("act_batch", "act_res_seq", "act_embed")


def _qkv(x, lw, cdt, cos, sin):
    """One layer's q, k (RoPE applied) and v, each (B, H, S, hd)
    contiguous. x: (B, S, D)."""
    cos, sin = replicated_like(x, cos), replicated_like(x, sin)
    q = constrain(apply_rope(_project(x, lw["wq"], cdt), cos, sin), _Q_AXES)
    kk = constrain(apply_rope(_project(x, lw["wk"], cdt), cos, sin),
                   _KV_AXES)
    vv = constrain(_project(x, lw["wv"], cdt), _KV_AXES)
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
    o = constrain(o, _O_AXES)
    return constrain(_out_proj(o, lp["wo"][l], cdt), _OUT_AXES).to(cdt), \
        (kk, vv)


def _layer(x, lw, cfg: TransformerConfig, cos, sin):
    """One layer of the training forward on that layer's weights ``lw``:
    (x, MoE load-balance loss). Attention is ``blocked_attention``
    (:func:`_train_attention`). Placed, the normed input is constrained
    to ``_OUT_AXES`` (under ``residual_sp`` the sequence gathered), each
    row-parallel product's partials are summed into the residual's
    placement (under ``residual_sp`` reduce-scattered over the sequence)
    and the layer ends on ``_RES_AXES``, as the JAX package's ``_layer``
    does."""
    cdt = cfg.compute_dtype
    q, kk, vv = _qkv(constrain(rms_norm(x, lw["ln1"]), _OUT_AXES), lw, cdt,
                     cos, sin)
    o = constrain(_train_attention(q, kk, vv, cfg.q_chunk), _O_AXES)
    x = x + constrain(_out_proj(o, lw["wo"], cdt), _RES_AXES)
    f, aux = _layer_ffn(constrain(rms_norm(x, lw["ln2"]), _OUT_AXES), lw,
                        cfg)
    return constrain(x + constrain(f, _RES_AXES), _RES_AXES), aux


def _layer_under(ctx, x, lw, cfg: TransformerConfig, cos, sin):
    """:func:`_layer` under the ``activation_sharding`` context ``ctx``
    (``current_sharding()`` of the forward; None: none): the checkpoint
    recomputes a layer during the backward, which autograd runs on its
    own thread for CUDA tensors, where the forward's thread-local context
    is not set."""
    if ctx is None:
        return _layer(x, lw, cfg, cos, sin)
    with activation_sharding(*ctx):
        return _layer(x, lw, cfg, cos, sin)


def _train_attention(q, k, v, q_chunk: int):
    """``blocked_attention`` (causal) of the training forward. Placed, on
    each rank's local heads: the kv heads its local query heads read are
    sliced where the kv heads are replicated (fewer kv heads than the
    ``model`` ranks), and their gradient is then a partial over those mesh
    dims, summed where the kv projection's gradient meets the others'."""
    if not is_placed(q):
        return blocked_attention(q, k, v, causal=True, q_chunk=q_chunk)
    from torch.distributed.tensor import Partial, Shard

    flash._check_placed(q, k, v, None, seq_ok=False)
    heads = flash._local_kv_heads(q, k)
    kv_grad = [Partial() if p.is_replicate() and qp == Shard(1) else p
               for p, qp in zip(k.placements, q.placements)]
    kl, vl = (t.to_local(grad_placements=kv_grad) for t in (k, v))
    if kl.shape[1] != heads.stop - heads.start:
        kl, vl = kl[:, heads], vl[:, heads]
    o = blocked_attention(q.to_local(), kl, vl, causal=True, q_chunk=q_chunk)
    return from_local(o, q.device_mesh, q.placements, q.shape)


def _logits(x, params, cfg: TransformerConfig):
    """Final norm, vocab projection, padded vocab masked to -1e9 so greedy
    decoding never picks a padded id. x: (B, D)."""
    cdt = cfg.compute_dtype
    x = rms_norm(x, params["final_norm"])
    logits = x @ gather_dim(params["lm_head"].to(cdt), 0)
    if is_placed(logits):     # the rank's vocab columns from its offset
        offset = dim_shard(logits, 1)[0] * _local_size(logits, 1)
        logits = from_local(_mask_vocab(logits.to_local(), cfg.vocab, offset),
                            logits.device_mesh, logits.placements,
                            logits.shape)
    else:
        logits = _mask_vocab(logits, cfg.vocab, 0)
    return constrain(logits, ("act_batch", "act_vocab"))


def _mask_vocab(logits, vocab: int, offset: int):
    """Logits of ids ``offset + j`` at or past ``vocab`` set to -1e9."""
    valid = torch.arange(logits.shape[-1], device=logits.device) \
        + offset < vocab
    return logits.masked_fill(~valid, -1e9)


# --------------------------------------------------------- placed helpers
def _local_size(x, dim: int) -> int:
    return x.shape[dim] // dim_shard(x, dim)[1]


def _embed(table, tokens, cdt):
    """The embedding rows of ``tokens`` in ``cdt``. Placed: vocab-parallel,
    as GSPMD partitions a gather from a vocab-sharded table: the table
    gathered over its FSDP axes, each rank looks up the ids in its vocab
    rows (the others give 0), and the result is partial over the vocab's
    mesh dims (summed by the ``constrain`` that follows)."""
    if not is_placed(table):
        return table[tokens.long()].to(cdt)
    from torch.distributed.tensor import Partial, Shard

    table = gather_dim(table.to(cdt), 1)
    vocab = mesh_dims(table, 0)
    if any(not table.placements[i].is_replicate() for i in range(
            table.device_mesh.ndim) if i not in vocab) or any(
            not tokens.placements[i].is_replicate() for i in vocab):
        raise ValueError(f"tokens {tokens.placements} and the table "
                         f"{table.placements} do not meet")
    V = _local_size(table, 0)
    lo = dim_shard(table, 0)[0] * V
    ids = tokens.to_local().long() - lo
    hit = (ids >= 0) & (ids < V)
    # a rank's rows are looked up by its own tokens: the table's gradient
    # is a partial over the mesh dims that shard the tokens
    grad = [Partial() if isinstance(t, Shard) else p
            for t, p in zip(tokens.placements, table.placements)]
    rows = table.to_local(grad_placements=grad)[ids.clamp(0, V - 1)]
    rows = rows.masked_fill(~hit[..., None], 0)
    placements = [Partial() if i in vocab else p
                  for i, p in enumerate(tokens.placements)]
    return from_local(rows, table.device_mesh, placements,
                      tuple(tokens.shape) + (table.shape[1],))


def _angles(positions, cfg: TransformerConfig):
    """RoPE's (cos, sin) at ``positions`` (placed as they are)."""
    if not is_placed(positions):
        return rope_angles(positions, cfg.head_dim, cfg.rope_base)
    return tuple(from_local(t, positions.device_mesh, positions.placements,
                            tuple(positions.shape) + (t.shape[-1],))
                 for t in rope_angles(positions.to_local(), cfg.head_dim,
                                      cfg.rope_base))


def _write_rows(cache_l, new, pos) -> None:
    """``cache_l[b, :, pos[b]] = new[b]`` in place for every batch row b.
    cache_l (B, Hkv, S, hd), new (B, Hkv, hd), pos (B,). Placed: on each
    rank's local shard, by the rank that holds row ``pos[b]`` only (the
    others write the row they hold back unchanged)."""
    if not is_placed(cache_l):
        bidx = torch.arange(new.shape[0], device=new.device)
        cache_l[bidx, :, pos.long()] = new.to(cache_l.dtype)
        return
    from torch.distributed.tensor import Replicate, Shard

    pl = cache_l.placements
    new = redistribute(new, [p if p in (Shard(0), Shard(1)) else Replicate()
                             for p in pl])
    pos = redistribute(pos, [p if p == Shard(0) else Replicate()
                             for p in pl])
    S = _local_size(cache_l, 2)
    local = cache_l.to_local()
    p = pos.to_local().long() - dim_shard(cache_l, 2)[0] * S
    mine = ((p >= 0) & (p < S))[:, None, None]
    p = p.clamp(0, S - 1)
    bidx = torch.arange(local.shape[0], device=local.device)
    local[bidx, :, p] = torch.where(mine, new.to_local().to(local.dtype),
                                    local[bidx, :, p])


# ---------------------------------------------------------------- training
def trunk(params, tokens: torch.Tensor, cfg: TransformerConfig):
    """Embedding + all layers + final norm (no vocab projection). tokens
    (B, S) int -> (x (B, S, D) in the compute dtype, mean over layers of
    the MoE load-balance loss (0 for a dense model)). Placed, the lookup
    is vocab-parallel (:func:`_embed`) and the residual stream constrained
    to ``_RES_AXES``."""
    cdt = cfg.compute_dtype
    x = constrain(_embed(params["embed"], tokens, cdt), _RES_AXES)
    S = tokens.shape[1]
    cos, sin = rope_angles(torch.arange(S, device=tokens.device),
                           cfg.head_dim, cfg.rope_base)
    # one view a layer of every stacked leaf; the backward stacks them once
    layers = {k: v.unbind(0) for k, v in params["layers"].items()}
    remat = cfg.remat == "full" and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    layer = functools.partial(_layer_under, current_sharding())
    for l in range(cfg.n_layers):
        lw = {k: v[l] for k, v in layers.items()}
        if remat:
            x, a = checkpoint(layer, x, lw, cfg, cos, sin,
                              use_reentrant=False, preserve_rng_state=False)
        else:
            x, a = layer(x, lw, cfg, cos, sin)
        aux = aux + a
    return rms_norm(x, params["final_norm"]), aux / cfg.n_layers


def forward(params, tokens: torch.Tensor, cfg: TransformerConfig):
    """tokens (B, S) int -> (logits (B, S, V_pad) in the compute dtype,
    MoE aux loss). Placed, the sequence is gathered where the residual
    stream shards it, ``lm_head`` gathered over its FSDP axes and the
    logits constrained to ``act_vocab`` (each rank its vocab columns)."""
    x, aux = trunk(params, tokens, cfg)
    x = constrain(x, _OUT_AXES)        # residual_sp: the sequence gathered
    logits = x @ gather_dim(params["lm_head"].to(cfg.compute_dtype), 0)
    return constrain(logits, ("act_batch", "act_seq", "act_vocab")), aux


def loss_fn(params, batch, cfg: TransformerConfig):
    """Fused vocab projection + CE: the (B, S, V) logits never
    materialize. batch: ``tokens``, ``labels`` (B, S) int. Returns (ce +
    z-loss + 0.01 * aux, {"ce", "aux"}); placed, each a plain tensor
    with the same value on every rank (``fused_ce_loss``'s
    vocab-parallel cross entropy)."""
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
    x = constrain(_embed(params["embed"], tokens, cdt), _RES_AXES)
    S = tokens.shape[1]
    cos, sin = rope_angles(torch.arange(S, device=tokens.device),
                           cfg.head_dim, cfg.rope_base)
    lp = params["layers"]
    ks, vs = [], []
    for l in range(cfg.n_layers):
        a, (kk, vv) = _attention(rms_norm(x, lp["ln1"][l]), lp, l, cfg, cos,
                                 sin, attention=attention)
        x = x + a
        f = _ffn(rms_norm(x, lp["ln2"][l]), lp, l, cfg, aux=False)[0]
        x = constrain(x + constrain(f, _OUT_AXES).to(cdt), _RES_AXES)
        ks.append(constrain(kk, _CACHE_AXES))
        vs.append(constrain(vv, _CACHE_AXES))
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
    k_cache, v_cache = cache
    x = constrain(_embed(params["embed"], tokens, cdt)[:, None, :],
                  _OUT_AXES)                                  # (B, 1, D)
    cos, sin = _angles(lengths[:, None], cfg)                 # (B, 1, half)
    live = lengths + 1
    lp = params["layers"]
    for l in range(cfg.n_layers):
        xn = rms_norm(x, lp["ln1"][l])
        q = apply_rope(_project(xn, lp["wq"][l], cdt), cos, sin)
        kk = apply_rope(_project(xn, lp["wk"][l], cdt), cos, sin)
        vv = _project(xn, lp["wv"][l], cdt)
        k_l, v_l = k_cache[l], v_cache[l]
        _write_rows(k_l, kk[:, 0], lengths)
        _write_rows(v_l, vv[:, 0], lengths)
        k_l, v_l = constrain(k_l, _CACHE_AXES), constrain(v_l, _CACHE_AXES)
        q = q.transpose(1, 2)                                 # (B, Hq, 1, hd)
        if attention is None:
            o = flash.flash_decode(q[:, :, 0].contiguous(), k_l, v_l,
                                   live)[:, :, None]
        else:
            o = attention(q, k_l, v_l, causal=False, lengths=live)
        o = constrain(o, _O_AXES)
        x = x + constrain(_out_proj(o, lp["wo"][l], cdt), _OUT_AXES).to(cdt)
        f = _ffn(rms_norm(x, lp["ln2"][l]), lp, l, cfg, aux=False)[0]
        x = constrain(x + constrain(f, _OUT_AXES).to(cdt), _OUT_AXES)
    return _logits(x[:, 0], params, cfg), cache, live
