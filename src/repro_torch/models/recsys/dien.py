"""DIEN: Deep Interest Evolution Network [arXiv:1809.03672], serve path.

The JAX package's ``models/recsys/dien.py`` in PyTorch, for CTR scoring:

  behavior embeddings  e_t = [item_embed ; cat_embed]            (2 * 18 = 36)
  interest extraction  GRU over the 100-step behavior sequence   (hidden 108)
  interest evolution   AUGRU — GRU whose update gate is scaled by
                       attention(h_t, target embedding)
  prediction MLP       [user features] -> 200 -> 80 -> 1 (sigmoid CTR)

The multi-hot user-profile lookup (``profile_embed``) goes through the
hand-written EmbeddingBag kernel (``kernels.embedding_bag.ops``), the
function the JAX package's Pallas ``embedding_bag`` kernel computes (on
CPU tensors its wrapper runs the plain version). The behaviour lookups stay
plain gathers, as the JAX package's ``jnp.take``. Each ``lax.scan`` is a
Python loop over the sequence. ``retrieval_score``, ``aux_loss`` and
``loss_fn`` wait (ROADMAP.md, 'Modules to port', item 13).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.embedding_bag import ops as bag_ops
from repro_torch.models.common import ParamSpec


@dataclasses.dataclass(frozen=True)
class DIENConfig:
    name: str = "dien"
    n_items: int = 1_000_000
    n_cats: int = 1_000
    embed_dim: int = 18
    seq_len: int = 100
    gru_dim: int = 108
    mlp_dims: tuple[int, ...] = (200, 80)
    n_profile_feats: int = 100_000     # multi-hot user-profile vocabulary
    profile_bag_size: int = 16         # multi-hot ids per user (padded)
    att_hidden: int = 80
    compute_dtype: torch.dtype = torch.float32

    @property
    def behav_dim(self) -> int:
        return 2 * self.embed_dim      # [item ; cat]


def _gru_specs(d_in: int, d_h: int, prefix: str):
    return {
        f"{prefix}_wx": ParamSpec((d_in, 3 * d_h), ("embed", "mlp")),
        f"{prefix}_wh": ParamSpec((d_h, 3 * d_h), (None, "mlp")),
        f"{prefix}_b": ParamSpec((3 * d_h,), (None,), init_scale=0.0),
    }


def param_specs(cfg: DIENConfig):
    d_b, d_h = cfg.behav_dim, cfg.gru_dim
    mlp_in = d_h + 2 * d_b + cfg.embed_dim   # interest + target + pooled + profile
    dims = (mlp_in, *cfg.mlp_dims, 1)
    mlp = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        mlp[f"w{i}"] = ParamSpec((a, b), ("embed" if i == 0 else None, None))
        mlp[f"b{i}"] = ParamSpec((b,), (None,), init_scale=0.0)
    return {
        "item_embed": ParamSpec((cfg.n_items, cfg.embed_dim), ("vocab", None)),
        "cat_embed": ParamSpec((cfg.n_cats, cfg.embed_dim), (None, None)),
        "profile_embed": ParamSpec((cfg.n_profile_feats, cfg.embed_dim),
                                   ("vocab", None)),
        **_gru_specs(d_b, d_h, "gru"),        # interest extraction
        **_gru_specs(d_h, d_h, "augru"),      # interest evolution (input: h_t)
        "att_w0": ParamSpec((d_h + d_b, cfg.att_hidden), (None, None)),
        "att_b0": ParamSpec((cfg.att_hidden,), (None,), init_scale=0.0),
        "att_w1": ParamSpec((cfg.att_hidden, 1), (None, None)),
        "mlp": mlp,
        # retrieval tower (retrieval_score is not ported; the leaf is kept so
        # parameter trees match the JAX package's)
        "ret_w": ParamSpec((d_h + d_b, cfg.embed_dim), (None, None)),
    }


# ----------------------------------------------------------------- GRU cells
def _gru_gates(p, prefix, x, h):
    """(x @ wx, h @ wh, b) in x's dtype."""
    dt = x.dtype
    return (x @ p[f"{prefix}_wx"].to(dt), h @ p[f"{prefix}_wh"].to(dt),
            p[f"{prefix}_b"].to(dt))


def _gru_step(p, prefix, x, h):
    """Standard GRU. x: (B, d_in), h: (B, d_h)."""
    d_h = h.shape[-1]
    gx, gh, b = _gru_gates(p, prefix, x, h)
    r, z, _ = torch.split(gx + gh + b, d_h, dim=-1)
    r, z = torch.sigmoid(r), torch.sigmoid(z)
    # candidate uses reset-scaled recurrent term
    n = torch.tanh(gx[:, 2 * d_h:] + r * gh[:, 2 * d_h:] + b[2 * d_h:])
    return (1.0 - z) * n + z * h


def _augru_step(p, x, h, att):
    """AUGRU: attention scales the update gate (DIEN eq. 8):
    u' = att * u;  h_t = (1 - u') h_{t-1} + u' h~_t  — att = 0 freezes h."""
    d_h = h.shape[-1]
    gx, gh, b = _gru_gates(p, "augru", x, h)
    r, z, _ = torch.split(gx + gh + b, d_h, dim=-1)
    r, z = torch.sigmoid(r), torch.sigmoid(z)
    z = att[:, None] * z
    n = torch.tanh(gx[:, 2 * d_h:] + r * gh[:, 2 * d_h:] + b[2 * d_h:])
    return (1.0 - z) * h + z * n


# ------------------------------------------------------------------ embedding
def behavior_embed(params, item_ids, cat_ids, cfg: DIENConfig):
    """(B, S) ids -> (B, S, 2*embed_dim)."""
    ei = params["item_embed"][item_ids.long()]
    ec = params["cat_embed"][cat_ids.long()]
    return torch.cat([ei, ec], dim=-1).to(cfg.compute_dtype)


def profile_embed(params, profile_ids, profile_mask, cfg: DIENConfig):
    """EmbeddingBag: multi-hot profile ids (B, n_bag) -> mean-pooled (B, d).
    One bag per row, weights = mask; the sum comes first, then the division
    by max(count, 1), in the JAX package's order. An all-masked row gives
    zeros."""
    B, n_bag = profile_ids.shape
    table = params["profile_embed"]
    ids = profile_ids.reshape(-1)
    w = profile_mask.reshape(-1).to(torch.float32)
    offsets = torch.arange(B, dtype=torch.int32, device=ids.device) * n_bag
    s = bag_ops.embedding_bag(table, ids, offsets, n_bags=B, weights=w)
    count = profile_mask.to(s.dtype).sum(dim=1, keepdim=True)
    return (s / count.clamp_min(1.0)).to(cfg.compute_dtype)


# -------------------------------------------------------------------- forward
def interest_states(params, behav, mask, cfg: DIENConfig):
    """GRU over the behavior sequence. behav: (B, S, d_b). Returns (B, S, d_h)."""
    B, S, _ = behav.shape
    h = torch.zeros((B, cfg.gru_dim), dtype=behav.dtype, device=behav.device)
    hs = []
    for t in range(S):
        h_new = _gru_step(params, "gru", behav[:, t], h)
        h = torch.where(mask[:, t, None], h_new, h)
        hs.append(h)
    return torch.stack(hs, dim=1)


def attention_scores(params, hs, target, mask):
    """(B, S, d_h) x (B, d_b) -> softmax scores (B, S)."""
    B, S, _ = hs.shape
    t = target[:, None, :].expand(B, S, target.shape[-1])
    a = torch.cat([hs, t], dim=-1)
    dt = a.dtype
    a = torch.sigmoid(a @ params["att_w0"].to(dt) + params["att_b0"].to(dt))
    logits = (a @ params["att_w1"].to(dt))[..., 0]
    logits = torch.where(mask, logits, torch.tensor(-1e9, dtype=logits.dtype,
                                                    device=logits.device))
    return torch.softmax(logits.float(), dim=-1).to(hs.dtype)


def evolve_interest(params, behav, hs, att, mask, cfg: DIENConfig):
    """AUGRU over interest states. Returns final state (B, d_h)."""
    B, S, _ = hs.shape
    h = torch.zeros((B, cfg.gru_dim), dtype=behav.dtype, device=behav.device)
    for t in range(S):
        h_new = _augru_step(params, hs[:, t], h, att[:, t])
        h = torch.where(mask[:, t, None], h_new, h)
    return h


def ctr_logits(params, batch, cfg: DIENConfig):
    """Full ranking path. batch keys: item_ids, cat_ids (B,S) int; mask (B,S)
    bool; target_item, target_cat (B,); profile_ids (B,n_bag); profile_mask."""
    behav = behavior_embed(params, batch["item_ids"], batch["cat_ids"], cfg)
    target = behavior_embed(params, batch["target_item"][:, None],
                            batch["target_cat"][:, None], cfg)[:, 0]
    mask = batch["mask"]
    hs = interest_states(params, behav, mask, cfg)
    att = attention_scores(params, hs, target, mask)
    final = evolve_interest(params, behav, hs, att, mask, cfg)
    m = mask.to(behav.dtype)
    pooled = (behav * m[..., None]).sum(1) / m.sum(1, keepdim=True).clamp_min(1.0)
    prof = profile_embed(params, batch["profile_ids"], batch["profile_mask"],
                         cfg)
    x = torch.cat([final, target, pooled, prof], dim=-1)
    mlp = params["mlp"]
    n = len([k for k in mlp if k.startswith("w")])
    for i in range(n):
        x = x @ mlp[f"w{i}"].to(x.dtype) + mlp[f"b{i}"].to(x.dtype)
        if i < n - 1:
            x = torch.relu(x)
    return x[:, 0], hs, behav


def serve(params, batch, cfg: DIENConfig):
    """Online/offline CTR scoring (serve_p99 / serve_bulk shapes)."""
    logits, _, _ = ctr_logits(params, batch, cfg)
    return torch.sigmoid(logits)
