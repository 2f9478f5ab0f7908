"""Roofline analysis over dry-run records: the JAX package's
``repro.launch.roofline`` on one H100's peaks.

Three terms per (arch x shape x mesh), in seconds per step per card:

  compute    = flops            / (chips * 989.4e12 FLOP/s dense bf16)
  memory     = bytes_accessed   / (chips * 3.35e12 B/s HBM3)
  collective = collective_bytes / (chips * 450e9 B/s NVLink, one direction)

The peaks are one H100 SXM5's, from NVIDIA's data sheet
(``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` reads
``NVIDIA H100 80GB HBM3, 700.00 W`` on the card this port is measured on).
``flops`` and ``bytes_accessed`` are what ``launch/dryrun.py --measure``
counted in one step (``FlopCounterMode``, the aten operands' bytes, and
the hand-written kernels' own counts); a record that was not measured has
neither, and only its model FLOPs.

``mfu`` is the one measured field: the run's model FLOPs over (chips x the
bf16 peak) over the measured step seconds; None for a record that was not
measured or a cell with no ``model_flops`` (eagr).

MODEL_FLOPS (analytic "useful" flops) per family, as in the JAX package:
  LM train    6 * N_active * tokens   (fwd 2ND + bwd 4ND) + attention
  LM prefill  2 * N_active * tokens + attention term
  LM decode   2 * N_active * B + attention 4*B*S*H*hd (one new token)
  GNN/recsys  closed-form per model (see model_flops)
"""
from __future__ import annotations

import argparse
import dataclasses
import json

PEAK_FLOPS = 989.4e12        # dense bf16 per card (H100 SXM5)
HBM_BW = 3.35e12             # bytes/s per card (HBM3)
NVLINK_BW = 450e9            # bytes/s per card, one direction (NVLink 4)

LM_ARCHS = ("granite-3-2b", "internlm2-1.8b", "command-r-plus-104b",
            "arctic-480b", "dbrx-132b")


# ------------------------------------------------------- analytic model flops
def _lm_params(cfg):
    """(N_total, N_active) parameter counts from a TransformerConfig."""
    D, F, V, L = cfg.d_model, cfg.d_ff, cfg.padded_vocab, cfg.n_layers
    Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    attn = D * Hq * hd + 2 * D * Hkv * hd + Hq * hd * D
    dense_ffn = 3 * D * F if (not cfg.is_moe or cfg.moe_dense_residual) else 0
    moe_total = 3 * D * F * cfg.n_experts if cfg.is_moe else 0
    moe_active = 3 * D * F * cfg.top_k if cfg.is_moe else 0
    router = D * cfg.n_experts if cfg.is_moe else 0
    total = L * (attn + dense_ffn + moe_total + router) + 2 * V * D
    active = L * (attn + dense_ffn + moe_active + router) + 2 * V * D
    return total, active


def model_flops(arch_id: str, shape: str,
                reduced: dict | None = None) -> tuple[float, float | None]:
    """(MODEL_FLOPS of the whole step across all chips, N_params_active):
    the JAX package's numbers, read from the port's configs. ``reduced``
    (a measured run's cut: ``"batch"``, ``"n_layers"``) gives the cut
    run's."""
    from repro_torch.configs import get_arch

    reduced = dict(reduced or {})
    mod = get_arch(arch_id)
    if arch_id in LM_ARCHS:
        cfg = dataclasses.replace(mod.CFG, **{
            k: v for k, v in reduced.items() if k == "n_layers"})
        _, n_active = _lm_params(cfg)
        L, Hq, hd = cfg.n_layers, cfg.n_heads, cfg.head_dim
        d = mod.SHAPE_DEFS[shape]
        B, S = reduced.get("batch", d["batch"]), d["seq"]
        tokens = B * S
        attn_fwd = 4 * tokens * S / 2 * Hq * hd * L   # causal: S/2 avg context
        if d["kind"] == "train":
            return 6 * n_active * tokens + 3 * attn_fwd, n_active
        if d["kind"] == "prefill":
            return 2 * n_active * tokens + attn_fwd, n_active
        # decode: 1 token/row against an S-cache
        return 2 * n_active * B + 4 * B * S * Hq * hd * L, n_active
    if arch_id == "graphcast":
        cfg = dataclasses.replace(mod.CFG, **reduced)
        d = mod.SHAPE_DEFS[shape]
        dh = cfg.d_hidden
        e_gm = 4 * d["n"]
        mlp2 = lambda din, dh_: 2 * (din * dh_ + dh_ * dh_)
        per_edge = mlp2(3 * dh, dh)
        per_node = mlp2(2 * dh, dh)
        fwd = (d["n"] * mlp2(cfg.n_vars, dh)                   # grid embed
               + 2 * e_gm * per_edge + (cfg.n_mesh + d["n"]) * per_node
               + cfg.n_layers * (cfg.n_mesh_edges * per_edge
                                 + cfg.n_mesh * per_node)
               + d["n"] * mlp2(dh, dh))
        return 3 * fwd, None
    if arch_id == "gat-cora":
        d = mod.SHAPE_DEFS[shape]
        fwd = (2 * d["n"] * d["d_feat"] * 64
               + 2 * d["n"] * 64 * d["classes"]
               + 4 * d["e"] * (64 + d["classes"]))
        return 3 * fwd, None
    if arch_id == "gatedgcn":
        d = mod.SHAPE_DEFS[shape]
        dh = 70
        layers = reduced.get("n_layers", 16)
        fwd = (2 * d["n"] * d["d_feat"] * dh
               + layers * (5 * 2 * d["n"] * dh * dh + 6 * d["e"] * dh))
        return 3 * fwd, None
    if arch_id == "nequip":
        cfg = dataclasses.replace(mod.CFG, **reduced)
        d = mod.SHAPE_DEFS[shape]
        mul, P = cfg.d_hidden, len(cfg.paths)
        # per edge per path: intertwiner contraction ~ 50*mul
        per_edge = P * 70 * mul + 2 * cfg.n_rbf * cfg.radial_hidden \
            + 2 * cfg.radial_hidden * P * mul
        per_node = 2 * (mul * 4) * mul * 9
        fwd = cfg.n_layers * (d["e"] * per_edge + d["n"] * per_node)
        mult = 3 if shape != "molecule" else 9   # force training: grad-of-grad
        return mult * fwd, None
    if arch_id == "dien":
        cfg = mod.CFG
        d = mod.SHAPE_DEFS[shape]
        dh, db, S = cfg.gru_dim, cfg.behav_dim, cfg.seq_len
        gru = 2 * S * 3 * dh * (db + dh)
        augru = 2 * S * 3 * dh * 2 * dh + 2 * S * (dh + db) * cfg.att_hidden
        mlp = 2 * (cfg.gru_dim + 2 * db + cfg.embed_dim) * 200 + 2 * 200 * 80
        if shape == "retrieval_cand":
            user = gru + 2 * (dh + db) * cfg.embed_dim
            return user + 2 * d["n_cand"] * cfg.embed_dim, None
        per_user = gru + augru + mlp
        mult = 3 if d["kind"] == "train" else 1
        return mult * reduced.get("batch", d["batch"]) * per_user, None
    raise KeyError(arch_id)


# ----------------------------------------------------------------- the table
def analyze(records: list[dict]) -> list[dict]:
    """The JAX package's roofline rows for ``records`` (the dry run's
    keys), plus ``mfu`` for a measured record."""
    out = []
    for r in records:
        n_chips = 1
        for v in r["mesh"].values():
            n_chips *= v
        mult = 1.0
        for tok in str(r.get("notes", "")).split():
            if tok.startswith("step_multiplier="):
                mult = float(tok.split("=")[1])
        # a record with no counted flops (a dry run that was not measured)
        # has no terms
        counted = r.get("flops") is not None
        flops_dev = max(r.get("flops") or 0.0, 0.0) * mult
        bytes_dev = max(r.get("bytes_accessed") or 0.0, 0.0) * mult
        coll_dev = sum(r.get("collective_bytes", {}).values()) * mult
        t_compute = flops_dev / PEAK_FLOPS
        t_memory = bytes_dev / HBM_BW
        t_coll = coll_dev / NVLINK_BW
        terms = {"compute": t_compute, "memory": t_memory,
                 "collective": t_coll}
        bottleneck = max(terms, key=terms.get) if counted else "n/a"
        if "model_flops" in r:    # the record's own (None: none for it)
            mf = r["model_flops"]
        else:
            try:
                mf, _ = model_flops(r["arch"], r["shape"], r.get("reduced"))
            except KeyError:
                mf = None
        measured = bool(r.get("measured")) and r.get("seconds")
        temp = r.get("temp_bytes")
        roof = mf and counted
        out.append(dict(
            arch=r["arch"], shape=r["shape"], chips=n_chips,
            t_compute_s=t_compute, t_memory_s=t_memory, t_collective_s=t_coll,
            bottleneck=bottleneck,
            hlo_flops_per_dev=flops_dev,
            hlo_bytes_per_dev=bytes_dev,
            collective_bytes_per_dev=coll_dev,
            model_flops_total=mf,
            useful_ratio=(mf / (flops_dev * n_chips)
                          if mf and flops_dev > 0 else None),
            roofline_fraction=(
                (mf / n_chips / PEAK_FLOPS) / max(max(terms.values()), 1e-30)
                if roof else None),
            roofline_cc=(
                (mf / n_chips / PEAK_FLOPS) / max(t_compute, t_coll, 1e-30)
                if roof else None),
            mfu=(mf / (n_chips * PEAK_FLOPS) / r["seconds"]
                 if mf and measured else None),
            seconds=r["seconds"] if measured else None,
            temp_gb=None if temp is None else temp / 1e9,
            reduced=r.get("reduced") or {},
            notes=r.get("notes", ""),
        ))
    return out


def format_table(rows: list[dict]) -> str:
    hdr = (f"{'arch':22s} {'shape':15s} {'chips':>5s} "
           f"{'compute(s)':>11s} {'memory(s)':>11s} {'collect(s)':>11s} "
           f"{'bound':>10s} {'useful':>7s} {'roofline':>8s} {'roof-cc':>8s} "
           f"{'step(s)':>9s} {'mfu':>7s} {'temp':>7s}  reduced")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        useful = (f"{r['useful_ratio']:6.2f}" if r["useful_ratio"] else "   n/a")
        roof = (f"{r['roofline_fraction']:7.1%}" if r["roofline_fraction"]
                else "    n/a")
        roofcc = (f"{r['roofline_cc']:7.1%}" if r.get("roofline_cc")
                  else "    n/a")
        step = f"{r['seconds']:9.4f}" if r.get("seconds") else "      n/a"
        mfu = f"{r['mfu']:6.1%}" if r.get("mfu") else "   n/a"
        temp = (f"{r['temp_gb']:6.1f}G" if r.get("temp_gb") is not None
                else "    n/a")
        lines.append(
            f"{r['arch']:22s} {r['shape']:15s} {r['chips']:5d} "
            f"{r['t_compute_s']:11.3e} {r['t_memory_s']:11.3e} "
            f"{r['t_collective_s']:11.3e} {r['bottleneck']:>10s} "
            f"{useful:>7s} {roof:>8s} {roofcc:>8s} {step} {mfu:>7s} "
            f"{temp}  {r.get('reduced') or ''}")
    return "\n".join(lines)


def main(argv=None):
    p = argparse.ArgumentParser(
        description="roofline table of dry-run records (H100 peaks)")
    p.add_argument("records", help="json from dryrun --json")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    with open(args.records) as f:
        records = json.load(f)
    rows = analyze(records)
    print(format_table(rows))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
