#!/usr/bin/env python3
"""Time two or more versions of the port's segment, decode and graph-entry
kernels side by side on one card.

    python3 tools/compare_kernels.py [--only KIND,...] NAME=TREE NAME=TREE [...]

``--only`` picks among ``segment``, ``decode``, ``graph`` and ``steps``
(default all).

Each ``TREE`` is the root of a checkout of this repository (for example the
parent commit unpacked with ``git archive`` into a gitignored directory, and
``.``). The EAGr reference deployment's plans (100,000 nodes / 800,000
edges, seed 0, ``sum`` and ``max`` queries, as ``chip_smoke.py`` builds
them) are built once with this checkout's package; then each tree runs in
its own process, in the order given and then in reverse (A, B, B, A), and
times through its own wrappers (``segment_agg_level``, ``flash_decode``),
built from its own sources, by profiler device time:

- the segment kernel (sum and max) at every real level of both plans, at
  F in {1, 2, 64}, and on ``chip_smoke.py``'s synthetic hub level;
- the decode kernel at the LM serve path's shape (granite-3-2b, B 8 against
  a 2,080-row cache), against a 32,768-row cache (B 4, ragged), at
  internlm2-1.8b's heads (16 / 8, head dim 128) and with one query head a
  kv head;
- the graph entry (``segment_agg_graph``) at the GNN cells' edge sets, as
  ``chip_smoke.py`` phase 12 draws them (seed 0): GraphCast
  ``minibatch_lg``'s six sets at F 512, GatedGCN's three at F 70, GAT's
  masked set (max at F 8, sums at F 8 and 64), NequIP ``molecule``'s
  messages at F 32, 96 and 160 and its readout at F 1; each in fp32
  through the tree's own ``segment_agg_graph`` and in bf16 through its own
  ``graph_sum`` / ``graph_max`` under ``torch.no_grad()`` (a tree that
  casts bf16 to fp32 and back does so there), on normal values from one
  seed, with profiler device time and CUDA-event time per call;
- the GNN train steps that run through the graph entry: GraphCast, GAT and
  GatedGCN at ``minibatch_lg`` and NequIP at ``molecule``, each built by
  the tree's own config (seed 0) and stepped by ``chip_smoke.gnn_cell``
  (one step replayed bit-equal, then ``STEPS`` timed, host clock to a
  synchronise; p50).

Every tree's outputs are checked against the plain versions before they are
timed (segment: exact on integer values; decode: bf16 tolerance of
``chip_smoke.py``); the graph entry's outputs must be bit-equal across every
run of every tree (a SHA-256 of each output, and a rerun inside each run).
Prints the card line and one JSON object, and writes it to
``chiprun_out/compare_kernels.json``. Needs one CUDA device.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F_SET = (1, 2, 64)
REPS = 20
STEPS = 9


def decode_cases():
    """(name, B, Hq, Hkv, S, d, lengths)"""
    import numpy as np

    live = np.linspace(2049, 2080, 8).round().astype(int).tolist()
    return [("serve", 8, 32, 8, 2080, 64, live),
            ("32k", 4, 32, 8, 32768, 64, [32768, 16461, 1, 24576]),
            ("internlm2", 8, 16, 8, 2080, 128, live),
            ("g1", 4, 8, 8, 2080, 64, [2080, 1, 0, 1500])]


def build_levels(path: str) -> None:
    """The reference deployment's real levels, with this checkout's package."""
    import numpy as np

    sys.path.insert(0, os.path.join(ROOT, "src"))
    import chip_smoke as cs
    from repro_torch import EagrSession, Query, WindowSpec
    from repro_torch.graphs.generators import rmat_graph

    session = EagrSession(rmat_graph(cs.N_NODES, cs.N_EDGES, seed=cs.SEED),
                          device="cpu")
    for agg in ("sum", "max"):
        session.register(Query(agg=agg, window=WindowSpec("tuple",
                                                          cs.WINDOW)))
    out = {}
    for g in session._groups.values():
        plan = g.engine.plan
        out[f"{g.agg.name}.meta"] = np.array([plan.meta.n_nodes,
                                              plan.meta.n_row_tiles])
        for side in ("push", "pull"):
            t = getattr(plan.arrays, side)
            for l in range(plan.depth):
                if int((t.seg[l] >= 0).sum()) == 0:
                    continue
                key = f"{g.agg.name}.{side}{l}"
                out[key + ".seg"] = t.seg[l].numpy()
                out[key + ".tob"] = t.tile_of_block[l].numpy()
                out[key + ".fot"] = t.first_of_tile[l].numpy()
    np.savez(path, **out)


def build_graphs(path: str) -> None:
    """The GNN cells' edge sets, with this checkout's package, on the host:
    (index, rows, mask) of each set and the (name, set, F, op) cases."""
    import numpy as np

    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import gnn_common, graphcast, nequip

    out, cases = {}, []

    def put(name, index, n_rows, mask=None):
        out[f"{name}.index"] = np.asarray(index, np.int64)
        out[f"{name}.rows"] = np.array(n_rows)
        if mask is not None:
            out[f"{name}.mask"] = np.asarray(mask, bool)

    # graphcast minibatch_lg (build_train's draw, seed 0)
    cfg, d = graphcast.CFG, gnn_common.SHAPE_DEFS["minibatch_lg"]
    n_grid = gnn_common.pad512(d["n"])
    b = graphcast.random_batch(
        np.random.default_rng(1), cfg, n_grid=n_grid, n_real=d["n"],
        e_gm=gnn_common.pad512(4 * n_grid),
        e_mesh=gnn_common.pad512(cfg.n_mesh_edges), device="cpu")
    M = cfg.n_mesh
    for name, idx, n in (("mesh dst", b.mesh_dst, M), ("mesh src", b.mesh_src, M),
                         ("g2m dst", b.g2m_dst, M), ("g2m src", b.g2m_src, n_grid),
                         ("m2g dst", b.m2g_dst, n_grid), ("m2g src", b.m2g_src, M)):
        put(f"graphcast {name}", idx.numpy(), n)
        cases.append((f"graphcast {name}", f"graphcast {name}", cfg.d_hidden,
                      "sum"))
    # gat-cora and gatedgcn minibatch_lg (build_graph_cell's draw, seed 0:
    # one batch for both)
    gb = gnn_common.pad_graph_batch(
        gnn_common.random_graph_batch(np.random.default_rng(1), d["n"],
                                      d["e"], 1, d["classes"], device="cpu"),
        gnn_common.pad512(d["n"]), gnn_common.pad512(d["e"]))
    N = gb.x.shape[0]
    put("mb dst masked", gb.edge_dst.numpy(), N, gb.edge_mask.numpy())
    put("mb src", gb.edge_src.numpy(), N)
    put("mb dst", gb.edge_dst.numpy(), N)
    for name in ("mb dst masked", "mb src", "mb dst"):
        cases.append((f"gatedgcn {name[3:]}", name, 70, "sum"))
    cases += [("gat softmax max", "mb dst masked", 8, "max"),
              ("gat softmax sum", "mb dst masked", 8, "sum"),
              ("gat messages", "mb dst masked", 64, "sum")]
    # nequip molecule (build_train's draw, seed 0)
    nb = nequip._batch(np.random.default_rng(1),
                       gnn_common.SHAPE_DEFS["molecule"], nequip.CFG,
                       targets=True, device="cpu")
    put("nequip dst", nb["edge_dst"].numpy(), nb["positions"].shape[0])
    put("nequip readout", nb["graph_ids"].numpy(),
        nb["energy_targets"].shape[0])
    for l in nequip.CFG.ls:
        cases.append((f"nequip l={l}", "nequip dst",
                      nequip.CFG.d_hidden * (2 * l + 1), "sum"))
    cases.append(("nequip readout", "nequip readout", 1, "sum"))
    out["cases"] = np.array(json.dumps(cases))
    np.savez(path, **out)


def worker(tree: str, levels: str, graphs: str, kinds: str,
           out_path: str) -> None:
    """Time one tree's kernels through its own wrappers."""
    import numpy as np

    import torch

    # the tree's package first: chip_smoke's own imports then find it
    sys.path.insert(0, os.path.join(tree, "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.segment_agg import ops as sa
    from repro_torch.kernels.segment_agg import ref as sa_ref

    sys.path.insert(1, ROOT)
    import chip_smoke as cs  # this checkout's timers, on the tree's package

    assert os.path.realpath(sa.__file__).startswith(os.path.realpath(tree))
    _build.build_all()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    kinds = kinds.split(",")
    res = {k: {} for k in kinds}
    if "graph" in kinds:
        res["graph_hash"] = {}
        graph_cases(torch, cs, sa, np.load(graphs), res, dev)
    if "steps" in kinds:
        gnn_steps(torch, cs, sa, res, os.path.dirname(out_path))
    lv = np.load(levels) if "segment" in kinds else None

    def seg_case(key, seg, tob, fot, n_rows, n_tiles, F):
        xi = torch.randint(-8, 9, (seg.numel(), F), generator=gen,
                           device=dev).float()
        xn = torch.randn((seg.numel(), F), generator=gen, device=dev)
        hit = torch.zeros(n_rows + 1, dtype=torch.bool, device=dev)
        hit[torch.where(seg >= 0, seg.long(), n_rows)] = True
        hit = hit[:n_rows]
        for op in ("sum", "max"):
            got = sa.segment_agg_level(xi, seg, tob, fot, n_rows=n_rows,
                                       n_row_tiles=n_tiles, op=op)
            want = sa_ref.segment_agg_level_ref(xi, seg, n_rows, op)
            if not torch.equal(got[hit], want[hit]):
                raise AssertionError(f"{tree}: segment {key} {op} F={F} "
                                     f"!= plain")
            res["segment"][f"{key} F={F} {op}"] = cs.device_ms(
                torch, lambda: sa.segment_agg_level(
                    xn, seg, tob, fot, n_rows=n_rows, n_row_tiles=n_tiles,
                    op=op), reps=REPS)

    for agg in ("sum", "max") if "segment" in kinds else ():
        n_rows, n_tiles = (int(v) for v in lv[f"{agg}.meta"])
        keys = sorted({k.rsplit(".", 1)[0] for k in lv.files
                       if k.startswith(agg + ".") and k.endswith(".seg")})
        for key in keys:
            seg, tob, fot = (torch.as_tensor(lv[f"{key}.{s}"], device=dev)
                             for s in ("seg", "tob", "fot"))
            for F in F_SET:
                seg_case(key, seg, tob, fot, n_rows, n_tiles, F)
    rng = np.random.default_rng(0)
    for F in (1, 64) if "segment" in kinds else ():
        x, seg, tob, fot, n_rows = cs.hub_level(sa, rng, F, True)
        seg, tob, fot = (torch.as_tensor(a, device=dev)
                         for a in (seg, tob, fot))
        seg_case("hub", seg, tob, fot, n_rows, 5, F)

    bf = torch.bfloat16
    for name, B, Hq, Hkv, S, d, lens in (decode_cases() if "decode" in kinds
                                         else ()):
        q = torch.randn((B, Hq, d), generator=gen, device=dev).to(bf)
        k = torch.randn((B, Hkv, S, d), generator=gen, device=dev).to(bf)
        v = torch.randn((B, Hkv, S, d), generator=gen, device=dev).to(bf)
        L = torch.tensor(lens, dtype=torch.int32, device=dev)
        got = fa.flash_decode(q, k, v, L)
        want = fa_ref.decode_ref(q.float(), k.float(), v.float(), L)
        torch.testing.assert_close(got.float(), want, rtol=cs.BF16_RTOL,
                                   atol=cs.BF16_ATOL)
        res["decode"][name] = cs.device_ms(
            torch, lambda: fa.flash_decode(q, k, v, L), reps=REPS)
    with open(out_path, "w") as f:
        json.dump(res, f)


def graph_cases(torch, cs, sa, gr, res, dev) -> None:
    """The graph entry at every case of ``build_graphs`` on ``dev``, fp32
    and bf16: each output's SHA-256 (after a rerun bit-equal to it) and its
    times."""
    import hashlib

    plans = {}
    for i, (name, key, F, op) in enumerate(json.loads(str(gr["cases"]))):
        if key not in plans:
            mask = gr[f"{key}.mask"] if f"{key}.mask" in gr.files else None
            plans[key] = sa.make_edge_plan(
                torch.as_tensor(gr[f"{key}.index"], device=dev),
                int(gr[f"{key}.rows"]),
                None if mask is None else torch.as_tensor(mask, device=dev))
        plan = plans[key]
        g = torch.Generator(device=dev)
        g.manual_seed(1000 + i)
        xn = torch.randn((plan.n_edges, F), generator=g, device=dev)
        xb = xn.to(torch.bfloat16)
        wrap = sa.graph_sum if op == "sum" else sa.graph_max

        def bf16_call(xb=xb, plan=plan, wrap=wrap):
            with torch.no_grad():
                return wrap(xb, plan)

        for dt, fn in (("fp32", lambda: sa.segment_agg_graph(xn, plan, op)),
                       ("bf16", bf16_call)):
            out = fn()
            if not cs.same_bits(torch, out, fn()):
                raise AssertionError(f"{name} {dt}: two calls differ")
            row = f"{name} F={F} {op} {dt}"
            res["graph_hash"][row] = hashlib.sha256(
                out.view(torch.int16 if dt == "bf16" else torch.int32)
                .cpu().numpy().tobytes()).hexdigest()
            res["graph"][row] = dict(
                device_ms=cs.device_ms(torch, fn, reps=REPS),
                event_ms=cs.cuda_ms(torch, fn, reps=REPS))
        del xn, xb


def gnn_steps(torch, cs, sa, res, out_dir) -> None:
    """Each GNN train cell of the tree: its step p50 (ms) over ``STEPS``
    steps after one replayed bit-equal, and its graph-entry launches a
    step."""
    import gc

    from repro_torch.configs import gat_cora, gatedgcn, graphcast, nequip

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name, mod, shape in (("graphcast", graphcast, "minibatch_lg"),
                             ("gat-cora", gat_cora, "minibatch_lg"),
                             ("gatedgcn", gatedgcn, "minibatch_lg"),
                             ("nequip", nequip, "molecule")):
        cell = mod.build_train(shape, seed=0)
        run = cs.gnn_cell(torch, sa, name, cell, out_dir, steps=STEPS)
        res["steps"][f"{name} {shape}"] = dict(
            p50_ms=run["step_p50_ms"], launches=run["launches_per_step"])
        del cell
        gc.collect()
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--worker":
        worker(*argv[1:6])
        return 0
    kinds = "segment,decode,graph,steps"
    if argv and argv[0] == "--only":
        kinds, argv = argv[1], argv[2:]
    trees = dict(a.split("=", 1) for a in argv if "=" in a)
    if len(trees) < 2 or len(trees) != len(argv) \
            or not set(kinds.split(",")) <= {"segment", "decode", "graph",
                                              "steps"}:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    card = cs.card_line()
    work = os.path.join(ROOT, "build", "compare")
    os.makedirs(work, exist_ok=True)
    levels = os.path.join(work, "levels.npz")
    graphs = os.path.join(work, "graphs.npz")
    if "segment" in kinds:
        build_levels(levels)
    if "graph" in kinds:
        build_graphs(graphs)
    order = list(trees) + list(trees)[::-1]
    runs: dict = {}
    hashes: dict = {}
    for i, name in enumerate(order):
        out = os.path.join(work, f"run{i}_{name}.json")
        subprocess.run([sys.executable, os.path.abspath(__file__), "--worker",
                        os.path.abspath(trees[name]), levels, graphs, kinds,
                        out], check=True, timeout=900)
        with open(out) as f:
            r = json.load(f)
        for key, h in r.pop("graph_hash", {}).items():
            hashes.setdefault(key, set()).add(h)
        for kind, rows in r.items():
            for key, ms in rows.items():
                runs.setdefault(kind, {}).setdefault(key, {}).setdefault(
                    name, []).append(ms)
    differ = sorted(k for k, h in hashes.items() if len(h) != 1)
    if differ:
        raise AssertionError(f"graph entry outputs differ between runs: "
                             f"{differ}")
    res = {"card": card, "order": order, "device_ms": runs,
           "graph_bit_equal": len(hashes)}
    print(card)
    for kind, rows in runs.items():
        for key, by in rows.items():
            if kind == "steps":
                print(f"  {kind:7s} {key:36s} " + "  ".join(
                    f"{n} " + " / ".join(f"{t['p50_ms']:.3f}" for t in ts)
                    for n, ts in by.items()), flush=True)
                continue
            if kind == "graph":
                print(f"  {kind:7s} {key:36s} " + "  ".join(
                    f"{n} " + " / ".join(f"{t['device_ms']:.5f} "
                                         f"({t['event_ms']:.4f})" for t in ts)
                    for n, ts in by.items()), flush=True)
                continue
            print(f"  {kind:7s} {key:28s} " + "  ".join(
                f"{n} {' / '.join(f'{t:.5f}' for t in ts)}"
                for n, ts in by.items()), flush=True)
    if hashes:
        print(f"  graph entry: {len(hashes)} outputs bit-equal across "
              f"{len(order)} runs", flush=True)
    print(json.dumps(res))
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "compare_kernels.json"), "w") as f:
        json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
