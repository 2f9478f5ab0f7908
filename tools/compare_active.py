#!/usr/bin/env python3
"""Time two or more versions of the port's frontier-sparse and dense levels
side by side on one card.

    python3 tools/compare_active.py NAME=TREE NAME=TREE [...]

Each ``TREE`` is the root of a checkout of this repository (for example the
parent commit unpacked with ``git archive`` into a gitignored directory, and
``.``). The levels are those of ``chip_smoke.py``'s phase 6, built once with
this checkout's package on the host: the EAGr reference deployment (100,000
nodes / 800,000 edges, seed 0, ``sum`` and ``max`` queries) and the active
blocks of phase 6's first 256-writer batch and 256 readers (push and pull
sides). Each tree then runs in its own process, in the order given and then
in reverse (A, B, B, A), and drives every such level through its own
engine's sparse level (``core.engine._levels`` with one level's active
list, built from its own sources): sum on the ``sum`` plan, max and min on
the ``max`` plan, F = 1; and the same level as the stacked engine runs it
(``core.engine._stacked_levels``) over 4 shards that each hold a copy of
the level, shard s's active list the level's own cut to its first
(s + 1) / 4 blocks. Each level also runs dense (``active=None``), single
and stacked, so the dense kernels' outputs are held across trees too; a
dense stacked level is the whole level as the stacked engine runs it (its
gather, sign and shard offsets included, whatever the tree fuses). Each
dense level also runs as a stacked level of one shard (``dense stacked1``)
beside the single engine's ``_level_reduce`` (``dense``), and its outputs
must equal that level's bit for bit in every tree: the stacked entry at
S = 1 against the single-shard dense path. Then the largest dense level of
``chip_smoke.py``'s phase 8 (``EagrSession(shards=4)`` over the same graph,
the push or pull level with the most live slots, built once on the host)
of each of its ``sum`` and ``max`` groups runs through each tree's
``_stacked_levels`` (keys ``p8.*``). Per level it records

- ``held_ms``: CUDA events around 50 calls enqueued while a sleep kernel
  holds the card (the device work alone, ``chip_smoke.held_ms``);
- ``device_ms``: the profiler's device time of one call (every kernel,
  memset and copy of 20 calls, summed), null where it saw none;
- ``host_ms``: the host's time to enqueue one call, the card held;
- ``launches``: the device operations (kernels, memsets, copies) one call
  enqueues, from a CUDA graph captured around it
  (``chip_smoke.captured_ops``), with their names.

The outputs of every tree (values on the rows the level recomputes, and
those rows) must agree bit for bit. Prints the card line and one JSON
object (``note`` says what the dense stacked levels time), and writes it to
``chiprun_out/compare_active.json``. Needs one CUDA device.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 50
S = 4  # shards of the stacked runs
NOTE = ("dense stacked levels time the whole level as each tree's stacked "
        "engine runs it, the gather of val by src, the sign and the shard "
        "offsets included; 'dense stacked1' is the level as a stack of one "
        "shard beside the single engine's 'dense' level; 'p8.*' are "
        "chip_smoke.py phase 8's largest stacked dense levels (4 shards)")


def build_levels(path: str) -> None:
    """Phase 6's sparse levels and phase 8's largest stacked dense levels,
    with this checkout's package on the host."""
    import numpy as np

    sys.path.insert(0, os.path.join(ROOT, "src"))
    import chip_smoke as cs
    from repro_torch import EagrSession, Query, WindowSpec
    from repro_torch.graphs.generators import rmat_graph

    graph = rmat_graph(cs.N_NODES, cs.N_EDGES, seed=cs.SEED)
    session = EagrSession(graph, device="cpu")
    for agg in ("sum", "max"):
        session.register(Query(agg=agg, window=WindowSpec("tuple",
                                                          cs.WINDOW)))
    rng = np.random.default_rng(cs.SEED + 6)  # phase 6's probe batch
    probe = cs.dyn_stream(np.asarray(session.writers, np.int64),
                          np.asarray(session.readers, np.int64), 1,
                          cs.DYN_SIZES[0], rng)[0]
    cs.set_sparse("1")
    sets = cs.active_sets(session, probe)
    cs.set_sparse("auto")
    out = {}
    for g in session._groups.values():
        plan = g.engine.plan
        out[f"{g.agg.name}.meta"] = np.array([
            plan.meta.n_nodes, plan.meta.n_writers, plan.meta.n_row_tiles])
        for side, acts in zip(("push", "pull"), sets[g.agg.name]):
            if acts is None:
                continue
            t = getattr(plan.arrays, side)
            for l in range(plan.depth):
                if acts[l].shape[0] == 0:
                    continue
                key = f"{g.agg.name}.{side}{l}"
                for f in t._fields:
                    out[f"{key}.{f}"] = getattr(t, f)[l].numpy()
                out[f"{key}.active"] = np.asarray(acts[l], np.int32)
    # phase 8: each group's stacked level with the most live slots (as
    # chip_smoke.check_stacked_kernel picks it)
    shards = EagrSession(graph, device="cpu", shards=S)
    for agg in ("sum", "max"):
        shards.register(Query(agg=agg, window=WindowSpec("tuple",
                                                         cs.WINDOW)))
    for g in shards._groups.values():
        eng = g.engine
        live, side, l = max(
            (int((getattr(eng.arrays, sd).seg[:, i] >= 0).sum()), sd, i)
            for sd in ("push", "pull") for i in range(eng.meta.depth))
        t = getattr(eng.arrays, side)
        key = f"p8.{g.agg.name}.{side}{l}"
        out[f"{key}.meta"] = np.array([eng.meta.n_nodes, eng.meta.n_writers,
                                       eng.meta.n_row_tiles])
        for f in t._fields:
            out[f"{key}.{f}"] = getattr(t, f)[:, l].numpy()
    np.savez(path, **out)


def measure(torch, E, cs, level, name: str, outs: dict) -> dict:
    """One level's outputs (into ``outs``), its device operations, host
    enqueue time and held device time (see the module docstring)."""
    import numpy as np

    out, rows = level()
    torch.cuda.synchronize()
    outs[f"{name}.rows"] = rows.cpu().numpy()
    outs[f"{name}.out"] = out[rows].cpu().numpy()
    names = cs.captured_ops(torch, level)
    host = []
    for _ in range(REPS):
        torch.cuda._sleep(E.SLEEP_CYCLES // 10)
        t0 = time.perf_counter()
        level()
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return dict(held_ms=cs.held_ms(torch, level, reps=REPS),
                device_ms=cs.device_ms_or_none(torch, level),
                host_ms=float(np.median(host)), launches=len(names),
                names=names)


def worker(tree: str, levels: str, out_path: str) -> None:
    """Drive one tree's sparse levels through its own engine."""
    import numpy as np

    import torch

    sys.path.insert(0, os.path.join(tree, "src"))
    from repro_torch.core import engine as E  # the tree's package
    from repro_torch.kernels import _build

    sys.path.insert(1, ROOT)
    import chip_smoke as cs  # this checkout's timers, on the tree's package

    assert os.path.realpath(E.__file__).startswith(os.path.realpath(tree))
    _build.library("segment_agg")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    lv = np.load(levels)
    res, outs = {}, {}
    for agg, ops in (("sum", ("sum",)), ("max", ("max", "min"))):
        n, n_w, n_tiles = (int(v) for v in lv[f"{agg}.meta"])
        meta = E.PlanMeta(n_nodes=n, n_writers=n_w, n_levels=1,
                          n_row_tiles=n_tiles, depth=1)
        keys = sorted({k.rsplit(".", 1)[0] for k in lv.files
                       if k.startswith(agg + ".") and k.endswith(".active")})
        val = torch.randn((n, 1), generator=gen, device=dev)
        for key in keys:
            tables = E.LevelTables(*(
                torch.as_tensor(lv[f"{key}.{f}"][None], device=dev)
                for f in E.LevelTables._fields))
            act = (torch.as_tensor(lv[f"{key}.active"], device=dev),)
            # 4 shards, each a copy of the level (a (S, 1, ...) stack), with
            # ragged active lists padded with the block count
            nb = tables.tile_of_block.shape[1]
            a = lv[f"{key}.active"]
            cuts = [a[a < nb][: max(1, int((a < nb).sum()) * (s + 1) // S)]
                    for s in range(S)]
            stacked = E.LevelTables(*(t[None].expand((S,) + t.shape)
                                      .contiguous() for t in tables))
            act_s = (torch.as_tensor(np.stack([
                np.pad(c, (0, a.size - c.size), constant_values=nb)
                for c in cuts]).astype(np.int32), device=dev),)
            val_s = val[None].expand(S, n, 1).contiguous()
            # mode: the single engine's level, the 4-shard stack, or the
            # level as a stack of one shard (the stacked entry at S = 1)
            stacked1 = E.LevelTables(*(t[None] for t in tables))
            runs = [(op, mode, dense) for dense in (False, True)
                    for mode in ("single", "stacked") for op in ops]
            runs += [(op, "stacked1", True) for op in ops]
            for op, mode, dense in runs:
                def level(op=op, mode=mode, dense=dense):
                    if mode == "single":
                        item = next(E._levels(meta, tables,
                                              None if dense else act))
                        v = val
                    else:
                        item = next(E._stacked_levels(
                            meta, stacked1 if mode == "stacked1" else stacked,
                            None if dense else act_s))
                        v = val[None] if mode == "stacked1" else val_s
                    if isinstance(item, tuple):  # (reduce, rows)
                        reduce, rows = item
                        return reduce(v, op), rows
                    return item(v, op)

                name = f"{key} {op}" + (" dense" if dense else "") + \
                    ("" if mode == "single" else f" {mode}")
                rec = measure(torch, E, cs, level, name, outs)
                rec.update(active=int((act[0] < tables.tile_of_block
                                       .shape[1]).sum().item()),
                           n_blocks=int(tables.tile_of_block.shape[1]))
                res[name] = rec
                if mode == "stacked1":  # the S = 1 stack == _level_reduce
                    one = f"{key} {op} dense"
                    if not (np.array_equal(outs[f"{name}.rows"][0],
                                           outs[f"{one}.rows"])
                            and np.array_equal(outs[f"{name}.out"],
                                               outs[f"{one}.out"])):
                        raise AssertionError(f"{name}: output differs from "
                                             f"{one}'s")
    for key in sorted({k.rsplit(".", 1)[0] for k in lv.files
                       if k.startswith("p8.") and k.endswith(".seg")}):
        agg = key.split(".")[1]
        n, n_w, n_tiles = (int(v) for v in lv[f"{key}.meta"])
        meta = E.PlanMeta(n_nodes=n, n_writers=n_w, n_levels=1,
                          n_row_tiles=n_tiles, depth=1)
        stacked = E.LevelTables(*(
            torch.as_tensor(lv[f"{key}.{f}"][:, None], device=dev)
            for f in E.LevelTables._fields))
        S8 = stacked.seg.shape[0]
        val_s = torch.randn((S8, n, 1), generator=gen, device=dev)
        for op in ("sum",) if agg == "sum" else ("max", "min"):
            def level(op=op, stacked=stacked, val_s=val_s, meta=meta):
                return next(E._stacked_levels(meta, stacked))(val_s, op)

            name = f"{key} {op} dense stacked"
            rec = measure(torch, E, cs, level, name, outs)
            rec.update(shards=S8, n_blocks=int(stacked.tile_of_block
                                               .shape[2]),
                       n_live=int((stacked.seg >= 0).sum().item()))
            res[name] = rec
    np.savez(out_path + ".npz", **outs)
    with open(out_path, "w") as f:
        json.dump(res, f)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--worker":
        worker(*argv[1:4])
        return 0
    trees = dict(a.split("=", 1) for a in argv if "=" in a)
    if len(trees) < 2 or len(trees) != len(argv):
        print(__doc__, file=sys.stderr)
        return 2
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("compare_active: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    card = cs.card_line()
    work = os.path.join(ROOT, "build", "compare_active")
    os.makedirs(work, exist_ok=True)
    levels = os.path.join(work, "levels.npz")
    build_levels(levels)
    order = list(trees) + list(trees)[::-1]
    runs: dict = {}
    first: dict = {}
    for i, name in enumerate(order):
        out = os.path.join(work, f"run{i}_{name}.json")
        subprocess.run([sys.executable, os.path.abspath(__file__), "--worker",
                        os.path.abspath(trees[name]), levels, out],
                       check=True, timeout=900)
        with open(out) as f:
            r = json.load(f)
        got = dict(np.load(out + ".npz"))
        ref = first.setdefault("outputs", got)
        for k, v in got.items():
            if not np.array_equal(ref[k], v):
                raise AssertionError(f"{name}: {k} differs from "
                                     f"{order[0]}'s")
        for key, row in r.items():
            by = runs.setdefault(key, {}).setdefault(name, {})
            for m, v in row.items():
                by.setdefault(m, []).append(v)
    res = {"card": card, "order": order, "note": NOTE, "levels": runs}
    print(card)
    for key, by in runs.items():
        print(f"  {key:24s} " + "  ".join(
            f"{n}: held {' / '.join(f'{t:.5f}' for t in m['held_ms'])} ms, "
            f"host {' / '.join(f'{t:.4f}' for t in m['host_ms'])} ms, "
            f"{m['launches'][0]} launches" for n, m in by.items()),
            flush=True)
    print("outputs bit-equal across trees on every level's rows")
    print(json.dumps(res))
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "compare_active.json"), "w") as f:
        json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
