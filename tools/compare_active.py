#!/usr/bin/env python3
"""Time two or more versions of the port's frontier-sparse level side by
side on one card.

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
and stacked, so the dense kernel's outputs are held across trees too. Per
level it records

- ``held_ms``: CUDA events around 50 calls enqueued while a sleep kernel
  holds the card (the device work alone, ``chip_smoke.held_ms``);
- ``host_ms``: the host's time to enqueue one call, the card held;
- ``launches``: the device operations (kernels, memsets, copies) one call
  enqueues, from torch.profiler traces (the fullest of 5), with their
  names; null where the profiler returned no trace.

The outputs of every tree (values on the rows the level recomputes, and
those rows) must agree bit for bit. Prints the card line and one JSON
object, and writes it to ``chiprun_out/compare_active.json``. Needs one
CUDA device.
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


def build_levels(path: str) -> None:
    """Phase 6's sparse levels, with this checkout's package on the host."""
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
    np.savez(path, **out)


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
            runs = [(op, stack, dense) for dense in (False, True)
                    for stack in (False, True) for op in ops]
            for op, stack, dense in runs:
                def level(op=op, stack=stack, dense=dense):
                    item = next(
                        E._stacked_levels(meta, stacked,
                                          None if dense else act_s)
                        if stack else
                        E._levels(meta, tables, None if dense else act))
                    v = val_s if stack else val
                    if isinstance(item, tuple):  # (reduce, rows)
                        reduce, rows = item
                        return reduce(v, op), rows
                    return item(v, op)

                name = f"{key} {op}" + (" dense" if dense else "") + \
                    (" stacked" if stack else "")
                out, rows = level()
                torch.cuda.synchronize()
                outs[f"{name}.rows"] = rows.cpu().numpy()
                outs[f"{name}.out"] = out[rows].cpu().numpy()
                try:
                    n_launch, names = cs.trace_launches(torch, level)
                except AssertionError:  # no trace: not measured
                    n_launch, names = None, []
                host = []
                for _ in range(REPS):
                    torch.cuda._sleep(E.SLEEP_CYCLES // 10)
                    t0 = time.perf_counter()
                    level()
                    host.append((time.perf_counter() - t0) * 1e3)
                    torch.cuda.synchronize()
                res[name] = dict(
                    held_ms=cs.held_ms(torch, level, reps=REPS),
                    host_ms=float(np.median(host)), launches=n_launch,
                    names=names, active=int((act[0] < tables.tile_of_block
                                             .shape[1]).sum().item()),
                    n_blocks=int(tables.tile_of_block.shape[1]))
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
    res = {"card": card, "order": order, "levels": runs}
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
