#!/usr/bin/env python3
"""Time two or more versions of the port's segment and decode kernels side by
side on one card.

    python3 tools/compare_kernels.py NAME=TREE NAME=TREE [...]

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
  kv head.

Every tree's outputs are checked against the plain versions before they are
timed (segment: exact on integer values; decode: bf16 tolerance of
``chip_smoke.py``). Prints the card line and one JSON object, and writes it
to ``chiprun_out/compare_kernels.json``. Needs one CUDA device.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F_SET = (1, 2, 64)
REPS = 20


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


def worker(tree: str, levels: str, out_path: str) -> None:
    """Time one tree's kernels through its own wrappers."""
    import numpy as np

    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs  # this checkout's timers and hub level

    sys.path.insert(0, os.path.join(tree, "src"))  # ahead of chip_smoke's
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.segment_agg import ops as sa
    from repro_torch.kernels.segment_agg import ref as sa_ref

    assert os.path.realpath(sa.__file__).startswith(os.path.realpath(tree))
    _build.build_all()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    res = {"segment": {}, "decode": {}}
    lv = np.load(levels)

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

    for agg in ("sum", "max"):
        n_rows, n_tiles = (int(v) for v in lv[f"{agg}.meta"])
        keys = sorted({k.rsplit(".", 1)[0] for k in lv.files
                       if k.startswith(agg + ".") and k.endswith(".seg")})
        for key in keys:
            seg, tob, fot = (torch.as_tensor(lv[f"{key}.{s}"], device=dev)
                             for s in ("seg", "tob", "fot"))
            for F in F_SET:
                seg_case(key, seg, tob, fot, n_rows, n_tiles, F)
    rng = np.random.default_rng(0)
    for F in (1, 64):
        x, seg, tob, fot, n_rows = cs.hub_level(sa, rng, F, True)
        seg, tob, fot = (torch.as_tensor(a, device=dev)
                         for a in (seg, tob, fot))
        seg_case("hub", seg, tob, fot, n_rows, 5, F)

    bf = torch.bfloat16
    for name, B, Hq, Hkv, S, d, lens in decode_cases():
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


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--worker":
        worker(*argv[1:4])
        return 0
    trees = dict(a.split("=", 1) for a in argv if "=" in a)
    if len(trees) < 2 or len(trees) != len(argv):
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
    build_levels(levels)
    order = list(trees) + list(trees)[::-1]
    runs: dict = {}
    for i, name in enumerate(order):
        out = os.path.join(work, f"run{i}_{name}.json")
        subprocess.run([sys.executable, os.path.abspath(__file__), "--worker",
                        os.path.abspath(trees[name]), levels, out],
                       check=True, timeout=900)
        with open(out) as f:
            r = json.load(f)
        for kind, rows in r.items():
            for key, ms in rows.items():
                runs.setdefault(kind, {}).setdefault(key, {}).setdefault(
                    name, []).append(ms)
    res = {"card": card, "order": order, "device_ms": runs}
    print(card)
    for kind, rows in runs.items():
        for key, by in rows.items():
            print(f"  {kind:7s} {key:28s} " + "  ".join(
                f"{n} {' / '.join(f'{t:.5f}' for t in ts)}"
                for n, ts in by.items()), flush=True)
    print(json.dumps(res))
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "compare_kernels.json"), "w") as f:
        json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
