#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # one CUDA device, full width

Needs one NVIDIA GPU (written for the H100, sm_90a) and ``nvcc``; it builds
the kernels from ``src/repro_torch/kernels/*/csrc`` at first use. Phases:

1. card and build: the card's name and power limit, then every CUDA source
   compiled (all ``nvcc`` started together) and the build seconds;
2. kernels against their plain PyTorch versions, on the card: the shape
   sweep of ``tests/test_kernels.py`` and every real level of the phase-3
   plans at F in {1, 2, 64}, sum and max, each kernel run twice for
   bit-equal output; kernel, plain-version and library-call times beside
   the kernel's bound;
3. the main path at full width: ``EagrSession`` over an RMAT graph of the
   repository's reference deployment (100,000 nodes, 800,000 edges, seed 0,
   tuple window 8, batches of 4096), ``sum``/``max``/``count`` queries, a
   stream of Zipf(1.5)-drawn writes with a read of every query after each
   batch (the first batch, which loads the path's kernels, is timed apart
   and the stream restarted); rates are all events over all the time their
   calls took; answers held against an independent numpy oracle, the stream
   replayed from a fresh state to require bit-equal PAOs, and each kernel's
   launch count on the main path required above zero; then one traced
   window of writes and one of reads (torch.profiler) for the device time
   by kernel and the device's busy share.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Any failed check raises and
the script exits non-zero without that line. Details of every measurement go
to ``chiprun_out/chip_smoke.json``. The script imports neither JAX nor the
JAX package.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# the reference deployment of repro.configs.eagr.CFG, copied as literals
N_NODES, N_EDGES, SEED = 100_000, 800_000, 0
WINDOW, BATCH, ZIPF_A = 8, 4096, 1.5
PROFILE_BATCHES = 5   # update batches and read rounds in each traced window

DEVICE = "cuda"

# H100 SXM peaks (NVIDIA data sheet) for the kernels' bound
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

KERNELS = {
    "sum": ("segment_agg_sum", "src/repro/kernels/segment_agg/segment_agg.py:41"),
    "max": ("segment_agg_max", "src/repro/kernels/segment_agg/segment_agg.py:59"),
}
SOURCE = "src/repro_torch/kernels/segment_agg/csrc/segment_agg.cu"
SWEEP = [(100, 8, 17), (1000, 64, 300), (37, 5, 10), (4096, 128, 128),
         (513, 200, 77), (1, 1, 1), (2000, 96, 1000)]


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int = 20) -> float:
    """Mean device time of one call over ``reps`` back-to-back calls (CUDA
    events), after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def check_kernel(torch, ops, ref, x, seg, tob, fot, n_rows, n_row_tiles, op,
                 exact: bool) -> float:
    """Kernel vs plain version on the rows some slot routes to; the kernel
    twice for bit-equal output. Returns the max abs difference."""
    a = ops.segment_agg_level(x, seg, tob, fot, n_rows=n_rows,
                              n_row_tiles=n_row_tiles, op=op)
    b = ops.segment_agg_level(x, seg, tob, fot, n_rows=n_rows,
                              n_row_tiles=n_row_tiles, op=op)
    want = ref.segment_agg_level_ref(x, seg, n_rows, op)
    torch.cuda.synchronize()
    hit = torch.zeros(n_rows + 1, dtype=torch.bool, device=x.device)
    hit[torch.where(seg >= 0, seg.long(), n_rows)] = True
    hit = hit[:n_rows]
    if not torch.equal(a[hit], b[hit]):
        raise AssertionError(f"{op} kernel is not deterministic")
    err = (a[hit] - want[hit]).abs().max().item() if hit.any() else 0.0
    if op == "max" or exact:
        if not torch.equal(a[hit], want[hit]):
            raise AssertionError(f"{op} kernel != plain version (exact), "
                                 f"max abs err {err}")
    else:
        torch.testing.assert_close(a[hit], want[hit], rtol=1e-5, atol=1e-5)
    return err


def level_bound_ms(seg, tob, fot, F: int, n_rows: int) -> tuple[float, str]:
    """Least time for one level: seg and the block tables read once, x read
    for each live slot, output written for each row of a visited tile; one
    add/max per live slot and feature."""
    n_live = int((seg >= 0).sum().item())
    rows_out = min(int(fot.sum().item()) * 128, n_rows)
    nbytes = seg.numel() * 4 + tob.numel() * 8 + n_live * 4 * F \
        + rows_out * 4 * F
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_live * F / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def shuffle_within_runs(ops, rng, plan, xp):
    """The same level with its slots permuted inside each tile's block run:
    seg is then unsorted inside a tile's range (as churn leaves it when it
    claims free slots anywhere in the range), padding slots included."""
    seg, x = plan.seg_padded.copy(), xp.copy()
    tob = plan.tile_of_block
    for t in np.unique(tob):
        blocks = np.flatnonzero(tob == t)
        lo, hi = blocks[0] * ops.E_BLK, (blocks[-1] + 1) * ops.E_BLK
        p = lo + rng.permutation(hi - lo)
        seg[lo:hi], x[lo:hi] = seg[p], x[p]
    return seg, x


def phase_kernels_sweep(torch, ops, ref, errs) -> None:
    from repro_torch.kernels.segment_agg.ops import make_plan

    rng = np.random.default_rng(0)
    dev = torch.device(DEVICE)
    for E, F, n_rows in SWEEP:
        seg_np = rng.integers(0, n_rows, E)
        x_np = rng.normal(size=(E, F)).astype(np.float32)
        plan = make_plan(seg_np, n_rows)
        xp = np.zeros((plan.e_pad, F), np.float32)
        xp[plan.perm] = x_np
        args = [torch.as_tensor(a, device=dev) for a in
                (xp, plan.seg_padded, plan.tile_of_block, plan.first_of_tile)]
        for op in ("sum", "max"):
            e = check_kernel(torch, ops, ref, *args, n_rows, plan.n_row_tiles,
                             op, exact=False)
            errs[op] = max(errs[op], e)
            # the plan-level wrapper against the plain reference semantics
            got = ops.segment_agg(torch.as_tensor(x_np, device=dev), plan,
                                  op=op)
            want = ref.segment_agg_ref(torch.as_tensor(x_np, device=dev),
                                       torch.as_tensor(seg_np, device=dev),
                                       n_rows, op)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        seg_s, xp_s = shuffle_within_runs(ops, rng, plan, xp)
        args_s = [torch.as_tensor(a, device=dev) for a in
                  (xp_s, seg_s, plan.tile_of_block, plan.first_of_tile)]
        for op in ("sum", "max"):
            e = check_kernel(torch, ops, ref, *args_s, n_rows,
                             plan.n_row_tiles, op, exact=False)
            errs[op] = max(errs[op], e)
        print(f"  sweep E={E} F={F} n_rows={n_rows}: sum/max ok, also with "
              f"slots shuffled inside each tile's run", flush=True)


def phase_kernels_full(torch, ops, ref, session, errs) -> list[dict]:
    """Every real level of the sum and max groups' push and pull tables, at
    F in {1, 2, 64}: exact comparison on integer-valued x (sums of integers
    below 2**24 are exact in fp32 in any order), bit-equal reruns and
    normal-valued determinism, plus times."""
    rows = []
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for g in session._groups.values():
        if g.agg.name not in ("sum", "max"):
            continue
        op = "sum" if g.agg.name == "sum" else "max"
        plan = g.engine.plan
        meta = plan.meta
        for side in ("push", "pull"):
            t = getattr(plan.arrays, side)
            for l in range(plan.depth):
                seg, tob, fot = t.seg[l], t.tile_of_block[l], t.first_of_tile[l]
                n_live = int((seg >= 0).sum().item())
                if n_live == 0:
                    continue
                for F in (1, 2, 64):
                    xi = torch.randint(-8, 9, (seg.numel(), F), generator=gen,
                                       device=dev).to(torch.float32)
                    e = check_kernel(torch, ops, ref, xi, seg, tob, fot,
                                     meta.n_nodes, meta.n_row_tiles, op,
                                     exact=True)
                    errs[op] = max(errs[op], e)
                    xn = torch.randn((seg.numel(), F), generator=gen,
                                     device=dev)
                    runs = [ops.segment_agg_level(
                        xn, seg, tob, fot, n_rows=meta.n_nodes,
                        n_row_tiles=meta.n_row_tiles, op=op)
                        for _ in range(2)]
                    # rows of tiles no block visits are unwritten: compare
                    # the rows some slot routes to
                    hit = torch.zeros(meta.n_nodes + 1, dtype=torch.bool,
                                      device=dev)
                    hit[torch.where(seg >= 0, seg.long(), meta.n_nodes)] = True
                    hit = hit[: meta.n_nodes]
                    if not torch.equal(runs[0][hit], runs[1][hit]):
                        raise AssertionError(f"{op} kernel not bit-equal "
                                             f"across runs ({side} l={l})")
                    k_ms = cuda_ms(torch, lambda: ops.segment_agg_level(
                        xn, seg, tob, fot, n_rows=meta.n_nodes,
                        n_row_tiles=meta.n_row_tiles, op=op))
                    p_ms = cuda_ms(torch, lambda: ref.segment_agg_level_ref(
                        xn, seg, meta.n_nodes, op))
                    dst = torch.where(seg >= 0, seg.long(), meta.n_nodes)
                    lib_out = torch.zeros((meta.n_nodes + 1, F), device=dev)
                    if op == "sum":
                        lib = lambda: lib_out.index_add_(0, dst, xn)
                    else:
                        lib = lambda: lib_out.index_reduce_(0, dst, xn, "amax")
                    l_ms = cuda_ms(torch, lib)
                    b_ms, b_by = level_bound_ms(seg, tob, fot, F, meta.n_nodes)
                    row = dict(op=op, group=g.agg.name, side=side, level=l,
                               e_pad=seg.numel(), n_blocks=tob.numel(),
                               n_live=n_live, n_rows=meta.n_nodes, F=F,
                               ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                               bound_ms=b_ms, bound_by=b_by)
                    rows.append(row)
                    print(f"  {op:3s} {side:4s} l={l} E_pad={seg.numel()} "
                          f"live={n_live} F={F:2d}: kernel {k_ms:.4f} ms, "
                          f"plain {p_ms:.4f} ms, library {l_ms:.4f} ms, "
                          f"bound {b_ms:.5f} ms ({b_by})", flush=True)
    return rows


def make_stream(writers, readers, n_batches: int, rng, dyadic: bool):
    perm = rng.permutation(len(writers))
    batches = []
    for _ in range(n_batches):
        rank = rng.zipf(ZIPF_A, BATCH)
        ids = writers[perm[(rank - 1) % len(writers)]]
        if dyadic:
            # multiples of 1/8: every sum in this run is exact in fp32
            vals = (rng.integers(-64, 65, BATCH) / 8.0).astype(np.float32)
        else:
            vals = rng.normal(size=BATCH).astype(np.float32)
        q = rng.choice(readers, BATCH)
        batches.append((ids, vals, q))
    return batches


def drive(torch, session, handles, batches):
    """The main path: one update and one read of every query per batch.
    Returns per-batch write and read latencies (ms, host clock around work
    that ends in a device sync) and the last round's answers."""
    w_ms, r_ms, last = [], [], None
    for ids, vals, q in batches:
        t0 = time.perf_counter()
        session.update(ids, vals)
        torch.cuda.synchronize()
        w_ms.append((time.perf_counter() - t0) * 1e3)
        last = []
        for h in handles:
            t0 = time.perf_counter()
            ans = session.read(h, q)    # returns host numpy: synchronized
            r_ms.append((time.perf_counter() - t0) * 1e3)
            last.append(ans)
    return w_ms, r_ms, last


def reset_engines(session) -> None:
    for g in session._groups.values():
        eng = g.engine
        eng.adopt_state(eng.init_state(), now_host=0.0, last_eval_now=0.0)


def oracle_check(session, handles, batches, sample) -> None:
    """Independent numpy oracle: replay the stream into per-writer tuple
    windows of the last WINDOW values, then reduce each sampled reader's
    neighborhood. Sum and count to 1e-4, max exactly."""
    win: dict[int, collections.deque] = {}
    for ids, vals, _ in batches:
        for w, v in zip(ids.tolist(), vals.tolist()):
            d = win.get(w)
            if d is None:
                d = win[w] = collections.deque(maxlen=WINDOW)
            d.append(np.float32(v))
    got = {h.agg.name: np.asarray(session.read(h, sample)).reshape(len(sample), -1)[:, 0]
           for h in handles}
    for i, r in enumerate(sample.tolist()):
        vals = [v for w in session.neighborhood(r) for v in win.get(w, ())]
        want_sum = float(np.sum(np.asarray(vals, np.float64)))
        want_max = np.float32(max(vals)) if vals else np.float32(-3.0e38)
        if abs(got["sum"][i] - want_sum) > 1e-4 + 1e-4 * abs(want_sum):
            raise AssertionError(f"sum of reader {r}: {got['sum'][i]} != "
                                 f"{want_sum}")
        if abs(got["count"][i] - len(vals)) > 1e-4:
            raise AssertionError(f"count of reader {r}: {got['count'][i]} "
                                 f"!= {len(vals)}")
        if np.float32(got["max"][i]) != want_max:
            raise AssertionError(f"max of reader {r}: {got['max'][i]} != "
                                 f"{want_max}")


def profile_main_path(torch, session, handles, batches, out_dir) -> dict:
    """Device time of the write path and of the read path, each over its own
    traced window: the time of every CUDA kernel, summed by name
    (torch.profiler), the window's host wall time, and their ratio (the
    device's busy share while traced; the tracer's own host cost is in the
    wall time, so the untraced share is higher). Chrome traces of both
    windows go to ``out_dir``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
    phases = {
        "write": lambda: [session.update(ids, vals) for ids, vals, _ in batches],
        "read": lambda: [session.read(h, q) for _, _, q in batches
                         for h in handles],
    }
    for name, run in phases.items():
        run()  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = []
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue  # host ops: their kernels are listed on their own
            dev_us = getattr(e, "self_device_time_total", None)
            if dev_us is None:
                dev_us = e.self_cuda_time_total
            rows.append((e.key, e.count, dev_us / 1e3))
        rows.sort(key=lambda r: -r[2])
        dev_ms = sum(r[2] for r in rows)
        n = len(batches)
        out[name] = dict(batches=n, wall_ms=wall_ms, device_ms=dev_ms,
                         busy_share=dev_ms / wall_ms,
                         top=[dict(kernel=k, calls=c, ms=t)
                              for k, c, t in rows[:15]])
        print(f"profile {name}: {n} batches, wall {wall_ms:.3f} ms, device "
              f"{dev_ms:.3f} ms, busy share {dev_ms / wall_ms:.4f}",
              flush=True)
        for k, c, t in rows[:8]:
            print(f"    {t:9.3f} ms  {c:6d} calls  {k[:90]}", flush=True)
        prof.export_chrome_trace(os.path.join(out_dir,
                                              f"trace_{name}.json"))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, default=N_NODES)
    ap.add_argument("--edges", type=int, default=N_EDGES)
    ap.add_argument("--batches", type=int, default=20)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    # no matmul runs on the port's path; keep fp32 products exact if one did
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch import EagrSession, Query, WindowSpec
    from repro_torch.graphs.generators import rmat_graph
    from repro_torch.kernels import _build
    from repro_torch.kernels.segment_agg import ops, ref

    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    report: dict = {"args": vars(args)}

    # ---- 1. card and build
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"build: {len(_build.SOURCES)} CUDA source(s) in {build_s:.2f} s",
          flush=True)
    for name, log in _build.BUILD_LOG.items():
        print(f"  ptxas ({name}):\n" + "\n".join(
            "    " + ln for ln in log.splitlines() if "registers" in ln
            or "spill" in ln), flush=True)
    report.update(card=card, build_s=build_s, build_log=_build.BUILD_LOG)

    # ---- 2a. kernels against their plain version: the shape sweep
    errs = {"sum": 0.0, "max": 0.0}
    phase_kernels_sweep(torch, ops, ref, errs)

    # ---- 3 (set-up). the session of the main path
    t0 = time.perf_counter()
    graph = rmat_graph(args.nodes, args.edges, seed=SEED)
    session = EagrSession(graph, device=DEVICE)
    build_session_s = time.perf_counter() - t0
    spec = WindowSpec("tuple", WINDOW)
    reg_s = {}
    handles = []
    for agg in ("sum", "max", "count"):
        t0 = time.perf_counter()
        handles.append(session.register(Query(agg=agg, window=spec)))
        reg_s[agg] = time.perf_counter() - t0
    plans = {g.agg.name: dict(
        n_nodes=g.engine.plan.meta.n_nodes, n_levels=g.engine.plan.meta.n_levels,
        depth=g.engine.plan.depth,
        push_slots=g.engine.plan.arrays.push.seg.shape[1],
        pull_slots=g.engine.plan.arrays.pull.seg.shape[1],
        push_edges=g.engine.plan.n_push_edges,
        pull_edges=g.engine.plan.n_pull_edges)
        for g in session._groups.values()}
    print(f"session: {args.nodes} nodes / {args.edges} edges built in "
          f"{build_session_s:.2f} s; register {reg_s}", flush=True)
    print(f"plans: {plans}", flush=True)
    report.update(session_build_s=build_session_s, register_s=reg_s,
                  plans=plans)

    # ---- 2b. kernels against their plain version at the main path's shapes
    level_rows = phase_kernels_full(torch, ops, ref, session, errs)
    report["levels"] = level_rows

    # ---- 3. the main path
    rng = np.random.default_rng(SEED)
    writers = np.asarray(session.writers, np.int64)
    readers = np.asarray(session.readers, np.int64)
    stream = make_stream(writers, readers, args.batches, rng, dyadic=True)
    # the first batch loads the path's kernels onto the card; time it apart,
    # then start the stream again from empty windows
    cold_w, cold_r, _ = drive(torch, session, handles, stream[:1])
    reset_engines(session)
    ops.reset_launches()
    w_ms, r_ms, _ = drive(torch, session, handles, stream)
    launches = dict(ops.LAUNCHES)
    print(f"main path launches: {launches}", flush=True)
    for op, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel segment_agg_{op} was not launched "
                                 f"on the main path")
    sample = rng.choice(readers, size=min(256, len(readers)), replace=False)
    oracle_check(session, handles, stream, sample)
    print(f"oracle: {len(sample)} sampled readers agree (sum, count to 1e-4, "
          f"max exactly)", flush=True)

    # determinism: the same normal-valued stream twice from a fresh state
    stream_n = make_stream(writers, readers, args.batches, rng, dyadic=False)
    finals = []
    for _ in range(2):
        reset_engines(session)
        _, _, last = drive(torch, session, handles, stream_n)
        finals.append(([g.engine.state.pao.clone()
                        for g in session._groups.values()], last))
    for a, b in zip(finals[0][0], finals[1][0]):
        if not torch.equal(a, b):
            raise AssertionError("PAOs differ between two runs of one stream")
    for a, b in zip(finals[0][1], finals[1][1]):
        if not np.array_equal(a, b):
            raise AssertionError("answers differ between two runs of one "
                                 "stream")
    for p in finals[0][0]:
        if not torch.isfinite(p).all():
            raise AssertionError("non-finite PAO")
    print("determinism: two runs of one stream give bit-equal PAOs and "
          "answers", flush=True)

    report["profile"] = profile_main_path(torch, session, handles,
                                          stream_n[:PROFILE_BATCHES], out_dir)

    # rates: every event of the run over all the time its calls took, so a
    # stall inside the window lowers them; latencies as quantiles beside them
    w50, r50 = float(np.median(w_ms)), float(np.median(r_ms))
    metrics = dict(write_p50_ms=w50, write_max_ms=float(np.max(w_ms)),
                   read_p50_ms=r50, read_max_ms=float(np.max(r_ms)),
                   cold_write_ms=cold_w[0], cold_read_ms=max(cold_r),
                   write_total_ms=float(np.sum(w_ms)),
                   read_total_ms=float(np.sum(r_ms)),
                   write_events_per_s=BATCH * len(w_ms) / (np.sum(w_ms) / 1e3),
                   read_events_per_s=BATCH * len(r_ms) / (np.sum(r_ms) / 1e3),
                   n_write_batches=len(w_ms), n_reads=len(r_ms))
    print(f"main path on {card}: {metrics['write_events_per_s']:.0f} "
          f"writes/s over 3 queries ({len(w_ms)} batches in "
          f"{metrics['write_total_ms']:.3f} ms; batch p50 {w50:.3f} ms, max "
          f"{metrics['write_max_ms']:.3f} ms), "
          f"{metrics['read_events_per_s']:.0f} reads/s per query ("
          f"{len(r_ms)} reads in {metrics['read_total_ms']:.3f} ms; p50 "
          f"{r50:.3f} ms, max {metrics['read_max_ms']:.3f} ms); first batch "
          f"write {cold_w[0]:.3f} ms, read {max(cold_r):.3f} ms", flush=True)
    report.update(main_path=metrics, launches=launches,
                  write_ms=w_ms, read_ms=r_ms)

    bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
           or m == "repro" or m.startswith("repro.")]
    if bad:
        raise AssertionError(f"the port loaded {bad[:5]}")

    # one entry per kernel: times at the main path's largest level, F=1
    kernels = []
    for op, (name, replaces) in KERNELS.items():
        rows = [r for r in level_rows if r["op"] == op and r["F"] == 1]
        top = max(rows, key=lambda r: r["n_live"])
        kernels.append(dict(
            name=name, route="cuda", source=SOURCE, replaces=replaces,
            launches=launches[op], max_abs_err=errs[op], ms=top["ms"],
            plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
            bound_by=top["bound_by"], library_ms=top["library_ms"]))
    report["kernels"] = kernels
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
