#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # one CUDA device, full width

Needs one NVIDIA GPU (written for the H100, sm_90a) and ``nvcc``; it builds
the kernels from ``src/repro_torch/kernels/*/csrc`` at first use. Phases:

1. card and build: the card's name and power limit, then every CUDA source
   compiled (all ``nvcc`` started together) and the build seconds;
2. kernels against their plain PyTorch versions, on the card: the segment
   kernels on the shape sweep of ``tests/test_kernels.py``, on a
   synthetic hub level (one tile of 1,024 live blocks crossing some 200 of
   the kernel's windows, dead blocks among them or slots shuffled inside
   runs, F 1 and 64; sums of normal values there held to the
   reordered-sum bound) and every real level of the phase-3 plans at F in
   {1, 2, 64}, sum and max, each kernel run twice for bit-equal output;
   the flash-attention kernels: the
   CUDA-core prefill and the decode kernel on ``tests/test_kernels.py``'s
   shapes plus every head dim in fp32 (to 2e-5); the tensor-core (wgmma)
   prefill in bf16 on ragged, offset and non-causal shapes at head dims 64
   and 128, and at internlm2's and granite-3-2b's serve shapes (B 8 x S
   2,048, causal), each against the plain version in fp32 on the same bf16
   inputs to the bf16-probability bar and, at the two serve shapes, to at
   most twice SDPA's max abs and normwise errors on the same inputs (with a
   control, P rounded to e4m3, that must break that bar); decode at the
   serve path's own shape (B 8 against a 2,080-row cache, live lengths
   2,049..2,080), against a 32,768-row cache, B 4, ragged lengths, at
   internlm2-1.8b's heads (16 / 8, head dim 128) and with one query head a
   kv head and a zero-length row among long ones; the
   embedding-bag kernel
   on ``tests/test_kernels.py``'s shapes and DIEN's (512 bags x 16 ids,
   D 18), with empty bags and padding ids, against its plain version on CPU
   copies of the same inputs (exact on integer tables, 1e-6 on normal ones);
   kernel, plain-version and library-call times beside each kernel's bound
   (CUDA events over back-to-back calls), and the kernel's and library
   call's device time (``device_ms``: the kernels alone, without the host's
   gaps between calls);
3. the EAGr main path at full width: ``EagrSession`` over an RMAT graph of
   the repository's reference deployment (100,000 nodes, 800,000 edges,
   seed 0, tuple window 8, batches of 4096), ``sum``/``max``/``count``
   queries, a stream of Zipf(1.5)-drawn writes with a read of every query
   after each batch (the first batch, which loads the path's kernels, is
   timed apart and the stream restarted); rates are all events over all the
   time their calls took; answers held against an independent numpy oracle,
   the stream replayed from a fresh state to require bit-equal PAOs, and
   each kernel's launch count on the main path required above zero; then
   one traced window of writes and one of reads (torch.profiler) for the
   device time by kernel and the device's busy share;
4. the LM serve path at granite-3-2b's full width (40 layers, d_model 2048,
   32/8 heads, head dim 64, d_ff 8192, vocab 49155; fp32 parameters drawn
   from a seeded generator, bf16 compute): ``prefill`` of 8 prompts of 2,048
   tokens, then 32 greedy ``decode_step``s; the prefill time and decode
   tokens/s; 40 flash launches per prefill, all of them on the tensor-core
   kernel, and 40 per decode step required;
   the prefill logits and the logits of the first and last decode step held
   against the same model with the plain attention called explicitly
   (teacher-forced on the kernel run's tokens);
5. the DIEN serve path at its full ``CFG`` (1M items, 100k profile
   features, sequence 100) at ``serve_p99`` (batch 512): p50 and p99 batch
   latency, one embedding-bag launch per batch required, scores held to 1e-5
   against the same model run on CPU copies of the parameters and batches
   (where the bag wrapper runs its plain version).

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
BF16_OPS_PER_S = 989e12

KERNELS = {
    "sum": ("segment_agg_sum", "src/repro/kernels/segment_agg/segment_agg.py:41"),
    "max": ("segment_agg_max", "src/repro/kernels/segment_agg/segment_agg.py:59"),
}
SOURCE = "src/repro_torch/kernels/segment_agg/csrc/segment_agg.cu"
FLASH_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention/flash_attention.py:34"
BAG_SOURCE = "src/repro_torch/kernels/embedding_bag/csrc/embedding_bag.cu"
BAG_REPLACES = "src/repro/kernels/embedding_bag/embedding_bag.py:32"
# each kernel's design, named in the kernels line
DESIGNS = {
    "sum": "cuda cores: one CTA per window of 16 blocks, long runs split "
           "across windows and combined in window order; per block, rows "
           "grouped by warp shuffles (F <= 4) or lane = feature (F > 4)",
    "max": "cuda cores: one CTA per window of 16 blocks, long runs split "
           "across windows and combined in window order; per block, rows "
           "grouped by warp shuffles (F <= 4) or lane = feature (F > 4)",
    "prefill": "wgmma: bf16 products on the tensor cores, TMA K/V ring of 2 "
               "stages, producer + 2 consumer warpgroups, persistent grid",
    "decode": "split KV: one CTA per (key chunk, kv head, batch row) "
              "serving the GQA group, 4 warps on cp.async rings, chunks "
              "merged in order by a second kernel",
    "bag": "one warp per bag, 16 table-row loads in flight",
}

# the LM serve path: granite-3-2b at full width; 8 prompts of 2,048 tokens
# and 32 greedy tokens (prefill_32k's B 32 x S 32,768 and decode_32k's
# B 128 would need more than the card's memory for the cache)
LM_BATCH, LM_PROMPT, LM_GEN, LM_SEED = 8, 2048, 32, 0
# the decode kernel's extra check: a 32,768-row cache (decode_32k's context)
DEC_BATCH, DEC_CACHE = 4, 32768
DIEN_BATCHES, DIEN_SEED = 50, 0
# flash kernels in fp32 against the plain version, to 2e-5: the shapes of
# tests/test_kernels.py plus head dims 16 and 128 and a causal offset with
# ragged lengths — (B, Hq, Hkv, Sq, Skv, d, causal, ragged)
FLASH_SWEEP = [(1, 2, 1, 128, 128, 32, c, False) for c in (True, False)] + [
    (2, 4, 2, 256, 256, 64, True, False), (2, 4, 2, 256, 256, 64, False, False),
    (1, 8, 8, 512, 512, 64, True, False), (2, 6, 2, 200, 200, 48, True, False),
    (2, 6, 2, 200, 200, 48, False, False), (2, 4, 2, 96, 96, 16, True, False),
    (1, 4, 1, 300, 300, 128, True, False), (2, 4, 2, 70, 200, 64, True, True)]
# the tensor-core prefill in bf16 (head dims 64 and 128): tile edges (S not a
# multiple of 128), causal offsets both ways, lengths, non-causal
TC_SWEEP = [(1, 1, 1, 128, 128, 64, False, False),
            (1, 2, 1, 256, 256, 64, True, False),
            (2, 4, 2, 200, 200, 64, True, False),
            (2, 4, 2, 70, 200, 64, True, True),
            (2, 4, 2, 300, 100, 64, True, False),
            (2, 4, 4, 1000, 1000, 64, False, True),
            (1, 1, 1, 128, 128, 128, False, False),
            (2, 4, 2, 256, 256, 128, True, False),
            (1, 4, 1, 300, 300, 128, True, True)]
# the CUDA-core prefill timed at one shape (B, Hq, Hkv, Sq, Skv, d), fp32
SIMT_TIMED = (2, 16, 8, 2048, 2048, 64)
DECODE_SWEEP = [(2, 4, 2, 512, 64), (1, 8, 1, 1024, 32), (3, 6, 3, 300, 64),
                (2, 4, 4, 200, 16), (2, 16, 8, 700, 128), (2, 6, 2, 333, 48)]
BAG_SWEEP = [(100, 16, 64, 8), (1000, 32, 256, 16), (500, 64, 100, 100),
             (64, 8, 16, 1)]
# bf16 output of a kernel that rounds only its output (the decode kernel)
# against the plain version in fp32 on the same bf16 inputs: one rounding of
# the output to bf16 (unit roundoff 2**-8 = 3.9e-3 relative) on top of fp32
# sums taken in another order (~1e-6)
BF16_RTOL, BF16_ATOL = 4e-3, 1e-5
BF16_UNIT = 2.0 ** -8
# the tensor-core prefill also rounds its probabilities to bf16 before P.V,
# as SDPA and every tensor-core flash kernel do: 2**-9 relative on each of
# ~2,048 probabilities gives ~4e-5 absolute on outputs near 0, above the bar
# above. It is held elementwise within rtol 4e-3 + atol 2**-8 * max|want|,
# and at the serve shapes its max abs error and its normwise error
# ||got - want||_2 / ||want||_2 against fp32 plain to at most TC_SDPA_FACTOR
# times SDPA's on the same bf16 inputs, measured in the run. The max abs
# error is set by the few large outputs of the first causal rows; the
# normwise error by the many small outputs of the later ones, which the
# elementwise atol (scaled by max|want|) leaves loose. A control with P
# rounded to e4m3 in the kernel's place must break the bar
TC_RTOL, TC_ATOL_REL, TC_SDPA_FACTOR = 4e-3, 2.0 ** -8, 2.0
# the LM's logits, kernel path against the plain path (blocked_attention):
# in bf16, an attention output whose fp32 value differs in its last bits
# (another summation order) can round to the neighbouring bf16 value, and 40
# layers of a random-init model carry such flips up to a few percent of the
# logits. The floor is the same comparison for the kernels' own plain
# version (attention_ref, another exact fp32 order) measured in this run;
# the kernel path must stay within LM_FLOOR_FACTOR times it plus one bf16
# unit roundoff, and below LM_L2_CAP (a wrong kernel decorrelates the logits:
# relative L2 ~1.4)
LM_FLOOR_FACTOR, LM_L2_CAP = 3.0, 0.25
LM_TRACE_STEPS = 4
SWEEP = [(100, 8, 17), (1000, 64, 300), (37, 5, 10), (4096, 128, 128),
         (513, 200, 77), (1, 1, 1), (2000, 96, 1000)]
# the synthetic hub level: live blocks routed to one tile (hub_level)
HUB_BLOCKS = 1024


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


def device_ms(torch, fn, reps: int = 50) -> float:
    """Device time of one call: every CUDA kernel, copy and memset that
    ``reps`` calls run, summed (torch.profiler), over ``reps``, after one
    warm-up call. Unlike ``cuda_ms`` it leaves out the gaps in which the
    device waits for the host, which for a call of a few microseconds are
    most of the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # the profiler now and then hands back an empty trace: take up to three
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total_us = 0.0
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                us = getattr(e, "self_device_time_total", None)
                total_us += e.self_cuda_time_total if us is None else us
        if total_us > 0:
            return total_us / 1e3 / reps
    raise AssertionError("the profiler saw no device time in three traces")


def check_kernel(torch, ops, ref, x, seg, tob, fot, n_rows, n_row_tiles, op,
                 exact: bool, reordered: bool = False) -> float:
    """Kernel vs plain version on the rows some slot routes to; the kernel
    twice for bit-equal output. Sums of normal values within 1e-5, or with
    ``reordered`` (the hub level, where a row adds ~10^5 values and two
    summation orders differ by more) within the bound of a reordered sum of
    n values, n * 2^-24 * sum|x| per row. Returns the max abs difference."""
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
    elif reordered:
        n = torch.zeros(n_rows + 1, device=x.device).index_add_(
            0, torch.where(seg >= 0, seg.long(), n_rows),
            torch.ones(seg.shape, device=x.device))[:n_rows, None]
        lim = n * 2.0 ** -24 * ref.segment_agg_level_ref(x.abs(), seg,
                                                         n_rows, "sum")
        if bool(((a - want).abs() > lim)[hit].any()):
            raise AssertionError(f"sum kernel beyond the reordered-sum "
                                 f"bound, max abs err {err}")
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


def hub_level(ops, rng, F: int, shuffle: bool,
              hub_blocks: int = HUB_BLOCKS):
    """A synthetic level with one hub tile: tile 2 of 5 holds
    ``hub_blocks`` blocks of live slots (most of them routed to 3 of its
    rows), with dead blocks mixed in among them, so its run crosses many
    of the kernel's windows; the other tiles hold a few blocks each and
    the last run is extended by trailing padding blocks. With ``shuffle``
    the slots are then shuffled inside each tile's run (which also spreads
    live slots into the dead blocks). Padding slots carry values the
    kernel must ignore. Returns numpy (x, seg, tob, fot, n_rows)."""
    n_rows, R = 5 * ops.R_BLK, ops.R_BLK
    hub = np.where(rng.random(hub_blocks * ops.E_BLK - 77) < 0.8,
                   2 * R + rng.integers(0, 3, hub_blocks * ops.E_BLK - 77),
                   2 * R + rng.integers(0, R, hub_blocks * ops.E_BLK - 77))
    seg = np.concatenate([rng.integers(0, R, 300), rng.integers(R, 2 * R, 5),
                          hub, rng.integers(3 * R, 4 * R, 1000),
                          rng.integers(4 * R, 5 * R, 40)])
    plan = ops.make_plan(seg, n_rows)
    blocks = plan.seg_padded.reshape(-1, ops.E_BLK)
    tob = plan.tile_of_block
    dead = np.full((1, ops.E_BLK), -1, np.int32)
    seg_b, tob_b = [], []
    for t in np.unique(tob):
        mine = [blocks[i] for i in np.flatnonzero(tob == t)]
        if t == 2:   # dead blocks among the hub's live ones
            mine += [dead[0]] * (hub_blocks // 4)
            mine = [mine[i] for i in rng.permutation(len(mine))]
        seg_b += mine
        tob_b += [t] * len(mine)
    seg_b += [dead[0]] * 333   # trailing padding extends the last run
    tob_b += [tob_b[-1]] * 333
    tob_b = np.asarray(tob_b, np.int32)
    fot_b = np.r_[1, (tob_b[1:] != tob_b[:-1])].astype(np.int32)
    seg_p = np.concatenate(seg_b).astype(np.int32)
    x = rng.normal(size=(seg_p.size, F)).astype(np.float32)
    if not shuffle:
        return x, seg_p, tob_b, fot_b, n_rows
    shuffled = ops.SegmentPlan(perm=np.zeros(0, np.int64), seg_padded=seg_p,
                               tile_of_block=tob_b, first_of_tile=fot_b,
                               n_rows=n_rows, n_row_tiles=5,
                               e_pad=seg_p.size)
    seg_p, x = shuffle_within_runs(ops, rng, shuffled, x)
    return x, seg_p, tob_b, fot_b, n_rows


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


def phase_kernels_hub(torch, ops, ref, errs) -> list[dict]:
    """The synthetic hub level (``hub_level``: 1,024 live blocks in one
    tile, crossing some 200 of the kernel's windows) at F 1 and 64, with
    dead blocks among the live ones or with slots shuffled inside runs:
    exact on
    integer values, max exact on normal ones, sums of normal values within
    the reordered-sum bound, reruns bit-equal; kernel, library-call and
    bound times (device time for both)."""
    rng = np.random.default_rng(4)
    dev = torch.device(DEVICE)
    rows = []
    for F in (1, 64):
        for shuffle in (False, True):
            x, seg, tob, fot, n_rows = hub_level(ops, rng, F, shuffle)
            xn, seg, tob, fot = (torch.as_tensor(a, device=dev)
                                 for a in (x, seg, tob, fot))
            xi = torch.as_tensor(np.round(x * 4), device=dev)
            n_tiles = n_rows // ops.R_BLK
            for op in ("sum", "max"):
                e = check_kernel(torch, ops, ref, xi, seg, tob, fot, n_rows,
                                 n_tiles, op, exact=True)
                e = max(e, check_kernel(torch, ops, ref, xn, seg, tob, fot,
                                        n_rows, n_tiles, op, exact=False,
                                        reordered=True))
                errs[op] = max(errs[op], e)
                dst = torch.where(seg >= 0, seg.long(), n_rows)
                lib_out = torch.zeros((n_rows + 1, F), device=dev)
                lib = (lambda: lib_out.index_add_(0, dst, xn)) \
                    if op == "sum" else \
                    (lambda: lib_out.index_reduce_(0, dst, xn, "amax"))
                k_dev = device_ms(torch, lambda: ops.segment_agg_level(
                    xn, seg, tob, fot, n_rows=n_rows, n_row_tiles=n_tiles,
                    op=op), reps=20)
                l_dev = device_ms(torch, lib, reps=20)
                b_ms, b_by = level_bound_ms(seg, tob, fot, F, n_rows)
                rows.append(dict(op=op, F=F, shuffled=shuffle,
                                 n_blocks=tob.numel(),
                                 n_live=int((seg >= 0).sum().item()),
                                 max_abs_err=e, device_ms=k_dev,
                                 library_device_ms=l_dev, bound_ms=b_ms,
                                 bound_by=b_by))
                print(f"  hub level F={F:2d} shuffled={shuffle} {op}: max "
                      f"abs err {e:.3g} (normal values); kernel {k_dev:.4f} "
                      f"ms, library {l_dev:.4f} ms (device), bound "
                      f"{b_ms:.5f} ms ({b_by})", flush=True)
    return rows


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


def level_device_ms(torch, ops, session, row) -> tuple[float, float]:
    """Device time (profiler) of the segment kernel and of its library call
    at one level row of ``phase_kernels_full``, on fresh normal inputs."""
    g = next(g for g in session._groups.values()
             if g.agg.name == row["group"])
    meta = g.engine.plan.meta
    t = getattr(g.engine.plan.arrays, row["side"])
    l = row["level"]
    seg, tob, fot = t.seg[l], t.tile_of_block[l], t.first_of_tile[l]
    xn = torch.randn((seg.numel(), row["F"]), device=seg.device)
    dst = torch.where(seg >= 0, seg.long(), meta.n_nodes)
    lib_out = torch.zeros((meta.n_nodes + 1, row["F"]), device=seg.device)
    if row["op"] == "sum":
        lib = lambda: lib_out.index_add_(0, dst, xn)
    else:
        lib = lambda: lib_out.index_reduce_(0, dst, xn, "amax")
    k_dev = device_ms(torch, lambda: ops.segment_agg_level(
        xn, seg, tob, fot, n_rows=meta.n_nodes,
        n_row_tiles=meta.n_row_tiles, op=row["op"]))
    return k_dev, device_ms(torch, lib)


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


def trace_window(torch, name: str, run, n: int, out_dir) -> dict:
    """One traced window of ``run()`` (after one untraced warm call): the
    time of every CUDA kernel, summed by name (torch.profiler), the window's
    host wall time, and their ratio (the device's busy share while traced;
    the tracer's own host cost is in the wall time, so the untraced share is
    higher). The Chrome trace goes to ``out_dir``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    print(f"profile {name}: {n} batches, wall {wall_ms:.3f} ms, device "
          f"{dev_ms:.3f} ms, busy share {dev_ms / wall_ms:.4f}", flush=True)
    for k, c, t in rows[:8]:
        print(f"    {t:9.3f} ms  {c:6d} calls  {k[:90]}", flush=True)
    prof.export_chrome_trace(os.path.join(out_dir, f"trace_{name}.json"))
    return dict(batches=n, wall_ms=wall_ms, device_ms=dev_ms,
                busy_share=dev_ms / wall_ms,
                top=[dict(kernel=k, calls=c, ms=t) for k, c, t in rows[:15]])


def profile_main_path(torch, session, handles, batches, out_dir) -> dict:
    """Device time of the write path and of the read path, each over its own
    traced window (``trace_window``)."""
    phases = {
        "write": lambda: [session.update(ids, vals) for ids, vals, _ in batches],
        "read": lambda: [session.read(h, q) for _, _, q in batches
                         for h in handles],
    }
    return {name: trace_window(torch, name, run, len(batches), out_dir)
            for name, run in phases.items()}


# ------------------------------------------------------- flash attention
def sdpa(torch, q, k, v, *, causal, mask=None):
    """The library yardstick (timed only; the port never calls it)."""
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, is_causal=causal, enable_gqa=True)


def prefill_bound_ms(B, Hq, Hkv, Sq, Skv, d, causal, esize) -> tuple:
    """q, k, v read once and out written once; 4 d operations (q.k and p.v)
    per live query-key pair, at the tensor cores' rate for the input type
    (bf16; fp32 inputs at the CUDA cores' rate)."""
    off = Skv - Sq
    pairs = sum(min(max(i + off + 1, 0), Skv) for i in range(Sq)) \
        if causal else Sq * Skv
    nbytes = (2 * B * Hq * Sq * d + 2 * B * Hkv * Skv * d) * esize
    ops = 4 * d * B * Hq * pairs
    rate = BF16_OPS_PER_S if esize == 2 else FP32_OPS_PER_S
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
    return max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def decode_bound_ms(Hq, Hkv, d, lengths, esize) -> tuple:
    """Each live cache row of k and v read once, q read and out written
    once; 4 d operations per query head and live key."""
    live = int(sum(lengths))
    B = len(lengths)
    nbytes = (2 * Hkv * d * live + 2 * B * Hq * d) * esize
    ops = 4 * d * Hq * live
    rate = BF16_OPS_PER_S if esize == 2 else FP32_OPS_PER_S
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
    return max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def tc_measure(torch, got, want, floor=None) -> dict:
    """How a bf16 prefill output stands against the fp32 plain version:
    its max abs error, its normwise error ||got - want||_2 / ||want||_2, and
    the limits of the tensor-core bar (see TC_RTOL) that it breaks: the
    elementwise rule and, given SDPA's (max abs, normwise) error on the same
    inputs as ``floor``, TC_SDPA_FACTOR times each."""
    got = got.float()
    diff = got - want
    atol = TC_ATOL_REL * want.abs().max().item()
    m = dict(max_abs_err=diff.abs().max().item(),
             l2_rel=(diff.norm() / want.norm()).item(), failed=[])
    if bool((diff.abs() > atol + TC_RTOL * want.abs()).any()):
        m["failed"].append(f"elementwise (rtol {TC_RTOL}, atol {atol:.4g})")
    if floor is not None:
        for key, lim in zip(("max_abs_err", "l2_rel"), floor):
            if m[key] > TC_SDPA_FACTOR * lim:
                m["failed"].append(f"{key} {m[key]:.4g} > {TC_SDPA_FACTOR} x "
                                   f"SDPA's {lim:.4g}")
    return m


def tc_check(torch, got, want, what: str, floor=None) -> dict:
    """``tc_measure``, raising if any limit is broken."""
    m = tc_measure(torch, got, want, floor)
    if m["failed"]:
        raise AssertionError(f"{what}: breaks {m['failed']}")
    return m


def sdpa_floor(torch, q, k, v, want) -> tuple:
    """SDPA's max abs and normwise error against the fp32 plain version on
    the same bf16 inputs (causal, Sq == Skv): the floor the tensor-core
    prefill is held to."""
    diff = sdpa(torch, q, k, v, causal=True).float() - want
    return diff.abs().max().item(), (diff.norm() / want.norm()).item()


def attention_p_rounded(torch, q, k, v, p_dtype):
    """The control of the tensor-core bar: causal attention (Sq == Skv) in
    fp32 on the bf16 inputs with the probabilities rounded to ``p_dtype``
    before P.V (max and sum in fp32, the output rounded to bf16), i.e. a
    tensor-core kernel's numerics with another rounding of P put in its
    place. One batch row at a time."""
    B, Hq, S, d = q.shape
    G = Hq // k.shape[1]
    above = torch.ones((S, S), dtype=torch.bool, device=q.device).triu(1)
    out = torch.empty_like(q)
    for b in range(B):
        kb = k[b].float().repeat_interleave(G, 0)
        vb = v[b].float().repeat_interleave(G, 0)
        s = q[b].float() @ kb.transpose(-1, -2) / d ** 0.5
        s.masked_fill_(above, float("-inf"))
        p = torch.exp(s - s.amax(-1, keepdim=True))
        out[b] = ((p.to(p_dtype).float() @ vb) / p.sum(-1, keepdim=True)
                  ).to(q.dtype)
    return out


def phase_flash_sweep(torch, errs) -> None:
    """The CUDA-core prefill (fp32) and the decode kernel against the plain
    version in fp32, to 2e-5; the tensor-core prefill in bf16 on the sweep's
    edge cases at head dims 64 and 128, to its elementwise bar
    (``tc_check``); decode in bf16 at head dim 128 to the bf16 tolerance."""
    from repro_torch.kernels.flash_attention import ops, ref

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(1)
    dev = torch.device(DEVICE)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    for B, Hq, Hkv, Sq, Skv, d, causal, ragged in FLASH_SWEEP:
        q, k, v = rnd(B, Hq, Sq, d), rnd(B, Hkv, Skv, d), rnd(B, Hkv, Skv, d)
        lens = torch.randint(1, Skv + 1, (B,), generator=gen, device=dev,
                             dtype=torch.int32) if ragged else None
        got = ops.flash_attention(q, k, v, causal=causal, lengths=lens)
        want = ref.attention_ref(q, k, v, causal=causal, lengths=lens)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
        errs["prefill_simt"] = max(errs["prefill_simt"],
                                   (got - want).abs().max().item())
    bf = torch.bfloat16
    for B, Hq, Hkv, Sq, Skv, d, causal, ragged in TC_SWEEP:
        q, k, v = (rnd(B, Hq, Sq, d, dtype=bf), rnd(B, Hkv, Skv, d, dtype=bf),
                   rnd(B, Hkv, Skv, d, dtype=bf))
        lens = torch.randint(1, Skv + 1, (B,), generator=gen, device=dev,
                             dtype=torch.int32) if ragged else None
        got = ops.flash_attention(q, k, v, causal=causal, lengths=lens)
        again = ops.flash_attention(q, k, v, causal=causal, lengths=lens)
        want = ref.attention_ref(q.float(), k.float(), v.float(),
                                 causal=causal, lengths=lens)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError("the tensor-core prefill is not "
                                 "deterministic")
        what = f"wgmma prefill {(B, Hq, Hkv, Sq, Skv, d, causal, ragged)}"
        errs["prefill"] = max(errs["prefill"], tc_check(
            torch, got, want, what)["max_abs_err"])
        if causal and Skv < Sq:   # rows before the first key give 0
            if not torch.equal(got[:, :, :Sq - Skv],
                               torch.zeros_like(got[:, :, :Sq - Skv])):
                raise AssertionError(f"{what}: rows without a key are not 0")
    for B, Hq, Hkv, S, d in DECODE_SWEEP:
        q, k, v = rnd(B, Hq, d), rnd(B, Hkv, S, d), rnd(B, Hkv, S, d)
        lens = torch.randint(1, S, (B,), generator=gen, device=dev,
                             dtype=torch.int32)
        lens[0] = 0   # a row with no live key gives 0
        got = ops.flash_decode(q, k, v, lens)
        want = ref.decode_ref(q, k, v, lens)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
        if not torch.equal(got[0], torch.zeros_like(got[0])):
            raise AssertionError("flash_decode: a zero-length row is not 0")
        errs["decode"] = max(errs["decode"], (got - want).abs().max().item())
    # bf16 decode at head dim 128 (internlm2-1.8b's)
    q, k, v = (rnd(1, 16, 128, dtype=bf), rnd(1, 8, 256, 128, dtype=bf),
               rnd(1, 8, 256, 128, dtype=bf))
    got = ops.flash_decode(q, k, v,
                           torch.tensor([200], device=dev))
    want = ref.decode_ref(q.float(), k.float(), v.float(),
                          torch.tensor([200], device=dev))
    torch.testing.assert_close(got.float(), want, rtol=BF16_RTOL,
                               atol=BF16_ATOL)
    print(f"  flash sweep: {len(FLASH_SWEEP)} CUDA-core prefill and "
          f"{len(DECODE_SWEEP)} decode shapes (head dims 16-128) agree with "
          f"the plain version to 2e-5 in fp32 (max abs err prefill "
          f"{errs['prefill_simt']:.3g}, decode {errs['decode']:.3g}); "
          f"{len(TC_SWEEP)} tensor-core prefill shapes in bf16 within "
          f"rtol {TC_RTOL} + {TC_ATOL_REL:.4g} max|want| (max abs err "
          f"{errs['prefill']:.3g}), bit-equal reruns", flush=True)


def phase_flash_serve_shapes(torch, cfg, prompt, gen_len, errs) -> dict:
    """Both flash kernels at granite-3-2b's serve shapes in bf16, against
    the plain version in fp32 on the same bf16 inputs; kernel, plain and
    SDPA times beside the bound. Decode runs at the serve path's own shape
    (B 8, a cache of prompt + gen_len rows, live lengths spread over the
    path's prompt + 1 .. prompt + gen_len) and against a 32,768-row cache."""
    from repro_torch.kernels.flash_attention import ops, ref

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(2)
    dev = torch.device(DEVICE)
    bf = torch.bfloat16
    Hq, Hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    out = {}

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    # prefill: one layer's attention of the serve path's prefill
    B, S = LM_BATCH, prompt
    q, k, v = rnd(B, Hq, S, d), rnd(B, Hkv, S, d), rnd(B, Hkv, S, d)
    if ops.prefill_variant(q.dtype, d) != "wgmma":
        raise AssertionError(f"the serve path's prefill (bf16, d={d}) does "
                             f"not go to the tensor-core kernel")
    got = ops.flash_attention(q, k, v, causal=True)
    again = ops.flash_attention(q, k, v, causal=True)
    want = ref.attention_ref(q.float(), k.float(), v.float(), causal=True)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError("flash_attention is not deterministic")
    floor = sdpa_floor(torch, q, k, v, want)
    m = tc_check(torch, got, want, "wgmma prefill at the serve shape", floor)
    errs["prefill"] = max(errs["prefill"], m["max_abs_err"])
    # the bar's control: the same numerics with P rounded to bf16 (as the
    # kernel does) and to e4m3 (3 mantissa bits) in the kernel's place; the
    # coarser rounding must break at least one limit
    ctl = {}
    for name, p_dtype in (("p_bf16", bf), ("p_e4m3", torch.float8_e4m3fn)):
        ctl[name] = tc_measure(torch, attention_p_rounded(
            torch, q, k, v, p_dtype), want, floor)
    if not ctl["p_e4m3"]["failed"]:
        raise AssertionError(f"the tensor-core bar passes P rounded to e4m3: "
                             f"{ctl['p_e4m3']}")
    del want
    k_ms = cuda_ms(torch, lambda: ops.flash_attention(q, k, v, causal=True),
                   reps=10)
    p_ms = cuda_ms(torch, lambda: ref.attention_ref(q, k, v, causal=True),
                   reps=3)
    l_ms = cuda_ms(torch, lambda: sdpa(torch, q, k, v, causal=True), reps=10)
    k_dev = device_ms(torch, lambda: ops.flash_attention(q, k, v,
                                                         causal=True), reps=10)
    l_dev = device_ms(torch, lambda: sdpa(torch, q, k, v, causal=True),
                      reps=10)
    b_ms, b_by = prefill_bound_ms(B, Hq, Hkv, S, S, d, True, 2)
    out["prefill"] = dict(B=B, Hq=Hq, Hkv=Hkv, S=S, d=d, dtype="bf16",
                          max_abs_err=m["max_abs_err"], l2_rel=m["l2_rel"],
                          library_max_abs_err=floor[0],
                          library_l2_rel=floor[1], control=ctl,
                          ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                          device_ms=k_dev, library_device_ms=l_dev,
                          bound_ms=b_ms, bound_by=b_by)
    print(f"  flash prefill (wgmma) B={B} Hq={Hq} Hkv={Hkv} S={S} d={d} bf16 "
          f"causal: max abs err {m['max_abs_err']:.4g}, normwise "
          f"{m['l2_rel']:.4g} vs fp32 plain (SDPA {floor[0]:.4g}, "
          f"{floor[1]:.4g}); control, P rounded to bf16: "
          f"{ctl['p_bf16']['max_abs_err']:.4g}, {ctl['p_bf16']['l2_rel']:.4g}"
          f" (breaks {ctl['p_bf16']['failed'] or 'nothing'}), to e4m3: "
          f"{ctl['p_e4m3']['max_abs_err']:.4g}, {ctl['p_e4m3']['l2_rel']:.4g}"
          f" (breaks {ctl['p_e4m3']['failed']}); kernel {k_ms:.4f} ms "
          f"(device {k_dev:.4f}), plain {p_ms:.4f} ms, SDPA {l_ms:.4f} ms "
          f"(device {l_dev:.4f}; {k_ms / l_ms:.3f}x), bound {b_ms:.5f} ms "
          f"({b_by})", flush=True)
    del q, k, v, got, again

    # the same at internlm2-1.8b's heads (16 / 8, head dim 128)
    q, k, v = rnd(B, 16, S, 128), rnd(B, 8, S, 128), rnd(B, 8, S, 128)
    got = ops.flash_attention(q, k, v, causal=True)
    want = ref.attention_ref(q.float(), k.float(), v.float(), causal=True)
    floor = sdpa_floor(torch, q, k, v, want)
    m = tc_check(torch, got, want, "wgmma prefill, d 128, B 8 x 2,048", floor)
    errs["prefill"] = max(errs["prefill"], m["max_abs_err"])
    del want, got
    k_ms = cuda_ms(torch, lambda: ops.flash_attention(q, k, v, causal=True),
                   reps=10)
    p_ms = cuda_ms(torch, lambda: ref.attention_ref(q, k, v, causal=True),
                   reps=3)
    l_ms = cuda_ms(torch, lambda: sdpa(torch, q, k, v, causal=True), reps=10)
    b_ms, b_by = prefill_bound_ms(B, 16, 8, S, S, 128, True, 2)
    out["prefill_d128"] = dict(B=B, Hq=16, Hkv=8, S=S, d=128, dtype="bf16",
                               max_abs_err=m["max_abs_err"],
                               l2_rel=m["l2_rel"],
                               library_max_abs_err=floor[0],
                               library_l2_rel=floor[1], ms=k_ms,
                               plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
                               bound_by=b_by)
    print(f"  flash prefill (wgmma) B={B} Hq=16 Hkv=8 S={S} d=128 bf16 "
          f"causal: max abs err {m['max_abs_err']:.4g}, normwise "
          f"{m['l2_rel']:.4g} (SDPA {floor[0]:.4g}, {floor[1]:.4g}); kernel "
          f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, SDPA {l_ms:.4f} ms "
          f"({k_ms / l_ms:.3f}x), bound {b_ms:.5f} ms ({b_by})", flush=True)
    del q, k, v

    # the CUDA-core prefill (fp32; off the serve path) at one sweep shape,
    # timed beside SDPA in fp32 (TF32 off) and its bound at the fp32 rate
    sh = SIMT_TIMED
    q, k, v = (rnd(sh[0], sh[1], sh[3], sh[5]).float(),
               rnd(sh[0], sh[2], sh[4], sh[5]).float(),
               rnd(sh[0], sh[2], sh[4], sh[5]).float())
    if ops.prefill_variant(q.dtype, sh[5]) != "simt":
        raise AssertionError("fp32 prefill does not go to the CUDA cores")
    calls = dict(
        kernel=lambda: ops.flash_attention(q, k, v, causal=True),
        plain=lambda: ref.attention_ref(q, k, v, causal=True),
        library=lambda: sdpa(torch, q, k, v, causal=True))
    ev = {name: cuda_ms(torch, fn, reps=10) for name, fn in calls.items()}
    dv = {name: device_ms(torch, fn, reps=10) for name, fn in calls.items()}
    b_ms, b_by = prefill_bound_ms(*sh, True, 4)
    out["prefill_simt"] = dict(zip(("B", "Hq", "Hkv", "Sq", "Skv", "d"), sh),
                               dtype="fp32", ms=ev["kernel"],
                               plain_ms=ev["plain"], library_ms=ev["library"],
                               device_ms=dv["kernel"],
                               plain_device_ms=dv["plain"],
                               library_device_ms=dv["library"],
                               bound_ms=b_ms, bound_by=b_by)
    print(f"  flash prefill (CUDA cores) {sh} fp32 causal: kernel "
          f"{ev['kernel']:.4f} ms (device {dv['kernel']:.4f}), plain "
          f"{ev['plain']:.4f} ms, SDPA {ev['library']:.4f} ms (device "
          f"{dv['library']:.4f}), bound {b_ms:.5f} ms ({b_by})", flush=True)
    del q, k, v

    def decode_case(key, B, S, lens, Hq=Hq, Hkv=Hkv, d=d):
        q, k, v = rnd(B, Hq, d), rnd(B, Hkv, S, d), rnd(B, Hkv, S, d)
        lens = torch.tensor(lens, dtype=torch.int32, device=dev)
        got = ops.flash_decode(q, k, v, lens)
        again = ops.flash_decode(q, k, v, lens)
        want = ref.decode_ref(q.float(), k.float(), v.float(), lens)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError("flash_decode is not deterministic")
        torch.testing.assert_close(got.float(), want, rtol=BF16_RTOL,
                                   atol=BF16_ATOL)
        for i, n in enumerate(lens.tolist()):
            if n == 0 and not torch.equal(got[i], torch.zeros_like(got[i])):
                raise AssertionError(f"flash_decode ({key}): a zero-length "
                                     f"row is not 0")
        err = (got.float() - want).abs().max().item()
        errs["decode"] = max(errs["decode"], err)
        k_ms = cuda_ms(torch, lambda: ops.flash_decode(q, k, v, lens))
        p_ms = cuda_ms(torch, lambda: ref.decode_ref(q, k, v, lens), reps=5)
        mask = (torch.arange(S, device=dev)[None, :] < lens[:, None])[
            :, None, None, :]
        l_ms = cuda_ms(torch, lambda: sdpa(torch, q[:, :, None], k, v,
                                           causal=False, mask=mask))
        k_dev = device_ms(torch, lambda: ops.flash_decode(q, k, v, lens))
        l_dev = device_ms(torch, lambda: sdpa(torch, q[:, :, None], k, v,
                                              causal=False, mask=mask))
        b_ms, b_by = decode_bound_ms(Hq, Hkv, d, lens.tolist(), 2)
        out[key] = dict(B=B, Hq=Hq, Hkv=Hkv, S=S, d=d, dtype="bf16",
                        lengths=lens.tolist(), max_abs_err=err, ms=k_ms,
                        plain_ms=p_ms, library_ms=l_ms, device_ms=k_dev,
                        library_device_ms=l_dev, bound_ms=b_ms,
                        bound_by=b_by)
        print(f"  flash decode B={B} Hq={Hq} Hkv={Hkv} cache={S} d={d} bf16 "
              f"lengths={lens.tolist()}: max abs err {err:.3g} vs fp32 "
              f"plain; kernel {k_ms:.4f} ms (device {k_dev:.4f}), plain "
              f"{p_ms:.4f} ms, SDPA {l_ms:.4f} ms (device {l_dev:.4f}), "
              f"bound {b_ms:.5f} ms ({b_by})", flush=True)

    # the serve path's decode: every step attends to prompt + 1 .. prompt +
    # gen_len live rows of a (prompt + gen_len)-row cache
    B = LM_BATCH
    live = np.linspace(prompt + 1, prompt + gen_len, B).round().astype(int)
    decode_case("decode", B, prompt + gen_len, live.tolist())
    # a 32,768-row cache (decode_32k's context), ragged lengths
    S = DEC_CACHE
    decode_case("decode_32k", DEC_BATCH, S,
                [S, S // 2 + 77, 1, 3 * S // 4][:DEC_BATCH])
    # internlm2-1.8b's heads (16 / 8, head dim 128) at the serve shape, and
    # one query head a kv head (G 1) with a zero-length row among long ones
    S = prompt + gen_len
    decode_case("decode_internlm2", B, S, live.tolist(), Hq=16, Hkv=8, d=128)
    decode_case("decode_g1", DEC_BATCH, S, [S, 0, S - 1, 1], Hq=8, Hkv=8)
    return out


# --------------------------------------------------------- embedding bag
def bag_bound_ms(n_live, n_ids, n_bags, D, weighted) -> tuple:
    """Each live id's row read once, ids/offsets/weights read once, out
    written once; a multiply and an add per live id and feature (fp32)."""
    nbytes = n_live * D * 4 + n_ids * (8 if weighted else 4) + n_bags * 4 \
        + n_bags * D * 4
    ops = 2 * D * n_live
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def phase_bag(torch, dien_cfg, errs) -> dict:
    """The embedding-bag kernel against its plain version on CPU copies of
    the same inputs (the wrapper's own CPU path): exact on integer-valued
    tables (sums of small integers are exact in any order), within 1e-6 on
    normal values, with empty bags and padding ids; then DIEN's shape,
    timed (the plain version timed on the card)."""
    from repro_torch.kernels.embedding_bag import ops, ref

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(3)
    dev = torch.device(DEVICE)

    def case(V, D, n_ids, n_bags, integer):
        table = torch.randint(-50, 51, (V, D), generator=gen, device=dev
                              ).float() if integer else \
            torch.randn((V, D), generator=gen, device=dev)
        ids = torch.randint(0, V, (n_ids,), generator=gen, device=dev,
                            dtype=torch.int32)
        ids[torch.rand(n_ids, generator=gen, device=dev) < 0.2] = -1  # padding
        offs = torch.sort(torch.randint(0, n_ids + 1, (n_bags,),
                                        generator=gen, device=dev)).values
        offs[0] = 0
        offs = offs.to(torch.int32)                   # repeats: empty bags
        w = torch.randn((n_ids,), generator=gen, device=dev)
        return table, ids, offs, w

    n_cases = 0
    for V, D, n_ids, n_bags in BAG_SWEEP + [(dien_cfg.n_profile_feats,
                                             dien_cfg.embed_dim, 512 * 16,
                                             512)]:
        for integer in (True, False):
            table, ids, offs, w = case(V, D, n_ids, n_bags, integer)
            for weights in (None, w):
                got = ops.embedding_bag(table, ids, offs, n_bags=n_bags,
                                        weights=weights).cpu()
                want = ops.embedding_bag(
                    table.cpu(), ids.cpu(), offs.cpu(), n_bags=n_bags,
                    weights=None if weights is None else weights.cpu())
                if integer:
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"embedding_bag != plain version on an integer "
                            f"table (V={V} D={D})")
                else:
                    torch.testing.assert_close(got, want, rtol=1e-6,
                                               atol=1e-6)
                errs["bag"] = max(errs["bag"],
                                  (got - want).abs().max().item())
                n_cases += 1
    print(f"  embedding bag: {n_cases} cases (empty bags, padding ids, "
          f"weighted and not) agree with the plain version on CPU copies "
          f"(exact on integer tables; max abs err {errs['bag']:.3g})",
          flush=True)

    # DIEN's profile lookup: 512 bags of 16 ids, D 18, mask weights
    B, nb, D = 512, dien_cfg.profile_bag_size, dien_cfg.embed_dim
    table = torch.randn((dien_cfg.n_profile_feats, D), generator=gen,
                        device=dev)
    ids = torch.randint(0, dien_cfg.n_profile_feats, (B * nb,),
                        generator=gen, device=dev, dtype=torch.int32)
    offs = torch.arange(B, dtype=torch.int32, device=dev) * nb
    w = torch.ones((B * nb,), device=dev)
    bags = ref.bags_of(offs, B * nb)
    ids64, offs64 = ids.long(), offs.long()
    F = torch.nn.functional
    calls = dict(
        kernel=lambda: ops.embedding_bag(table, ids, offs, n_bags=B,
                                         weights=w),
        plain=lambda: ref.embedding_bag_ref(table, ids, bags, B, weights=w),
        library=lambda: F.embedding_bag(ids64, table, offs64, mode="sum",
                                        per_sample_weights=w))
    # the calls are a few microseconds of device work behind tens of host
    # microseconds each: back-to-back event time (the yardstick of every
    # kernel's ms, host dispatch included here) and device time (profiler:
    # the kernels alone) side by side
    ev = {k: cuda_ms(torch, fn) for k, fn in calls.items()}
    dev_ms = {k: device_ms(torch, fn) for k, fn in calls.items()}
    b_ms, b_by = bag_bound_ms(B * nb, B * nb, B, D, True)
    print(f"  embedding bag at DIEN's shape ({B} bags x {nb} ids, D={D}, "
          f"V={dien_cfg.n_profile_feats}), back-to-back event time: kernel "
          f"{ev['kernel']:.5f} ms, plain {ev['plain']:.5f} ms, "
          f"F.embedding_bag {ev['library']:.5f} ms; device time: kernel "
          f"{dev_ms['kernel']:.5f}, plain {dev_ms['plain']:.5f}, "
          f"F.embedding_bag {dev_ms['library']:.5f} ms; bound {b_ms:.6f} ms "
          f"({b_by})", flush=True)
    return dict(B=B, bag=nb, D=D, V=dien_cfg.n_profile_feats,
                max_abs_err=errs["bag"], ms=ev["kernel"],
                plain_ms=ev["plain"], library_ms=ev["library"],
                device_ms=dev_ms["kernel"], plain_device_ms=dev_ms["plain"],
                library_device_ms=dev_ms["library"], bound_ms=b_ms,
                bound_by=b_by)


# ------------------------------------------------------------- LM serve
def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def lm_compare(torch, got, want) -> dict:
    """bf16 logits of one run against another's: the largest difference
    relative to the second run's largest magnitude, and the relative L2
    difference, over the real vocab (the padded vocab is -1e9 in both)."""
    g, w = got.float(), want.float()
    valid = w > -1e8
    g, w = g[valid], w[valid]
    return dict(max_rel=((g - w).abs().max() / w.abs().max()).item(),
                l2_rel=((g - w).norm() / w.norm()).item())


def phase_serve_lm(torch, n_layers, prompt, gen_len, out_dir) -> dict:
    """granite-3-2b's serve path: prefill, then greedy decode, through the
    flash kernels, counted; then the same model twice with a plain attention
    called explicitly, teacher-forced on the kernel run's tokens: the JAX
    package's ``blocked_attention`` (the comparison) and the kernels' own
    plain version ``attention_ref`` (the floor: two exact fp32 softmaxes
    that differ only in summation order, run through the same bf16 model);
    then a traced window of decode steps."""
    import dataclasses

    from repro_torch.configs import granite_3_2b
    from repro_torch.kernels.flash_attention import ops as flash
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models import transformer as T
    from repro_torch.models.common import blocked_attention, init_from_specs

    cfg = granite_3_2b.CFG
    if n_layers != cfg.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(LM_SEED)
    t0 = time.perf_counter()
    params = T.serving_params(init_from_specs(T.param_specs(cfg), gen), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    B, L = LM_BATCH, cfg.n_layers
    tokens = torch.randint(0, cfg.vocab, (B, prompt), generator=gen,
                           device=dev, dtype=torch.int32)
    cache_shape = (L, B, cfg.n_kv_heads, prompt + gen_len, cfg.head_dim)

    def run(attention=None, forced=None):
        """prefill + gen_len greedy decode steps; per-step launch counts;
        ``forced`` tokens (teacher forcing) replace the greedy ones."""
        flash.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, (k, v) = T.prefill(params, tokens, cfg, attention=attention)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        launches = dict(prefill=dict(flash.LAUNCHES), steps=[])
        kc = torch.zeros(cache_shape, dtype=cfg.compute_dtype, device=dev)
        vc = torch.zeros(cache_shape, dtype=cfg.compute_dtype, device=dev)
        kc[:, :, :, :prompt] = k
        vc[:, :, :, :prompt] = v
        del k, v
        lengths = torch.full((B,), prompt, dtype=torch.int32, device=dev)
        tok = torch.argmax(logits, -1).to(torch.int32)
        out = dict(prefill_logits=logits, tokens=[tok], step_logits=[])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(gen_len):
            if forced is not None:
                tok = forced[i]
            before = flash.LAUNCHES["decode"]
            lg, (kc, vc), lengths = T.decode_step(
                params, (kc, vc), tok, lengths, cfg, attention=attention)
            launches["steps"].append(flash.LAUNCHES["decode"] - before)
            tok = torch.argmax(lg, -1).to(torch.int32)
            out["tokens"].append(tok)
            out["step_logits"].append(lg if i in (0, gen_len - 1) else None)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3
        out.update(prefill_ms=prefill_ms, decode_ms=decode_ms,
                   launches=launches, total=dict(flash.LAUNCHES))
        return out

    run()                               # warm: cuBLAS and kernel loading
    torch.cuda.reset_peak_memory_stats()
    kern = run()                        # the serve path, counted
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    lp = kern["launches"]
    if lp["prefill"] != {"prefill": L, "prefill_wgmma": L, "decode": 0}:
        raise AssertionError(f"prefill launched {lp['prefill']}, want "
                             f"{L} flash prefill launches, all on the "
                             f"tensor-core kernel")
    if any(n != L for n in lp["steps"]):
        raise AssertionError(f"decode steps launched {lp['steps']} flash "
                             f"decode kernels, want {L} each")
    if max(int(t.max()) for t in kern["tokens"]) >= cfg.vocab:
        raise AssertionError("greedy decoding picked a padded vocab id")
    for lg in [kern["prefill_logits"]] + [x for x in kern["step_logits"]
                                          if x is not None]:
        if not torch.isfinite(lg).all():
            raise AssertionError("non-finite logits on the serve path")

    forced = kern["tokens"][:gen_len]
    plain = run(blocked_attention, forced=forced)
    floor = run(attention_ref, forced=forced)
    for r in (plain, floor):
        if any(r["total"].values()):
            raise AssertionError(f"a plain path launched {r['total']}")

    def compare(a):
        return dict(prefill=lm_compare(torch, a["prefill_logits"],
                                       plain["prefill_logits"]),
                    first_step=lm_compare(torch, a["step_logits"][0],
                                          plain["step_logits"][0]),
                    last_step=lm_compare(torch, a["step_logits"][-1],
                                         plain["step_logits"][-1]))

    agree = [float((a == b).float().mean()) for a, b in
             zip(kern["tokens"][1:], plain["tokens"][1:])]

    # where a decode step's time goes: a traced window of decode steps
    kc = torch.zeros(cache_shape[:3] + (prompt + LM_TRACE_STEPS,
                                        cfg.head_dim),
                     dtype=cfg.compute_dtype, device=dev)
    vc = torch.zeros_like(kc)
    lens0 = torch.full((B,), prompt, dtype=torch.int32, device=dev)

    def decode_window():
        tok, lens = forced[0], lens0
        for _ in range(LM_TRACE_STEPS):
            lg, _, lens = T.decode_step(params, (kc, vc), tok, lens, cfg)
            tok = torch.argmax(lg, -1).to(torch.int32)

    trace = trace_window(torch, "lm_decode", decode_window, LM_TRACE_STEPS,
                         out_dir)
    return dict(arch=cfg.name, n_layers=L, batch=B, prompt=prompt,
                gen=gen_len, init_s=init_s, prefill_ms=kern["prefill_ms"],
                decode_ms=kern["decode_ms"],
                decode_tok_s=B * gen_len / (kern["decode_ms"] / 1e3),
                plain_prefill_ms=plain["prefill_ms"],
                plain_decode_ms=plain["decode_ms"], peak_gb=peak_gb,
                launches=dict(prefill=lp["prefill"]["prefill"],
                              prefill_wgmma=lp["prefill"]["prefill_wgmma"],
                              decode=sum(lp["steps"]),
                              per_decode_step=lp["steps"][0]),
                logits_vs_plain=compare(kern), logits_floor=compare(floor),
                greedy_agreement_teacher_forced=agree, decode_trace=trace,
                param_gb=tree_bytes(params) / 1e9)


# ----------------------------------------------------------- DIEN serve
def to_cpu(tree):
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    return tree.cpu()


def phase_serve_dien(torch, n_batches, out_dir) -> dict:
    """DIEN's full CFG at serve_p99 (batch 512): batch latency through the
    embedding-bag kernel, one launch per batch, scores against the same
    model on CPU copies of the parameters and batches (the plain path)."""
    from repro_torch.configs import dien as dcfg
    from repro_torch.kernels.embedding_bag import ops as bag
    from repro_torch.models.common import init_from_specs
    from repro_torch.models.recsys import dien as m

    cfg = dcfg.CFG
    B = dcfg.SHAPE_DEFS["serve_p99"]["batch"]
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(DIEN_SEED)
    params = init_from_specs(m.param_specs(cfg), gen)
    batches = [dcfg.rand_rank_batch(gen, cfg, B) for _ in range(n_batches)]
    # some users with partly masked profiles, one with none
    for b in batches:
        b["profile_mask"] = torch.rand(b["profile_mask"].shape, generator=gen,
                                       device=DEVICE) < 0.7
        b["profile_mask"][0] = False
    m.serve(params, batches[0], cfg)     # warm
    torch.cuda.synchronize()
    bag.reset_launches()
    lat, scores = [], []
    for b in batches:
        t0 = time.perf_counter()
        scores.append(m.serve(params, b, cfg))
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    launches = bag.LAUNCHES["embedding_bag"]
    if launches != n_batches:
        raise AssertionError(f"DIEN serve launched embedding_bag {launches} "
                             f"times for {n_batches} batches")
    err = 0.0
    cpu_params = to_cpu(params)
    for b, sc in zip(batches, scores):
        sc = sc.cpu()
        want = m.serve(cpu_params, to_cpu(b), cfg)
        torch.testing.assert_close(sc, want, rtol=1e-5, atol=1e-5)
        err = max(err, (sc - want).abs().max().item())
        if sc.shape != (B,) or not torch.isfinite(sc).all() \
                or not ((sc > 0) & (sc < 1)).all():
            raise AssertionError("DIEN scores are not finite CTRs in (0, 1)")
    if bag.LAUNCHES["embedding_bag"] != n_batches:
        raise AssertionError("the plain path launched the kernel")
    trace = trace_window(torch, "dien_serve",
                         lambda: [m.serve(params, b, cfg) for b in batches[:3]],
                         3, out_dir)
    lat = np.asarray(lat)
    return dict(batch=B, batches=n_batches, trace=trace,
                p50_ms=float(np.percentile(lat, 50)),
                p99_ms=float(np.percentile(lat, 99)),
                max_ms=float(lat.max()), mean_ms=float(lat.mean()),
                launches=launches, max_abs_err_vs_plain=err,
                requests_per_s=B * n_batches / (lat.sum() / 1e3))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, default=N_NODES)
    ap.add_argument("--edges", type=int, default=N_EDGES)
    ap.add_argument("--batches", type=int, default=20)
    ap.add_argument("--lm-layers", type=int, default=None,
                    help="cut granite-3-2b's depth (default: all 40)")
    ap.add_argument("--prompt", type=int, default=LM_PROMPT)
    ap.add_argument("--gen", type=int, default=LM_GEN)
    ap.add_argument("--dien-batches", type=int, default=DIEN_BATCHES)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    # fp32 products in full fp32 (the plain attention's and DIEN's
    # matmuls), stated both ways; the LM's bf16 products accumulate in fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch import EagrSession, Query, WindowSpec
    from repro_torch.configs import dien as dien_configs
    from repro_torch.configs import granite_3_2b
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

    # ---- 2a. kernels against their plain version: the shape sweeps
    errs = {"sum": 0.0, "max": 0.0, "prefill": 0.0, "prefill_simt": 0.0,
            "decode": 0.0, "bag": 0.0}
    phase_kernels_sweep(torch, ops, ref, errs)
    report["hub"] = phase_kernels_hub(torch, ops, ref, errs)
    phase_flash_sweep(torch, errs)
    flash_rows = phase_flash_serve_shapes(torch, granite_3_2b.CFG,
                                          args.prompt, args.gen, errs)
    bag_row = phase_bag(torch, dien_configs.CFG, errs)
    report.update(flash=flash_rows, embedding_bag=bag_row)

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

    # ---- 4. the LM serve path at granite-3-2b's full width
    n_layers = args.lm_layers or granite_3_2b.CFG.n_layers
    lm = phase_serve_lm(torch, n_layers, args.prompt, args.gen, out_dir)
    print(f"LM serve on {card}: {lm['arch']} {lm['n_layers']} layers, "
          f"{lm['param_gb']:.2f} GB of bf16/fp32 serving parameters: prefill "
          f"{lm['batch']} x {lm['prompt']} tokens in {lm['prefill_ms']:.3f} "
          f"ms; {lm['gen']} greedy decode steps in {lm['decode_ms']:.3f} ms = "
          f"{lm['decode_tok_s']:.1f} tokens/s; peak memory "
          f"{lm['peak_gb']:.2f} GB; flash launches {lm['launches']}",
          flush=True)
    print(f"  logits vs blocked_attention (teacher-forced): kernels "
          f"{lm['logits_vs_plain']}; floor (attention_ref) "
          f"{lm['logits_floor']}; greedy agreement per step min "
          f"{min(lm['greedy_agreement_teacher_forced']):.3f}; plain path "
          f"prefill {lm['plain_prefill_ms']:.3f} ms, decode "
          f"{lm['plain_decode_ms']:.3f} ms", flush=True)
    for k, c in lm["logits_vs_plain"].items():
        f = lm["logits_floor"][k]
        for m in ("max_rel", "l2_rel"):
            tol = LM_FLOOR_FACTOR * f[m] + BF16_UNIT
            if c[m] > tol or c["l2_rel"] > LM_L2_CAP:
                raise AssertionError(
                    f"{k} logits differ from the plain path: {c} against "
                    f"the floor {f} (tolerance {LM_FLOOR_FACTOR} x floor + "
                    f"{BF16_UNIT}, l2 cap {LM_L2_CAP})")
    report["serve_lm"] = lm

    # ---- 5. the DIEN serve path at its full CFG, serve_p99
    dien = phase_serve_dien(torch, args.dien_batches, out_dir)
    print(f"DIEN serve on {card}: {dien['batches']} batches of "
          f"{dien['batch']}: p50 {dien['p50_ms']:.3f} ms, p99 "
          f"{dien['p99_ms']:.3f} ms, max {dien['max_ms']:.3f} ms "
          f"({dien['requests_per_s']:.0f} requests/s); embedding_bag "
          f"launches {dien['launches']}; scores vs plain max abs err "
          f"{dien['max_abs_err_vs_plain']:.3g}", flush=True)
    report["serve_dien"] = dien

    bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
           or m == "repro" or m.startswith("repro.")]
    if bad:
        raise AssertionError(f"the port loaded {bad[:5]}")

    # one entry per kernel: the segment kernels at the EAGr main path's
    # largest level, F=1; the flash kernels at the LM serve path's shapes
    # (prefill: the tensor-core kernel, its errors beside SDPA's; decode: B 8
    # against the path's prompt + gen cache); the embedding bag at DIEN's;
    # launches from each path's counted run. ms, plain_ms and library_ms are
    # back-to-back CUDA-event times for every kernel; device_ms and
    # library_device_ms the profiler's device time of the same calls
    kernels = []
    for op, (name, replaces) in KERNELS.items():
        rows = [r for r in level_rows if r["op"] == op and r["F"] == 1]
        top = max(rows, key=lambda r: r["n_live"])
        k_dev, l_dev = level_device_ms(torch, ops, session, top)
        kernels.append(dict(
            name=name, route="cuda", source=SOURCE, replaces=replaces,
            design=DESIGNS[op], launches=launches[op], max_abs_err=errs[op],
            ms=top["ms"], plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
            bound_by=top["bound_by"], library_ms=top["library_ms"],
            device_ms=k_dev, library_device_ms=l_dev))
    for name, key, n in (("flash_attention", "prefill",
                          lm["launches"]["prefill_wgmma"]),
                         ("flash_decode", "decode", lm["launches"]["decode"])):
        row = flash_rows[key]
        kernels.append(dict(
            name=name, route="cuda", source=FLASH_SOURCE,
            replaces=FLASH_REPLACES, design=DESIGNS[key], launches=n,
            max_abs_err=errs[key], ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"], device_ms=row["device_ms"],
            library_device_ms=row["library_device_ms"]))
    kernels[-2].update({k: flash_rows["prefill"][k] for k in (
        "l2_rel", "library_max_abs_err", "library_l2_rel")})
    kernels.append(dict(
        name="embedding_bag", route="cuda", source=BAG_SOURCE,
        replaces=BAG_REPLACES, design=DESIGNS["bag"],
        launches=dien["launches"], max_abs_err=errs["bag"], ms=bag_row["ms"],
        plain_ms=bag_row["plain_ms"], bound_ms=bag_row["bound_ms"],
        bound_by=bag_row["bound_by"], library_ms=bag_row["library_ms"],
        device_ms=bag_row["device_ms"],
        library_device_ms=bag_row["library_device_ms"]))
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
