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
   the repository's reference deployment (``repro_torch.configs.eagr.CFG``:
   100,000 nodes, 800,000 edges, seed 0, tuple window 8, batches of 4096;
   the session's own ``vnm_a`` overlay), ``sum``/``max``/``count``
   queries, a stream of Zipf(1.5)-drawn writes with a read of every query
   after each batch (the first batch, which loads the path's kernels, is
   timed apart and the stream restarted); rates are all events over all the
   time their calls took; answers held against an independent numpy oracle,
   the stream replayed from a fresh state to require bit-equal PAOs, and
   each segment op launched on the main path (its dense or its active
   entry: the default ``auto`` mode picks per step); then
   one traced window of writes and one of reads (torch.profiler) for the
   device time by kernel and the device's busy share; then the F1 gate: the
   same stream under ``auto``, forced dense and forced sparse in lockstep
   (a state copy per mode, every batch under each mode in turn), 7 rounds,
   ``auto``'s write p50 and read p50 over them each required within 1.10x
   of the better forced mode;
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
   (where the bag wrapper runs its plain version);
6. the dynamic path on phase 3's session (headroom 2.0): the segment
   kernel's active entry held, at every real level of the sum and max plans
   and the active sets of a 256-writer batch, bit-equal on the rows it
   covers to the dense kernel with the inactive blocks set to the identity,
   and to its plain version (exact on integer values and for max), sums of
   normal values within n * 2^-24 * sum|x| per row of an fp64 sum on CPU
   copies; one write stream run
   twice from one starting state, frontier-sparse (``EAGR_SPARSE_WRITE=1``)
   and dense (``=0``), at batches of 256 and 4,096 Zipf(1.5) writers each
   followed by reads of 256 readers, PAOs and answers required bit-equal and
   both active launch counts above zero on writes and on reads; the sparse
   write step's host work by part (unique rows, frontier keys, packing, the
   staged upload beside a copy per array); a steady-state sparse window
   run under
   ``torch.cuda.set_sync_debug_mode("error")``; 10 churn bursts at 0.1% and
   10 at 1% of the readers (70% ``add_edge``, 30% ``delete_edge``), each
   flushed, then a write batch and a read, the plan tables required to keep
   their storage across in-capacity bursts, the answers held to the oracle
   on 256 sampled readers, sparse against dense replayed bit-equal on the
   churned plans from copies of one state; then one ``adapt()`` and the
   oracle again. Phase 3 runs under the default ``auto`` mode and prints how
   many of its steps went sparse;
7. the streaming path on phase 3's deployment: an ``EagrSession`` with an
   ingest ring (``ingest_depth=2``, device batches of 8,192 coalesced from
   arrival batches of 1,024 Zipf(1.5) writes of integer values from the
   port's ``generate_trace``), continuous ``sum`` and ``max`` queries, and
   one standing alert on every reader of ``sum`` whose per-reader ``above``
   sits over the warmed-up sum at a ~0.1% fired share per batch; the stream
   pipelined, then through the synchronous session at the same device
   batches (states, answers and fired sets required bit-equal), the poll
   oracle after every device batch (fired sets required equal, batch by
   batch), a cap of 8 that must overflow and still give the exact sets, a
   window of pipelined writes, reads and drains under
   ``set_sync_debug_mode("error")``, and one traced window; events/s of the
   ring against the synchronous session, the ring's stall and barrier time,
   detection latency p50/p99 (dispatch into the ring to the fired set on the
   host), and segment launches on the ring's steps required above zero;
8. shards and checkpoints on phase 3's graph: ``EagrSession(shards=4)``
   with ``sum`` and ``max`` (tuple window 8), its cold build timed; 10
   write batches of 4,096 Zipf(1.5) writers (5 forced dense, 5 forced
   sparse) required bit-equal to a host loop of 4 single-shard engines
   over copies of the aligned plans (windows, PAOs, clocks and answers),
   the dense steps to launch the stacked entry exactly once a level and
   reduce, and 256 sampled readers to agree with the stream oracle; the
   shard-batched kernel at the phase's largest level (dense) and largest
   active push level, sum at F=1 and max, bit-equal to 4 launches of the
   single-shard entry and held to its plain version (exact on integers and
   for max, normal-valued sums within n * 2^-24 * sum|x| of an fp64 sum),
   its device time beside 4 single-shard launches, ``index_add_`` over the
   flattened shards and the bound; stacked write/read p50 and throughput
   beside phase 3's, and a traced write window's busy share; a window of
   stacked writes and reads under ``set_sync_debug_mode("error")``; 3 churn
   bursts at 0.1% of the readers, the stacked tables and owner maps
   required to keep their storage, answers held to the owning shards'
   window oracle; then, in a temporary directory removed at exit, a save
   (blocking part, total, bytes, MB/s), a same-layout restore (seconds
   against the cold build's, first read bit-identical), reshards 4 -> 2
   and 4 -> single (sums within 1e-4, max exact) and
   ``SessionRecoveryDriver`` with one injected failure required
   bit-identical to an uninterrupted run.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Any failed check raises and
the script exits non-zero without that line. Details of every measurement go
to ``chiprun_out/chip_smoke.json``. The script imports neither JAX nor the
JAX package.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# the reference deployment: the port's configs/eagr.py CFG (graph, window,
# batch and Zipf exponent; the session builds its own overlay, ``vnm_a``
# with 3 iterations, where CFG's engine builds ``vnm_n`` with 4 and splits
# nodes)
from repro_torch.configs.eagr import CFG as EAGR_CFG  # noqa: E402

N_NODES, N_EDGES, SEED = EAGR_CFG.n_nodes, EAGR_CFG.n_edges, EAGR_CFG.seed
WINDOW, BATCH, ZIPF_A = EAGR_CFG.window, EAGR_CFG.write_batch, \
    EAGR_CFG.zipf_a
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
# the active entry serves the same TPU kernels on the frontier-sparse steps
ACTIVE_KERNELS = {
    "sum_active": ("segment_agg_sum_active", KERNELS["sum"][1]),
    "max_active": ("segment_agg_max_active", KERNELS["max"][1]),
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
    "stacked": "the single-shard kernel with a third grid axis over S "
               "shards: each CTA offsets its pointers to its shard's slice "
               "and runs the single-shard code; one launch a level for all "
               "shards (dense or active entry)",
    "active": "the dense template over the active blocks only: one CTA per "
              "window holding an active block, windows cut by the blocks' "
              "own indices, other blocks skipped as padding, a run's pieces "
              "combined in window order by its first active block",
}
# phase 6: the dynamic path
DYN_BATCHES = 8            # batches of each sparse/dense run
DYN_SIZES = (256, BATCH)   # writers a batch (benchmarks/dynamic_bench.py's
DYN_READS = 256            # 256, and phase 3's 4,096); readers a read
CHURN = ((0.001, 10), (0.01, 10))  # (share of readers a burst, bursts)
SYNC_WINDOW = 4            # sparse batches under the sync check
# F1: phase 3's stream under auto against both forced modes
F1_ROUNDS, F1_FACTOR = 7, 1.10
# phase 7: the streaming path (an ingest ring of 2 slots, device batches of
# 8,192 coalesced from arrival batches of 1,024; one standing alert tuned
# to the 0.1% fired share per batch of benchmarks/alerts_bench.py's
# GATE_FRAC)
INGEST_DEPTH, ARRIVAL, COALESCE = 2, 1024, 8
STREAM_BATCHES = 32        # device batches of the parity stream
STREAM_WARMUP = 8          # device batches before the thresholds are set
STREAM_CALIB = 4           # device batches the thresholds are set from
GATE_FRAC = 0.001          # alerts_bench.py's fired share per batch
OVERFLOW_CAP, OVERFLOW_BATCHES = 8, 4
STREAM_ROUNDS = 3          # timed rounds of the ring and the sync session
STREAM_SYNC_WINDOW = 4     # device batches under the sync check
# phase 8: shards and checkpoints (4 shards: the reference's checkpoint
# bench reshards to 4, and its sharded bench peaked at 4)
SHARDS = 4
PARITY_BATCHES = 10        # write batches of the stack-vs-host-loop check
SPEED_BATCHES = 10         # write batches (each with reads) of the timing
SHARD_CHURN_BURSTS = 3     # bursts at CHURN[0]'s 0.1% of the readers
RECOVERY_BATCHES, RECOVERY_EVERY = 6, 2  # the recovery driver's run

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


def held_ms(torch, fn, reps: int = 50) -> float:
    """Device time of one call, by CUDA events around ``reps`` back-to-back
    calls that the host enqueues while a sleep kernel holds the card (as
    ``auto``'s timing does): the events then time the device work alone,
    with no host gap between calls, and need no profiler. After one warm
    call."""
    from repro_torch.core.engine import SLEEP_CYCLES

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


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


class Oracle:
    """Independent numpy oracle: per-writer tuple windows of the last
    WINDOW values, fed in stream order; a reader's answer reduces its
    current neighbourhood's windows."""

    def __init__(self, batches=()):
        self.win: dict[int, collections.deque] = {}
        for ids, vals, _ in batches:
            self.feed(ids, vals)

    def feed(self, ids, vals) -> None:
        for w, v in zip(ids.tolist(), vals.tolist()):
            d = self.win.get(w)
            if d is None:
                d = self.win[w] = collections.deque(maxlen=WINDOW)
            d.append(np.float32(v))

    def check(self, session, handles, sample) -> None:
        check_answers(session, handles, self.win, sample)


def oracle_check(session, handles, batches, sample) -> None:
    """Replay the stream into the oracle's windows, then reduce each sampled
    reader's neighborhood. Sum and count to 1e-4, max exactly."""
    Oracle(batches).check(session, handles, sample)


def check_answers(session, handles, win, sample) -> None:
    got = {h.agg.name: np.asarray(session.read(h, sample)).reshape(len(sample), -1)[:, 0]
           for h in handles}
    for i, r in enumerate(sample.tolist()):
        vals = [v for w in session.neighborhood(r) for v in win.get(w, ())]
        want_sum = float(np.sum(np.asarray(vals, np.float64)))
        want_max = np.float32(max(vals)) if vals else np.float32(-3.0e38)
        if abs(got["sum"][i] - want_sum) > 1e-4 + 1e-4 * abs(want_sum):
            raise AssertionError(f"sum of reader {r}: {got['sum'][i]} != "
                                 f"{want_sum}")
        if "count" in got and abs(got["count"][i] - len(vals)) > 1e-4:
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


def f1_gate(torch, ops, session, handles, stream) -> dict:
    """Phase 3's stream under ``auto``, forced dense (``0``) and forced
    sparse (``1``) in lockstep: each mode keeps its own copy of the engine
    states, and every batch is written (then read by every query) under
    each mode in turn, the order rotated batch by batch, so the host's
    spread between moments falls on every mode alike. F1_ROUNDS rounds of
    the stream, each from a copy of one starting state; each mode's write
    p50 and read p50 over all its rounds' calls, where ``auto`` must be
    within F1_FACTOR of the better forced mode on both (each round's p50s
    are kept too). Also the write steps that went sparse and the
    active-entry launches (sparse steps of either kind) under each mode,
    and auto's measured costs."""
    modes = ("auto", "0", "1")
    reset_engines(session)
    start = snapshot_states(session)
    for mode in modes:  # warm each mode (index builds, auto's timing)
        set_sparse(mode)
        restore_states(session, start)
        drive(torch, session, handles, stream[:2])
    per = {m: dict(write_p50_ms=[], read_p50_ms=[], sparse_steps=[],
                   active_launches=[]) for m in modes}
    calls = {m: dict(write_p50_ms=[], read_p50_ms=[]) for m in modes}
    k = 0
    for _ in range(F1_ROUNDS):
        states = {}
        for mode in modes:
            restore_states(session, start)   # a copy per mode
            states[mode] = snapshot_states(session)
        w = {m: [] for m in modes}
        rd = {m: [] for m in modes}
        sparse = dict.fromkeys(modes, 0)
        active = dict.fromkeys(modes, 0)
        for ids, vals, q in stream:
            for mode in modes[k % 3:] + modes[: k % 3]:
                set_sparse(mode)
                for g, (st, now, last) in zip(session._groups.values(),
                                              states[mode]):
                    g.engine.adopt_state(st, now_host=now,
                                         last_eval_now=last)
                ops.reset_launches()
                ws, rs, _ = drive(torch, session, handles, [(ids, vals, q)])
                w[mode].extend(ws)
                rd[mode].extend(rs)
                sparse[mode] += sum(g.engine.frontier_log[-1] >= 0
                                    for g in session._groups.values())
                active[mode] += ops.LAUNCHES["sum_active"] + \
                    ops.LAUNCHES["max_active"]
                states[mode] = snapshot_states(session)
            k += 1
        for m in modes:
            calls[m]["write_p50_ms"].extend(w[m])
            calls[m]["read_p50_ms"].extend(rd[m])
            per[m]["write_p50_ms"].append(float(np.median(w[m])))
            per[m]["read_p50_ms"].append(float(np.median(rd[m])))
            per[m]["sparse_steps"].append(sparse[m])
            per[m]["active_launches"].append(active[m])
    set_sparse("auto")
    reset_engines(session)
    med = {m: {k: float(np.median(calls[m][k] if k in calls[m] else v))
               for k, v in per[m].items()} for m in modes}
    costs = {g.agg.name: {side: None if c is None else dataclasses.asdict(c)
                          for side, c in (("write", g.engine.plan.write_costs),
                                          ("read", g.engine.plan.read_costs))}
             for g in session._groups.values()}
    out = dict(rounds=F1_ROUNDS, factor=F1_FACTOR, per_round=per,
               median=med, write_steps=len(stream) * len(session._groups),
               auto_costs_s=costs)
    print(f"auto's measured costs (s): {costs}", flush=True)
    print(f"F1 gate per round: {per}", flush=True)
    print(f"F1 gate on {card_line()}: p50s over {F1_ROUNDS} rounds of "
          f"phase 3's stream, the modes in lockstep: {med}; under auto "
          f"{med['auto']['sparse_steps']:.0f} of {out['write_steps']} write "
          f"steps went sparse", flush=True)
    for key in ("write_p50_ms", "read_p50_ms"):
        best = min(med["0"][key], med["1"][key])
        if med["auto"][key] > F1_FACTOR * best:
            raise AssertionError(
                f"auto's {key} {med['auto'][key]:.3f} ms is above "
                f"{F1_FACTOR} x the better forced mode's {best:.3f} ms")
    return out


# ---------------------------------------------------------- dynamic path
def set_sparse(mode: str) -> None:
    """The engines read EAGR_SPARSE_WRITE per call: '1' sparse, '0' dense,
    'auto' (the default) by batch size and frontier density."""
    os.environ["EAGR_SPARSE_WRITE"] = mode


def dyn_stream(writers, readers, n_batches: int, size: int, rng):
    """Zipf(1.5)-drawn writers as in benchmarks/dynamic_bench.py, normal
    values, and DYN_READS readers a batch."""
    perm = rng.permutation(len(writers))
    out = []
    for _ in range(n_batches):
        rank = rng.zipf(ZIPF_A, size)
        out.append((writers[perm[(rank - 1) % len(writers)]],
                    rng.normal(size=size).astype(np.float32),
                    rng.choice(readers, DYN_READS)))
    return out


def drive_counted(torch, ops, session, handles, batches) -> dict:
    """``drive`` with the kernel launches of the writes and of the reads
    counted apart (each set to 0 just before and read just after)."""
    out = dict(w_ms=[], r_ms=[], answers=[],
               write_launches=dict.fromkeys(ops.LAUNCHES, 0),
               read_launches=dict.fromkeys(ops.LAUNCHES, 0))
    for ids, vals, q in batches:
        ops.reset_launches()
        t0 = time.perf_counter()
        session.update(ids, vals)
        torch.cuda.synchronize()
        out["w_ms"].append((time.perf_counter() - t0) * 1e3)
        for k, v in ops.LAUNCHES.items():
            out["write_launches"][k] += v
        ops.reset_launches()
        for h in handles:
            t0 = time.perf_counter()
            out["answers"].append(session.read(h, q))  # host numpy: synced
            out["r_ms"].append((time.perf_counter() - t0) * 1e3)
        for k, v in ops.LAUNCHES.items():
            out["read_launches"][k] += v
    return out


def snapshot_states(session):
    return [(g.engine.state, g.engine._now_host, g.engine._last_eval_now)
            for g in session._groups.values()]


def restore_states(session, states) -> None:
    """Put copies of saved engine states back (the step bodies never write
    a state in place, but the copies keep each run's start identical)."""
    for g, (st, now, last) in zip(session._groups.values(), states):
        copy = type(st)(type(st.windows)(*(t.clone() for t in st.windows)),
                        st.pao.clone(), st.now.clone())
        g.engine.adopt_state(copy, now_host=now, last_eval_now=last)


def sparse_vs_dense(torch, ops, session, handles, batches, start) -> dict:
    """One stream from one starting state twice, sparse then dense: PAOs
    and answers bit-equal; per-mode write/read times and launches."""
    runs = {}
    for mode in ("1", "0"):
        set_sparse(mode)
        restore_states(session, start)
        drive(torch, session, handles, batches[:1])  # warm (index builds)
        restore_states(session, start)
        runs[mode] = drive_counted(torch, ops, session, handles, batches)
        runs[mode]["paos"] = [g.engine.state.pao.clone()
                              for g in session._groups.values()]
    set_sparse("auto")
    for a, b in zip(runs["1"]["paos"], runs["0"]["paos"]):
        if not torch.equal(a, b):
            raise AssertionError("sparse and dense PAOs differ")
    for a, b in zip(runs["1"]["answers"], runs["0"]["answers"]):
        if not np.array_equal(a, b):
            raise AssertionError("sparse and dense answers differ")
    return runs


def rates(run, size: int) -> dict:
    w, r = run["w_ms"], run["r_ms"]
    return dict(write_events_per_s=size * len(w) / (np.sum(w) / 1e3),
                write_p50_ms=float(np.median(w)),
                write_max_ms=float(np.max(w)),
                read_p50_ms=float(np.median(r)), read_max_ms=float(np.max(r)),
                write_launches=run["write_launches"],
                read_launches=run["read_launches"])


def plain_sum_fp64(x, seg_c, n_rows: int):
    """Reduce-by-destination of ``x`` over slots ``seg_c`` in fp64 on CPU
    copies (slot order, one thread): the deterministic plain sum the
    active entry's normal-valued sums are held to. (n_rows, F) fp64."""
    import torch

    xc = x.detach().cpu().double()
    dst = seg_c.detach().cpu().long()
    dst = torch.where(dst >= 0, dst, n_rows)
    out = torch.zeros((n_rows + 1, xc.shape[1]), dtype=torch.float64)
    return out.index_add_(0, dst, xc)[:n_rows]


def active_bound_ms(seg_c, tob, act, F: int) -> tuple[float, str]:
    """Least time for one active-entry call: the active blocks' seg and
    block tables read once, x read for each live slot of the active blocks,
    output written for each row of a tile an active block routes to; one
    add/max per live slot and feature."""
    n_live = int((seg_c >= 0).sum().item())
    nb = tob.numel()
    real = act[act < nb].long()
    tiles = int(tob[real].unique().numel())
    nbytes = seg_c.numel() * 4 + real.numel() * 12 + n_live * 4 * F \
        + tiles * 128 * 4 * F
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_live * F / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def active_sets(session, batch):
    """The push (write) and pull (read) active tuples the engines expand for
    one batch of writers and readers, per group."""
    out = {}
    ids, _, q = batch
    for g in session._groups.values():
        eng = g.engine
        rows, mask = eng.plan.routes.writer_rows(ids)
        push = eng.frontier_active(rows, mask)
        nodes, _ = eng.plan.routes.reader_nodes(q)
        rd = eng._reader_active(nodes)
        out[g.agg.name] = (push, None if rd is None else rd[1])
    return out


def check_active(torch, ops, ref, session, batch, errs) -> list[dict]:
    """The active entry at the phase-6 shapes: every real level of the sum
    and max plans with the active blocks of one 256-writer batch (push) and
    256 readers (pull), F in {1, 2, 64}: bit-equal on the covered rows to
    the dense kernel over the level with the inactive blocks' values set to
    the op's identity, exact against the plain version on integer values
    and for max, sums of normal values within n * 2^-24 * sum|x| per row
    (n the row's active live slots) of an exact-order plain sum in fp64 on
    CPU copies (``plain_sum_fp64``: deterministic, where the fp32 plain
    version on the card adds by atomics in no fixed order), reruns
    bit-equal; times beside the bound and ``index_add_`` on the same
    compacted data."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    set_sparse("1")
    sets = active_sets(session, batch)
    set_sparse("auto")
    rows = []
    E = ops.E_BLK
    for g in session._groups.values():
        if g.agg.name not in ("sum", "max"):
            continue
        op = "sum" if g.agg.name == "sum" else "max"
        plan, meta = g.engine.plan, g.engine.plan.meta
        for side, acts in zip(("push", "pull"), sets[g.agg.name]):
            if acts is None:
                continue
            t = getattr(plan.arrays, side)
            for l in range(plan.depth):
                if acts[l].shape[0] == 0:
                    continue
                seg, tob, fot = t.seg[l], t.tile_of_block[l], \
                    t.first_of_tile[l]
                nb = tob.numel()
                act = torch.as_tensor(acts[l], device=dev)
                a = act.long()
                real = a[a < nb]
                seg_c = torch.where((a < nb)[:, None],
                                    seg.view(nb, E)[a.clamp(max=nb - 1)],
                                    -1).reshape(-1)
                n_live = int((seg_c >= 0).sum().item())
                if n_live == 0:
                    continue
                cov = torch.zeros(meta.n_nodes + 1, dtype=torch.bool,
                                  device=dev)
                cov[torch.where(seg_c >= 0, seg_c.long(), meta.n_nodes)] = True
                cov = cov[: meta.n_nodes]
                # active live slots a row adds: the reordered-sum bound's n
                n_in = torch.zeros(meta.n_nodes + 1, device=dev).index_add_(
                    0, torch.where(seg_c >= 0, seg_c.long(), meta.n_nodes),
                    torch.ones(seg_c.shape, device=dev))[: meta.n_nodes, None]
                ident = 0.0 if op == "sum" else -3.0e38
                for F in (1, 2, 64):
                    for integer in (True, False):
                        xf = (torch.randint(-8, 9, (seg.numel(), F),
                                            generator=gen, device=dev)
                              .to(torch.float32) if integer else
                              torch.randn((seg.numel(), F), generator=gen,
                                          device=dev))
                        xb = xf.view(nb, E, F)
                        xc = xb[a.clamp(max=nb - 1)].reshape(-1, F) \
                            .contiguous()
                        kw = dict(n_rows=meta.n_nodes,
                                  n_row_tiles=meta.n_row_tiles, op=op)
                        got = [ops.segment_agg_active(xc, seg, tob, fot, act,
                                                      **kw)
                               for _ in range(2)]
                        xi = torch.full_like(xb, ident)
                        xi[real] = xb[real]
                        dense = ops.segment_agg_level(
                            xi.reshape(-1, F).contiguous(), seg, tob, fot,
                            **kw)
                        plain = ref.segment_agg_active_ref(xc, seg, act,
                                                           meta.n_nodes, op)
                        if not torch.equal(got[0][cov], got[1][cov]):
                            raise AssertionError("active entry is not "
                                                 "deterministic")
                        if not torch.equal(got[0][cov], dense[cov]):
                            raise AssertionError(
                                f"active {op} != dense kernel with identity "
                                f"({side} l={l} F={F})")
                        err = (got[0][cov] - plain[cov]).abs().max().item()
                        if integer or op == "max":
                            if not torch.equal(got[0][cov], plain[cov]):
                                raise AssertionError(
                                    f"active {op} != plain version (exact), "
                                    f"max abs err {err}")
                        else:
                            exact = plain_sum_fp64(xc, seg_c, meta.n_nodes)
                            lim = n_in.cpu().double() * 2.0 ** -24 * \
                                plain_sum_fp64(xc.abs(), seg_c, meta.n_nodes)
                            dev64 = (got[0].cpu().double() - exact).abs()
                            cov_c = cov.cpu()
                            err = dev64[cov_c].max().item()
                            if bool((dev64 > lim)[cov_c].any()):
                                raise AssertionError(
                                    f"active sum beyond n * 2^-24 * sum|x| "
                                    f"of the fp64 sum ({side} l={l} F={F}), "
                                    f"max abs err {err}")
                        errs[f"{op}_active"] = max(errs[f"{op}_active"], err)
                    k_ms = cuda_ms(torch, lambda: ops.segment_agg_active(
                        xc, seg, tob, fot, act, **kw))
                    k_dev = device_ms(torch, lambda: ops.segment_agg_active(
                        xc, seg, tob, fot, act, **kw), reps=20)
                    p_ms = cuda_ms(torch, lambda: ref.segment_agg_active_ref(
                        xc, seg, act, meta.n_nodes, op))
                    dst = torch.where(seg_c >= 0, seg_c.long(), meta.n_nodes)
                    lib_out = torch.zeros((meta.n_nodes + 1, F), device=dev)
                    lib = (lambda: lib_out.index_add_(0, dst, xc)) \
                        if op == "sum" else \
                        (lambda: lib_out.index_reduce_(0, dst, xc, "amax"))
                    l_ms = cuda_ms(torch, lib)
                    l_dev = device_ms(torch, lib, reps=20)
                    b_ms, b_by = active_bound_ms(seg_c, tob, act, F)
                    rows.append(dict(
                        op=op, side=side, level=l, n_blocks=nb,
                        active=int(real.numel()), K=int(act.numel()),
                        n_live=n_live, F=F, ms=k_ms, device_ms=k_dev,
                        plain_ms=p_ms, library_ms=l_ms,
                        library_device_ms=l_dev, bound_ms=b_ms,
                        bound_by=b_by))
                    print(f"  active {op:3s} {side:4s} l={l} blocks "
                          f"{int(real.numel())}/{nb} live={n_live} F={F:2d}: "
                          f"kernel {k_ms:.4f} ms ({k_dev:.5f} device), plain "
                          f"{p_ms:.4f} ms, index_add_/reduce "
                          f"{l_ms:.4f} ms ({l_dev:.5f} device), bound "
                          f"{b_ms:.6f} ms ({b_by})", flush=True)
    return rows


def sparse_host_parts(torch, session, batch, reps: int = 7) -> dict:
    """The sparse write step's host work by part for one batch, per group
    (host milliseconds, median of ``reps``): ``np.unique`` of the routed
    rows, ``FrontierIndex.keys``, the packing (``_pack_active``), and the
    uploads of rows, values, mask and active lists as one staged copy
    (``engine.stage``) beside one pinned copy per array."""
    from repro_torch.core import engine as E
    from repro_torch.core import frontier as F

    ids, vals, _ = batch
    dev = torch.device(DEVICE)
    out = {}
    for g in session._groups.values():
        eng = g.engine
        fi = eng.plan.frontier
        if fi is None:
            continue
        rows, mask = eng.plan.routes.writer_rows(ids)
        t = collections.defaultdict(list)
        for _ in range(reps):
            t0 = time.perf_counter()
            rows_u = np.unique(rows[mask])
            t1 = time.perf_counter()
            keys = fi.keys(rows_u)
            t2 = time.perf_counter()
            act = F._pack_active(keys, fi.n_levels, fi.n_blocks, None)
            t3 = time.perf_counter()
            parts = [(rows, np.int32), (vals, np.float32), (mask, bool)] + \
                [(a, np.int32) for a in act]
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            E.stage(parts, dev)
            t5 = time.perf_counter()
            torch.cuda.synchronize()
            t6 = time.perf_counter()
            for a, dt in parts:
                E.stage([(a, dt)], dev)
            t7 = time.perf_counter()
            torch.cuda.synchronize()
            for k, v in (("unique", t1 - t0), ("keys", t2 - t1),
                         ("pack", t3 - t2), ("stage_one_copy", t5 - t4),
                         ("per_array_uploads", t7 - t6)):
                t[k].append(v * 1e3)
        out[g.agg.name] = dict({k: float(np.median(v)) for k, v in t.items()},
                               n_rows=int(len(rows_u)),
                               arrays=len(parts))
    return out


def plan_ptrs(session) -> list[dict]:
    """Each group's plan tables by name: where their storage lives."""
    from repro_torch.core.engine import _plan_array_leaves

    return [{k: v.data_ptr() for k, v in
             _plan_array_leaves(g.engine.plan.arrays)}
            for g in session._groups.values()]


def churn_burst(session, rng, readers, n_base: int, n_ops: int) -> None:
    """One burst as benchmarks/dynamic_bench.py draws it: a reader at
    random, then an edge add (70%) or a delete of one of its inputs."""
    for _ in range(n_ops):
        r = int(rng.choice(readers))
        nb = session.neighborhood(r)
        if rng.random() < 0.7 or not nb:
            session.add_edge(int(rng.integers(0, n_base)), r)
        else:
            session.delete_edge(int(next(iter(nb))), r)


def phase_dynamic(torch, ops, ref, session, handles, errs, out_dir) -> dict:
    """Phase 6 (see the module docstring)."""
    report: dict = {"seconds_by_part": {}}
    clock = [time.perf_counter()]

    def lap(part: str) -> None:
        now = time.perf_counter()
        report["seconds_by_part"][part] = now - clock[0]
        clock[0] = now

    rng = np.random.default_rng(SEED + 6)
    writers = np.asarray(session.writers, np.int64)
    readers = np.asarray(session.readers, np.int64)
    reset_engines(session)
    start = snapshot_states(session)

    # ---- 6a. the active entry at this path's shapes
    probe = dyn_stream(writers, readers, 1, DYN_SIZES[0], rng)[0]
    report["active_levels"] = check_active(torch, ops, ref, session, probe,
                                           errs)
    lap("active_entry_checks")

    # ---- 6b. sparse against dense on one stream, both batch sizes
    runs = {}
    for size in DYN_SIZES:
        batches = dyn_stream(writers, readers, DYN_BATCHES, size, rng)
        r = sparse_vs_dense(torch, ops, session, handles, batches, start)
        runs[size] = {m: rates(r[m], size) for m in ("1", "0")}
        for where in ("write_launches", "read_launches"):
            for mode, k in (("1", "sum_active"), ("1", "max_active"),
                            ("0", "sum"), ("0", "max")):
                if r[mode][where][k] <= 0:
                    raise AssertionError(
                        f"{k} not launched on the {where.split('_')[0]} "
                        f"path with EAGR_SPARSE_WRITE={mode} (batch {size})")
        print(f"sparse vs dense, batches of {size}: PAOs and answers "
              f"bit-equal over {DYN_BATCHES} batches; sparse "
              f"{runs[size]['1']['write_events_per_s']:.0f} writes/s (p50 "
              f"{runs[size]['1']['write_p50_ms']:.3f} ms), dense "
              f"{runs[size]['0']['write_events_per_s']:.0f} writes/s (p50 "
              f"{runs[size]['0']['write_p50_ms']:.3f} ms); read p50 sparse "
              f"{runs[size]['1']['read_p50_ms']:.3f} ms, dense "
              f"{runs[size]['0']['read_p50_ms']:.3f} ms; sparse launches "
              f"writes {r['1']['write_launches']}, reads "
              f"{r['1']['read_launches']}", flush=True)
        parts = sparse_host_parts(torch, session, batches[0])
        report.setdefault("sparse_host_ms", {})[size] = parts
        print(f"sparse write step host work by part, batches of {size} "
              f"(ms, median): {parts}", flush=True)
        if size == DYN_SIZES[0]:
            # the kernels line's counts: the main path's writes and reads
            # of this batch size, the active entries' from the sparse run,
            # the dense entries' from the dense run
            report["launches"] = {
                k: r[m]["write_launches"][k] + r[m]["read_launches"][k]
                for k in ops.LAUNCHES
                for m in ["1" if k.endswith("_active") else "0"]}
            # steady state: sparse batches with no implicit host sync
            set_sparse("1")
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            for ids, vals, _ in batches[:SYNC_WINDOW]:
                session.update(ids, vals)
            torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            set_sparse("auto")
            print(f"sync check: {SYNC_WINDOW} sparse write batches ran under "
                  f"set_sync_debug_mode('error')", flush=True)
    report["sparse_vs_dense"] = runs
    lap("sparse_vs_dense")
    blocks = {}
    set_sparse("1")
    for name, acts in active_sets(session, probe).items():
        g = next(g for g in session._groups.values() if g.agg.name == name)
        depth = g.engine.plan.depth
        nbs = [getattr(g.engine.plan.arrays, side).tile_of_block.shape[1]
               for side in ("push", "pull")]
        blocks[name] = {side: None if a is None else
                        [int((x < nb).sum()) for x in a[:depth]]
                        for side, a, nb in zip(("push", "pull"), acts, nbs)}
        blocks[name].update(push_blocks=nbs[0], pull_blocks=nbs[1])
    set_sparse("auto")
    print(f"active blocks per level (one batch of {DYN_SIZES[0]} writers, "
          f"{DYN_READS} readers) against the level's blocks: {blocks}",
          flush=True)
    report["active_blocks"] = blocks

    # ---- 6c. churn bursts, each flushed, then a write batch and a read
    reset_engines(session)
    oracle = Oracle()
    n_base = int(max(writers.max(), readers.max())) + 1
    patch_ms, kinds = [], collections.Counter()
    log = []
    for share, n_bursts in CHURN:
        n_ops = max(1, int(share * len(readers)))
        for _ in range(n_bursts):
            churn_burst(session, rng, readers, n_base, n_ops)
            ptrs = plan_ptrs(session)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rep = session.flush()
            torch.cuda.synchronize()
            patch_ms.append((time.perf_counter() - t0) * 1e3)
            for k in ("patched", "relayout", "recompiled"):
                kinds[k] += getattr(rep, k)
            for res, before, after in zip(rep, ptrs, plan_ptrs(session)):
                if res is not None and not res.recompiled and before != after:
                    raise AssertionError("an in-capacity patch reallocated "
                                         "a plan table")
            cur = np.asarray(session.writers, np.int64)
            (batch,) = dyn_stream(cur, np.asarray(session.readers), 1,
                                  DYN_SIZES[0], rng)
            session.update(batch[0], batch[1])
            oracle.feed(batch[0], batch[1])
            for h in handles:
                session.read(h, batch[2])
            log.append(dict(share=share, ops=n_ops, ms=patch_ms[-1],
                            patched=rep.patched, relayout=rep.relayout,
                            recompiled=rep.recompiled,
                            journal_nodes=rep.journal_nodes))
    readers = np.asarray(session.readers, np.int64)
    sample = rng.choice(readers, size=min(256, len(readers)), replace=False)
    oracle.check(session, handles, sample)
    print(f"churn: {sum(n for _, n in CHURN)} bursts ({CHURN}) on {card_line()}"
          f": patch p50 {np.median(patch_ms):.3f} ms, max "
          f"{np.max(patch_ms):.3f} ms a burst (3 groups); {dict(kinds)}; "
          f"tables kept their storage across in-capacity bursts; oracle: "
          f"{len(sample)} sampled readers agree", flush=True)
    lap("churn")
    report.update(churn=log, patch_p50_ms=float(np.median(patch_ms)),
                  patch_max_ms=float(np.max(patch_ms)), churn_kinds=dict(kinds))

    # ---- 6d. sparse == dense on the churned plans, from copies of a state
    writers = np.asarray(session.writers, np.int64)
    after = snapshot_states(session)
    batches = dyn_stream(writers, readers, 4, DYN_SIZES[0], rng)
    sparse_vs_dense(torch, ops, session, handles, batches, after)
    restore_states(session, after)
    print("sparse vs dense after churn: PAOs and answers bit-equal on the "
          "churned plans", flush=True)
    lap("sparse_vs_dense_after_churn")

    # ---- 6e. one adapt(), then the oracle again
    flips = session.adapt()
    batches = dyn_stream(writers, readers, 2, DYN_SIZES[0], rng)
    for ids, vals, _ in batches:
        session.update(ids, vals)
        oracle.feed(ids, vals)
    oracle.check(session, handles, sample)
    print(f"adapt: {flips!r}; oracle: {len(sample)} sampled readers agree",
          flush=True)
    report["adapt_flips"] = list(flips.per_group)
    lap("adapt")
    print(f"phase 6 seconds by part: {report['seconds_by_part']}",
          flush=True)
    return report


# -------------------------------------------------------- streaming path
def stream_of(writers, readers, n_device_batches: int, seed: int):
    """Arrival batches of ``ARRIVAL`` Zipf(ZIPF_A) writes with integer
    values 0..63 (every sum exact in fp32, so a threshold cannot flip on
    rounding), from the port's ``generate_trace``/``batched_playback``."""
    from repro_torch.streams import batched_playback, generate_trace

    n = n_device_batches * ARRIVAL * COALESCE
    tr = generate_trace(writers, readers, n, write_read_ratio=1e9,
                        alpha=ZIPF_A, value_domain=64, seed=seed)
    return [(ids, vals) for kind, ids, vals in batched_playback(tr, ARRIVAL)
            if kind == "write"]


def device_batches(arrivals):
    """The same events cut at the ring's device-batch boundaries."""
    ids = np.concatenate([i for i, _ in arrivals])
    vals = np.concatenate([v for _, v in arrivals])
    B = ARRIVAL * COALESCE
    return [(ids[o: o + B], vals[o: o + B]) for o in range(0, len(ids), B)]


def fired_map(batches) -> dict:
    """now -> (base ids, values, overflow) of a list of FiredBatch es."""
    out = {}
    for b in batches:
        if len(b):
            out[float(b.now)] = (b.base_ids.tolist(),
                                 np.asarray(b.values, np.float32).tolist(),
                                 bool(b.overflow))
    return out


def alert_eval_cost(torch, eng, al, reps: int = 20) -> dict:
    """One step's alert evaluation on the ring's engine, on a copy of the
    alert columns: its CUDA kernels (torch.profiler: launches and device
    time) and its host time a call (the mean of ``reps`` enqueues)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.streams.alerts import alert_eval

    st = type(al.state)(*(t.clone() for t in al.state))
    now = eng.state.now - 1.0
    alert_eval(eng.agg, st, eng.state.pao, now, al.cap)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        alert_eval(eng.agg, st, eng.state.pao, now, al.cap)
        torch.cuda.synchronize()
    launches, dev_us = 0, 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            dev_us += e.self_cuda_time_total if us is None else us
            launches += e.count
    t0 = time.perf_counter()
    for _ in range(reps):
        alert_eval(eng.agg, st, eng.state.pao, now, al.cap)
    host_ms = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return dict(launches=launches, device_ms=dev_us / 1e3, host_ms=host_ms)


def phase_streaming(torch, ops, graph, out_dir) -> dict:
    """Phase 7 (see the module docstring)."""
    from repro_torch import EagrSession, Query, WindowSpec
    from repro_torch.streams import PollOracle

    report: dict = {"seconds_by_part": {}}
    clock = [time.perf_counter()]

    def lap(part: str) -> None:
        now = time.perf_counter()
        report["seconds_by_part"][part] = now - clock[0]
        clock[0] = now

    B = ARRIVAL * COALESCE
    session = EagrSession(graph, device=DEVICE, ingest_depth=INGEST_DEPTH,
                          ingest_batch=B)
    spec = WindowSpec("tuple", WINDOW)
    hs = session.register(Query(agg="sum", window=spec, continuous=True))
    hm = session.register(Query(agg="max", window=spec, continuous=True))
    handles = [hs, hm]
    eng = hs.group.engine
    writers = np.asarray(session.writers, np.int64)
    readers = np.asarray(session.readers, np.int64)
    lap("session")

    # ---- 7a. warm up, then per-reader thresholds at ~GATE_FRAC per batch:
    # above = the warmed-up sum + the (1 - GATE_FRAC) quantile of the sums'
    # rises over the next batches (alerts_bench.py sets per-reader headroom
    # over the warmed-up measure the same way)
    warm = stream_of(writers, readers, STREAM_WARMUP + STREAM_CALIB, SEED + 7)
    for ids, vals in warm[: STREAM_WARMUP * COALESCE]:
        session.update(ids, vals)
    m0 = session.read(hs, readers).reshape(len(readers))
    rises = []
    for k in range(STREAM_CALIB):
        lo = (STREAM_WARMUP + k) * COALESCE
        for ids, vals in warm[lo: lo + COALESCE]:
            session.update(ids, vals)
        rises.append(session.read(hs, readers).reshape(len(readers)) - m0)
    head = max(1.0, float(np.ceil(np.quantile(np.concatenate(rises),
                                              1.0 - GATE_FRAC))))
    above = (m0 + head).astype(np.float32)
    alert = hs.on_threshold(above=above, readers=readers.tolist())
    al = eng.alerts
    session._retire_pipeline()
    al.collect()
    al.pop_fired()
    start = snapshot_states(session)
    start_alerts = [t.clone() for t in al.state]
    print(f"streaming: {len(readers)} readers alerted, above = warmed-up "
          f"sum + {head:.0f} (the {1 - GATE_FRAC} quantile of its rises)",
          flush=True)
    lap("warmup_and_thresholds")

    def restart(depth: int = INGEST_DEPTH) -> None:
        session._retire_pipeline()
        al.collect()
        al.pop_fired()
        restore_states(session, start)
        for t, c in zip(al.state, start_alerts):
            t.copy_(c)
        session.ingest_depth = depth
        torch.cuda.synchronize()

    def state_copy():
        return [[t.clone() for t in g.engine.state.windows] +
                [g.engine.state.pao.clone(), g.engine.state.now.clone()]
                for g in session._groups.values()]

    stream = stream_of(writers, readers, STREAM_BATCHES, SEED + 8)
    dev_batches = device_batches(stream)
    n_events = sum(len(i) for i, _ in stream)
    sample = np.random.default_rng(SEED + 7).choice(readers, 4096)

    # ---- 7b-d. the ring against the synchronous session, in rounds (the
    # modes' order rotated each round): the ring; the synchronous session
    # at the ring's device batches (states, answers and fired sets required
    # bit-equal to the ring's); the synchronous session one arrival batch a
    # step. Launches counted on the first ring run
    modes = ("ring", "sync_device", "sync_arrival")
    secs = {m: [] for m in modes}
    detect_ms, ring, launches, first = [], {}, None, {}
    for r in range(STREAM_ROUNDS):
        for mode in modes[r % 3:] + modes[: r % 3]:
            restart(INGEST_DEPTH if mode == "ring" else 0)
            batches = dev_batches if mode == "sync_device" else stream
            if mode == "ring":
                before = session.stats().ingest.as_dict()
                al.detect_s.clear()
                if launches is None:
                    ops.reset_launches()
            t0 = time.perf_counter()
            for ids, vals in batches:
                session.update(ids, vals)
            if mode == "ring":
                session._pipeline.flush()
            torch.cuda.synchronize()
            secs[mode].append(time.perf_counter() - t0)
            if mode == "ring":
                if launches is None:
                    launches = dict(ops.LAUNCHES)
                detect_ms.extend(np.asarray(al.detect_s) * 1e3)
                after = session.stats().ingest.as_dict()
                for k, v in after.items():
                    ring.setdefault(k, []).append(
                        v if k == "max_in_flight" else v - before[k])
            if mode not in first and mode != "sync_arrival":
                first[mode] = (state_copy(),
                               [session.read(h, sample) for h in handles],
                               fired_map(session.drain_fired()))
    for op in ("sum", "max"):
        if launches[op] + launches[f"{op}_active"] <= 0:
            raise AssertionError(f"segment_agg_{op} was not launched on the "
                                 f"ring's steps")
    (state_p, answers_p, fired_p), (state_s, answers_s, fired_s) = \
        first["ring"], first["sync_device"]
    for a, b in zip(state_p, state_s):
        for x, y in zip(a, b):
            if not torch.equal(x, y):
                raise AssertionError("pipelined and synchronous states "
                                     "differ")
    for a, b in zip(answers_p, answers_s):
        if not np.array_equal(a, b):
            raise AssertionError("pipelined and synchronous answers differ")
    if fired_p != fired_s:
        raise AssertionError("pipelined and synchronous fired sets differ")
    ring = {k: (max(v) if k == "max_in_flight" else float(np.median(v)))
            for k, v in ring.items()}
    detect_ms = np.asarray(detect_ms)
    lap("ring_against_sync")

    # ---- 7e. the poll oracle after every device batch, batch by batch
    def polled_run(batches):
        oracle = PollOracle(al)
        oracle.resync(eng)
        polled = []
        for ids, vals in batches:
            session.update(ids, vals)
            polled.append(oracle.poll(eng, eng._now_host - 1.0))
        return polled, session.drain_fired()

    restart(depth=0)
    polled, fired_o = polled_run(dev_batches)
    if fired_map(polled) != fired_map(fired_o) or \
            fired_map(fired_o) != fired_p:
        raise AssertionError("fired sets differ from the poll oracle's")
    n_fired = sum(len(v[0]) for v in fired_p.values())
    lap("oracle")

    # ---- 7f. overflow: a cap of OVERFLOW_CAP, the exact set recovered
    restart(depth=0)
    cap = al.cap
    al.cap = OVERFLOW_CAP
    try:
        polled, fired_v = polled_run(dev_batches[:OVERFLOW_BATCHES])
    finally:
        al.cap = cap
    n_over = sum(b.overflow for b in fired_v)
    if n_over == 0:
        raise AssertionError(f"no batch overflowed a cap of {OVERFLOW_CAP}")
    got = {k: v[:2] for k, v in fired_map(fired_v).items()}
    if got != {k: v[:2] for k, v in fired_map(polled).items()}:
        raise AssertionError("overflowed fired sets differ from the oracle's")
    lap("overflow")

    # ---- 7g. steady state with no implicit sync: pipelined writes with
    # the alert, reads of both queries and the fired-set drain
    restart()
    window = stream_of(writers, readers, 2 + STREAM_SYNC_WINDOW, SEED + 9)
    for ids, vals in window[: 2 * COALESCE]:
        session.update(ids, vals)
    for h in handles:
        session.read(h, sample)
    session.drain_fired()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for ids, vals in window[2 * COALESCE:]:
            session.update(ids, vals)
        for h in handles:
            session.read(h, sample)
        session.drain_fired()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    lap("sync_check")

    # ---- 7h. one traced window of the ring
    restart()
    traced = stream[: 4 * COALESCE]

    def run():
        for ids, vals in traced:
            session.update(ids, vals)
        session._pipeline.flush()

    report["profile"] = trace_window(torch, "stream", run,
                                     len(traced) // COALESCE, out_dir)
    report["alert_eval"] = alert_eval_cost(torch, eng, al)
    print(f"alert evaluation, one step: {report['alert_eval']}", flush=True)
    lap("trace")

    p50, p99 = (float(np.percentile(detect_ms, q)) for q in (50, 99))
    report.update(
        readers_alerted=int(len(readers)), head=head,
        device_batches=len(dev_batches), events=n_events,
        rounds=STREAM_ROUNDS, seconds_per_round={m: v for m, v in secs.items()},
        pipelined_events_per_s=n_events / float(np.median(secs["ring"])),
        sync_device_batch_events_per_s=n_events / float(
            np.median(secs["sync_device"])),
        sync_arrival_batch_events_per_s=n_events / float(
            np.median(secs["sync_arrival"])),
        ring=ring, detect_p50_ms=p50, detect_p99_ms=p99,
        fired=n_fired, fired_share_per_batch=n_fired / len(dev_batches)
        / len(readers), overflow_batches=int(n_over), launches=launches,
        write_steps_sparse=sum(k >= 0 for k in eng.frontier_log))
    print(f"streaming on {card_line()}: medians of {STREAM_ROUNDS} rounds: "
          f"pipelined {report['pipelined_events_per_s']:.0f} events/s against"
          f" the "
          f"synchronous session's {report['sync_device_batch_events_per_s']:.0f}"
          f" (same device batches of {B}) and "
          f"{report['sync_arrival_batch_events_per_s']:.0f} (a step per "
          f"arrival batch of {ARRIVAL}); {n_events} events in "
          f"{len(dev_batches)} device batches; stall {ring['stall_s']:.4f} s,"
          f" barrier {ring['barrier_s']:.4f} s, max in flight "
          f"{ring['max_in_flight']}; detection p50 {p50:.3f} ms, p99 "
          f"{p99:.3f} ms; {n_fired} fired ({report['fired_share_per_batch']:.5f}"
          f" of the readers a batch), {n_over} of {OVERFLOW_BATCHES} batches "
          f"overflowed a cap of {OVERFLOW_CAP} and were recovered exactly; "
          f"pipelined == synchronous (states, answers, fired sets) and fired "
          f"sets == the poll oracle's; launches {launches}; no implicit sync "
          f"in {STREAM_SYNC_WINDOW} device batches with reads and drains",
          flush=True)
    print(f"phase 7 seconds by part: {report['seconds_by_part']}",
          flush=True)
    session.unregister_alert(alert)
    return report


# ------------------------------------------------- shards and checkpoints
def stacked_window_oracle(torch, session, handles, sample) -> None:
    """The single engine's window oracle applied to the stacked deployment
    (as the JAX package's stacked churn test does): each sampled reader's
    answer reduced in fp64 from the raw window values its owning shard
    holds for the writers of its shard's neighbourhood, independent of the
    overlay and its plan. After churn a shard that newly follows a writer
    holds its window from then on only (the documented backfill gap), so
    this, not the stream oracle, is the ground truth. Sum to 1e-4, max
    exactly."""
    from repro_torch.core.engine import to_host

    for h in handles:
        g = h.group
        vals, count = to_host(g.engine.state.windows.values,
                              g.engine.state.windows.count)
        got = np.asarray(session.read(h, sample)).reshape(len(sample), -1)
        for i, r in enumerate(sample.tolist()):
            s = g.sharded.reader_shard[r]
            rows = g.sharded.shard_plans[s].writer_row_of_base
            win = [vals[s, rows[w], : count[s, rows[w]]]
                   for w in g.sdyn.dynamics[s].reader_inputs[r]]
            win = np.concatenate(win) if win else np.zeros(0, np.float32)
            if h.agg.name == "sum":
                want = float(np.sum(win.astype(np.float64)))
                if abs(got[i, 0] - want) > 1e-4 + 1e-4 * abs(want):
                    raise AssertionError(f"stacked sum of reader {r}: "
                                         f"{got[i, 0]} != {want}")
            else:
                want = np.float32(win.max()) if len(win) else \
                    np.float32(-3.0e38)
                if np.float32(got[i, 0]) != want:
                    raise AssertionError(f"stacked max of reader {r}: "
                                         f"{got[i, 0]} != {want}")


def stacked_state(group) -> list:
    st = group.engine.state
    return [t.clone() for t in (*st.windows, st.pao, st.now)]


def stacked_ptrs(group) -> dict:
    from repro_torch.core.engine import _plan_array_leaves

    eng = group.engine
    out = {k: v.data_ptr() for k, v in _plan_array_leaves(eng.arrays)}
    out.update(writer_map=eng.writer_map.data_ptr(),
               reader_map=eng.reader_map.data_ptr())
    return out


def stacked_level_bound_ms(seg, tob, fot, F: int, n_rows: int):
    """``level_bound_ms`` of every shard's slice of one stacked level,
    summed: the bytes and operations of S levels."""
    t_b = t_o = 0.0
    for s in range(seg.shape[0]):
        n_live = int((seg[s] >= 0).sum().item())
        rows_out = min(int(fot[s].sum().item()) * 128, n_rows)
        t_b += (seg[s].numel() * 4 + tob[s].numel() * 8 + n_live * 4 * F
                + rows_out * 4 * F) / HBM_BYTES_PER_S * 1e3
        t_o += n_live * F / FP32_OPS_PER_S * 1e3
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def check_stacked_kernel(torch, ops, ref, group, errs, act_sets) -> list:
    """The shard-batched entries at this phase's largest level (the stacked
    push or pull level with the most live slots over all shards), sum at
    F=1 and max: each shard bit-equal to a launch of the single-shard entry
    on its slice; exact against the plain version on integer values and
    for max, normal-valued sums within n * 2^-24 * sum|x| per row of an
    fp64 sum on CPU copies (``plain_sum_fp64``); then the same for the
    active entries over the stacked active lists of one batch. Times: the
    stacked launch, S launches of the single-shard entry, the plain
    version (shard by shard) and ``index_add_``/``index_reduce_`` over the
    flattened shards, each beside the bound."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    eng = group.engine
    op = "sum" if group.agg.name == "sum" else "max"
    meta, S, E = eng.meta, eng.n_shards, ops.E_BLK
    n = meta.n_nodes
    # the dense entry at the level with the most live slots, push or pull;
    # the active entry at the push level whose active blocks hold the most
    best, best_a = None, None
    for side in ("push", "pull"):
        t = getattr(eng.arrays, side)
        for l in range(meta.depth):
            live = int((t.seg[:, l] >= 0).sum().item())
            if best is None or live > best[0]:
                best = (live, side, l)
            acts = act_sets[side]
            if acts is not None and l < len(acts) and acts[l].shape[1]:
                a = torch.as_tensor(acts[l], device=dev).long()
                nb_l = t.tile_of_block.shape[2]
                sid = torch.arange(S, device=dev)[:, None]
                blk = t.seg[:, l].reshape(S, nb_l, E)[sid, a.clamp(
                    max=nb_l - 1)]
                live = int(((blk >= 0) & (a < nb_l)[..., None]).sum().item())
                if best_a is None or live > best_a[0]:
                    best_a = (live, side, l)
    kw = dict(n_rows=n, n_row_tiles=meta.n_row_tiles, op=op)
    rows = []
    for entry, pick in (("dense", best), ("active", best_a)):
        if pick is None:
            continue
        _, side, l = pick
        t = getattr(eng.arrays, side)
        seg, tob = t.seg[:, l], t.tile_of_block[:, l]
        fot = t.first_of_tile[:, l]
        nb = tob.shape[1]
        if entry == "dense":
            act, seg_c = None, seg
            K = nb
        else:
            act = torch.as_tensor(act_sets[side][l], device=dev)
            K = act.shape[1]
            a = act.long()
            sid = torch.arange(S, device=dev)[:, None]
            seg_c = torch.where(
                (a < nb)[..., None],
                seg.reshape(S, nb, E)[sid, a.clamp(max=nb - 1)],
                -1).reshape(S, -1)
        hit = torch.zeros((S, n + 1), dtype=torch.bool, device=dev)
        hit.scatter_(1, torch.where(seg_c >= 0, seg_c.long(), n),
                     torch.ones_like(seg_c, dtype=torch.bool))
        hit = hit[:, :n]
        n_live = int((seg_c >= 0).sum().item())
        name = "stacked" if entry == "dense" else "active_stacked"

        def launch(x):
            if act is None:
                return ops.segment_agg_level_stacked(x, seg, tob, fot, **kw)
            return ops.segment_agg_active_stacked(x, seg, tob, fot, act,
                                                  **kw)

        def singles(x):
            if act is None:
                return [ops.segment_agg_level(x[s], seg[s], tob[s], fot[s],
                                              **kw) for s in range(S)]
            return [ops.segment_agg_active(x[s], seg[s], tob[s], fot[s],
                                           act[s], **kw) for s in range(S)]

        def plain(x):
            if act is None:
                return ref.segment_agg_level_stacked_ref(x, seg, n, op)
            return ref.segment_agg_active_stacked_ref(x, seg, act, n, op)

        F = 1
        err = 0.0
        for integer in (True, False):
            shape = (S, K * E, F)
            x = (torch.randint(-8, 9, shape, generator=gen, device=dev)
                 .to(torch.float32) if integer else
                 torch.randn(shape, generator=gen, device=dev))
            got = launch(x)
            again = launch(x)
            one = singles(x)
            want = plain(x)
            torch.cuda.synchronize()
            for s in range(S):
                h = hit[s]
                if not torch.equal(got[s][h], again[s][h]):
                    raise AssertionError(f"{op}_{name} is not deterministic")
                if not torch.equal(got[s][h], one[s][h]):
                    raise AssertionError(
                        f"{op}_{name} shard {s} != the single-shard entry "
                        f"({side} l={l})")
                e = (got[s][h] - want[s][h]).abs().max().item() \
                    if h.any() else 0.0
                if integer or op == "max":
                    if not torch.equal(got[s][h], want[s][h]):
                        raise AssertionError(
                            f"{op}_{name} != plain version (exact), shard "
                            f"{s}, max abs err {e}")
                else:
                    xs = x[s].reshape(-1, F)
                    exact = plain_sum_fp64(xs, seg_c[s], n)
                    cnt = torch.zeros(n + 1).index_add_(
                        0, torch.where(seg_c[s] >= 0, seg_c[s].long(), n)
                        .cpu(), torch.ones(seg_c[s].numel()))[:n, None]
                    lim = cnt.double() * 2.0 ** -24 * \
                        plain_sum_fp64(xs.abs(), seg_c[s], n)
                    d64 = (got[s].cpu().double() - exact).abs()
                    hc = h.cpu()
                    e = d64[hc].max().item() if hc.any() else 0.0
                    if bool((d64 > lim)[hc].any()):
                        raise AssertionError(
                            f"{op}_{name} beyond n * 2^-24 * sum|x| of the "
                            f"fp64 sum, shard {s}, max abs err {e}")
                err = max(err, e)
        errs[f"{op}_{name}"] = max(errs.get(f"{op}_{name}", 0.0), err)
        k_ms = cuda_ms(torch, lambda: launch(x))
        k_dev = device_ms(torch, lambda: launch(x), reps=20)
        s_dev = device_ms(torch, lambda: singles(x), reps=20)
        k_held = held_ms(torch, lambda: launch(x))
        s_held = held_ms(torch, lambda: singles(x))
        p_ms = cuda_ms(torch, lambda: plain(x), reps=5)
        dst = (torch.where(seg_c >= 0, seg_c.long(), n)
               + torch.arange(S, device=dev)[:, None] * (n + 1)).reshape(-1)
        xf = x.reshape(-1, F)
        lib_out = torch.zeros((S * (n + 1), F), device=dev)
        lib = (lambda: lib_out.index_add_(0, dst, xf)) if op == "sum" else \
            (lambda: lib_out.index_reduce_(0, dst, xf, "amax"))
        l_ms = cuda_ms(torch, lib)
        l_dev = device_ms(torch, lib, reps=20)
        if act is None:
            b_ms, b_by = stacked_level_bound_ms(seg, tob, fot, F, n)
        else:
            # each shard's active-entry bound, summed (all bound by bytes
            # at F=1: one add per live slot against 4 bytes read for it)
            b_ms = sum(active_bound_ms(seg_c[s], tob[s], act[s], F)[0]
                       for s in range(S))
            b_by = active_bound_ms(seg_c[0], tob[0], act[0], F)[1]
        rows.append(dict(op=op, entry=name, side=side, level=l, shards=S,
                         n_blocks=nb, K=K, n_live=n_live, F=F,
                         max_abs_err=err, ms=k_ms, device_ms=k_dev,
                         single_x_S_device_ms=s_dev, held_ms=k_held,
                         single_x_S_held_ms=s_held, plain_ms=p_ms,
                         library_ms=l_ms, library_device_ms=l_dev,
                         bound_ms=b_ms, bound_by=b_by))
        print(f"  {op}_{name} {side} l={l} S={S} blocks {K}/{nb} "
              f"live={n_live} F=1: bit-equal to {S} single-shard launches, "
              f"plain version held (max abs err {err:.3g}); kernel "
              f"{k_ms:.4f} ms ({k_dev:.5f} device, {k_held:.5f} held) vs "
              f"{S} single-shard launches {s_dev:.5f} device, {s_held:.5f} "
              f"held; plain {p_ms:.4f} ms; "
              f"index_add_/reduce over the flattened shards {l_ms:.4f} ms "
              f"({l_dev:.5f} device); bound {b_ms:.6f} ms ({b_by})",
              flush=True)
    return rows


def stacked_active_sets(group, ids):
    """The stacked engine's per-level (S, K) active lists for one batch
    (forced sparse), push side; the stacked read has no sparse path."""
    set_sparse("1")
    try:
        push = group.engine._frontier_active(ids)
    finally:
        set_sparse("auto")
    return {"push": push, "pull": None}


def phase_shards(torch, ops, ref, graph, single, out_dir, errs) -> dict:
    """Phase 8 (see the module docstring)."""
    import tempfile

    from repro_torch import EagrSession, Query, WindowSpec
    from repro_torch.core.engine import EagrEngine, plan_from_snapshot
    from repro_torch.core.engine import plan_snapshot
    from repro_torch.distributed import (
        SessionRecoveryDriver,
        host_loop_read,
        host_loop_write,
    )

    report: dict = {"seconds_by_part": {}}
    clock = [time.perf_counter()]

    def lap(part: str) -> None:
        now = time.perf_counter()
        report["seconds_by_part"][part] = now - clock[0]
        clock[0] = now

    # ---- set-up: the cold build of a sharded session over phase 3's graph
    t0 = time.perf_counter()
    session = EagrSession(graph, device=DEVICE, shards=SHARDS)
    spec = WindowSpec("tuple", WINDOW)
    handles = [session.register(Query(agg=a, window=spec))
               for a in ("sum", "max")]
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    groups = [h.group for h in handles]
    shapes = {g.agg.name: dict(
        shards=g.engine.n_shards, n_nodes=g.engine.meta.n_nodes,
        depth=g.engine.meta.depth, n_writers=g.engine.meta.n_writers,
        push_slots=g.engine.arrays.push.seg.shape[2],
        pull_slots=g.engine.arrays.pull.seg.shape[2],
        replication=g.sharded.replication_factor()) for g in groups}
    print(f"shards: EagrSession(shards={SHARDS}) with sum and max built in "
          f"{cold_s:.2f} s (construction, min-cut, partition, compile); "
          f"{shapes}", flush=True)
    writers = np.asarray(session.writers, np.int64)
    readers = np.asarray(session.readers, np.int64)
    rng = np.random.default_rng(SEED + 8)
    report.update(cold_build_s=cold_s, shapes=shapes)
    lap("cold_build")

    # ---- 8a. parity: the stack against a host loop of single-shard
    # engines over copies of the aligned plans, and the answers against the
    # stream oracle; the launches counted over the stream, dense batches
    # first (one launch per level and reduce, whatever S is), then sparse
    hosts = {}
    for g in groups:
        engs = []
        for s, p in enumerate(g.sharded.shard_plans):
            plan = plan_from_snapshot(*plan_snapshot(p), device=DEVICE)
            engs.append(EagrEngine(g.sharded.shards[s], plan.decision,
                                   g.agg, g.spec, plan=plan, device=DEVICE))
        hosts[g.agg.name] = engs
    stream = make_stream(writers, readers, PARITY_BATCHES, rng, dyadic=False)
    drive(torch, session, handles, stream[:1])   # warm: kernels, indices
    for g in groups:
        g.engine.adopt_state(g.engine.init_state(), now_host=0.0,
                             last_eval_now=np.zeros(SHARDS, np.float32))
    half = PARITY_BATCHES // 2
    expect = {"sum_stacked": half * groups[0].engine.meta.depth,
              "max_stacked": half * 2 * groups[1].engine.meta.depth}
    # the stack's launches only: each call counted from 0, the host loop's
    # single-shard launches left out
    counted = dict.fromkeys(ops.LAUNCHES, 0)

    def count(call):
        ops.reset_launches()
        out = call()
        for key, v in ops.LAUNCHES.items():
            counted[key] += v
        return out

    for k, (ids, vals, q) in enumerate(stream):
        set_sparse("0" if k < half else "1")
        count(lambda: session.update(ids, vals))
        for g in groups:
            host_loop_write(g.sharded, hosts[g.agg.name], ids, vals)
        if k == half - 1:
            dense = dict(counted)
    set_sparse("auto")
    torch.cuda.synchronize()
    writes = dict(counted)
    for k, v in expect.items():
        if dense[k] != v:
            raise AssertionError(f"{k}: {dense[k]} launches over {half} "
                                 f"dense write steps, expected {v} (one a "
                                 f"level and reduce)")
    if any(dense[k] for k in ("sum", "max", "sum_active", "max_active")):
        raise AssertionError(f"single-shard entries launched by the stack: "
                             f"{dense}")
    for k in ("sum_active_stacked", "max_active_stacked"):
        top = groups[0 if k.startswith("sum") else 1].engine.meta.depth * \
            (1 if k.startswith("sum") else 2)
        if not 0 < writes[k] <= top * (PARITY_BATCHES - half):
            raise AssertionError(f"{k}: {writes[k]} launches over "
                                 f"{PARITY_BATCHES - half} sparse steps "
                                 f"(at most {top} a step)")
    sample = rng.choice(readers, size=min(256, len(readers)), replace=False)
    for g, h in zip(groups, handles):
        st = g.engine.state
        for i, name in enumerate(("values", "stamps", "head", "count")):
            host = torch.stack([e.state.windows[i] for e in hosts[g.agg.name]])
            if not torch.equal(st.windows[i], host):
                raise AssertionError(f"stacked {g.agg.name} windows.{name} "
                                     f"!= the host loop's")
        for name in ("pao", "now"):
            host = torch.stack([getattr(e.state, name)
                                for e in hosts[g.agg.name]])
            if not torch.equal(getattr(st, name), host):
                raise AssertionError(f"stacked {g.agg.name} {name} != the "
                                     f"host loop's")
        got = count(lambda: session.read(h, sample))
        loop = host_loop_read(g.sharded, hosts[g.agg.name], sample)
        if not np.array_equal(got, loop):
            raise AssertionError(f"stacked {g.agg.name} answers != the host "
                                 f"loop's")
    torch.cuda.synchronize()
    launches = dict(counted)
    Oracle(stream).check(session, handles, sample)
    del hosts
    print(f"8a parity: {PARITY_BATCHES} write batches ({half} dense, "
          f"{PARITY_BATCHES - half} sparse) of {BATCH}: stacked state == a "
          f"host loop of {SHARDS} single-shard engines bit for bit (windows, "
          f"PAOs, clocks, answers); {len(sample)} sampled readers agree with "
          f"the stream oracle (sum to 1e-4, max exactly); launches on the "
          f"writes {writes} (dense half {dense}: one a level and reduce, "
          f"expected {expect}); with the reads {launches}", flush=True)
    report.update(launches=launches, dense_write_launches=dense,
                  write_launches=writes)
    lap("parity")

    # ---- 8b. the shard-batched kernel at this phase's largest level
    probe = make_stream(writers, readers, 1, rng, dyadic=False)[0]
    krows = []
    for g in groups:
        krows += check_stacked_kernel(torch, ops, ref, g, errs,
                                      stacked_active_sets(g, probe[0]))
    report["kernel"] = krows
    lap("kernel")

    # ---- 8c. speed (printed, not gated): the stacked main path beside
    # phase 3's single engine on the same graph; one traced write window
    for g in groups:
        g.engine.adopt_state(g.engine.init_state(), now_host=0.0,
                             last_eval_now=np.zeros(SHARDS, np.float32))
    speed = make_stream(writers, readers, SPEED_BATCHES, rng, dyadic=False)
    w_ms, r_ms, _ = drive(torch, session, handles, speed)
    metrics = dict(write_p50_ms=float(np.median(w_ms)),
                   write_events_per_s=BATCH * len(w_ms) / (np.sum(w_ms) / 1e3),
                   read_p50_ms=float(np.median(r_ms)),
                   read_events_per_s=BATCH * len(r_ms) / (np.sum(r_ms) / 1e3))
    report["profile"] = trace_window(
        torch, "stacked_write",
        lambda: [session.update(i, v) for i, v, _ in speed[:PROFILE_BATCHES]],
        PROFILE_BATCHES, out_dir)
    print(f"8c speed on {card_line()}: stacked ({SHARDS} shards, sum + max): "
          f"write p50 {metrics['write_p50_ms']:.3f} ms, "
          f"{metrics['write_events_per_s']:.0f} writes/s, read p50 "
          f"{metrics['read_p50_ms']:.3f} ms; phase 3's single engine (sum + "
          f"max + count): write p50 {single['write_p50_ms']:.3f} ms, "
          f"{single['write_events_per_s']:.0f} writes/s, read p50 "
          f"{single['read_p50_ms']:.3f} ms; stacked write busy share "
          f"{report['profile']['busy_share']:.4f}", flush=True)
    report["speed"] = metrics
    lap("speed")

    # ---- 8d. no implicit host sync in a window of stacked writes and reads
    window = make_stream(writers, readers, 3, rng, dyadic=False)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for ids, vals, q in window:
            session.update(ids, vals)
            for h in handles:
                session.read(h, q[:256])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print(f"8d sync check: {len(window)} stacked write batches and "
          f"{len(window) * len(handles)} reads ran under "
          f"set_sync_debug_mode('error')", flush=True)
    lap("sync_check")

    # ---- 8e. churn bursts at 0.1% of the readers, each flushed: the
    # patched slices keep their storage, answers against the window oracle
    n_base = int(max(writers.max(), readers.max())) + 1
    n_ops = max(1, int(CHURN[0][0] * len(readers)))
    kinds = collections.Counter()
    churn_ms = []
    for _ in range(SHARD_CHURN_BURSTS):
        churn_burst(session, rng, readers, n_base, n_ops)
        before = [stacked_ptrs(g) for g in groups]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = session.flush()
        torch.cuda.synchronize()
        churn_ms.append((time.perf_counter() - t0) * 1e3)
        for k in ("patched", "relayout", "recompiled"):
            kinds[k] += getattr(rep, k)
        for g, res, b in zip(groups, rep, before):
            if not any(r is not None and r.recompiled for r in res) \
                    and stacked_ptrs(g) != b:
                raise AssertionError("an in-capacity slice patch "
                                     "reallocated a stacked table")
        (ids, vals, q), = make_stream(np.asarray(session.writers), readers,
                                      1, rng, dyadic=False)
        session.update(ids, vals)
    stacked_window_oracle(torch, session, handles, sample)
    print(f"8e churn: {SHARD_CHURN_BURSTS} bursts of {n_ops} ops (0.1% of "
          f"the readers): flush p50 {np.median(churn_ms):.3f} ms; "
          f"{dict(kinds)}; stacked tables and owner maps kept their storage; "
          f"{len(sample)} sampled readers agree with the window oracle",
          flush=True)
    report.update(churn_ms=churn_ms, churn_kinds=dict(kinds))
    lap("churn")

    # ---- 8f. checkpoints in a temporary directory, removed at exit
    q = sample
    want = [session.read(h, q) for h in handles]
    with tempfile.TemporaryDirectory(prefix="eagr_ckpt_",
                                     dir=os.path.join(ROOT, "build")) as d:
        os.makedirs(d, exist_ok=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step = session.save(os.path.join(d, "main"), blocking=False)
        block_s = time.perf_counter() - t0
        session.wait_for_checkpoint()
        total_s = time.perf_counter() - t0
        sdir = os.path.join(d, "main", f"step_{step:08d}")
        nbytes = sum(os.path.getsize(os.path.join(sdir, f))
                     for f in os.listdir(sdir))
        t0 = time.perf_counter()
        same = EagrSession.restore(os.path.join(d, "main"), device=DEVICE)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        got = [same.read(h, q) for h in same.queries]
        for a, b in zip(got, want):
            if not np.array_equal(a, b):
                raise AssertionError("the restored session's first read "
                                     "differs from the saved session's")
        del same
        reshard = {}
        for m in (2, 0):
            t0 = time.perf_counter()
            r = EagrSession.restore(os.path.join(d, "main"), shards=m,
                                    device=DEVICE)
            torch.cuda.synchronize()
            reshard[m] = time.perf_counter() - t0
            got = [r.read(h, q) for h in r.queries]
            for h, a, b in zip(handles, got, want):
                if h.agg.name == "max":
                    if not np.array_equal(a, b):
                        raise AssertionError(f"reshard {SHARDS} -> {m}: max "
                                             f"answers differ")
                elif not np.allclose(a, b, rtol=1e-4, atol=1e-4):
                    raise AssertionError(f"reshard {SHARDS} -> {m}: sum "
                                         f"answers beyond 1e-4")
            del r
        print(f"8f checkpoints on {card_line()}: save {nbytes} bytes, "
              f"blocking part {block_s:.3f} s, total {total_s:.3f} s "
              f"({nbytes / total_s / 1e6:.1f} MB/s); restore to the same "
              f"layout {restore_s:.3f} s against the cold build's "
              f"{cold_s:.3f} s, first read bit-identical; reshard "
              f"{SHARDS} -> 2 {reshard[2]:.3f} s, {SHARDS} -> single "
              f"{reshard[0]:.3f} s (sums within 1e-4, max exact)", flush=True)
        report.update(save_bytes=nbytes, save_block_s=block_s,
                      save_total_s=total_s,
                      save_mb_s=nbytes / total_s / 1e6,
                      restore_s=restore_s, reshard_s=reshard)
        lap("save_restore_reshard")

        # the recovery driver: a run with one injected failure against an
        # uninterrupted one, both from this checkpoint ("cold" = restore)
        base = os.path.join(d, "main")
        seq0 = session._seq
        feed = make_stream(writers, readers, RECOVERY_BATCHES, rng,
                           dyadic=False)
        make_batch = lambda seq: feed[seq - seq0][:2]
        make = lambda: EagrSession.restore(base, device=DEVICE)
        ends = []
        for name, fail in (("fault", {seq0 + RECOVERY_BATCHES // 2 + 1}),
                           ("clean", None)):
            drv = SessionRecoveryDriver(make, make_batch,
                                        os.path.join(d, name),
                                        ckpt_every=RECOVERY_EVERY,
                                        device=DEVICE)
            t0 = time.perf_counter()
            s_end = drv.run(seq0 + RECOVERY_BATCHES, fail_at=fail)
            ends.append((s_end, drv.report, time.perf_counter() - t0))
        (sf, rf, tf), (sc, rc, tc) = ends
        if rf.restarts != 1 or rc.restarts != 0:
            raise AssertionError(f"recovery restarts {rf.restarts}, "
                                 f"{rc.restarts}")
        for gf, gc in zip(sf._groups.values(), sc._groups.values()):
            for a, b in zip(stacked_state(gf), stacked_state(gc)):
                if not torch.equal(a, b):
                    raise AssertionError("the recovered run's state differs "
                                         "from the uninterrupted run's")
        for hf, hc in zip(sf.queries, sc.queries):
            if not np.array_equal(sf.read(hf, q), sc.read(hc, q)):
                raise AssertionError("the recovered run's answers differ")
        print(f"8f recovery: {RECOVERY_BATCHES} batches, checkpoint every "
              f"{RECOVERY_EVERY}, one injected failure: restarts "
              f"{rf.restarts}, state and answers bit-identical to the "
              f"uninterrupted run ({tf:.2f} s against {tc:.2f} s)",
              flush=True)
        report.update(recovery_s=tf, recovery_clean_s=tc)
        del sf, sc
        lap("recovery")
    print(f"phase 8 seconds by part: {report['seconds_by_part']}",
          flush=True)
    return report


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
            "decode": 0.0, "bag": 0.0, "sum_active": 0.0, "max_active": 0.0}
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
    steps = [k for g in session._groups.values()
             for k in g.engine.frontier_log[-len(stream):]]
    print(f"main path launches: {launches}; under the default auto mode "
          f"{sum(k >= 0 for k in steps)} of {len(steps)} write steps went "
          f"sparse", flush=True)
    # under auto a step runs the dense or the active entry of an op
    for op in KERNELS:
        if launches[op] + launches[f"{op}_active"] <= 0:
            raise AssertionError(f"kernel segment_agg_{op} was not launched "
                                 f"on the main path (dense or active)")
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
    # F1: auto against both forced modes on phase 3's stream
    report["f1_gate"] = f1_gate(torch, ops, session, handles, stream)

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

    # ---- 6. the dynamic path on phase 3's session
    t0 = time.perf_counter()
    dynamic = phase_dynamic(torch, ops, ref, session, handles, errs, out_dir)
    dynamic["seconds"] = time.perf_counter() - t0
    print(f"dynamic path: {dynamic['seconds']:.1f} s", flush=True)
    report["dynamic"] = dynamic

    # ---- 7. the streaming path on phase 3's deployment
    t0 = time.perf_counter()
    streaming = phase_streaming(torch, ops, graph, out_dir)
    streaming["seconds"] = time.perf_counter() - t0
    print(f"streaming path: {streaming['seconds']:.1f} s", flush=True)
    report["streaming"] = streaming

    # ---- 8. shards and checkpoints on phase 3's graph
    t0 = time.perf_counter()
    shards = phase_shards(torch, ops, ref, graph, metrics, out_dir, errs)
    shards["seconds"] = time.perf_counter() - t0
    print(f"shards and checkpoints: {shards['seconds']:.1f} s", flush=True)
    report["shards"] = shards

    bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
           or m == "repro" or m.startswith("repro.")]
    if bad:
        raise AssertionError(f"the port loaded {bad[:5]}")

    # one entry per kernel: the segment kernels at the EAGr main path's
    # largest level, F=1 (their active entries at phase 6's; launches of
    # both from phase 6's dense and sparse runs of the main path: phase 3's
    # auto mode picks per step); the flash kernels at the LM serve path's
    # shapes
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
            design=DESIGNS[op], launches=dynamic["launches"][op],
            max_abs_err=errs[op],
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
    # the active entry at the largest level of the phase-6 batch, F=1;
    # launches from phase 6's counted sparse run
    for key, (name, replaces) in ACTIVE_KERNELS.items():
        op = key.split("_")[0]
        rows = [r for r in dynamic["active_levels"]
                if r["op"] == op and r["F"] == 1]
        top = max(rows, key=lambda r: r["n_live"])
        kernels.append(dict(
            name=name, route="cuda", source=SOURCE, replaces=replaces,
            design=DESIGNS["active"], launches=dynamic["launches"][key],
            max_abs_err=errs[key], ms=top["ms"], plain_ms=top["plain_ms"],
            bound_ms=top["bound_ms"], bound_by=top["bound_by"],
            library_ms=top["library_ms"], device_ms=top["device_ms"],
            library_device_ms=top["library_device_ms"]))
    # the shard-batched entries at phase 8's largest level, F=1; launches
    # from phase 8's counted stream (dense, then sparse, then the reads)
    for row in shards["kernel"]:
        key = f"{row['op']}_{row['entry']}"
        kernels.append(dict(
            name=f"segment_agg_{key}", route="cuda", source=SOURCE,
            replaces=KERNELS[row["op"]][1], design=DESIGNS["stacked"],
            launches=shards["launches"][key], max_abs_err=errs[key],
            ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"], device_ms=row["device_ms"],
            library_device_ms=row["library_device_ms"],
            single_x_S_device_ms=row["single_x_S_device_ms"],
            held_ms=row["held_ms"],
            single_x_S_held_ms=row["single_x_S_held_ms"],
            shards=row["shards"]))
    missing = {f"{op}_{e}" for op in KERNELS
               for e in ("stacked", "active_stacked")} - \
        {f"{r['op']}_{r['entry']}" for r in shards["kernel"]}
    if missing:
        raise AssertionError(f"no phase-8 check of {sorted(missing)}")
    for k in ("sum_stacked", "max_stacked", "sum_active_stacked",
              "max_active_stacked"):
        if shards["launches"][k] <= 0:
            raise AssertionError(f"segment_agg_{k} was not launched on "
                                 f"phase 8's path")
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
