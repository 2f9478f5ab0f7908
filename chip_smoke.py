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
   shapes plus every head dim in fp32 (to 2e-5), decode also at the GQA
   groups of 6, 7 and 12 at head dim 128; the tensor-core (wgmma)
   prefill in bf16 on ragged, offset and non-causal shapes at head dims 64
   and 128 (groups of 7 and 12 among them), and at internlm2's and
   granite-3-2b's serve shapes (B 8 x S
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
   (teacher-forced on the kernel run's tokens); every kernel call of that
   run held on its own inputs (``checked_flash``);
5. the DIEN serve path at its full ``CFG`` (1M items, 100k profile
   features, sequence 100) at ``serve_p99`` (batch 512): p50 and p99 batch
   latency, one embedding-bag launch per batch required, scores held to 1e-5
   against the same model run on CPU copies of the parameters and batches
   (where the bag wrapper runs its plain version);
6. the dynamic path on phase 3's session (headroom 2.0): the segment
   kernel's fused active entry (one launch a sparse level: gather by src,
   sign, reduce and row mask) held, at every real level of the sum and max
   plans and the active sets of a 256-writer batch, for sum, max and min,
   bit-equal on the rows it covers to the dense kernel over the level's
   gathered values with the inactive blocks set to the identity, its row
   mask equal to its plain version's, its values exact against the plain
   version on integer values and for max and min, sums of normal values
   within n * 2^-24 * sum|x| per row of an fp64 sum on CPU copies; its
   time beside the bound and the library composition (``index_select``,
   the sign's multiply, ``index_add_`` / ``index_reduce_``); the device
   operations of one sparse level, from a CUDA graph capture; one write
   stream run
   twice from one starting state, frontier-sparse (``EAGR_SPARSE_WRITE=1``)
   and dense (``=0``), at batches of 256 and 4,096 Zipf(1.5) writers each
   followed by reads of 256 readers, PAOs and answers required bit-equal and
   both active launch counts above zero on writes and on reads; the sparse
   write step's host work by part (unique rows, frontier keys, packing, the
   staged upload beside a copy per array); a steady-state sparse window
   run under
   ``torch.cuda.set_sync_debug_mode("error")``; 6 churn bursts at 0.1% and
   6 at 1% of the readers (70% ``add_edge``, 30% ``delete_edge``), each
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
   shard-batched fused entries (each gathers, signs and reduces a level of
   all shards in one launch) at the phase's largest level (dense) and
   largest active push level, F in {1, 2, 64}, sum on the sum group and
   max and min on the max group, bit-equal to the 4 single-shard levels
   they replace (the dense entry on each shard's gathered values, or the
   single-shard active entry) and held to their plain version (exact on
   integers and for max and min, normal-valued sums within n * 2^-24 *
   sum|x| of an fp64 sum; the active row masks equal to the active slots'
   rows), one dense stacked level's CUDA graph capture required to be the
   one fused kernel and nothing else, their device time at F=1 beside the
   4 single-shard levels, the library composition over the flattened
   shards (the dense level's shard offsets, ``index_select``, the sign's
   multiply, ``index_add_`` / ``index_reduce_``) and the bound; the dense
   entry under the same bars on a synthetic hub level in each shard (rows
   of ~70,000 slots) at F 1, 2, 3, 40 and 64; stacked
   write/read p50 and throughput beside phase 3's, and a traced write
   window's busy share; a window of
   stacked writes and reads under ``set_sync_debug_mode("error")``; 3 churn
   bursts at 0.1% of the readers, the stacked tables and owner maps
   required to keep their storage, answers held to the owning shards'
   window oracle; then, in a temporary directory removed at exit, a save
   (blocking part, total, bytes, MB/s), a same-layout restore (seconds
   against the cold build's, first read bit-identical), reshards 4 -> 2
   and 4 -> single (sums within 1e-4, max exact) and
   ``SessionRecoveryDriver`` with one injected failure required
   bit-identical to an uninterrupted run;
9. bf16 edge values (``EAGR_SEGAGG_BF16``) on phase 3's overlay and
   decisions, compiled again with the flag (no second construction): bf16
   and fp32 engines of ``sum``, ``max`` and ``count`` and a 4-shard bf16
   stack of ``sum`` and of ``max``. (a) Every real level of the bf16 plans
   through each bf16 entry: the dense entry at S = 1 (the single engine's
   bf16 dense level), the active entry on the frontier of a 256-writer
   batch and 256 readers, and the shard-batched dense and active entries
   on the stack (a 4,096-writer batch's frontier), F 1, 2 and 64, sum on
   the sum plan, max and min on the max plan: reruns bit-equal, each
   shard of a stacked call bit-equal to its single-shard call, exact
   against the plain version on integers and for max and min, normal sums
   within n * 2^-24 * sum|x| per row of an fp64 sum of the values rounded
   on their bits on CPU copies, and the fp32 instance required to give
   another output. (b) 20 write batches of 4,096 Zipf(1.5) writers with a
   read round after every 4th: bf16 sparse == bf16 dense bit for bit
   (forced modes), the stack (dense half, sparse half) == a host loop of
   single-shard bf16 engines bit for bit, every bf16 instance launched and
   no fp32 instance; against the fp32 engines on the same stream, sums
   differ in at least one reader, sums and counts stay within ((1 +
   2^-8)^(2 D) - 1) * 3 M (M the |values| written into the reader's
   neighbourhood, D the depth) and within rtol 0.05 / atol 0.5, max within
   one bf16 ulp. (c) Each entry's times at its largest level, F = 1, the
   bf16 instance held (the card held by a sleep kernel) against the fp32
   instance, the dense entry also against the fp32 ``_level_reduce``;
10. the rest of the serve path, on a card freed of phases 3-9's sessions:
   dbrx-132b (4 of 40 layers), arctic-480b (1 of 35) and
   command-r-plus-104b (5 of 64) at their published widths (heads 48/8,
   56/8, 96/8 at head dim 128; 16 experts top-4 and 128 experts top-2 with
   a dense residual, sort dispatch), bf16 weights drawn from a seed at the
   scale of the full depth, one after another, each freed before the next:
   the tensor-core prefill and the decode kernel at the arch's shapes held
   as in phase 2 and timed beside SDPA and the bound, then phase 4's serve
   run and its bar (prefill of 8 x 2,048, 32 greedy tokens, launches
   counted; MoE routing replayed from the plain run in the comparison
   runs, as tokens are), weights and peak memory; one full-width dbrx MoE
   layer in fp32 (B 2 x S 256, capacity factor 8.0, each matrix drawn at
   1/sqrt of its input dim) through the sort and einsum dispatches, every
   assignment kept by both and outputs within rtol 1e-4 / atol 1e-5 (the
   JAX package's test of the two); DIEN's ``retrieval_cand`` at its full
   CFG (1,000,000 candidates), p50/p99 over 50 calls beside the bound,
   scores within rtol 1e-4 / atol 1e-5 of the same function in fp64 on
   the CPU;
11. training, on a card freed of phase 10's models: the embedding bag's
   backward kernel (the dense table gradient; sorted ids, one warp a table
   row, no atomics) against its plain version on CPU copies at
   ``tests/test_kernels.py``'s bag shapes and DIEN's (512 and the train
   batch's bags of 16 ids, D 18), with padding ids, ids past the table and
   before the first bag and empty bags: bit-equal on a rerun, exact on
   integer inputs, normal sums within n * 2^-24 * sum|x| of fp64; its time
   beside the bound and F.embedding_bag's backward; granite-3-2b's
   train_4k at full width and depth (fp32 parameters, bf16 compute, AdamW,
   accum 4, seq 4,096, remat full, fused CE in chunks of 512; global batch
   cut to 4): one step run twice from copies of one state, bit-equal in
   every parameter and moment, the loss finite and falling over 5 steps
   on one batch, no flash launch, step time, tokens/s, peak memory and a
   traced step's busy share; DIEN's train_batch at its full CFG and its
   assigned batch of 65,536: the loss and every gradient leaf at batch 512
   held to CPU copies (rtol 1e-4, atol max(1e-6, 1e-4 of the leaf's
   largest magnitude)), one
   launch of each bag kernel a step, step p50, users/s, peak memory; the
   training launcher (``repro_torch.launch.train``) on every trainable
   arch's reduced cell, and one run with an injected failure required
   bit-equal to the uninterrupted one;
12. the GNNs, on a card freed of phase 11's models: the segment kernel's
   graph entry (``segment_agg_graph``: the stacked dense entry at S = 1
   over an edge plan) at each cell's real edge sets (GraphCast's mesh,
   grid2mesh and mesh2grid sets into their destination and source rows
   at F 512; GAT's softmax max at F 8 and message sum at F 64; NequIP's
   sums at F 32, 96 and 160 and its readout at F 1), held to its plain
   version as the other phases hold the segment kernels (and, for the
   smaller sets, to the plain version on CPU copies), its gather's
   backward through autograd, timed beside the bound, the plain version,
   the library call and, at GraphCast's sets, the bf16 path's casts;
   graphcast's minibatch_lg at full width and depth (``CFG``: 16
   processor layers, d 512, refinement 6, 227 vars, bf16 compute, fp32
   parameters, AdamW): one step twice from copies of one state,
   bit-equal, the 70 segment launches a step the code predicts, the loss
   falling over 5 more steps on one batch, step p50, peak memory, a
   traced step's busy share and the segment kernel's share; its strict
   bar at full width in fp32 (2 processor layers, refinement 3,
   full_graph_sm's grid), loss and every gradient leaf against CPU
   copies; gat-cora and gatedgcn at minibatch_lg and nequip at molecule
   (energies and forces), each a step twice bit-equal, step p50, peak
   memory, and its loss and gradients against CPU copies (GatedGCN's 16
   layers and NequIP's forces held to the fp32 floor: each leaf no
   farther from an fp64 run than twice the CPU copies' own; GatedGCN's on
   full_graph_sm); the launcher on every GNN's reduced cell, one run
   replayed bit-equal after an injected failure;
13. the cell tools (``repro_torch.launch.dryrun`` and ``roofline``): all
   40 assigned (arch x shape) cells built on the meta device (and eagr's
   cell at its smoke config), the card's allocation required unmoved, each
   cell's argument GB, per-device GB on the 16 x 16 production mesh,
   ``model_flops`` and whether it fits one card printed; five cells
   measured on the card, one counted step (aten FLOPs and operand bytes
   plus the kernels' own counts) and timed steps each: granite-3-2b
   prefill_32k (batch cut to 1) and decode_32k (batch cut to 8), DIEN
   serve_p99, gat-cora and graphcast minibatch_lg train steps, each
   required to launch its kernels and to give 0 < mfu <= 1, and the
   roofline table of the five; the kernels' counts of each cell's smoke
   step on the card required equal to the CPU's, DIEN's and GAT's measured
   steps counted again on the CPU and the LM cells' against the per-call
   formulas, all exactly; int8 compression with error feedback on the
   card bit-equal to the CPU.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Any failed check raises and
the script exits non-zero without that line. Details of every measurement go
to ``chiprun_out/chip_smoke.json``. The script imports neither JAX nor the
JAX package.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import gc
import json
import os
import re
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

# each kernel's work a call (its wrapper module's cost functions), held to
# the H100 SXM's peaks (NVIDIA data sheet) by ``bound_of``
from repro_torch.kernels.embedding_bag import ops as bag_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.segment_agg import ops as seg_ops  # noqa: E402


def bound_of(ops: int, nbytes: int, rate: str = "fp32") -> tuple[float, str]:
    """``kernels/cost.bound_ms`` of ``ops`` operations at ``rate`` and
    ``nbytes`` bytes: the least time on the card in ms, and what bounds
    it. ``kernels/cost.py`` is imported here, not with the script:
    ``tools/compare_active.py`` imports this script for its timers on the
    package of trees older than that module."""
    from repro_torch.kernels import cost

    return cost.bound_ms(cost.Work(ops, nbytes, rate))


def bound_of_work(work) -> tuple[float, str]:
    """``bound_of`` a cost function's ``Work``."""
    return bound_of(work.ops, work.bytes, work.rate)

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
    "bag_backward": "ids sorted stably by table row (preparation), one warp "
                    "per table row summing its run of w * grad_out rows in "
                    "id order, every row written once (zeros included), no "
                    "atomics",
    "stacked": "one launch a dense level for all S shards: one CTA per "
               "(window of 16 blocks, shard), a warp per block; the seg "
               "rows staged first and blocks with no live slot skipped, the "
               "live blocks' src/sign rows staged by cp.async, val gathered "
               "into registers (sign multiplied, min negated), a block's 8 "
               "slot rounds overlapped; a run crossing windows combined in "
               "window order by the last of its pieces to take an integer "
               "ticket",
    "active_stacked": "the fused active entry with a third grid axis over "
                      "S shards: each CTA offsets its pointers to its "
                      "shard's slice; one launch a sparse level for all "
                      "shards",
    "bf16": "the fused entry's BF16 instance: each slot's value rounded "
            "to bfloat16 (to nearest even) where it is gathered, after the "
            "sign's multiply, then reduced in fp32 as the fp32 instance "
            "reduces it; at S = 1 the dense entry is the single engine's "
            "bf16 dense level",
    "gnn": "the stacked dense entry at S = 1 over an edge plan built once "
           "per index array (live edges sorted stably by row into 256-slot "
           "blocks routed to 128-row tiles, each slot's src the edge): a "
           "GNN aggregation in one launch, edge values gathered into "
           "registers by src, rows of no live edge zeroed after; its "
           "backward is a gather and a gather's backward is this entry, so "
           "every derivative reduces here without atomics",
    "active": "one launch a frontier-sparse level: one CTA per window "
              "holding an active block, a warp per active block (16 slot-lane "
              "or 4 feature-lane warps), only those blocks' seg/src/sign rows "
              "staged by cp.async, val gathered into registers (sign "
              "multiplied, min negated), a block's 8 slot rounds overlapped, "
              "the row mask written; a run crossing windows combined in "
              "window order by the last of its pieces to take an integer "
              "ticket",
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
# phase 9: bf16 edge values on phase 3's overlay and decisions; a read
# round after every 4th of 20 write batches of 4,096
BF16_BATCHES, BF16_READ_EVERY = 20, 4
BF16_U = 2.0 ** -8          # bf16's unit roundoff (8 significant bits)
BF16_REF_BAR = (0.05, 0.5)  # the JAX package's own bf16 bar (rtol, atol)

# the LM serve path: granite-3-2b at full width; 8 prompts of 2,048 tokens
# and 32 greedy tokens (prefill_32k's B 32 x S 32,768 and decode_32k's
# B 128 would need more than the card's memory for the cache)
LM_BATCH, LM_PROMPT, LM_GEN, LM_SEED = 8, 2048, 32, 0
# phase 10: the other LM archs at their published widths, depth cut to what
# one card's 80 GB holds with room for the exact plain attention of the
# comparison runs (~28 GB of bf16 weights each)
REST_ARCHS = (("dbrx-132b", 4), ("arctic-480b", 1), ("command-r-plus-104b", 5))
MOE_CHECK = (2, 256, 8.0)  # dbrx's fp32 layer: B, S, capacity factor
RETRIEVAL_CALLS = 50
# phase 11: training. granite-3-2b's train_4k at full width and depth
# with its global batch of 256 cut to 4 (one 4,096-token sequence a
# microbatch of its accum 4: params, gradients and AdamW's moments take
# ~52.6 GB of the card's 80); losses over LM_TRAIN_STEPS steps on one
# batch. DIEN's train_batch at its full CFG and its assigned batch of
# 65,536, not cut: the tensors its two 100-step loops save for the backward
# (a GRU step keeps x @ wx and h @ wh, 324 floats each, and r, z, n, 1 - z
# and h, 108 each; an AUGRU step as many and its attention weight) come to
# ~1 MB a user, ~65 GB, within the card's 80; held against CPU copies at
# DIEN_CHECK_BATCH. The launcher: every trainable arch's reduced cell, a
# few steps each, and one run with an injected failure
LM_TRAIN_BATCH, LM_TRAIN_STEPS = 4, 5
DIEN_TRAIN_BATCH, DIEN_TRAIN_STEPS, DIEN_CHECK_BATCH = 65536, 5, 512
TRAIN_ARCHS = ("granite-3-2b", "internlm2-1.8b", "command-r-plus-104b",
               "arctic-480b", "dbrx-132b", "dien")
LAUNCH_STEPS, LAUNCH_FAIL_AT = 6, 3
# phase 12: the GNNs, on a card freed of phase 11's models. graphcast's
# minibatch_lg at full width and depth (CFG: 16 processor layers, d 512,
# refinement 6, 227 vars, bf16 compute, fp32 parameters, AdamW lr 1e-3; the
# shape's 169,984 grid nodes, 679,936 edges each way between grid and mesh,
# the multimesh's 327,660 edges padded to 327,680), GNN_STEPS steps on one
# batch after the replayed one; its strict bar at full width in fp32 with
# GNN_STRICT's depth and mesh on full_graph_sm's grid; gat-cora and gatedgcn
# at minibatch_lg and nequip at molecule, each held to CPU copies, then
# GNN_TIMED steps; the launcher on every GNN's reduced cell
GNN_SEED, GNN_STEPS, GNN_TIMED = 0, 5, 5
GNN_STRICT = dict(n_layers=2, mesh_refinement=3)
GNN_ARCHS = ("gat-cora", "gatedgcn", "graphcast", "nequip")
# phase 13: the measured cells (arch, shape), cut by the dry run's own
# fit, and the kernel entries each must launch ({module: keys}); timed
# repeats of each step
CELL_RUNS = (
    ("granite-3-2b", "prefill_32k",
     {"flash_attention": ("prefill", "prefill_wgmma")}),
    ("granite-3-2b", "decode_32k", {"flash_attention": ("decode",)}),
    ("dien", "serve_p99", {"embedding_bag": ("embedding_bag",)}),
    ("gat-cora", "minibatch_lg", {"segment_agg": ("sum_gnn", "max_gnn")}),
    ("graphcast", "minibatch_lg", {"segment_agg": ("sum_gnn",)}),
)
CELL_REPEATS = 3
# device_ms calls timed by held CUDA events because the profiler's traces
# held no device record
PROFILER_FALLBACKS = []
# cells whose measured size is counted again on the CPU (the others' steps
# take minutes there); the LM cells' counts are checked by formula
CELL_CPU_COUNTED = (("dien", "serve_p99"), ("gat-cora", "minibatch_lg"))
COMPRESS_STEPS = 20
# the bag's backward has no Pallas kernel (JAX differentiates jnp.take); it
# is the gradient of _bag_kernel's function, which the port's forward runs
BAG_BACKWARD_REPLACES = BAG_REPLACES
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
            (1, 4, 1, 300, 300, 128, True, True),
            # GQA groups of 7 (arctic-480b) and 12 (command-r-plus-104b)
            (1, 56, 8, 300, 300, 128, True, False),
            (2, 96, 8, 256, 256, 128, True, True)]
# the CUDA-core prefill timed at one shape (B, Hq, Hkv, Sq, Skv, d), fp32
SIMT_TIMED = (2, 16, 8, 2048, 2048, 64)
DECODE_SWEEP = [(2, 4, 2, 512, 64), (1, 8, 1, 1024, 32), (3, 6, 3, 300, 64),
                (2, 4, 4, 200, 16), (2, 16, 8, 700, 128), (2, 6, 2, 333, 48),
                # GQA groups of 6 (dbrx-132b), 7 (arctic-480b) and 12
                # (command-r-plus-104b): idle heads in the decode kernel's
                # 8-head tiles, and two tiles per kv head
                (2, 48, 8, 700, 128), (2, 56, 8, 333, 128),
                (2, 96, 8, 1024, 128)]
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
HUB_STACKED_F = (1, 2, 3, 40, 64)  # phase 8's stacked hub level


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


def device_ms_or_none(torch, fn, reps: int = 20, only: str | None = None):
    """Device time of one call: every CUDA kernel, copy and memset that
    ``reps`` calls run (only those whose name holds ``only``, if given),
    summed (torch.profiler), over ``reps``, after one warm-up call; None
    where the profiler handed back three traces with no such record (it
    now and then does). Unlike ``cuda_ms`` it leaves out the gaps in which
    the device waits for the host, which for a call of a few microseconds
    are most of the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total_us = 0.0
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and (only is None
                                                     or only in e.key):
                us = getattr(e, "self_device_time_total", None)
                total_us += e.self_cuda_time_total if us is None else us
        if total_us > 0:
            return total_us / 1e3 / reps
    return None


def device_ms(torch, fn, reps: int = 50, only: str | None = None) -> float:
    """``device_ms_or_none``; where the profiler saw nothing, ``held_ms``
    (CUDA events with the host's enqueueing hidden behind a sleep kernel:
    the device work alone, no profiler), each such call named in
    ``PROFILER_FALLBACKS``. With ``only``, which needs the profiler's
    names, an empty trace raises."""
    t = device_ms_or_none(torch, fn, reps, only)
    if t is not None:
        return t
    if only is not None:
        raise AssertionError(f"the profiler saw no device time of {only} "
                             f"in three traces")
    PROFILER_FALLBACKS.append(getattr(fn, "__qualname__", repr(fn)))
    print(f"device_ms: the profiler saw no device time in three traces; "
          f"timed by held CUDA events ({PROFILER_FALLBACKS[-1]})",
          flush=True)
    return held_ms(torch, fn, reps)


def ms_or_not(t) -> str:
    return "not measured" if t is None else f"{t:.5f}"


def share_or_not(x) -> str:
    return "not measured" if x is None else f"{x:.4f}"


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
    """Least time for one level (``seg_ops.level_cost``) at its live slots
    and visited tiles."""
    n_live = int((seg >= 0).sum().item())
    rows_out = min(int(fot.sum().item()) * 128, n_rows)
    return bound_of_work(seg_ops.level_cost(seg.numel(), n_live, tob.numel(),
                                            rows_out, F))


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


def trace_window(torch, name: str, run, n: int, out_dir, *,
                 lean: bool = False) -> dict:
    """One traced window of ``run()`` (after one untraced warm call): the
    time of every CUDA kernel, summed by name (torch.profiler), the window's
    host wall time, and their ratio (the device's busy share while traced;
    the tracer's own host cost is in the wall time, so the untraced share is
    higher). The Chrome trace goes to ``out_dir``. ``lean``, for a long run
    that is warm already (a train step): no warm call, the device traced
    alone and no Chrome trace (a train step's hundreds of thousands of
    host ops take the profiler minutes to sum)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not lean:
        run()  # warm
    torch.cuda.synchronize()
    with profile(activities=([] if lean else [ProfilerActivity.CPU])
                 + [ProfilerActivity.CUDA]) as prof:
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
    # the profiler now and then hands back a trace with no device record:
    # the window's device time is then not measured
    dev_ms = sum(r[2] for r in rows) if rows else None
    busy = None if dev_ms is None else dev_ms / wall_ms
    print(f"profile {name}: {n} batches, wall {wall_ms:.3f} ms, device "
          f"{ms_or_not(dev_ms)} ms, busy share {share_or_not(busy)}",
          flush=True)
    for k, c, t in rows[:8]:
        print(f"    {t:9.3f} ms  {c:6d} calls  {k[:90]}", flush=True)
    if not lean:
        prof.export_chrome_trace(os.path.join(out_dir,
                                              f"trace_{name}.json"))
    return dict(batches=n, wall_ms=wall_ms, device_ms=dev_ms,
                busy_share=busy, segment_ms=None if dev_ms is None else
                sum(t for k, _, t in rows if "segment_agg" in k),
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


def active_bound_ms(seg_c, src_c, tob, act, F: int, n_rows: int, op: str,
                    bf16: bool = False) -> tuple[float, str]:
    """Least time for one call of the fused active entry
    (``seg_ops.active_cost``) at its active blocks, their live slots
    (``seg_c``), the distinct sources among them (``src_c`` beside
    ``seg_c``) and the tiles they route to."""
    live = seg_c >= 0
    n_live = int(live.sum().item())
    n_src = int(src_c[live].unique().numel())
    nb = tob.numel()
    real = act[act < nb].long()
    tiles = int(tob[real].unique().numel())
    return bound_of_work(seg_ops.active_cost(real.numel(), n_live, n_src,
                                             tiles, F, n_rows, op, bf16))


def captured_ops(torch, fn) -> list:
    """The device operations one call of ``fn`` enqueues, read from a CUDA
    graph captured around it and dumped as DOT: one entry per graph node,
    its type and, for a kernel, its mangled name. No profiler is involved:
    a capture records every kernel, memset and copy enqueued on the
    capturing stream. The call is warmed on that stream first, so that the
    per-stream scratch of the fused entries already exists."""
    import tempfile

    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)  # kept for its dump only
    g.enable_debug_mode()
    with torch.cuda.graph(g, stream=stream):
        fn()
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        path = os.path.join(d, "level.dot")
        g.debug_dump(path)
        with open(path) as f:
            dot = f.read()
    del g
    ops = []
    # node statements only: an edge statement starts with its tail node
    for body in re.findall(r'^\s*"graph_\d+_node_\d+"\s*\[(.*?)\];', dot,
                           re.S | re.M):
        kind = re.search(r'label="\{?\s*(\w+)', body)
        name = re.search(r"_Z\w+|\w*segment_agg\w*", body)
        ops.append(" ".join(x.group(x.lastindex or 0)
                            for x in (kind, name) if x) or body[:80])
    if not ops:
        raise AssertionError(f"no node read from the captured graph's DOT "
                             f"dump: {dot[:1500]!r}")
    return ops


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


def active_checked(torch, ops, ref, args, seg_c, cov, n_in, tob, kw,
                   integer: bool) -> float:
    """One fused active call against its bars (see ``check_active``):
    ``args`` (val, seg, src, sign, tob, fot, active) on the card, ``seg_c``
    the active slots' rows, ``cov`` their (n_rows,) mask, ``n_in`` each
    row's count of them. Returns the max abs error against the plain
    version (the fp64 plain sum for normal-valued sums)."""
    val, seg, src, sign, _, fot, act = args
    op, n = kw["op"], kw["n_rows"]
    E, F = ops.E_BLK, val.shape[1]
    nb = tob.numel()
    got = [ops.segment_agg_active(*args, **kw) for _ in range(2)]
    # the dense kernel over the level's gathered values, the inactive
    # blocks at the op's identity
    x = val.index_select(0, src.long())
    x = x * sign[:, None] if op == "sum" else (-x if op == "min" else x)
    a = act.long()
    real = a[a < nb]
    xi = torch.full_like(x.view(nb, E, F), 0.0 if op == "sum" else -3.0e38)
    xi[real] = x.view(nb, E, F)[real]
    dense = ops.segment_agg_level(xi.reshape(-1, F).contiguous(), seg, tob,
                                  fot, n_rows=n, n_row_tiles=kw["n_row_tiles"],
                                  op="sum" if op == "sum" else "max")
    dense = -dense if op == "min" else dense
    plain, plain_hit = ref.segment_agg_active_ref(val, seg, src, sign, act,
                                                  n, op)
    torch.cuda.synchronize()
    where = f"({op} F={F} {'integer' if integer else 'normal'})"
    if not (torch.equal(got[0][0][cov], got[1][0][cov])
            and torch.equal(got[0][1], got[1][1])):
        raise AssertionError(f"active entry is not deterministic {where}")
    if not torch.equal(got[0][1], plain_hit) or \
            not torch.equal(got[0][1], cov):
        raise AssertionError(f"active row mask != plain version's {where}")
    out = got[0][0]
    if not torch.equal(out[cov], dense[cov]):
        raise AssertionError(f"active {op} != dense kernel with identity "
                             f"{where}")
    err = (out[cov] - plain[cov]).abs().max().item()
    if integer or op != "sum":
        if not torch.equal(out[cov], plain[cov]):
            raise AssertionError(f"active {op} != plain version (exact) "
                                 f"{where}, max abs err {err}")
        return err
    xc = x.view(nb, E, F)[a.clamp(max=nb - 1)].reshape(-1, F)
    exact = plain_sum_fp64(xc, seg_c, n)
    lim = n_in.cpu().double() * 2.0 ** -24 * \
        plain_sum_fp64(xc.abs(), seg_c, n)
    dev64 = (out.cpu().double() - exact).abs()
    cov_c = cov.cpu()
    err = dev64[cov_c].max().item()
    if bool((dev64 > lim)[cov_c].any()):
        raise AssertionError(f"active sum beyond n * 2^-24 * sum|x| of the "
                             f"fp64 sum {where}, max abs err {err}")
    return err


def check_active(torch, ops, ref, session, batch, errs) -> list[dict]:
    """The fused active entry at the phase-6 shapes: every real level of
    the sum and max plans with the active blocks of one 256-writer batch
    (push) and 256 readers (pull), F in {1, 2, 64}, sum on the sum plan and
    max and min on the max plan, values ``val`` (n_nodes, F) gathered by
    the level's own src and sign: reruns bit-equal; on the covered rows
    bit-equal to the dense kernel over the level's gathered values with the
    inactive blocks' values set to the op's identity; exact against the
    plain version on integer values and for max and min, sums of normal
    values within n * 2^-24 * sum|x| per row (n the row's active live
    slots) of an exact-order plain sum in fp64 on CPU copies
    (``plain_sum_fp64``: deterministic, where the fp32 plain version on the
    card adds by atomics in no fixed order); the row mask equal to the
    plain version's. Times beside the bound, the plain version and the
    library composition (``index_select``, the sign's multiply and
    ``index_add_`` / ``index_reduce_`` on the active slots)."""
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
        kops = ("sum",) if g.agg.name == "sum" else ("max", "min")
        plan, meta = g.engine.plan, g.engine.plan.meta
        n = meta.n_nodes
        for side, acts in zip(("push", "pull"), sets[g.agg.name]):
            if acts is None:
                continue
            t = getattr(plan.arrays, side)
            for l in range(plan.depth):
                if acts[l].shape[0] == 0:
                    continue
                seg, src, sign = t.seg[l], t.src[l], t.sign[l]
                tob, fot = t.tile_of_block[l], t.first_of_tile[l]
                nb = tob.numel()
                act = torch.as_tensor(acts[l], device=dev)
                a = act.long()
                ab = a.clamp(max=nb - 1)
                real = a[a < nb]
                seg_c = torch.where((a < nb)[:, None], seg.view(nb, E)[ab],
                                    -1).reshape(-1)
                n_live = int((seg_c >= 0).sum().item())
                if n_live == 0:
                    continue
                dst = torch.where(seg_c >= 0, seg_c.long(), n)
                cov = torch.zeros(n + 1, dtype=torch.bool, device=dev)
                cov[dst] = True
                cov = cov[:n]
                # active live slots a row adds: the reordered-sum bound's n
                n_in = torch.zeros(n + 1, device=dev).index_add_(
                    0, dst, torch.ones(seg_c.shape, device=dev))[:n, None]
                src_c = src.view(nb, E)[ab].reshape(-1).long()
                sign_c = sign.view(nb, E)[ab].reshape(-1)[:, None]
                for F in (1, 2, 64):
                    for integer in (True, False):
                        val = (torch.randint(-8, 9, (n, F), generator=gen,
                                             device=dev).to(torch.float32)
                               if integer else
                               torch.randn((n, F), generator=gen, device=dev))
                        args = (val, seg, src, sign, tob, fot, act)
                        for op in kops:
                            kw = dict(n_rows=n, n_row_tiles=meta.n_row_tiles,
                                      op=op)
                            err = active_checked(torch, ops, ref, args, seg_c,
                                                 cov, n_in, tob, kw, integer)
                            key = "sum_active" if op == "sum" else \
                                "max_active"
                            errs[key] = max(errs[key], err)
                    for op in kops:
                        kw = dict(n_rows=n, n_row_tiles=meta.n_row_tiles,
                                  op=op)

                        def fused(kw=kw):
                            return ops.segment_agg_active(*args, **kw)

                        k_ms = cuda_ms(torch, fused)
                        k_dev = device_ms(torch, fused, reps=20)
                        k_held = held_ms(torch, fused)
                        p_ms = cuda_ms(torch, lambda op=op: ref
                                       .segment_agg_active_ref(
                                           val, seg, src, sign, act, n, op))
                        lib_out = torch.zeros((n + 1, F), device=dev)
                        if op == "sum":
                            def lib():
                                return lib_out.index_add_(
                                    0, dst, val.index_select(0, src_c)
                                    * sign_c)
                        else:
                            def lib(how="amax" if op == "max" else "amin"):
                                return lib_out.index_reduce_(
                                    0, dst, val.index_select(0, src_c), how)
                        l_ms = cuda_ms(torch, lib)
                        l_dev = device_ms(torch, lib, reps=20)
                        b_ms, b_by = active_bound_ms(seg_c, src_c, tob, act,
                                                     F, n, op)
                        rows.append(dict(
                            op=op, side=side, level=l, n_blocks=nb,
                            active=int(real.numel()), K=int(act.numel()),
                            n_live=n_live, F=F, ms=k_ms, device_ms=k_dev,
                            held_ms=k_held, plain_ms=p_ms, library_ms=l_ms,
                            library_device_ms=l_dev, bound_ms=b_ms,
                            bound_by=b_by))
                        print(f"  active {op:3s} {side:4s} l={l} blocks "
                              f"{int(real.numel())}/{nb} live={n_live} "
                              f"F={F:2d}: fused {k_ms:.4f} ms ({k_dev:.5f} "
                              f"device, {k_held:.5f} held), plain "
                              f"{p_ms:.4f} ms, library composition "
                              f"{l_ms:.4f} ms ({l_dev:.5f} device), bound "
                              f"{b_ms:.6f} ms ({b_by})", flush=True)
    return rows


def sparse_level_launches(torch, session, batch) -> dict:
    """The device operations one sparse level of the engine enqueues (the
    fused active entry's memset and kernel and the row mask's ``&``), at
    the sum plan's busiest push level for the active blocks of one batch,
    through the engine's own ``_levels``, from a CUDA graph capture
    (``captured_ops``)."""
    from repro_torch.core import engine as E

    set_sparse("1")
    sets = active_sets(session, batch)
    set_sparse("auto")
    g = next(g for g in session._groups.values() if g.agg.name == "sum")
    push = sets["sum"][0]
    nb = g.engine.plan.arrays.push.tile_of_block.shape[1]
    l = max(range(g.engine.plan.depth),
            key=lambda i: int((np.asarray(push[i]) < nb).sum()))
    dev = torch.device(DEVICE)
    act = tuple(torch.as_tensor(push[i] if i == l else push[i][:0],
                                device=dev)
                for i in range(g.engine.plan.depth))
    val = torch.randn((g.engine.plan.meta.n_nodes, 1), device=dev)

    def level():
        for reduce in E._levels(g.engine.plan.meta, g.engine.plan.arrays.push,
                                act):
            return reduce(val, "sum")

    names = captured_ops(torch, level)
    return dict(level=l, active=int((np.asarray(push[l]) < nb).sum()),
                n_blocks=nb, launches=len(names), names=names)


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
    caught = sparse_level_launches(torch, session, probe)
    report["sparse_level_launches"] = caught
    print(f"one captured sparse level (sum plan, push level "
          f"{caught['level']}, {caught['active']} of {caught['n_blocks']} "
          f"blocks active): {caught['launches']} device operations "
          f"{caught['names']}", flush=True)
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


def stacked_level_bound_ms(seg, src, tob, fot, F: int, n_rows: int, op: str,
                           bf16: bool = False) -> tuple[float, str]:
    """Least time for one call of the fused stacked dense entry
    (``seg_ops.stacked_cost``), summed over the shards, at each shard's
    live slots, blocks holding one, distinct sources and visited tiles."""
    ops = nbytes = 0
    for s in range(seg.shape[0]):
        nb = tob[s].numel()
        live = seg[s] >= 0
        n_live = int(live.sum().item())
        live_blocks = int(live.view(nb, -1).any(1).sum().item())
        n_src = int(src[s][live].unique().numel())
        rows_out = min(int(fot[s].sum().item()) * 128, n_rows)
        w = seg_ops.stacked_cost(seg[s].numel(), live_blocks, n_src, nb,
                                 rows_out, n_live, F, op, bf16)
        ops, nbytes = ops + w.ops, nbytes + w.bytes
    return bound_of(ops, nbytes)


def stacked_level_launches(torch, meta, tables, l: int, op: str) -> list:
    """The device operations of one dense stacked level through the
    engine's own ``_stacked_levels`` (level ``l``, F=1), from a CUDA graph
    capture (``captured_ops``)."""
    from repro_torch.core import engine as E

    S = tables.seg.shape[0]
    val = torch.randn((S, meta.n_nodes, 1), device=torch.device(DEVICE))

    def level():
        for i, reduce in enumerate(E._stacked_levels(meta, tables)):
            if i == l:
                return reduce(val, op)

    return captured_ops(torch, level)


def stacked_checked(torch, calls, x, op: str, hit, seg_c, n: int,
                    integer: bool, where: str) -> tuple:
    """One shard-batched call on values ``x`` (S, n, F) against its bars
    (see ``check_stacked_kernel``): ``calls`` are its launch, the S
    single-shard levels, its plain version and a shard's gathered slot
    values. Returns the max abs error against the plain version (the fp64
    sum for normal-valued sums), the largest share of the n * 2^-24 *
    sum|x| bar a row used, and, for normal-valued sums, the rows beyond
    rtol = atol = 1e-4 of the fp32 plain version, the fp32 plain version's
    own rows beyond that of the fp64 sum, and the rows checked: a relative
    bar that sums reordered in fp32 need not meet where a row's terms
    cancel."""
    launch, singles, plain, gathered = calls
    S, F = x.shape[0], x.shape[2]
    where = f"{where} F={F} {'integer' if integer else 'normal'}"
    got, got_hit = launch(x, op)
    again, again_hit = launch(x, op)
    one = singles(x, op)
    want, want_hit = plain(x, op)
    torch.cuda.synchronize()
    if not (torch.equal(got_hit, hit) and torch.equal(again_hit, hit)
            and torch.equal(want_hit, hit)):
        raise AssertionError(f"{where}: row mask != the active slots' rows")
    err = share = 0.0
    loose = [0, 0, 0]
    for s in range(S):
        h = hit[s]
        if not torch.equal(got[s][h], again[s][h]):
            raise AssertionError(f"{where} is not deterministic")
        if not torch.equal(got[s][h], one[s][0][h]) or \
                not torch.equal(one[s][1], h):
            raise AssertionError(f"{where}: shard {s} != the single-shard "
                                 f"level")
        e = (got[s][h] - want[s][h]).abs().max().item() if h.any() else 0.0
        if integer or op != "sum":
            if not torch.equal(got[s][h], want[s][h]):
                raise AssertionError(f"{where} != plain version (exact), "
                                     f"shard {s}, max abs err {e}")
            err = max(err, e)
            continue
        xs = gathered(x, s, op).reshape(-1, F)
        exact = plain_sum_fp64(xs, seg_c[s], n)
        cnt = torch.zeros(n + 1).index_add_(
            0, torch.where(seg_c[s] >= 0, seg_c[s].long(), n).cpu(),
            torch.ones(seg_c[s].numel()))[:n, None]
        lim = cnt.double() * 2.0 ** -24 * plain_sum_fp64(xs.abs(), seg_c[s],
                                                         n)
        d64 = (got[s].cpu().double() - exact).abs()
        hc = h.cpu()
        e = d64[hc].max().item() if hc.any() else 0.0
        if bool((d64 > lim)[hc].any()):
            raise AssertionError(f"{where} beyond n * 2^-24 * sum|x| of the "
                                 f"fp64 sum, shard {s}, max abs err {e}")
        err = max(err, e)
        if hc.any():
            share = max(share, (d64 / lim.clamp_min(1e-300))[hc].max().item())
        w32 = want[s].cpu().double()
        loose[0] += int(((got[s].cpu().double() - w32).abs()
                         > 1e-4 + 1e-4 * w32.abs())[hc].any(1).sum())
        loose[1] += int(((w32 - exact).abs() > 1e-4 + 1e-4 * exact.abs())
                        [hc].any(1).sum())
        loose[2] += int(hc.sum())
    return err, share, loose


def stacked_calls(ops, ref, level, act, hit, src_c, sign_c, kw) -> tuple:
    """A shard-batched entry on one stacked level (``level`` = (seg, src,
    sign, tob, fot), each (S, ...)), as ``stacked_checked`` takes it:
    its launch, the S single-shard levels it replaces, its plain version
    and a shard's gathered slot values; each launch (but the gather) gives
    (out, hit), the dense entry's hit the level's rows. The dense entry
    when ``act`` is None, else the fused active entry on the (S, K) lists
    ``act``; ``src_c`` / ``sign_c`` are the slots' sources and signs."""
    seg, src, sign, tob, fot = level
    S, n = seg.shape[0], kw["n_rows"]

    def gathered(x, s, op):
        """Shard s's slot values as its single-shard level reduces them
        (min: negated, the max kernel's input)."""
        v = x[s].index_select(0, src_c[s])
        return v * sign_c[s][:, None] if op == "sum" else \
            (-v if op == "min" else v)

    def launch(x, op):
        if act is None:
            return ops.segment_agg_level_stacked(
                x, seg, src, sign, tob, fot, **kw, op=op), hit
        return ops.segment_agg_active_stacked(x, seg, src, sign, tob, fot,
                                              act, **kw, op=op)

    def singles(x, op):
        """The dense entry on each shard's gathered values (as
        ``_level_reduce`` runs it), or the single-shard active entry."""
        if act is not None:
            return [ops.segment_agg_active(x[s], seg[s], src[s], sign[s],
                                           tob[s], fot[s], act[s], **kw,
                                           op=op)
                    for s in range(S)]
        outs = []
        for s in range(S):
            o = ops.segment_agg_level(gathered(x, s, op), seg[s], tob[s],
                                      fot[s], **kw,
                                      op="sum" if op == "sum" else "max")
            outs.append((-o if op == "min" else o, hit[s]))
        return outs

    def plain(x, op):
        if act is None:
            return ref.segment_agg_level_stacked_ref(x, seg, src, sign, n,
                                                     op), hit
        return ref.segment_agg_active_stacked_ref(x, seg, src, sign, act, n,
                                                  op)

    return launch, singles, plain, gathered


def stacked_hub_check(torch, ops, ref, errs) -> dict:
    """The fused stacked dense entry on a synthetic hub level in each of
    ``SHARDS`` shards (``hub_level``: a hub tile of 1,024 live blocks, most
    of its slots routed to 3 rows, dead blocks among them; a shard's own
    draw each), sources drawn from 4,096 values and signs +-1, at F in {1,
    2, 3, 40, 64} (every slot-lane instance, and feature passes full and
    partial), sum, max and min, under ``stacked_checked``'s bars. Its rows
    beyond rtol = atol = 1e-4 of the fp32 plain version show what such a
    relative bar does on rows of ~10^5 cancelling terms."""
    rng = np.random.default_rng(9)
    dev = torch.device(DEVICE)
    lv = [hub_level(ops, rng, 1, False) for _ in range(SHARDS)]
    seg, tob, fot = (torch.as_tensor(np.stack([v[i] for v in lv]),
                                     device=dev) for i in (1, 2, 3))
    n, n_val = lv[0][4], 4096
    live = seg >= 0
    src = torch.where(live, torch.as_tensor(
        rng.integers(0, n_val, seg.shape), dtype=torch.int32, device=dev), 0)
    sign = torch.where(live, torch.as_tensor(
        rng.choice([-1.0, 1.0], seg.shape), dtype=torch.float32,
        device=dev), 0.0)
    hit = torch.zeros((SHARDS, n + 1), dtype=torch.bool, device=dev)
    hit.scatter_(1, torch.where(live, seg.long(), n),
                 torch.ones_like(live))
    hit = hit[:, :n]
    kw = dict(n_rows=n, n_row_tiles=n // ops.R_BLK)
    calls = stacked_calls(ops, ref, (seg, src, sign, tob, fot), None, hit,
                          src.long(), sign, kw)
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    err = {"sum": 0.0, "max": 0.0}
    share, loose = 0.0, [0, 0, 0]
    for F in HUB_STACKED_F:
        for op in ("sum", "max", "min"):
            for integer in (True, False):
                x = (torch.randint(-8, 9, (SHARDS, n_val, F), generator=gen,
                                   device=dev).to(torch.float32)
                     if integer else
                     torch.randn((SHARDS, n_val, F), generator=gen,
                                 device=dev))
                e, sh, lo = stacked_checked(torch, calls, x, op, hit, seg, n,
                                            integer, f"{op}_stacked hub")
                key = "sum" if op == "sum" else "max"
                err[key], share = max(err[key], e), max(share, sh)
                loose = [a + b for a, b in zip(loose, lo)]
    for key, e in err.items():
        errs[f"{key}_stacked"] = max(errs.get(f"{key}_stacked", 0.0), e)
    seg0 = lv[0][1]
    hub_n = int(np.bincount(seg0[seg0 >= 0]).max())
    print(f"  dense stacked hub level: S={SHARDS} blocks {tob.shape[1]} a "
          f"shard, {hub_n} slots on shard 0's largest row, F "
          f"{'/'.join(map(str, HUB_STACKED_F))} "
          f"(sum/max/min): bit-equal to {SHARDS} single-shard levels, plain "
          f"version held (max abs err sum {err['sum']:.3g}, max/min "
          f"{err['max']:.3g}); normal sums used {share:.3g} of the fp64 bar "
          f"at most, {loose[0]} of {loose[2]} rows beyond rtol = atol = "
          f"1e-4 of the fp32 plain version (that version's own beyond it "
          f"of the fp64 sum: {loose[1]})", flush=True)
    return dict(shards=SHARDS, n_blocks=int(tob.shape[1]), n_rows=n,
                largest_row_slots=hub_n, checked_F=list(HUB_STACKED_F),
                max_abs_err=err, fp64_bar_share=share,
                beyond_1e4_rows=loose[0], plain_beyond_1e4_rows=loose[1],
                float_sum_rows=loose[2])


def check_stacked_kernel(torch, ops, ref, group, errs, act_sets) -> list:
    """The shard-batched entries at this phase's largest level (the stacked
    push or pull level with the most live slots over all shards; the fused
    active entry at the push level whose active blocks hold the most),
    values ``val`` (S, n, F) gathered by the level's src and sign at F in
    {1, 2, 64}: sum on the sum group, max and min on the max group. Each
    shard bit-equal to the single-shard level it replaces and on a rerun:
    for the dense entry the single-shard dense entry on the shard's
    gathered values (``val[src] * sign``, or ``-val[src]`` negated back for
    min), for the active entry the single-shard active entry; exact against
    the plain version on integer values and for max and min, normal-valued
    sums within n * 2^-24 * sum|x| per row of an fp64 sum on CPU copies
    (``plain_sum_fp64``); the active row masks equal to the active slots'
    rows (``stacked_checked``). The device operations of one dense stacked
    level, from a CUDA graph capture: one kernel and nothing else. Times at
    F=1: the stacked launch, the S single-shard levels, the plain version
    (shard by shard) and the library composition over the flattened shards
    (the shard offsets' cast and add for the dense entry, ``index_select``,
    the sign's multiply, then ``index_add_`` / ``index_reduce_``), each
    beside the bound."""
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
    kw = dict(n_rows=n, n_row_tiles=meta.n_row_tiles)
    cops = (op, "min") if op == "max" else (op,)
    rows = []
    for entry, pick in (("dense", best), ("active", best_a)):
        if pick is None:
            continue
        _, side, l = pick
        t = getattr(eng.arrays, side)
        seg, src, sign = t.seg[:, l], t.src[:, l], t.sign[:, l]
        tob, fot = t.tile_of_block[:, l], t.first_of_tile[:, l]
        nb = tob.shape[1]
        sid = torch.arange(S, device=dev)[:, None]
        if entry == "dense":
            act, K = None, nb
            seg_c, src_c, sign_c = seg, src.long(), sign
        else:
            act = torch.as_tensor(act_sets[side][l], device=dev)
            K = act.shape[1]
            a = act.long()
            ab = a.clamp(max=nb - 1)
            # the active slots' rows, sources and signs
            seg_c = torch.where((a < nb)[..., None],
                                seg.reshape(S, nb, E)[sid, ab],
                                -1).reshape(S, -1)
            src_c = src.reshape(S, nb, E)[sid, ab].reshape(S, -1).long()
            sign_c = sign.reshape(S, nb, E)[sid, ab].reshape(S, -1)
        hit = torch.zeros((S, n + 1), dtype=torch.bool, device=dev)
        hit.scatter_(1, torch.where(seg_c >= 0, seg_c.long(), n),
                     torch.ones_like(seg_c, dtype=torch.bool))
        hit = hit[:, :n]
        n_live = int((seg_c >= 0).sum().item())
        name = "stacked" if entry == "dense" else "active_stacked"

        calls = stacked_calls(ops, ref, (seg, src, sign, tob, fot), act, hit,
                              src_c, sign_c, kw)
        launch, singles, plain, _ = calls

        # F 1, 2 and 64: the slot-lane (FC 1, 2) and feature-lane (FC 32)
        # instances a sharded session runs (avg has 2 features, topk 64)
        err = share = 0.0
        loose = [0, 0, 0]  # float-sum rows: kernel, plain, rows checked
        for F in (1, 2, 64):
            for cop in cops:
                for integer in (True, False):
                    x = (torch.randint(-8, 9, (S, n, F), generator=gen,
                                       device=dev).to(torch.float32)
                         if integer else
                         torch.randn((S, n, F), generator=gen, device=dev))
                    e, sh, lo = stacked_checked(
                        torch, calls, x, cop, hit, seg_c, n, integer,
                        f"{cop}_{name} {side} l={l}")
                    err, share = max(err, e), max(share, sh)
                    loose = [a + b for a, b in zip(loose, lo)]
        errs[f"{op}_{name}"] = max(errs.get(f"{op}_{name}", 0.0), err)
        F = 1  # the timed values
        x = torch.randn((S, n, F), generator=gen, device=dev)
        launched = None
        if act is None:  # one dense stacked level: one kernel, nothing else
            launched = stacked_level_launches(torch, meta, t, l, op)
            if len(launched) != 1 or "dense_stacked" not in launched[0]:
                raise AssertionError(f"a dense stacked {op} level ran "
                                     f"{len(launched)} device operations "
                                     f"{launched}, expected the one fused "
                                     f"kernel")
        k_ms = cuda_ms(torch, lambda: launch(x, op))
        # late in this process the profiler has seen only part of the
        # stacked launches, or none: held_ms is their device time, and a
        # profiler reading that fails is not measured (None)
        k_dev = device_ms_or_none(torch, lambda: launch(x, op))
        s_dev = device_ms_or_none(torch, lambda: singles(x, op))
        k_held = held_ms(torch, lambda: launch(x, op))
        s_held = held_ms(torch, lambda: singles(x, op))
        p_ms = cuda_ms(torch, lambda: plain(x, op), reps=5)
        # the library composition over the flattened shards: gather, the
        # sign's multiply, then one scatter; for the dense entry the whole
        # level as the engine composed it before the fused entry, the
        # sources' shard offsets (cast and add) included
        dst = (torch.where(seg_c >= 0, seg_c.long(), n)
               + sid * (n + 1)).reshape(-1)
        lib_out = torch.zeros((S * (n + 1), F), device=dev)
        xv = x.reshape(-1, F)
        src_f = (src_c + sid * n).reshape(-1)

        def lib():
            g = xv.index_select(0, src_f if act is not None else (
                src.to(torch.int64) + sid * n).reshape(-1))
            if op == "sum":
                return lib_out.index_add_(
                    0, dst, (g.view(S, -1, F) * sign_c[..., None])
                    .reshape(-1, F))
            return lib_out.index_reduce_(0, dst, g, "amax")

        l_ms = cuda_ms(torch, lib)
        l_dev = device_ms_or_none(torch, lib)
        if act is None:
            b_ms, b_by = stacked_level_bound_ms(seg, src, tob, fot, F, n, op)
        else:
            # each shard's fused-entry bound, summed (all bound by bytes at
            # F=1)
            b_ms = sum(active_bound_ms(seg_c[s], src_c[s], tob[s], act[s],
                                       F, n, op)[0] for s in range(S))
            b_by = active_bound_ms(seg_c[0], src_c[0], tob[0], act[0], F, n,
                                   op)[1]
        rows.append(dict(op=op, entry=name, side=side, level=l, shards=S,
                         n_blocks=nb, K=K, n_live=n_live, F=F,
                         max_abs_err=err, ms=k_ms, device_ms=k_dev,
                         single_x_S_device_ms=s_dev, held_ms=k_held,
                         single_x_S_held_ms=s_held, plain_ms=p_ms,
                         library_ms=l_ms, library_device_ms=l_dev,
                         bound_ms=b_ms, bound_by=b_by,
                         level_launches=launched, checked_F=[1, 2, 64],
                         fp64_bar_share=share, beyond_1e4_rows=loose[0],
                         plain_beyond_1e4_rows=loose[1],
                         float_sum_rows=loose[2]))
        bars = "" if op != "sum" else (
            f"; normal sums used {share:.3g} of the fp64 bar at most, "
            f"{loose[0]} of {loose[2]} rows beyond rtol = atol = 1e-4 of "
            f"the fp32 plain version (that version's own beyond it of the "
            f"fp64 sum: {loose[1]})")
        print(f"  {op}_{name} {side} l={l} S={S} blocks {K}/{nb} "
              f"live={n_live} F 1/2/64 ({'/'.join(cops)}): bit-equal to {S} "
              f"single-shard levels, plain version held (max abs err "
              f"{err:.3g}{bars}); at F=1 kernel {k_ms:.4f} ms "
              f"({ms_or_not(k_dev)} device, "
              f"{k_held:.5f} held) vs {S} single-shard levels "
              f"{ms_or_not(s_dev)} device, {s_held:.5f} held; plain "
              f"{p_ms:.4f} ms; library composition over the flattened "
              f"shards {l_ms:.4f} ms ({ms_or_not(l_dev)} device); bound "
              f"{b_ms:.6f} ms ({b_by})"
              + ("" if launched is None else
                 f"; one captured level: {launched}"), flush=True)
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
    report["kernel_hub"] = stacked_hub_check(torch, ops, ref, errs)
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
          f"{share_or_not(report['profile']['busy_share'])}", flush=True)
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

# ---------------------------------------------------------- bf16 edge values
def round_bf16_np(x) -> np.ndarray:
    """fp32 values rounded to bfloat16 (to nearest even) and back, on the
    bits in numpy: the checks' own rounding, independent of torch's."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def bf16_ulp(x) -> np.ndarray:
    """One bf16 ulp at |x|: 2^(e - 8) for |x| = f * 2^e, f in [0.5, 1)."""
    return np.ldexp(1.0, np.frexp(np.abs(np.asarray(x, np.float64)))[1] - 8)


class segagg_bf16:
    """``EAGR_SEGAGG_BF16`` set to ``on`` inside the block (plans compiled
    there carry the flag), restored after."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        self.old = os.environ.get("EAGR_SEGAGG_BF16")
        os.environ["EAGR_SEGAGG_BF16"] = "1" if self.on else "0"

    def __exit__(self, *exc):
        if self.old is None:
            os.environ.pop("EAGR_SEGAGG_BF16", None)
        else:
            os.environ["EAGR_SEGAGG_BF16"] = self.old


def rows_of(torch, seg_c, n: int):
    """(S, n) bool: the rows the slots ``seg_c`` (S, E) route to."""
    hit = torch.zeros((seg_c.shape[0], n + 1), dtype=torch.bool,
                      device=seg_c.device)
    hit.scatter_(1, torch.where(seg_c >= 0, seg_c.long(), n),
                 torch.ones_like(seg_c, dtype=torch.bool))
    return hit[:, :n]


def bf16_checked(torch, call, val, slots, op: str, integer: bool,
                 where: str) -> tuple[float, bool]:
    """One bf16 entry on values ``val`` (S, n, F) against its bars.
    ``call`` = (launch, plain, fp32, singles): the bf16 launch and its plain
    version, each ``val -> (out (S, n, F), hit (S, n))``, the entry's fp32
    instance ``val -> out`` and, for the stacked entries, the single-shard
    bf16 calls of each shard (``val -> [(out, hit)]``, else None).
    ``slots`` = (seg_c, src_c, sign_c) (S, E) the slots the call reduces.
    Bars: the row mask the slots' rows; a rerun bit-equal; each shard of a
    stacked call bit-equal to its single-shard call; exact against the plain
    version on integer values and for max and min; normal-valued sums
    within n * 2^-24 * sum|x| per row (n the row's slots) of an fp64 sum of
    the values rounded on their bits in numpy (``round_bf16_np``), on CPU
    copies. Returns the max abs error (against the fp64 sum for normal
    sums) and whether the fp32 instance gives another output on some row
    (normal values: the rounding shows)."""
    launch, plain, fp32, singles = call
    seg_c, src_c, sign_c = slots
    S, n, F = val.shape
    where = f"{where} F={F} {'integer' if integer else 'normal'}"
    got, got_hit = launch(val)
    again, again_hit = launch(val)
    want, want_hit = plain(val)
    one = singles(val) if singles is not None else None
    other = None if integer else fp32(val)
    torch.cuda.synchronize()
    hit = rows_of(torch, seg_c, n)
    if not (torch.equal(got_hit, hit) and torch.equal(again_hit, hit)
            and torch.equal(want_hit, hit)):
        raise AssertionError(f"{where}: row mask != the slots' rows")
    err, differs = 0.0, False
    for s in range(S):
        h = hit[s]
        if not h.any():
            continue
        if not torch.equal(got[s][h], again[s][h]):
            raise AssertionError(f"{where} is not deterministic")
        if one is not None and not (torch.equal(got[s][h], one[s][0][h])
                                    and torch.equal(one[s][1], h)):
            raise AssertionError(f"{where}: shard {s} != its single-shard "
                                 f"bf16 call")
        if other is not None:
            differs |= not torch.equal(got[s][h], other[s][h])
        if integer or op != "sum":
            e = (got[s][h] - want[s][h]).abs().max().item()
            if not torch.equal(got[s][h], want[s][h]):
                raise AssertionError(f"{where} != plain version (exact), "
                                     f"shard {s}, max abs err {e}")
            err = max(err, e)
            continue
        live = (seg_c[s] >= 0).cpu()
        x = val[s].cpu().numpy()[src_c[s].cpu().numpy()] \
            * sign_c[s].cpu().numpy()[:, None]
        x = torch.from_numpy(round_bf16_np(x).astype(np.float64))
        dst = torch.where(live, seg_c[s].cpu().long(), n)
        exact = torch.zeros((n + 1, F), dtype=torch.float64) \
            .index_add_(0, dst, x)[:n]
        mag = torch.zeros((n + 1, F), dtype=torch.float64) \
            .index_add_(0, dst, x.abs())[:n]
        cnt = torch.zeros(n + 1, dtype=torch.float64).index_add_(
            0, dst, torch.ones(dst.shape, dtype=torch.float64))[:n, None]
        d64 = (got[s].cpu().double() - exact).abs()
        hc = h.cpu()
        e = d64[hc].max().item()
        if bool((d64 > cnt * 2.0 ** -24 * mag)[hc].any()):
            raise AssertionError(f"{where} beyond n * 2^-24 * sum|x| of the "
                                 f"fp64 sum of the rounded values, shard "
                                 f"{s}, max abs err {e}")
        err = max(err, e)
    return err, differs


def bf16_calls(torch, ops, ref, tables, act, kw, single: bool):
    """The bf16 entry on one level (``tables`` = (seg, src, sign, tob,
    fot), each (S, ...); ``act`` (S, K) active lists or None for the dense
    entry) as ``bf16_checked`` takes it. ``single``: one shard through the
    single-shard active entry, or the dense entry at S = 1 (the single
    engine's bf16 dense level); else the shard-batched entries, whose
    singles are the single-shard calls of each shard."""
    seg, src, sign, tob, fot = tables
    S, n = seg.shape[0], kw["n_rows"]
    hit = rows_of(torch, seg, n) if act is None else None

    def launch(val, op, bf16=True):
        if act is None:
            return ops.segment_agg_level_stacked(
                val, *tables, op=op, bf16=bf16, **kw), hit
        if single:
            out, h = ops.segment_agg_active(
                val[0], *(t[0] for t in tables), act[0], op=op, bf16=bf16,
                **kw)
            return out[None], h[None]
        return ops.segment_agg_active_stacked(val, *tables, act, op=op,
                                              bf16=bf16, **kw)

    def plain(val, op):
        if act is None:
            return ref.segment_agg_level_stacked_ref(
                val, seg, src, sign, n, op, bf16=True), hit
        return ref.segment_agg_active_stacked_ref(val, seg, src, sign, act,
                                                  n, op, bf16=True)

    def singles(val, op):
        out = []
        for s in range(S):
            one = [t[s: s + 1] for t in tables]
            if act is None:
                o = ops.segment_agg_level_stacked(val[s: s + 1].contiguous(),
                                                  *one, op=op, bf16=True,
                                                  **kw)[0]
                out.append((o, hit[s]))
            else:
                out.append(ops.segment_agg_active(
                    val[s], *(t[0] for t in one), act[s].contiguous(), op=op,
                    bf16=True, **kw))
        return out

    def for_op(op):
        return (lambda v: launch(v, op), lambda v: plain(v, op),
                lambda v: launch(v, op, False)[0],
                None if single else (lambda v: singles(v, op)))

    return for_op


def bf16_slots(torch, tables, act):
    """The slots a call reduces, (seg_c, src_c, sign_c) (S, E): the whole
    level's, or the active blocks' (pads as padding slots)."""
    seg, src, sign = tables[:3]
    if act is None:
        return seg, src.long(), sign
    S, E = seg.shape[0], 256
    nb = tables[3].shape[1]
    a = act.long()
    ab = a.clamp(max=nb - 1)
    sid = torch.arange(S, device=seg.device)[:, None]
    seg_c = torch.where((a < nb)[..., None], seg.reshape(S, nb, E)[sid, ab],
                        -1).reshape(S, -1)
    src_c = src.reshape(S, nb, E)[sid, ab].reshape(S, -1).long()
    sign_c = sign.reshape(S, nb, E)[sid, ab].reshape(S, -1)
    return seg_c, src_c, sign_c


def bf16_levels(plan_tables, depth: int, acts, stacked: bool):
    """(side, level, tables (S, ...), act (S, K) or None) of every real
    level with work: the dense entry's every level, or the active entry's
    levels with an active block. ``plan_tables`` maps side -> LevelTables
    of one plan (single) or of the stack; ``acts`` side -> per-level
    active lists (numpy) or None for dense."""
    for side, t in plan_tables.items():
        for l in range(depth):
            if stacked:
                tabs = (t.seg[:, l], t.src[:, l], t.sign[:, l],
                        t.tile_of_block[:, l], t.first_of_tile[:, l])
            else:
                tabs = tuple(x[l][None] for x in (
                    t.seg, t.src, t.sign, t.tile_of_block, t.first_of_tile))
            if acts is None:
                yield side, l, tabs, None
                continue
            a = acts.get(side)
            if a is None or l >= len(a):
                continue
            a = np.asarray(a[l])
            nb = tabs[3].shape[1]
            if a.size == 0 or not (a < nb).any():
                continue
            yield side, l, tabs, (a if stacked else a[None])


def bf16_kernel_checks(torch, ops, ref, entry: str, engine, tables_of,
                       depth, acts, stacked: bool, errs) -> dict:
    """Every level of one plan (or stack) through one bf16 entry, sum on
    the sum plan, max and min on the max plan (``bf16_checked``): F 1 on
    integer and normal values at every level, F 2 normal and F 64 integer
    too (the slot-lane and feature-lane instances). Returns the levels
    checked, the largest error, whether the rounding showed, and the
    largest level (most live slots) for the timings."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    meta = engine.meta if stacked else engine.plan.meta
    n = meta.n_nodes
    kw = dict(n_rows=n, n_row_tiles=meta.n_row_tiles)
    out = dict(levels=0, max_abs_err=0.0, differs=False, top=None)
    cops = ("sum",) if engine.agg.name == "sum" else ("max", "min")
    for side, l, tabs, act in bf16_levels(tables_of, depth, acts, stacked):
        S = tabs[0].shape[0]
        act_t = None if act is None else torch.as_tensor(
            np.ascontiguousarray(act, np.int32), device=dev)
        calls = bf16_calls(torch, ops, ref, tabs, act_t, kw, not stacked)
        slots = bf16_slots(torch, tabs, act_t)
        n_live = int((slots[0] >= 0).sum().item())
        if n_live == 0:
            continue
        out["levels"] += 1
        for F, kinds in ((1, (True, False)), (2, (False,)), (64, (True,))):
            for integer in kinds:
                val = (torch.randint(-8, 9, (S, n, F), generator=gen,
                                     device=dev).to(torch.float32)
                       if integer else
                       torch.randn((S, n, F), generator=gen, device=dev) * 4)
                for op in cops:
                    e, d = bf16_checked(torch, calls(op), val, slots, op,
                                        integer, f"{op} {entry} {side} l={l}")
                    out["max_abs_err"] = max(out["max_abs_err"], e)
                    out["differs"] |= d
                    key = f"{'sum' if op == 'sum' else 'max'}_{entry}_bf16"
                    errs[key] = max(errs.get(key, 0.0), e)
        if out["top"] is None or n_live > out["top"][0]:
            out["top"] = (n_live, side, l, tabs, act_t)
    if not out["levels"]:
        raise AssertionError(f"no level checked through the bf16 {entry} "
                             f"entry")
    if not out["differs"]:
        raise AssertionError(f"the bf16 {entry} entry gave the fp32 "
                             f"instance's output on every level")
    return out


def bf16_timed(torch, ops, entry: str, op: str, top, kw, stacked: bool
               ) -> dict:
    """One entry's times at its largest level, F = 1, normal values: the
    bf16 instance (events back to back, and held: the card held by a sleep
    kernel) beside the fp32 instance (held), the plain version, the library
    composition (``index_select``, the sign's multiply, the rounding
    ``.to(bfloat16).to(float32)``, ``index_add_`` / ``index_reduce_`` over
    the flattened shards) and the bound; the dense entry at S = 1 also
    beside the fp32 single engine's ``_level_reduce`` (gather, multiply and
    two-kernel dense entry, ``segment_agg_level``), held."""
    from repro_torch.core import engine as E
    from repro_torch.kernels.segment_agg import ref

    n_live, side, l, tabs, act = top
    dev = torch.device(DEVICE)
    S, n = tabs[0].shape[0], kw["n_rows"]
    val = torch.randn((S, n, 1), device=dev)
    seg_c, src_c, sign_c = bf16_slots(torch, tabs, act)
    calls = bf16_calls(torch, ops, ref, tabs, act, kw, not stacked)(op)
    launch, plain, fp32 = calls[0], calls[1], calls[2]
    k_ms = cuda_ms(torch, lambda: launch(val))
    k_held = held_ms(torch, lambda: launch(val))
    f_held = held_ms(torch, lambda: fp32(val))
    p_ms = cuda_ms(torch, lambda: plain(val), reps=5)
    sid = torch.arange(S, device=dev)[:, None]
    dst = (torch.where(seg_c >= 0, seg_c.long(), n) + sid * (n + 1)) \
        .reshape(-1)
    src_f = (src_c + sid * n).reshape(-1)
    sign_f = sign_c.reshape(-1, 1)
    lib_out = torch.zeros((S * (n + 1), 1), device=dev)
    xv = val.reshape(-1, 1)

    def lib():
        g = xv.index_select(0, src_f)
        if op == "sum":
            g = g * sign_f
        g = g.to(torch.bfloat16).to(torch.float32)
        if op == "sum":
            return lib_out.index_add_(0, dst, g)
        return lib_out.index_reduce_(0, dst, g, "amax")

    l_ms = cuda_ms(torch, lib)
    if act is None:
        b_ms, b_by = stacked_level_bound_ms(tabs[0], tabs[1], tabs[3],
                                            tabs[4], 1, n, op, bf16=True)
    else:
        parts = [active_bound_ms(seg_c[s], src_c[s], tabs[3][s], act[s], 1,
                                 n, op, bf16=True) for s in range(S)]
        b_ms, b_by = sum(p[0] for p in parts), parts[0][1]
    row = dict(entry=entry, op=op, side=side, level=l, shards=S,
               n_blocks=int(tabs[3].shape[1]),
               K=None if act is None else int(act.shape[1]), n_live=n_live,
               F=1, ms=k_ms, held_ms=k_held, fp32_held_ms=f_held,
               plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms, bound_by=b_by)
    if entry == "dense":
        meta = E.PlanMeta(n_nodes=n, n_writers=1, n_levels=1,
                          n_row_tiles=kw["n_row_tiles"], depth=1)
        t1 = E.LevelTables(*(t for t in tabs),
                           touched=torch.ones((1, n), dtype=torch.bool,
                                              device=dev))
        row["level_reduce_fp32_held_ms"] = held_ms(
            torch, lambda: E._level_reduce(meta, t1, 0, val[0], op))
    return row


def engine_active_sets(eng, ids, q):
    """The push (write) and pull (read) active lists the single engine
    expands for one batch of writers and readers, forced sparse."""
    set_sparse("1")
    try:
        rows, mask = eng.plan.routes.writer_rows(ids)
        push = eng.frontier_active(rows, mask)
        nodes, _ = eng.plan.routes.reader_nodes(q)
        rd = eng._reader_active(nodes)
    finally:
        set_sparse("auto")
    return {"push": push, "pull": None if rd is None else rd[1]}


def lockstep(torch, ops, eng16, eng32, stream) -> dict:
    """The bf16 stream in lockstep (the host's speed swings between
    moments): every batch, from one bf16 state, written by the bf16 engines
    (agg -> EagrEngine) forced dense and, from a copy of that state, forced
    sparse, PAOs and windows required bit-equal; then by the fp32 engines
    forced dense; a read round of the batch's readers after every
    BF16_READ_EVERY-th, each mode in turn, the two bf16 modes' answers
    required bit-equal. Each engine set starts from empty windows. Returns
    per mode the write and read times, the launches (counted from 0 around
    each mode's calls) and the answers."""
    modes = (("dense", eng16, "0"), ("sparse", eng16, "1"),
             ("fp32", eng32, "0"))
    out = {m: dict(w_ms=[], r_ms=[], answers=[],
                   launches=dict.fromkeys(ops.LAUNCHES, 0))
           for m, _, _ in modes}
    for engs in (eng16, eng32):
        for e in engs.values():
            e.adopt_state(e.init_state(), now_host=0.0, last_eval_now=0.0)
    torch.cuda.synchronize()
    try:
        for k, (ids, vals, q) in enumerate(stream):
            start = [(e.state, e._now_host, e._last_eval_now)
                     for e in eng16.values()]
            states = {}
            for name, engs, mode in modes:
                if name == "sparse":  # from a copy of the dense step's start
                    for e, (st, now, last) in zip(eng16.values(), start):
                        e.adopt_state(type(st)(
                            type(st.windows)(*(t.clone() for t in st.windows)),
                            st.pao.clone(), st.now.clone()),
                            now_host=now, last_eval_now=last)
                run = out[name]
                set_sparse(mode)
                ops.reset_launches()
                t0 = time.perf_counter()
                for e in engs.values():
                    e.write_batch(ids, vals)
                torch.cuda.synchronize()
                run["w_ms"].append((time.perf_counter() - t0) * 1e3)
                if (k + 1) % BF16_READ_EVERY == 0:
                    t0 = time.perf_counter()
                    run["answers"].append([np.asarray(e.read_batch(q))
                                           for e in engs.values()])
                    run["r_ms"].append((time.perf_counter() - t0) * 1e3)
                for key, v in ops.LAUNCHES.items():
                    run["launches"][key] += v
                if engs is eng16:
                    states[name] = [[*e.state.windows, e.state.pao]
                                    for e in engs.values()]
            for agg, a, b in zip(eng16, states["dense"], states["sparse"]):
                if not all(torch.equal(x, y) for x, y in zip(a, b)):
                    raise AssertionError(f"bf16 sparse {agg} state != dense "
                                         f"after batch {k}")
            if out["dense"]["answers"] and (k + 1) % BF16_READ_EVERY == 0:
                for agg, x, y in zip(eng16, out["dense"]["answers"][-1],
                                     out["sparse"]["answers"][-1]):
                    if not np.array_equal(x, y):
                        raise AssertionError(f"bf16 sparse {agg} answers != "
                                             f"dense after batch {k}")
    finally:
        set_sparse("auto")
    return out


def bf16_bar(torch, engines32, stream, readers_of_round, depth: int):
    """The bar the bf16 sums and counts are held to against fp32 on the
    same stream, per answer: every value reaching an answer is rounded at
    most once a level in each sweep it crosses (a write sweep rounds the
    batch's deltas, a read sweep the PAOs; D real levels), each rounding
    within u = 2^-8 of its value, so an answer moves by at most
    ((1 + u)^(2 D) - 1) times the magnitudes that crossed the levels: every
    delta (at most |new| + |evicted| a write) and the PAOs read (at most
    the window's |values|), together at most 3 M, M the sum of |v| over
    every write of the stream into the reader's neighbourhood. M (and the
    count of those writes, for count) comes from an fp32 engine with a
    window of one into which each writer writes its stream totals once.
    Returns per read round the (sum, count) bars."""
    from repro_torch import WindowSpec
    from repro_torch.core.aggregates import make_aggregate
    from repro_torch.core.engine import EagrEngine

    ref32 = engines32["sum"]
    ids = np.concatenate([b[0] for b in stream])
    vals = np.abs(np.concatenate([b[1] for b in stream])).astype(np.float64)
    ws, inv = np.unique(ids, return_inverse=True)
    mv = np.stack([np.bincount(inv, weights=vals, minlength=len(ws)),
                   np.bincount(inv, minlength=len(ws))], 1).astype(np.float32)
    mag = EagrEngine(ref32.overlay, ref32.plan.decision,
                     make_aggregate("sum", value_dim=2),
                     WindowSpec("tuple", 1, value_dim=2), device=DEVICE)
    mag.write_batch(ws, mv)
    grow = (1.0 + BF16_U) ** (2 * depth) - 1.0
    out = []
    for q in readers_of_round:
        m = np.asarray(mag.read_batch(q), np.float64).reshape(len(q), 2)
        out.append((grow * 3 * m[:, 0] + 2.0 ** -20 * m[:, 0],
                    grow * 3 * m[:, 1]))
    return out


def phase_bf16(torch, ops, ref, bases, writers, readers, errs,
               out_dir) -> dict:
    """Phase 9 (see the module docstring)."""
    from repro_torch import WindowSpec
    from repro_torch.core.aggregates import make_aggregate
    from repro_torch.core.engine import (
        EagrEngine,
        plan_from_snapshot,
        plan_snapshot,
    )
    from repro_torch.distributed import (
        StackedShardedEngine,
        host_loop_read,
        host_loop_write,
        partition_overlay,
    )

    report: dict = {"seconds_by_part": {}}
    clock = [time.perf_counter()]

    def lap(part: str) -> None:
        now = time.perf_counter()
        report["seconds_by_part"][part] = now - clock[0]
        clock[0] = now

    # ---- set-up: phase 3's overlay and decisions compiled again, bf16 and
    # fp32 engines side by side; a 4-shard bf16 stack of sum and of max
    spec = WindowSpec("tuple", WINDOW)
    aggs = ("sum", "max", "count")
    eng = {True: {}, False: {}}
    for bf16 in (True, False):
        for agg in aggs:
            ov, dec = bases[agg]
            with segagg_bf16(bf16):
                e = EagrEngine(ov, dec, make_aggregate(agg), spec,
                               device=DEVICE, headroom=2.0)
            if e.plan.meta.bf16 is not bf16:
                raise AssertionError(f"{agg} plan compiled with "
                                     f"EAGR_SEGAGG_BF16={int(bf16)} carries "
                                     f"bf16={e.plan.meta.bf16}")
            eng[bf16][agg] = e
    n_base = int(max(writers.max(), readers.max())) + 1
    stk, hosts = {}, {}
    for agg in ("sum", "max"):
        ov, dec = bases[agg]
        with segagg_bf16(True):
            sh = partition_overlay(ov, dec, SHARDS, seed=SEED, device=DEVICE,
                                   headroom=2.0)
        stk[agg] = StackedShardedEngine(sh, make_aggregate(agg), spec,
                                        base_capacity=n_base)
        if not stk[agg].meta.bf16:
            raise AssertionError(f"the {agg} stack is not in bf16 mode")
        hosts[agg] = []
        for s, p in enumerate(sh.shard_plans):
            plan = plan_from_snapshot(*plan_snapshot(p), device=DEVICE)
            if not plan.meta.bf16:
                raise AssertionError("a snapshot dropped the bf16 flag")
            hosts[agg].append(EagrEngine(sh.shards[s], plan.decision,
                                         make_aggregate(agg), spec, plan=plan,
                                         device=DEVICE))
    depth = max(e.plan.meta.depth for e in eng[True].values())
    print(f"9 set-up: bf16 and fp32 engines of sum, max and count on phase "
          f"3's overlay and decisions (depth {depth}), a {SHARDS}-shard bf16 "
          f"stack of sum and of max with a host loop of single-shard bf16 "
          f"engines over snapshot copies of its plans", flush=True)
    lap("set_up")

    # ---- 9a. every level of the bf16 plans through each bf16 entry
    rng = np.random.default_rng(SEED + 9)
    ((ids256, _, q256),) = dyn_stream(writers, readers, 1, 256, rng)
    (probe,) = make_stream(writers, readers, 1, rng, dyadic=False)
    checks, tops = {}, {}
    for agg in ("sum", "max"):
        e = eng[True][agg]
        tabs = {"push": e.plan.arrays.push, "pull": e.plan.arrays.pull}
        d = e.plan.meta.depth
        checks[f"{agg}_dense"] = bf16_kernel_checks(
            torch, ops, ref, "stacked", e, tabs, d, None, False, errs)
        checks[f"{agg}_active"] = bf16_kernel_checks(
            torch, ops, ref, "active", e, tabs, d,
            engine_active_sets(e, ids256, q256), False, errs)
        s = stk[agg]
        stabs = {"push": s.arrays.push, "pull": s.arrays.pull}
        checks[f"{agg}_stacked"] = bf16_kernel_checks(
            torch, ops, ref, "stacked", s, stabs, s.meta.depth, None, True,
            errs)
        set_sparse("1")
        try:
            push = s._frontier_active(probe[0])
        finally:
            set_sparse("auto")
        if push is None:
            raise AssertionError(f"the {agg} stack expanded no frontier for "
                                 f"a batch of {BATCH}")
        checks[f"{agg}_active_stacked"] = bf16_kernel_checks(
            torch, ops, ref, "active_stacked", s, stabs, s.meta.depth,
            {"push": push}, True, errs)
    for key, c in checks.items():
        tops[key] = c.pop("top")
        print(f"  9a {key}_bf16: {c['levels']} levels, F 1/2/64 "
              f"({'sum' if key.startswith('sum') else 'max/min'}): plain "
              f"version held (max abs err {c['max_abs_err']:.3g}), reruns "
              f"bit-equal{', each shard == its single-shard bf16 call' if 'stacked' in key else ''}; "
              f"the fp32 instance gives another output", flush=True)
    report["kernel_checks"] = checks
    lap("kernels")

    # ---- 9b. 20 write batches of 4,096 Zipf(1.5) writers, 5 read rounds:
    # bf16 dense, bf16 sparse and fp32 in lockstep, from empty windows;
    # then the stack against its host loop, dense half then sparse half
    stream = make_stream(writers, readers, BF16_BATCHES, rng, dyadic=False)
    # warm: the kernels, the frontier indices
    lockstep(torch, ops, eng[True], eng[False],
             make_stream(writers, readers, BF16_READ_EVERY, rng,
                         dyadic=False))
    runs = lockstep(torch, ops, eng[True], eng[False], stream)
    dn, sp, f32 = runs["dense"], runs["sparse"], runs["fp32"]
    dl, sl = dn["launches"], sp["launches"]
    for k in ("sum_stacked_bf16", "max_stacked_bf16"):
        if dl[k] <= 0:
            raise AssertionError(f"the bf16 dense run launched no {k}")
    for k in ("sum_active_bf16", "max_active_bf16"):
        if sl[k] <= 0:
            raise AssertionError(f"the bf16 sparse run launched no {k}")
    fp32_keys = [k for k in ops.LAUNCHES if not k.endswith("_bf16")]
    if any(dl[k] or sl[k] for k in fp32_keys):
        raise AssertionError(f"a bf16 engine launched an fp32 instance: "
                             f"dense {dl}, sparse {sl}")
    # against fp32 on the same stream (bf16_bar)
    rounds = [q for k, (_, _, q) in enumerate(stream)
              if (k + 1) % BF16_READ_EVERY == 0]
    bars = bf16_bar(torch, eng[False], stream, rounds, depth)
    rtol, atol = BF16_REF_BAR
    held = dict(sum_share=0.0, count_share=0.0, ref_share=0.0,
                max_ulps=0.0)
    differ = dict.fromkeys(aggs, 0)
    for r, (a16, a32, (b_sum, b_cnt)) in enumerate(zip(
            dn["answers"], f32["answers"], bars)):
        for agg, x, y in zip(aggs, a16, a32):
            x = np.asarray(x, np.float64).reshape(-1)
            y = np.asarray(y, np.float64).reshape(-1)
            d = np.abs(x - y)
            differ[agg] += int((d > 0).sum())
            if agg == "max":
                ulps = d / bf16_ulp(y)
                held["max_ulps"] = max(held["max_ulps"], float(ulps.max()))
                if (ulps > 1).any():
                    raise AssertionError(f"bf16 max beyond one bf16 ulp of "
                                         f"fp32 in read round {r}: "
                                         f"{float(ulps.max())} ulps")
                continue
            bar = b_sum if agg == "sum" else b_cnt
            share = float((d / np.maximum(bar, 1e-30)).max())
            ref_share = float((d / (atol + rtol * np.abs(y))).max())
            held[f"{agg}_share"] = max(held[f"{agg}_share"], share)
            held["ref_share"] = max(held["ref_share"], ref_share)
            if share > 1 or ref_share > 1:
                raise AssertionError(
                    f"bf16 {agg} beyond its bar against fp32 in read round "
                    f"{r}: {share:.3g} of ((1 + 2^-8)^(2 D) - 1) 3 M, "
                    f"{ref_share:.3g} of rtol {rtol} / atol {atol}")
    if differ["sum"] == 0:
        raise AssertionError("bf16 sum answers equal fp32's in every reader: "
                             "the mode did not round")
    n_ans = sum(len(q) for q in rounds)
    p50 = {m: (float(np.median(r["w_ms"])), float(np.median(r["r_ms"])))
           for m, r in runs.items()}
    print(f"9b single engines: {BF16_BATCHES} write batches of {BATCH}, "
          f"{len(rounds)} read rounds, in lockstep: bf16 sparse == bf16 dense "
          f"bit for bit (state after every batch, answers); write / read "
          f"p50 ms of sum + max + count {p50}; launches dense {dl}, sparse "
          f"{sl}; against fp32, answers that differ of {n_ans}: {differ}; "
          f"largest share of the bar used: sum {held['sum_share']:.3g}, "
          f"count {held['count_share']:.3g} of ((1 + 2^-8)^(2 D) - 1) 3 M, "
          f"{held['ref_share']:.3g} of rtol {rtol} / atol {atol}; max within "
          f"{held['max_ulps']:.3g} bf16 ulp", flush=True)
    report.update(single_launches=dict(dense=dl, sparse=sl),
                  vs_fp32=dict(held, differ=differ, answers=n_ans),
                  write_p50_ms={k: v[0] for k, v in p50.items()},
                  read_p50_ms={k: v[1] for k, v in p50.items()})
    del runs, dn, sp, f32
    lap("single")

    counted = dict.fromkeys(ops.LAUNCHES, 0)

    def count(call):
        ops.reset_launches()
        out = call()
        for key, v in ops.LAUNCHES.items():
            counted[key] += v
        return out

    half = BF16_BATCHES // 2
    for agg in ("sum", "max"):
        s = stk[agg]
        s.adopt_state(s.init_state(), now_host=0.0,
                      last_eval_now=np.zeros(SHARDS, np.float32))
        for e in hosts[agg]:
            e.adopt_state(e.init_state(), now_host=0.0, last_eval_now=0.0)
    for k, (ids, vals, q) in enumerate(stream):
        set_sparse("0" if k < half else "1")
        for agg in ("sum", "max"):
            count(lambda: stk[agg].write_batch(ids, vals))
            host_loop_write(stk[agg].sharded, hosts[agg], ids, vals)
            if (k + 1) % BF16_READ_EVERY == 0:
                got = count(lambda: stk[agg].read_batch(q))
                if not np.array_equal(got, host_loop_read(
                        stk[agg].sharded, hosts[agg], q)):
                    raise AssertionError(f"bf16 {agg} stack answers != the "
                                         f"host loop's after batch {k}")
    set_sparse("auto")
    for agg in ("sum", "max"):
        st = stk[agg].state
        for i, name in enumerate(("values", "stamps", "head", "count")):
            if not torch.equal(st.windows[i], torch.stack(
                    [e.state.windows[i] for e in hosts[agg]])):
                raise AssertionError(f"bf16 {agg} stack windows.{name} != "
                                     f"the host loop's")
        for name in ("pao", "now"):
            if not torch.equal(getattr(st, name), torch.stack(
                    [getattr(e.state, name) for e in hosts[agg]])):
                raise AssertionError(f"bf16 {agg} stack {name} != the host "
                                     f"loop's")
    stacked_launches = dict(counted)
    for k in ("sum_stacked_bf16", "max_stacked_bf16",
              "sum_active_stacked_bf16", "max_active_stacked_bf16"):
        if stacked_launches[k] <= 0:
            raise AssertionError(f"the bf16 stack launched no {k}")
    if any(stacked_launches[k] for k in fp32_keys):
        raise AssertionError(f"the bf16 stack launched an fp32 instance: "
                             f"{stacked_launches}")
    print(f"9b stack: {SHARDS} shards, sum and max, {half} dense and "
          f"{BF16_BATCHES - half} sparse write batches, {len(rounds)} read "
          f"rounds: == the host loop of {SHARDS} single-shard bf16 engines "
          f"bit for bit (windows, PAOs, clocks, answers); launches "
          f"{stacked_launches}", flush=True)
    report["stacked_launches"] = stacked_launches
    del hosts
    lap("stack")

    # ---- 9c. held times at each entry's largest level, bf16 against fp32
    rows = []
    for key, top in tops.items():
        agg, entry = key.split("_", 1)
        stacked = entry in ("stacked", "active_stacked")
        e = stk[agg] if stacked else eng[True][agg]
        meta = e.meta if stacked else e.plan.meta
        kw = dict(n_rows=meta.n_nodes, n_row_tiles=meta.n_row_tiles)
        row = bf16_timed(torch, ops, entry, agg, top, kw, stacked)
        row["max_abs_err"] = checks[key]["max_abs_err"]
        rows.append(row)
        extra = "" if "level_reduce_fp32_held_ms" not in row else (
            f"; fp32 _level_reduce {row['level_reduce_fp32_held_ms']:.5f} "
            f"held")
        print(f"  9c {agg}_{entry}_bf16 {row['side']} l={row['level']} "
              f"S={row['shards']} live={row['n_live']}: {row['ms']:.4f} ms, "
              f"held {row['held_ms']:.5f} against the fp32 instance's "
              f"{row['fp32_held_ms']:.5f}{extra}; plain {row['plain_ms']:.4f}"
              f" ms, library composition {row['library_ms']:.4f} ms, bound "
              f"{row['bound_ms']:.6f} ms ({row['bound_by']})", flush=True)
    report["timed"] = rows
    lap("times")
    print(f"phase 9 seconds by part: {report['seconds_by_part']}",
          flush=True)
    return report


# ------------------------------------------------------- flash attention
def sdpa(torch, q, k, v, *, causal, mask=None):
    """The library yardstick (timed only; the port never calls it)."""
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, is_causal=causal, enable_gqa=True)


def prefill_bound_ms(B, Hq, Hkv, Sq, Skv, d, causal, esize) -> tuple:
    """Least time of one prefill call (``flash_ops.prefill_cost``), at the
    tensor cores' rate for bf16 inputs, the CUDA cores' for fp32."""
    return bound_of_work(flash_ops.prefill_cost(B, Hq, Hkv, Sq, Skv, d,
                                                causal, esize))


def decode_bound_ms(Hq, Hkv, d, lengths, esize) -> tuple:
    """Least time of one decode call (``flash_ops.decode_cost``) over the
    rows' live lengths."""
    return bound_of_work(flash_ops.decode_cost(len(lengths), Hq, Hkv, d,
                                               int(sum(lengths)), esize))


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


def per_row(torch, attention):
    """``attention`` called on one batch row at a time (the same function
    of each row; a 1/B of its temporaries, which for the exact plain
    attention at B 8 x S 2,048 and 96 heads are ~13 GB a tensor)."""
    def attn(q, k, v, *, causal, lengths):
        return torch.cat([attention(
            q[b:b + 1], k[b:b + 1], v[b:b + 1], causal=causal,
            lengths=None if lengths is None else lengths[b:b + 1])
            for b in range(q.shape[0])])
    return attn


def prefill_row(torch, rnd, B, Hq, Hkv, S, d, errs) -> dict:
    """The tensor-core prefill on one layer's bf16 attention of shape (B,
    Hq, Hkv, S, d), causal: required on the ``wgmma`` kernel, bit-equal on
    a rerun and within the tensor-core bar (elementwise and twice SDPA's
    errors) of the plain version in fp32 on the same inputs (taken a batch
    row at a time); kernel, plain-version and SDPA times (events and
    device) beside the bound."""
    from repro_torch.kernels.flash_attention import ops, ref

    q, k, v = rnd(B, Hq, S, d), rnd(B, Hkv, S, d), rnd(B, Hkv, S, d)
    what = f"wgmma prefill, Hq {Hq} / Hkv {Hkv}, d {d}, B {B} x {S}"
    if ops.prefill_variant(q.dtype, d) != "wgmma":
        raise AssertionError(f"{what}: not the tensor-core kernel")
    got = ops.flash_attention(q, k, v, causal=True)
    again = ops.flash_attention(q, k, v, causal=True)
    want = per_row(torch, ref.attention_ref)(
        q.float(), k.float(), v.float(), causal=True, lengths=None)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{what}: not deterministic")
    floor = sdpa_floor(torch, q, k, v, want)
    m = tc_check(torch, got, want, what, floor)
    errs["prefill"] = max(errs["prefill"], m["max_abs_err"])
    del want, got, again
    calls = dict(
        kernel=lambda: ops.flash_attention(q, k, v, causal=True),
        plain=lambda: ref.attention_ref(q, k, v, causal=True),
        library=lambda: sdpa(torch, q, k, v, causal=True))
    ev = {n: cuda_ms(torch, fn, reps=3 if n == "plain" else 10)
          for n, fn in calls.items()}
    dv = {n: device_ms(torch, calls[n], reps=10) for n in ("kernel",
                                                            "library")}
    b_ms, b_by = prefill_bound_ms(B, Hq, Hkv, S, S, d, True, 2)
    print(f"  flash prefill (wgmma) B={B} Hq={Hq} Hkv={Hkv} S={S} d={d} bf16 "
          f"causal: max abs err {m['max_abs_err']:.4g}, normwise "
          f"{m['l2_rel']:.4g} (SDPA {floor[0]:.4g}, {floor[1]:.4g}); kernel "
          f"{ev['kernel']:.4f} ms (device {dv['kernel']:.4f}), plain "
          f"{ev['plain']:.4f} ms, SDPA {ev['library']:.4f} ms (device "
          f"{dv['library']:.4f}; {ev['kernel'] / ev['library']:.3f}x), bound "
          f"{b_ms:.5f} ms ({b_by})", flush=True)
    return dict(B=B, Hq=Hq, Hkv=Hkv, S=S, d=d, dtype="bf16",
                max_abs_err=m["max_abs_err"], l2_rel=m["l2_rel"],
                library_max_abs_err=floor[0], library_l2_rel=floor[1],
                ms=ev["kernel"], plain_ms=ev["plain"],
                library_ms=ev["library"], device_ms=dv["kernel"],
                library_device_ms=dv["library"], bound_ms=b_ms, bound_by=b_by)


def decode_row(torch, rnd, B, Hq, Hkv, S, d, lens, errs, key) -> dict:
    """The decode kernel on bf16 q (B, Hq, d) against a (B, Hkv, S, d)
    cache with live ``lens``: bit-equal on a rerun, within the bf16
    tolerance of the plain version in fp32, zero-length rows 0; kernel,
    plain-version and SDPA times (events and device) beside the bound."""
    from repro_torch.kernels.flash_attention import ops, ref

    dev = torch.device(DEVICE)
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
    print(f"  flash decode B={B} Hq={Hq} Hkv={Hkv} cache={S} d={d} bf16 "
          f"lengths={lens.tolist()}: max abs err {err:.3g} vs fp32 "
          f"plain; kernel {k_ms:.4f} ms (device {k_dev:.4f}), plain "
          f"{p_ms:.4f} ms, SDPA {l_ms:.4f} ms (device {l_dev:.4f}), "
          f"bound {b_ms:.5f} ms ({b_by})", flush=True)
    return dict(B=B, Hq=Hq, Hkv=Hkv, S=S, d=d, dtype="bf16",
                lengths=lens.tolist(), max_abs_err=err, ms=k_ms,
                plain_ms=p_ms, library_ms=l_ms, device_ms=k_dev,
                library_device_ms=l_dev, bound_ms=b_ms, bound_by=b_by)


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
    out["prefill_d128"] = prefill_row(torch, rnd, B, 16, 8, S, 128, errs)

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
        out[key] = decode_row(torch, rnd, B, Hq, Hkv, S, d, lens, errs, key)

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
    """Least time of one bag call (``bag_ops.bag_cost``)."""
    return bound_of_work(bag_ops.bag_cost(n_live, n_ids, n_bags, D,
                                          weighted))


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


def fmt_logits(cmp: dict) -> str:
    """``lm_compare`` results by compared logits, in one line."""
    return "; ".join(f"{k} max_rel {c['max_rel']:.4g} l2 {c['l2_rel']:.4g}"
                     for k, c in cmp.items())


@contextlib.contextmanager
def checked_flash(torch, calls: list):
    """Within the block, every flash kernel call is held, on its own
    inputs, to the tensor-core bar (``tc_check``: elementwise within rtol
    TC_RTOL + TC_ATOL_REL max|want| of the plain version in fp32 on the same
    bf16 inputs, and max abs and normwise errors at most TC_SDPA_FACTOR
    times SDPA's on them); each call's errors go to ``calls``. The model's
    activations, not random ones: the kernels as the serve path feeds
    them."""
    from repro_torch.kernels.flash_attention import ops, ref

    prefill, decode = ops.flash_attention, ops.flash_decode

    def checked_prefill(q, k, v, *, causal=True, lengths=None):
        out = prefill(q, k, v, causal=causal, lengths=lengths)
        want = per_row(torch, ref.attention_ref)(
            q.float(), k.float(), v.float(), causal=causal, lengths=lengths)
        floor = sdpa_floor(torch, q, k, v, want)
        m = tc_check(torch, out, want, f"prefill call {len(calls)} of the "
                     f"serve path", floor)
        calls.append(dict(kind="prefill", max_abs_err=m["max_abs_err"],
                          l2_rel=m["l2_rel"], library_max_abs_err=floor[0],
                          library_l2_rel=floor[1]))
        return out

    def checked_decode(q, k, v, lengths):
        out = decode(q, k, v, lengths)
        want = ref.decode_ref(q.float(), k.float(), v.float(), lengths)
        live = torch.arange(k.shape[2], device=q.device)[None, :] \
            < lengths[:, None]
        lib = sdpa(torch, q[:, :, None], k, v, causal=False,
                   mask=live[:, None, None])[:, :, 0].float() - want
        floor = (lib.abs().max().item(), (lib.norm() / want.norm()).item())
        m = tc_check(torch, out, want, f"decode call {len(calls)} of the "
                     f"serve path", floor)
        calls.append(dict(kind="decode", max_abs_err=m["max_abs_err"],
                          l2_rel=m["l2_rel"], library_max_abs_err=floor[0],
                          library_l2_rel=floor[1]))
        return out

    ops.flash_attention, ops.flash_decode = checked_prefill, checked_decode
    try:
        yield
    finally:
        ops.flash_attention, ops.flash_decode = prefill, decode


def calls_summary(calls: list) -> dict:
    """Per kind: the calls checked, and the worst error and worst ratio to
    SDPA's on the same inputs."""
    out = {}
    for kind in ("prefill", "decode"):
        rows = [c for c in calls if c["kind"] == kind]
        if rows:
            out[kind] = dict(
                calls=len(rows),
                max_abs_err=max(c["max_abs_err"] for c in rows),
                l2_rel=max(c["l2_rel"] for c in rows),
                max_abs_vs_library=max(c["max_abs_err"] / max(
                    c["library_max_abs_err"], 1e-30) for c in rows),
                l2_vs_library=max(c["l2_rel"] / max(c["library_l2_rel"],
                                                    1e-30) for c in rows))
    return out


@contextlib.contextmanager
def routing_tape(T, tape: list, replay: bool):
    """Within the block, every MoE routing (``T._route``) appends its
    ``gate_idx`` to ``tape`` or, with ``replay``, takes the next one from
    it (the gates then recomputed from this run's probabilities at those
    experts, as ``_route`` computes them). A dense model never routes."""
    route, taken = T._route, iter(tape)

    def taped(x, router, k):
        probs, vals, idx = route(x, router, k)
        if not replay:
            tape.append(idx)
            return probs, vals, idx
        idx = next(taken)
        vals = probs.gather(-1, idx)
        return probs, vals / vals.sum(-1, keepdim=True).clamp_min(1e-9), idx

    T._route = taped
    try:
        yield
    finally:
        T._route = route


def phase_serve_lm(torch, cfg, prompt, gen_len, out_dir, depth) -> dict:
    """An LM arch's serve path (``cfg``, its depth as given; weights drawn
    from a seed at the scale of ``depth`` layers, the full model's):
    prefill, then greedy decode, through the flash kernels, counted; then
    the same model with a plain attention called explicitly, teacher-forced
    on the kernel run's tokens: the JAX package's ``blocked_attention``
    (the comparison) and the kernels' own plain version ``attention_ref``,
    a batch row at a time (the floor: two exact fp32 softmaxes that differ
    only in summation order, run through the same bf16 model); then the
    kernel path again, teacher-forced, every kernel call held on its own
    inputs (``checked_flash``): its logits are the ones compared; then a
    traced window of decode steps.

    An MoE model's routing is a discrete choice like a greedy token: a
    last-bit difference in an attention output can move a token to another
    expert, which moves the logits by far more than the attention's own
    error. So the floor and the held kernel run replay the plain run's
    routing (``routing_tape``), as they replay its tokens."""
    from repro_torch.kernels.flash_attention import ops as flash
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models import transformer as T
    from repro_torch.models.common import blocked_attention, init_from_specs

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(LM_SEED)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.serving_params(
        init_from_specs(T.param_specs(cfg), gen, depth=depth), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
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
    tape, calls = [], []
    with routing_tape(T, tape, replay=False):
        plain = run(blocked_attention, forced=forced)
    with routing_tape(T, tape, replay=True):
        floor = run(per_row(torch, attention_ref), forced=forced)
    with routing_tape(T, tape, replay=True), checked_flash(torch, calls):
        held = run(forced=forced)    # the kernel path, every call held
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

    trace = trace_window(torch, f"lm_decode_{cfg.name}", decode_window,
                         LM_TRACE_STEPS, out_dir)
    return dict(arch=cfg.name, n_layers=L, batch=B, prompt=prompt,
                gen=gen_len, init_s=init_s, init_peak_gb=init_peak_gb,
                prefill_ms=kern["prefill_ms"],
                decode_ms=kern["decode_ms"],
                decode_tok_s=B * gen_len / (kern["decode_ms"] / 1e3),
                plain_prefill_ms=plain["prefill_ms"],
                plain_decode_ms=plain["decode_ms"], peak_gb=peak_gb,
                launches=dict(prefill=lp["prefill"]["prefill"],
                              prefill_wgmma=lp["prefill"]["prefill_wgmma"],
                              decode=sum(lp["steps"]),
                              per_decode_step=lp["steps"][0]),
                logits_vs_plain=compare(held), logits_floor=compare(floor),
                kernel_calls=calls_summary(calls),
                greedy_agreement_teacher_forced=agree, decode_trace=trace,
                param_gb=tree_bytes(params) / 1e9)


def check_lm_logits(lm) -> None:
    """The LM serve bar, on every compared logits (prefill, first and last
    decode step): the kernel path's within LM_FLOOR_FACTOR times the floor
    plus one bf16 unit roundoff of the plain path's, and below LM_L2_CAP."""
    for k, c in lm["logits_vs_plain"].items():
        f = lm["logits_floor"][k]
        if c["l2_rel"] > LM_L2_CAP or any(
                c[m] > LM_FLOOR_FACTOR * f[m] + BF16_UNIT
                for m in ("max_rel", "l2_rel")):
            raise AssertionError(
                f"{lm['arch']}: {k} logits differ from the plain path: "
                f"{c} against the floor {f} (tolerance {LM_FLOOR_FACTOR} x "
                f"floor + {BF16_UNIT}, l2 cap {LM_L2_CAP})")


# ----------------------------------------------------------- DIEN serve
def to_cpu(tree, dtype=None):
    """CPU copies of a tree of tensors (in ``dtype`` if one is given)."""
    if isinstance(tree, dict):
        return {k: to_cpu(v, dtype) for k, v in tree.items()}
    return tree.cpu() if dtype is None else tree.to("cpu", dtype)


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


# ------------------------------------------------ the rest of the serve path
def flash_rows_at(torch, cfg, prompt, gen_len, errs) -> dict:
    """Both flash kernels at an LM arch's serve shapes (its heads, head dim
    and the serve path's B 8 x S prompt prefill and decode against a
    prompt + gen_len cache), as ``prefill_row`` and ``decode_row`` hold
    them."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(4)
    dev = torch.device(DEVICE)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    Hq, Hkv, d, B = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, LM_BATCH
    live = np.linspace(prompt + 1, prompt + gen_len, B).round().astype(int)
    return dict(
        prefill=prefill_row(torch, rnd, B, Hq, Hkv, prompt, d, errs),
        decode=decode_row(torch, rnd, B, Hq, Hkv, prompt + gen_len, d,
                          live.tolist(), errs, cfg.name))


def moe_dispatch_check(torch) -> dict:
    """One full-width dbrx-132b MoE layer in fp32 on B x S tokens with
    capacity factor 8.0 (nothing drops), each matrix drawn from a seed at
    1/sqrt of its input dim (the router and the gate and up experts d_model,
    the down experts d_ff), through the sort and the einsum dispatch: every
    assignment kept by both, outputs within rtol 1e-4 / atol 1e-5 (the JAX
    package's own test of the two). Both call one ``_route`` on the same
    inputs, so their ``gate_idx`` agree by construction; the check that
    they do is one of determinism."""
    from repro_torch.configs import dbrx_132b
    from repro_torch.models import transformer as T

    B, S, cf = MOE_CHECK
    cfg = dataclasses.replace(dbrx_132b.CFG, n_layers=1, capacity_factor=cf,
                              param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(LM_SEED + 1)
    specs = T.param_specs(cfg)["layers"]
    p = {}
    for k in T._MOE_LEAVES:
        shape = specs[k].shape[1:]        # the layer axis (L = 1) dropped
        p[k] = torch.randn(shape, generator=gen, device=DEVICE) \
            / shape[-2] ** 0.5
    x = torch.randn((B, S, cfg.d_model), generator=gen, device=DEVICE)
    out, tape = {}, []
    with routing_tape(T, tape, replay=False):
        for impl, fn in (("sort", T._moe_ffn_sort),
                         ("einsum", T._moe_ffn_einsum)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[impl] = fn(x, p, dataclasses.replace(cfg, moe_impl=impl))
            torch.cuda.synchronize()
            out[impl + "_ms"] = (time.perf_counter() - t0) * 1e3
    idx_sort, idx_einsum = tape
    if not torch.equal(idx_sort, idx_einsum):
        raise AssertionError("dbrx MoE: one routing gave two gate_idx")
    *_, keep_sk = T._dispatch_sort(idx_sort, cfg.n_experts,
                                   T._capacity_sort(cfg, S))
    disp, _ = T._dispatch_einsum(idx_einsum, torch.ones_like(
        idx_einsum, dtype=torch.float32), cfg.n_experts,
        T._capacity_einsum(cfg, S), torch.float32)
    kept_einsum = disp.sum(-1).gather(-1, idx_einsum) > 0
    if not (bool(keep_sk.all()) and bool(kept_einsum.all())):
        raise AssertionError("dbrx MoE: an assignment dropped at capacity "
                             "factor 8.0")
    (ys, aux_s), (ye, aux_e) = out["sort"], out["einsum"]
    torch.testing.assert_close(ys, ye, rtol=1e-4, atol=1e-5)
    res = dict(B=B, S=S, capacity_factor=cf, dtype="fp32",
               max_abs_diff=(ys - ye).abs().max().item(),
               max_abs=ye.abs().max().item(),
               l2_rel=((ys - ye).norm() / ye.norm()).item(),
               aux_sort=aux_s.item(), aux_einsum=aux_e.item(),
               sort_ms=out["sort_ms"], einsum_ms=out["einsum_ms"])
    print(f"  dbrx-132b MoE layer, fp32, B {B} x S {S}, capacity factor {cf}: "
          f"{idx_sort.numel()} choices, none dropped by either dispatch; "
          f"sort vs einsum outputs max abs diff {res['max_abs_diff']:.4g} of "
          f"max |y| {res['max_abs']:.4g}, normwise {res['l2_rel']:.4g} (rtol "
          f"1e-4 / atol 1e-5); aux {res['aux_sort']:.6f} / "
          f"{res['aux_einsum']:.6f}; first call sort {out['sort_ms']:.1f} "
          f"ms, einsum {out['einsum_ms']:.1f} ms", flush=True)
    return res


def retrieval_bound_ms(batch, n_cand, cfg) -> tuple:
    """The candidate half of ``retrieval_score``, whose size grows with the
    candidates: each distinct item and category row the candidates name
    read once (fp32), both id vectors read once, the scores written once;
    two operations per candidate and feature (an add and a multiply-add of
    the matvec), at the fp32 rate. Also the bytes if every candidate's two
    rows were read (no row read twice counted once)."""
    D = cfg.embed_dim
    rows = (batch["cand_items"].unique().numel()
            + batch["cand_cats"].unique().numel())
    nbytes = rows * D * 4 + 2 * n_cand * 4 + n_cand * 4
    ops = 3 * D * n_cand
    every = 2 * n_cand * D * 4 + 2 * n_cand * 4 + n_cand * 4
    return (*bound_of(ops, nbytes), nbytes, every)


def phase_retrieval(torch, out_dir) -> dict:
    """DIEN's ``retrieval_cand`` at its full CFG (1M items, 1,000
    categories): one user against 1,000,000 candidates, RETRIEVAL_CALLS
    calls timed (host clock to a synchronize), p50 and p99; the scores held
    to rtol 1e-4 / atol 1e-5 against the same port function in fp64 on CPU
    copies; one traced call."""
    from repro_torch.configs import dien as dcfg
    from repro_torch.models.common import init_from_specs
    from repro_torch.models.recsys import dien as m

    cfg = dcfg.CFG
    n = dcfg.SHAPE_DEFS["retrieval_cand"]["n_cand"]
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(DIEN_SEED + 1)
    params = init_from_specs(m.param_specs(cfg), gen)
    batch = dcfg.rand_rank_batch(gen, cfg, 1)
    del batch["target_item"], batch["target_cat"]
    batch.update(dcfg.rand_candidates(gen, cfg, n))
    scores = m.retrieval_score(params, batch, cfg)     # warm
    torch.cuda.synchronize()
    lat = []
    for _ in range(RETRIEVAL_CALLS):
        t0 = time.perf_counter()
        scores = m.retrieval_score(params, batch, cfg)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    if scores.shape != (n,) or not torch.isfinite(scores).all():
        raise AssertionError(f"DIEN retrieval: scores {tuple(scores.shape)}, "
                             f"finite {bool(torch.isfinite(scores).all())}")
    want = m.retrieval_score(to_cpu(params, torch.float64), to_cpu(batch),
                             dataclasses.replace(cfg,
                                                 compute_dtype=torch.float64))
    got = scores.cpu().double()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    err = (got - want).abs().max().item()
    trace = trace_window(torch, "dien_retrieval",
                         lambda: m.retrieval_score(params, batch, cfg), 1,
                         out_dir)
    b_ms, b_by, nbytes, every = retrieval_bound_ms(batch, n, cfg)
    lat = np.asarray(lat)
    res = dict(n_cand=n, calls=RETRIEVAL_CALLS,
               p50_ms=float(np.percentile(lat, 50)),
               p99_ms=float(np.percentile(lat, 99)), max_ms=float(lat.max()),
               max_abs_err_vs_fp64=err, max_abs_score=want.abs().max().item(),
               bound_ms=b_ms, bound_by=b_by, bound_bytes=nbytes,
               every_row_bytes=every,
               every_row_bound_ms=bound_of(0, every)[0], trace=trace)
    print(f"  DIEN retrieval_cand: 1 user x {n} candidates, {RETRIEVAL_CALLS} "
          f"calls: p50 {res['p50_ms']:.4f} ms, p99 {res['p99_ms']:.4f} ms; "
          f"scores vs fp64 on the CPU max abs err {err:.3g} (max |score| "
          f"{res['max_abs_score']:.4g}); bound {b_ms:.5f} ms ({b_by}: "
          f"{nbytes / 1e6:.1f} MB, distinct rows once), "
          f"{res['every_row_bound_ms']:.5f} ms reading every candidate's "
          f"rows ({every / 1e6:.1f} MB); traced busy share "
          f"{share_or_not(trace['busy_share'])}", flush=True)
    return res


def phase_serve_rest(torch, prompt, gen_len, card, out_dir, errs) -> dict:
    """The rest of the serve path: dbrx-132b, arctic-480b and
    command-r-plus-104b at their published widths (bf16 weights from a
    seed), depth cut to fit one card (REST_ARCHS), one after another, each
    freed before the next: both flash kernels at the arch's shapes, then
    its serve path as phase 4 runs granite's; then the dbrx MoE layer's two
    dispatches in fp32; then DIEN's retrieval_cand at full size."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T

    out = dict(archs={}, flash={})
    for arch_id, n_layers in REST_ARCHS:
        t0 = time.perf_counter()
        full = get_arch(arch_id).CFG
        cfg = dataclasses.replace(full, n_layers=n_layers)
        out["flash"][arch_id] = flash_rows_at(torch, cfg, prompt, gen_len,
                                              errs)
        gc.collect()
        torch.cuda.empty_cache()
        lm = phase_serve_lm(torch, cfg, prompt, gen_len, out_dir,
                            depth=full.n_layers)
        lm["seconds"] = time.perf_counter() - t0
        lm["depth_cut"] = f"{n_layers} of {full.n_layers} layers"
        moe = (f"{cfg.n_experts} experts top-{cfg.top_k}, prefill capacity "
               f"{T._capacity_sort(cfg, prompt)} a row and expert"
               if cfg.is_moe else "dense")
        print(f"{arch_id} serve on {card}: {lm['depth_cut']} at full width "
              f"(d {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, "
              f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, {moe}), "
              f"{lm['param_gb']:.2f} GB of bf16 weights, peak "
              f"{lm['init_peak_gb']:.2f} GB while drawn and "
              f"{lm['peak_gb']:.2f} GB serving: prefill {lm['batch']} x "
              f"{lm['prompt']} in {lm['prefill_ms']:.3f} ms; {lm['gen']} "
              f"greedy steps in {lm['decode_ms']:.3f} ms = "
              f"{lm['decode_tok_s']:.1f} tokens/s; flash launches "
              f"{lm['launches']}; {lm['seconds']:.1f} s", flush=True)
        print(f"  kernel calls of the serve run, each on its own inputs "
              f"against the fp32 plain version (worst, and worst ratio to "
              f"SDPA's on the same inputs): {lm['kernel_calls']}", flush=True)
        print(f"  logits vs blocked_attention (teacher-forced tokens"
              f"{' and routing' if cfg.is_moe else ''}): kernels "
              f"{fmt_logits(lm['logits_vs_plain'])}; floor (attention_ref) "
              f"{fmt_logits(lm['logits_floor'])}", flush=True)
        check_lm_logits(lm)
        out["archs"][arch_id] = lm
        gc.collect()
        torch.cuda.empty_cache()
    out["moe_dispatch"] = moe_dispatch_check(torch)
    gc.collect()
    torch.cuda.empty_cache()
    out["retrieval"] = phase_retrieval(torch, out_dir)
    return out


# ------------------------------------------------------------- training
def bag_backward_bound_ms(n_live, n_ids, n_bags, V, D, weighted) -> tuple:
    """Least time of one bag backward call (``bag_ops.bag_backward_cost``)."""
    return bound_of_work(bag_ops.bag_backward_cost(n_live, n_ids, n_bags, V,
                                                   D, weighted))


def bag_backward_fp64(torch, g, ids, bags, V, w):
    """On the CPU: the table gradient summed in fp64, each row's sum of
    |w_i * grad_out_i| and its number of terms."""
    n_bags, D = g.shape
    keep = torch.nonzero((ids >= 0) & (ids < V) & (bags >= 0)
                         & (bags < n_bags)).flatten()
    rows = g.double()[bags[keep].long()]
    if w is not None:
        rows = rows * w.double()[keep, None]
    idx = ids[keep].long()
    out = torch.zeros((V, D), dtype=torch.float64).index_add_(0, idx, rows)
    mag = torch.zeros((V, D), dtype=torch.float64).index_add_(0, idx,
                                                             rows.abs())
    return out, mag, torch.bincount(idx, minlength=V).double()[:, None]


def phase_bag_backward(torch, dien_cfg, train_bags, errs) -> dict:
    """The bag's backward kernel against its plain version on CPU copies of
    the same inputs (the wrapper's own CPU path), at tests/test_kernels.py's
    bag shapes and DIEN's (512 bags and ``train_bags`` of 16 ids, D 18, V
    100,000), with padding ids, ids past the table, ids before the first
    bag and empty bags: exact on integer-valued inputs, normal-valued rows
    within n * 2^-24 * sum|w g| of an fp64 sum (n the row's terms), every
    call run twice and bit-equal; then DIEN's profile lookup at batch 512,
    timed beside F.embedding_bag's backward."""
    from repro_torch.kernels.embedding_bag import ops, ref

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(5)
    dev = torch.device(DEVICE)

    def case(V, D, n_ids, n_bags, integer):
        g = torch.randint(-50, 51, (n_bags, D), generator=gen, device=dev
                          ).float() if integer else \
            torch.randn((n_bags, D), generator=gen, device=dev)
        ids = torch.randint(0, V, (n_ids,), generator=gen, device=dev,
                            dtype=torch.int32)
        r = torch.rand(n_ids, generator=gen, device=dev)
        ids[r < 0.15] = -1                                 # padding
        ids[(r >= 0.15) & (r < 0.18)] = V + 1              # past the table
        lead = min(3, n_ids // 4)                          # before any bag
        offs = torch.sort(torch.randint(lead, n_ids + 1, (n_bags,),
                                        generator=gen, device=dev)).values
        offs[0] = lead
        w = torch.randint(-3, 4, (n_ids,), generator=gen, device=dev
                          ).float() if integer else \
            torch.randn((n_ids,), generator=gen, device=dev)
        return g, ids, offs.to(torch.int32), w

    V_d, D_d, nb = dien_cfg.n_profile_feats, dien_cfg.embed_dim, \
        dien_cfg.profile_bag_size
    n_cases = n_equal = 0
    worst_ratio = 0.0
    for V, D, n_ids, n_bags in BAG_SWEEP + [(V_d, D_d, 512 * nb, 512),
                                            (V_d, D_d, train_bags * nb,
                                             train_bags)]:
        for integer in (True, False):
            g, ids, offs, w = case(V, D, n_ids, n_bags, integer)
            for weights in (None, w):
                call = lambda: ops.embedding_bag_backward(
                    g, ids, offs, n_rows=V, weights=weights)
                got, again = call(), call()
                if not torch.equal(got, again):
                    raise AssertionError(f"embedding_bag_backward differs "
                                         f"between two runs (V={V} D={D})")
                got = got.cpu()
                gc_, ic, oc = g.cpu(), ids.cpu(), offs.cpu()
                wc = None if weights is None else weights.cpu()
                want = ops.embedding_bag_backward(gc_, ic, oc, n_rows=V,
                                                  weights=wc)
                n_equal += int(torch.equal(got, want))
                if integer:
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"embedding_bag_backward != plain version on "
                            f"integer inputs (V={V} D={D} n_ids={n_ids})")
                else:
                    exact, mag, n = bag_backward_fp64(
                        torch, gc_, ic, ref.bags_of(oc, n_ids), V, wc)
                    err = (got.double() - exact).abs()
                    bound = n * 2.0 ** -24 * mag
                    if (err > bound).any():
                        raise AssertionError(
                            f"embedding_bag_backward off its fp64 sum by "
                            f"more than n * 2^-24 * sum|x| (V={V} D={D})")
                    live = bound > 0
                    if live.any():
                        worst_ratio = max(worst_ratio, float(
                            (err[live] / bound[live]).max()))
                errs["bag_backward"] = max(errs["bag_backward"],
                                           (got - want).abs().max().item())
                n_cases += 1
    print(f"  embedding bag backward: {n_cases} cases (padding ids, ids past "
          f"the table and before the first bag, empty bags, weighted and "
          f"not; up to {train_bags} bags) bit-equal on a rerun, exact on "
          f"integer inputs, normal sums within {worst_ratio:.3g} of their "
          f"n * 2^-24 * sum|x| bound; {n_equal} of {n_cases} bit-equal to "
          f"the plain version (max abs err {errs['bag_backward']:.3g})",
          flush=True)

    # DIEN's profile lookup at batch 512: 16 ids a user, D 18, mask weights
    B = 512
    g = torch.randn((B, D_d), generator=gen, device=dev)
    ids = torch.randint(0, V_d, (B * nb,), generator=gen, device=dev,
                        dtype=torch.int32)
    offs = torch.arange(B, dtype=torch.int32, device=dev) * nb
    w = (torch.rand((B * nb,), generator=gen, device=dev) < 0.7).float()
    bags = ref.bags_of(offs, B * nb)
    table = torch.randn((V_d, D_d), generator=gen, device=dev,
                        requires_grad=True)
    ids64, offs64 = ids.long(), offs.long()
    F = torch.nn.functional
    lib_fwd = lambda: F.embedding_bag(ids64, table, offs64, mode="sum",
                                      per_sample_weights=w)
    calls = dict(
        kernel=lambda: ops.embedding_bag_backward(g, ids, offs, n_rows=V_d,
                                                  weights=w),
        plain=lambda: ref.embedding_bag_backward_ref(g, ids, bags, V_d,
                                                     weights=w),
        library_fwd=lib_fwd,
        library_fwd_bwd=lambda: torch.autograd.grad(lib_fwd(), table, g))
    ev = {k: cuda_ms(torch, fn) for k, fn in calls.items()}
    dv = {k: device_ms(torch, fn) for k, fn in calls.items()}
    # the kernel alone, without the wrapper's sort and run starts (None
    # where the profiler saw no such kernel)
    try:
        k_dev = device_ms(torch, calls["kernel"],
                          only="embedding_bag_backward_kernel")
    except AssertionError:
        k_dev = None
    lib_ms = ev["library_fwd_bwd"] - ev["library_fwd"]
    lib_dev = dv["library_fwd_bwd"] - dv["library_fwd"]
    n_live = int((w != 0).sum())
    b_ms, b_by = bag_backward_bound_ms(n_live, B * nb, B, V_d, D_d, True)
    print(f"  embedding bag backward at DIEN's shape ({B} bags x {nb} ids, "
          f"D={D_d}, V={V_d}, 70% live), back-to-back event time: wrapper "
          f"(sort, run starts, kernel) {ev['kernel']:.5f} ms, plain "
          f"{ev['plain']:.5f} ms, F.embedding_bag backward (forward + "
          f"backward less forward) {lib_ms:.5f} ms; device time: wrapper "
          f"{dv['kernel']:.5f} (the kernel alone {ms_or_not(k_dev)}), plain "
          f"{dv['plain']:.5f}, library {lib_dev:.5f} ms; bound {b_ms:.6f} "
          f"ms ({b_by})", flush=True)
    return dict(B=B, bag=nb, D=D_d, V=V_d, cases=n_cases,
                bit_equal_to_plain=n_equal, bound_ratio=worst_ratio,
                max_abs_err=errs["bag_backward"], ms=ev["kernel"],
                plain_ms=ev["plain"], library_ms=lib_ms,
                device_ms=dv["kernel"], kernel_device_ms=k_dev,
                plain_device_ms=dv["plain"], library_device_ms=lib_dev,
                bound_ms=b_ms, bound_by=b_by)


def phase_train_lm(torch, card, out_dir) -> dict:
    """granite-3-2b's train_4k at its published width and depth, fp32
    parameters drawn from a seed, bf16 compute, AdamW, accum 4, seq
    4,096, remat full, the fused CE in chunks of 512,
    a global batch of LM_TRAIN_BATCH: one step from the drawn state, the
    state after it moved to the host and the drawn state put back on the
    card, the same step again, required bit-equal in every parameter and
    moment (and loss); then steps to LM_TRAIN_STEPS on the same batch (the
    last one traced), the loss required finite and falling; step time,
    tokens/s, peak memory, the traced step's busy share; the flash
    kernels' launches required unchanged (training attends through
    blocked_attention)."""
    from repro_torch.configs import granite_3_2b
    from repro_torch.kernels.flash_attention import ops as flash
    from repro_torch.train.optimizer import tree_leaves

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cell = granite_3_2b.build_train(batch=LM_TRAIN_BATCH, device=DEVICE,
                                    seed=LM_SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg, step, batch, lr = cell["cfg"], cell["step"], cell["batch"], \
        cell["lr"]
    params, opt_state = cell["params"], cell["opt_state"]
    leaves = tree_leaves((params, opt_state))
    n_params = sum(x.numel() for x in tree_leaves(params))
    state_gb = sum(x.numel() * x.element_size() for x in leaves) / 1e9
    B, S = batch["tokens"].shape
    flash_before = dict(flash.LAUNCHES)

    def one():
        _, _, m = step(params, opt_state, batch, lr)    # in place
        torch.cuda.synchronize()
        return {k: float(v) for k, v in m.items()}

    # the drawn state to pinned host memory
    t0 = time.perf_counter()
    pin = DEVICE == "cuda"
    host = [torch.empty(x.shape, dtype=x.dtype, pin_memory=pin)
            for x in leaves]
    for h, x in zip(host, leaves):
        h.copy_(x, non_blocking=pin)
    torch.cuda.synchronize()
    copy_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    first = one()
    first_ms = (time.perf_counter() - t0) * 1e3
    # the state after step 1 to the host, the drawn state back to the card
    # (stream order: each leaf is read from the host before it is written)
    t0 = time.perf_counter()
    for h, x in zip(host, leaves):
        after = x.clone()
        x.copy_(h, non_blocking=pin)
        h.copy_(after, non_blocking=pin)
        del after
    torch.cuda.synchronize()
    swap_s = time.perf_counter() - t0
    again = one()
    t0 = time.perf_counter()
    differ = [i for i, (h, x) in enumerate(zip(host, leaves))
              if not torch.equal(x, h.to(x.device, non_blocking=pin))]
    compare_s = time.perf_counter() - t0
    del host
    if differ or again != first:
        raise AssertionError(f"two runs of one train step from copies of one "
                             f"state differ: {len(differ)} of {len(leaves)} "
                             f"parameter and moment leaves; metrics {first} "
                             f"vs {again}")
    print(f"  train replay: one granite-3-2b step run twice from copies of "
          f"the drawn state, bit-equal in all {len(leaves)} parameter and "
          f"moment leaves (state {state_gb:.2f} GB; pinned host copy "
          f"{copy_s:.1f} s, swap {swap_s:.1f} s, compare {compare_s:.1f} s)",
          flush=True)
    losses, step_ms = [first["loss"]], []
    for _ in range(LM_TRAIN_STEPS - 2):
        t0 = time.perf_counter()
        m = one()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(m["loss"])
    # the last step traced (device only), its time left out of the p50
    t0 = time.perf_counter()
    trace = trace_window(torch, "train_lm", lambda: losses.append(
        one()["loss"]), 1, out_dir, lean=True)
    trace["seconds"] = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"granite-3-2b's loss on one repeated batch is "
                             f"not finite and falling: {losses}")
    if dict(flash.LAUNCHES) != flash_before:
        raise AssertionError(f"a train step launched the flash kernels: "
                             f"{flash_before} -> {dict(flash.LAUNCHES)}")
    p50 = float(np.median(step_ms))
    out = dict(arch=cfg.name, n_layers=cfg.n_layers, batch=B, seq=S,
               accum=cell["accum"], optimizer=cell["optimizer"].name, lr=lr,
               n_params=n_params, state_gb=state_gb, init_s=init_s,
               first_step_ms=first_ms, step_ms=step_ms, step_p50_ms=p50,
               tokens_per_s=B * S / (p50 / 1e3), peak_gb=peak_gb,
               losses=losses, grad_norm=first["grad_norm"], trace=trace,
               replay_s=dict(copy=copy_s, swap=swap_s, compare=compare_s))
    print(f"granite-3-2b train on {card}: full width and depth, "
          f"{cfg.n_layers} layers ({n_params / 1e9:.3f} B fp32 parameters; "
          f"params + AdamW moments {state_gb:.2f} GB), batch {B} x {S} tokens in "
          f"{out['accum']} microbatches: first step {first_ms:.1f} ms, then "
          f"p50 {p50:.1f} ms = {out['tokens_per_s']:.0f} tokens/s; peak "
          f"{peak_gb:.2f} GB; traced step busy "
          f"{share_or_not(trace['busy_share'])}; losses "
          f"{[round(x, 4) for x in losses]}",
          flush=True)
    return out


def phase_train_dien(torch, card, out_dir) -> dict:
    """DIEN's train_batch at its full CFG: at DIEN_CHECK_BATCH (profiles
    partly masked, one user with none) the loss and every gradient leaf
    of the card's step (both bag kernels) held to the same computation on
    CPU copies (the bag wrapper's plain versions): rtol 1e-4 and atol
    1e-6; then at DIEN_TRAIN_BATCH users DIEN_TRAIN_STEPS AdamW steps, each
    required to launch the bag kernel and its backward exactly once; step
    p50, users/s, peak memory, a traced step's busy share."""
    from repro_torch.configs import dien as dcfg
    from repro_torch.kernels.embedding_bag import ops as bag
    from repro_torch.models.recsys import dien as m
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.trainer import value_and_grad

    cfg = dcfg.CFG
    loss_fn = lambda p, b: m.loss_fn(p, b, cfg)
    small = dcfg.build_train(batch=DIEN_CHECK_BATCH, device=DEVICE,
                             seed=DIEN_SEED + 1)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(DIEN_SEED + 2)
    pm = small["batch"]["profile_mask"]
    pm.copy_(torch.rand(pm.shape, generator=gen, device=DEVICE) < 0.7)
    pm[0] = False
    bag.reset_launches()
    loss, _, grads = value_and_grad(loss_fn, small["params"], small["batch"])
    if bag.LAUNCHES != {"embedding_bag": 1, "embedding_bag_backward": 1}:
        raise AssertionError(f"DIEN's gradient on the card launched "
                             f"{dict(bag.LAUNCHES)}")
    t0 = time.perf_counter()
    cl, _, cg = value_and_grad(loss_fn, to_cpu(small["params"]),
                               to_cpu(small["batch"]))
    cpu_s = time.perf_counter() - t0
    torch.testing.assert_close(loss.cpu(), cl, rtol=1e-4, atol=1e-6)
    worst = 0.0
    for a, b in zip(grads, cg):
        a = a.cpu()
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
        worst = max(worst, float((a - b).abs().max()))
    print(f"  DIEN train at batch {DIEN_CHECK_BATCH}: loss {float(loss):.6f} "
          f"(CPU {float(cl):.6f}); {len(grads)} gradient leaves within rtol "
          f"1e-4 + atol 1e-6 of the CPU copies' (worst abs diff "
          f"{worst:.3g}; CPU step {cpu_s:.1f} s)", flush=True)
    del small, grads, cg
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    batch_size = DIEN_TRAIN_BATCH
    cell = dcfg.build_train(batch=batch_size, device=DEVICE, seed=DIEN_SEED)
    params, opt_state, batch, lr = (cell[k] for k in ("params", "opt_state",
                                                      "batch", "lr"))
    step = cell["step"]

    def one():
        _, _, mm = step(params, opt_state, batch, lr)
        torch.cuda.synchronize()
        return float(mm["loss"])

    t0 = time.perf_counter()
    losses = [one()]                      # warm
    first_ms = (time.perf_counter() - t0) * 1e3
    bag.reset_launches()
    step_ms = []
    for _ in range(DIEN_TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(one())
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = dict(bag.LAUNCHES)
    want = {"embedding_bag": DIEN_TRAIN_STEPS,
            "embedding_bag_backward": DIEN_TRAIN_STEPS}
    if launches != want:
        raise AssertionError(f"DIEN's {DIEN_TRAIN_STEPS} train steps launched "
                             f"{launches}, want {want}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not np.isfinite(losses).all():
        raise AssertionError(f"DIEN's train loss is not finite: {losses}")
    if not all(bool(torch.isfinite(x).all()) for x in tree_leaves(params)):
        raise AssertionError("DIEN's parameters are not finite")
    trace = trace_window(torch, "train_dien", lambda: step(
        params, opt_state, batch, lr), 1, out_dir, lean=True)
    p50 = float(np.median(step_ms))
    out = dict(batch=batch_size, steps=DIEN_TRAIN_STEPS, launches=launches,
               first_step_ms=first_ms, step_ms=step_ms, step_p50_ms=p50,
               users_per_s=batch_size / (p50 / 1e3), peak_gb=peak_gb,
               losses=losses, check_batch=DIEN_CHECK_BATCH,
               check_worst_abs=worst, trace=trace)
    print(f"DIEN train on {card}: full CFG, batch {batch_size}: first step "
          f"{first_ms:.1f} ms, then p50 {p50:.1f} ms = "
          f"{out['users_per_s']:.0f} users/s; peak {peak_gb:.2f} GB; "
          f"traced step busy {share_or_not(trace['busy_share'])}; bag "
          f"launches {launches}; losses {[round(x, 4) for x in losses]}",
          flush=True)
    return out


def phase_train_launcher(torch, archs=TRAIN_ARCHS,
                         replay: str = "granite-3-2b") -> dict:
    """``repro_torch.launch.train`` on the card: each of ``archs``' reduced
    train cell for LAUNCH_STEPS steps under the fault-tolerant runner
    (checkpoints every 2 steps into a temporary directory under build/,
    removed at exit), losses required finite; then ``replay`` again with a
    failure injected at LAUNCH_FAIL_AT, required to end bit-equal, in
    parameters and optimizer state, to its uninterrupted run."""
    import tempfile

    from repro_torch.launch import train as launcher
    from repro_torch.train.optimizer import tree_leaves

    out, states = {}, {}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        for arch_id in tuple(archs) + (replay,):
            fail_at = LAUNCH_FAIL_AT if arch_id in states else None
            t0 = time.perf_counter()
            state, report, shape = launcher.train(
                arch_id, steps=LAUNCH_STEPS, lr=1e-3,
                ckpt_dir=os.path.join(d, f"{arch_id}-{fail_at}"),
                ckpt_every=2, fail_at=fail_at, device=DEVICE)
            torch.cuda.synchronize()
            key = arch_id if fail_at is None else f"{arch_id} fail_at"
            out[key] = dict(shape=shape, steps_run=report.steps_run,
                            restarts=report.restarts,
                            checkpoints=report.checkpoints,
                            losses=report.losses,
                            seconds=time.perf_counter() - t0)
            if not np.isfinite(report.losses).all():
                raise AssertionError(f"launcher {arch_id}: loss not finite "
                                     f"{report.losses}")
            if fail_at is None:
                states[arch_id] = tree_leaves(state)
                continue
            if report.restarts != 1:
                raise AssertionError(f"launcher {arch_id}: the injected "
                                     f"failure gave {report.restarts} "
                                     f"restarts")
            ref_leaves = states[arch_id]
            leaves = tree_leaves(state)
            if len(leaves) != len(ref_leaves) or not all(
                    torch.equal(a, b) for a, b in zip(leaves, ref_leaves)):
                raise AssertionError(f"launcher {arch_id}: the run with a "
                                     f"failure at step {fail_at} does not "
                                     f"end bit-equal to the uninterrupted "
                                     f"run")
    runs = ", ".join(f"{k} {v['seconds']:.1f} s" for k, v in out.items())
    print(f"  launcher ({LAUNCH_STEPS} steps each): {runs}; the run with a "
          f"failure at step {LAUNCH_FAIL_AT} ends bit-equal to the "
          f"uninterrupted one", flush=True)
    return out


def phase_train(torch, card, out_dir, errs) -> dict:
    """Phase 11, training: the bag's backward kernel, granite-3-2b's
    full-width train step, DIEN's at its full CFG, the launcher."""
    from repro_torch.configs import dien as dien_configs

    parts = {}
    out = {}
    for name, run in (
            ("bag_backward", lambda: phase_bag_backward(
                torch, dien_configs.CFG, DIEN_TRAIN_BATCH, errs)),
            ("lm", lambda: phase_train_lm(torch, card, out_dir)),
            ("dien", lambda: phase_train_dien(torch, card, out_dir)),
            ("launcher", lambda: phase_train_launcher(torch))):
        t0 = time.perf_counter()
        out[name] = run()
        parts[name] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    out["seconds_by_part"] = parts
    rounded = {k: round(v, 1) for k, v in parts.items()}
    print(f"phase 11 seconds by part: {rounded}", flush=True)
    return out


# ------------------------------------------------------------ phase 12: GNNs
def gnn_bound_ms(plan, F: int) -> tuple[float, str]:
    """Least time of one graph-entry call (``seg_ops.graph_cost``)."""
    return bound_of_work(seg_ops.graph_cost(plan.seg.shape[1], plan.n_live,
                                            plan.n_rows, F))


def gnn_fp64_sum(torch, x, plan):
    """The plan's reduce of ``x`` in fp64, and each row's n * 2^-24 *
    sum|x| (the reordered-sum bound of phases 2 and 6), on x's device."""
    idx, xd = plan.index, x.double()
    if plan.live is not None:
        keep = plan.live.nonzero()[:, 0]
        idx, xd = idx[keep], xd[keep]
    z = torch.zeros((plan.n_rows, x.shape[1]), dtype=torch.float64,
                    device=x.device)
    want = z.index_add(0, idx, xd)
    absum = z.index_add(0, idx, xd.abs())
    n = torch.bincount(idx, minlength=plan.n_rows).double()[:, None]
    return want, n * 2.0 ** -24 * absum


def gnn_kernel_row(torch, ops, ref, name: str, plan, F: int, op: str,
                   errs: dict, *, cpu: bool, seed: int,
                   bf16_cast: bool = False, profile: bool = False) -> dict:
    """The graph entry on ``plan`` at F features, op sum or max, against
    its plain version: bit-equal on a rerun; exact on integer values (sum)
    and for max, against the plain version on the card and, with ``cpu``,
    on CPU copies; normal sums within n * 2^-24 * sum|x| a row of an fp64
    sum; the gather over the plan, whose backward is this reduce, checked
    through autograd. Timed (CUDA events) beside the bound, the plain
    version and the library call (index_add_ for sum, scatter_reduce_
    amax for max) on the same values; with ``bf16_cast`` the casts the
    bf16 path adds (edge values to fp32, rows back to bf16)."""
    dev = plan.seg.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    E, n = plan.n_edges, plan.n_rows
    xi = torch.randint(-8, 9, (E, F), generator=gen, device=dev).float()
    xn = torch.randn((E, F), generator=gen, device=dev)
    worst = 0.0
    for x, exact in ((xi, True), (xn, op == "max")):
        got = ops.segment_agg_graph(x, plan, op)
        if not torch.equal(got, ops.segment_agg_graph(x, plan, op)):
            raise AssertionError(f"{name}: two launches differ")
        plain = ref.segment_agg_graph_ref(x, plan.index, plan.live, n, op)
        if exact:
            if not torch.equal(got, plain):
                raise AssertionError(f"{name}: {op} differs from the plain "
                                     f"version (exact)")
        else:
            want, bar = gnn_fp64_sum(torch, x, plan)
            err = (got.double() - want).abs()
            if bool((err > bar).any()):
                raise AssertionError(f"{name}: a sum is past n * 2^-24 * "
                                     f"sum|x| of fp64 (worst "
                                     f"{float((err - bar).max()):.3g})")
            worst = max(worst, float((got - plain).abs().max()))
        if cpu:
            xc = x.cpu()
            pc = ref.segment_agg_graph_ref(
                xc, plan.index.cpu(), None if plan.live is None
                else plan.live.cpu(), n, op)
            gc_ = got.cpu()
            if exact and not torch.equal(gc_, pc):
                raise AssertionError(f"{name}: {op} differs from the plain "
                                     f"version on CPU copies")
            if not exact:
                want, bar = gnn_fp64_sum(torch, xc, ops.make_edge_plan(
                    plan.index.cpu(), n, None if plan.live is None
                    else plan.live.cpu()))
                if bool(((gc_.double() - want).abs() > bar).any()):
                    raise AssertionError(f"{name}: a sum is past the bound "
                                         f"against CPU copies")
                worst = max(worst, float((gc_ - pc).abs().max()))
    if op == "sum":   # the gather's backward is this reduce
        h = torch.zeros((n, F), device=dev, requires_grad=True)
        ops.graph_gather(h, plan).backward(xi)
        if not torch.equal(h.grad, ops.segment_agg_graph(xi, plan, "sum")):
            raise AssertionError(f"{name}: the gather's backward is not the "
                                 f"graph entry's sum")
    key = f"{op}_gnn"
    errs[key] = max(errs.get(key, 0.0), worst)
    ms = cuda_ms(torch, lambda: ops.segment_agg_graph(xn, plan, op))
    plain_ms = cuda_ms(torch, lambda: ref.segment_agg_graph_ref(
        xn, plan.index, plan.live, n, op), reps=5)
    xl, il = xn, plan.index
    if plan.live is not None:
        keep = plan.live.nonzero()[:, 0]
        xl, il = xn[keep], plan.index[keep]
    if op == "sum":
        lib = lambda: torch.zeros((n, F), device=dev).index_add_(0, il, xl)
    else:
        ix = il[:, None].expand(-1, F)
        lib = lambda: torch.full((n, F), float("-inf"), device=dev) \
            .scatter_reduce_(0, ix, xl, reduce="amax")
    library_ms = cuda_ms(torch, lib)
    bound, by = gnn_bound_ms(plan, F)
    row = dict(name=name, op=op, F=F, edges=E, live=plan.n_live, rows=n,
               slots=int(plan.seg.shape[1]), blocks=int(plan.tob.shape[1]),
               max_abs_err=worst, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=bound, bound_by=by)
    if bf16_cast:
        xb = xn.to(torch.bfloat16)
        out = ops.segment_agg_graph(xn, plan, op)
        row["cast_ms"] = cuda_ms(torch, lambda: xb.to(torch.float32)) \
            + cuda_ms(torch, lambda: out.to(torch.bfloat16))
    if profile:
        row["device_ms"] = device_ms_or_none(
            torch, lambda: ops.segment_agg_graph(xn, plan, op))
        row["library_device_ms"] = device_ms_or_none(torch, lib)
    print(f"  {name}: {op} F {F}, {plan.n_live} live edges into {n} rows: "
          f"kernel {ms:.4f} ms (bound {bound:.4f} ms, {by}), plain "
          f"{plain_ms:.4f} ms, library {library_ms:.4f} ms"
          + (f", bf16 casts {row['cast_ms']:.4f} ms" if bf16_cast else "")
          + f"; rerun bit-equal, exact on integers"
          + (", max exact" if op == "max" else
             f", normal sums within the fp64 bound (vs plain {worst:.3g})"),
          flush=True)
    return row


def gnn_scratch_bytes(ops) -> int:
    """Bytes the fused entries' scratch holds on every (device, stream)."""
    return sum(b.numel() * b.element_size() for bufs in ops._SCRATCH.values()
               for b in bufs if b is not None)


def batch_to_cpu(batch, float_dtype=None):
    """CPU copies of a GNN batch (a dataclass or a dict of tensors), its
    floating tensors in ``float_dtype`` if one is given."""
    import torch

    def put(t):
        return t.to("cpu", float_dtype) if float_dtype is not None \
            and t.is_floating_point() else t.cpu()

    if dataclasses.is_dataclass(batch):
        return dataclasses.replace(batch, **{
            f.name: put(getattr(batch, f.name))
            for f in dataclasses.fields(batch)
            if torch.is_tensor(getattr(batch, f.name))})
    return {k: put(v) for k, v in batch.items()}


def gnn_vs_cpu(torch, name, loss_fn, params, batch, loss_fn64=None) -> dict:
    """The loss and every gradient leaf of one step on the card against the
    same computation on CPU copies (the graph entry's plain version): the
    loss within rtol 1e-4; each gradient leaf within rtol 1e-4 and atol
    max(1e-6, 1e-4 of the leaf's largest magnitude), phase 11's bar. With
    ``loss_fn64`` (the model in fp64, run on fp64 CPU copies) the
    gradients are held instead to the fp32 floor: each leaf's distance
    from fp64 at most twice the CPU copies' own plus 1e-4 of its largest
    magnitude (a deep model whose fp32 gradients, on any device, sit
    farther from fp64 than the fixed bar)."""
    from repro_torch.train.trainer import value_and_grad

    loss, _, grads = value_and_grad(loss_fn, params, batch)
    t0 = time.perf_counter()
    cl, _, cg = value_and_grad(loss_fn, to_cpu(params), batch_to_cpu(batch))
    cpu_s = time.perf_counter() - t0
    torch.testing.assert_close(loss.cpu(), cl, rtol=1e-4, atol=0.0)
    ref64 = None
    if loss_fn64 is not None:
        _, _, ref64 = value_and_grad(loss_fn64,
                                     to_cpu(params, torch.float64),
                                     batch_to_cpu(batch, torch.float64))
    worst, worst_leaf, ratios = 0.0, None, []
    for i, (a, b) in enumerate(zip(grads, cg)):
        a = a.cpu()
        scale = float(b.abs().max())
        if ref64 is None:
            torch.testing.assert_close(a, b, rtol=1e-4,
                                       atol=max(1e-6, 1e-4 * scale))
            rel = float((a - b).abs().max()) / max(scale, 1e-30)
        else:
            d = ref64[i]
            s64 = max(float(d.abs().max()), 1e-30)
            card = float((a.double() - d).abs().max())
            cpu = float((b.double() - d).abs().max())
            if card > 2 * cpu + 1e-4 * s64:
                raise AssertionError(
                    f"{name}: gradient leaf {i} {tuple(d.shape)} sits "
                    f"{card / s64:.3g} of its largest from fp64, the CPU "
                    f"copies' {cpu / s64:.3g}")
            ratios.append(card / max(cpu, 1e-300))
            rel = card / s64
        if rel >= worst:
            worst, worst_leaf = rel, i
    bar = ("rtol 1e-4 + max(1e-6, 1e-4 of the leaf's largest magnitude) "
           "of the CPU copies'" if ref64 is None else
           f"twice the CPU copies' distance from fp64 (largest ratio "
           f"{max(ratios):.3g})")
    print(f"  {name} against CPU copies: loss {float(loss):.6f} (CPU "
          f"{float(cl):.6f}); {len(grads)} gradient leaves within {bar}; "
          f"worst {worst:.3g} of a leaf's largest (leaf {worst_leaf}); CPU "
          f"{cpu_s:.1f} s", flush=True)
    return dict(loss=float(loss), cpu_loss=float(cl), worst_rel=worst,
                worst_leaf=worst_leaf, leaves=len(grads), cpu_s=cpu_s,
                fp64_ratio_max=max(ratios) if ratios else None)


def gnn_cell(torch, ops, name, cell, out_dir, *, steps: int,
             trace: bool = False, want_launches: dict | None = None,
             falling: bool = False) -> dict:
    """A GNN train cell on the card: one step from the built state, the
    state after it kept, the built state put back and the step run again,
    required bit-equal in every parameter and moment; its segment launches
    counted (and required equal to ``want_launches`` where given, else
    above zero); then ``steps`` more steps on the same batch, timed (p50),
    the loss finite (and with ``falling`` lower at the end than at the
    start); peak memory; with ``trace`` one traced step's busy share and
    device time by kernel."""
    from repro_torch.train.optimizer import tree_leaves

    step, batch, lr = cell["step"], cell["batch"], cell["lr"]
    params, opt_state = cell["params"], cell["opt_state"]
    leaves = tree_leaves((params, opt_state))

    def one():
        _, _, m = step(params, opt_state, batch, lr)
        torch.cuda.synchronize()
        return {k: float(v) for k, v in m.items()}

    saved = [x.clone() for x in leaves]
    ops.reset_launches()
    t0 = time.perf_counter()
    first = one()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = {k: ops.LAUNCHES[k] for k in ("sum_gnn", "max_gnn")}
    after = [x.clone() for x in leaves]
    for x, s in zip(leaves, saved):
        x.copy_(s)
    del saved
    again = one()
    differ = [i for i, (x, a) in enumerate(zip(leaves, after))
              if not torch.equal(x, a)]
    del after
    if differ or again != first:
        raise AssertionError(f"{name}: two runs of one train step from "
                             f"copies of one state differ in {len(differ)} "
                             f"of {len(leaves)} leaves; {first} vs {again}")
    if want_launches is not None and launches != want_launches:
        raise AssertionError(f"{name}: a step launched {launches}, the code "
                             f"predicts {want_launches}")
    if launches["sum_gnn"] + launches["max_gnn"] <= 0:
        raise AssertionError(f"{name}: a step launched no segment kernel")
    losses, step_ms = [first["loss"], again["loss"]], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(one()["loss"])
        step_ms.append((time.perf_counter() - t0) * 1e3)
    out = dict(first_step_ms=first_ms, step_ms=step_ms,
               step_p50_ms=float(np.median(step_ms)), losses=losses,
               launches_per_step=launches, replay_leaves=len(leaves),
               grad_norm=first["grad_norm"])
    if trace:
        out["trace"] = trace_window(torch, f"train_{name}", lambda: losses
                                    .append(one()["loss"]), 1, out_dir,
                                    lean=True)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if not np.isfinite(losses).all():
        raise AssertionError(f"{name}: loss not finite: {losses}")
    if falling and not losses[-1] < losses[0]:
        raise AssertionError(f"{name}: the loss on one repeated batch does "
                             f"not fall: {losses}")
    return out


def graphcast_launches(cfg) -> dict:
    """The segment launches of one GraphCast train step: the forward sums
    once into the mesh (encoder), once a processor layer and once into the
    grid (decoder); the backward recomputes each processor layer's sum and
    reduces once for each of the two gathers of every block; no max."""
    L = cfg.n_layers
    return {"sum_gnn": (1 + L + 1) + L + 2 * (L + 2), "max_gnn": 0}


def phase_gnn(torch, card, out_dir, errs) -> dict:
    """Phase 12, the GNNs: the graph entry at each cell's edge sets;
    graphcast's minibatch_lg at full width and depth, then its strict bar
    in fp32; gat-cora and gatedgcn at minibatch_lg, nequip at molecule;
    the launcher on every GNN's reduced cell."""
    from repro_torch.configs import gat_cora, gatedgcn, graphcast, nequip
    from repro_torch.kernels.segment_agg import ops, ref
    from repro_torch.models.gnn import gat as gat_m
    from repro_torch.models.gnn import gatedgcn as gg_m
    from repro_torch.models.gnn import graphcast as gc_m
    from repro_torch.models.gnn import nequip as nq_m
    from repro_torch.train.optimizer import tree_leaves

    parts, out, rows = {}, {}, []

    # ---- graphcast minibatch_lg at full width and depth
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = graphcast.CFG
    cell = graphcast.build_train("minibatch_lg", cfg=cfg, device=DEVICE,
                                 seed=GNN_SEED)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    b = cell["batch"]
    G, M = b.grid_x.shape[0], cfg.n_mesh
    sets = {"graphcast mesh": (b.mesh_src, b.mesh_dst, M, M),
            "graphcast grid2mesh": (b.g2m_src, b.g2m_dst, G, M),
            "graphcast mesh2grid": (b.m2g_src, b.m2g_dst, M, G)}
    t1 = time.perf_counter()
    for i, (name, (src, dst, n_src, n_dst)) in enumerate(sets.items()):
        rows.append(gnn_kernel_row(
            torch, ops, ref, f"{name} (sum into dst)",
            ops.edge_plan(dst, n_dst), cfg.d_hidden, "sum", errs, cpu=False,
            seed=GNN_SEED + i, bf16_cast=True, profile=i == 0))
        rows.append(gnn_kernel_row(
            torch, ops, ref, f"{name} (gather backward into src)",
            ops.edge_plan(src, n_src), cfg.d_hidden, "sum", errs, cpu=False,
            seed=GNN_SEED + 10 + i))
    parts["graphcast kernels"] = time.perf_counter() - t1
    n_params = sum(x.numel() for x in tree_leaves(cell["params"]))
    gc_run = gnn_cell(torch, ops, "graphcast", cell, out_dir,
                      steps=GNN_STEPS, trace=True,
                      want_launches=graphcast_launches(cfg), falling=True)
    gc_run.update(build_s=build_s, n_params=n_params, grid=G, mesh=M,
                  edges=dict(g2m=int(b.g2m_src.shape[0]),
                             mesh=int(b.mesh_src.shape[0]),
                             m2g=int(b.m2g_src.shape[0])),
                  scratch_gb=gnn_scratch_bytes(ops) / 1e9)
    tr = gc_run["trace"]
    gc_run["segment_share"] = None if tr["device_ms"] is None \
        else tr["segment_ms"] / tr["device_ms"]
    print(f"graphcast train on {card}: minibatch_lg at full width and depth "
          f"({cfg.n_layers} processor layers, d {cfg.d_hidden}, refinement "
          f"{cfg.mesh_refinement}: {M} mesh nodes, {b.mesh_src.shape[0]} "
          f"mesh edges; grid {G}, {b.g2m_src.shape[0]} edges each way; "
          f"{n_params / 1e6:.2f} M fp32 parameters, bf16 compute): first "
          f"step {gc_run['first_step_ms']:.1f} ms, then p50 "
          f"{gc_run['step_p50_ms']:.1f} ms; peak {gc_run['peak_gb']:.2f} "
          f"GB; traced step busy {share_or_not(tr['busy_share'])}, "
          f"segment kernel {ms_or_not(tr['segment_ms'])} ms = "
          f"{share_or_not(gc_run['segment_share'])} of device time; "
          f"launches a step {gc_run['launches_per_step']}; "
          f"segment scratch {gc_run['scratch_gb']:.3f} GB; losses "
          f"{[round(x, 5) for x in gc_run['losses']]}", flush=True)
    del cell, b, sets
    gc.collect()
    torch.cuda.empty_cache()
    parts["graphcast"] = time.perf_counter() - t0

    # ---- the strict bar at full width: fp32, 2 processor layers,
    # refinement 3, full_graph_sm's grid
    t0 = time.perf_counter()
    strict_cfg = dataclasses.replace(cfg, compute_dtype=torch.float32,
                                     **GNN_STRICT)
    cell = graphcast.build_train("full_graph_sm", cfg=strict_cfg,
                                 device=DEVICE, seed=GNN_SEED + 1)
    strict = gnn_vs_cpu(torch, "graphcast strict bar (fp32, d 512, 227 "
                        "vars, 2 layers, refinement 3, 2,708-node grid)",
                        lambda p, bb: gc_m.loss_fn(p, bb, strict_cfg),
                        cell["params"], cell["batch"])
    del cell
    parts["graphcast strict"] = time.perf_counter() - t0
    out["graphcast"] = dict(gc_run, strict=strict)

    # ---- gat-cora and gatedgcn at minibatch_lg, nequip at molecule
    for arch, mod, model, shape in (
            ("gat-cora", gat_cora, gat_m, "minibatch_lg"),
            ("gatedgcn", gatedgcn, gg_m, "minibatch_lg"),
            ("nequip", nequip, nq_m, "molecule")):
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        cell = mod.build_train(shape, device=DEVICE, seed=GNN_SEED)
        ccfg, batch = cell["cfg"], cell["batch"]
        if arch == "nequip":
            loss_fn = lambda p, bb: model.loss_fn(p, bb, ccfg)
            n, dst, F = batch["positions"].shape[0], batch["edge_dst"], \
                ccfg.d_hidden
            gid, n_g = batch["graph_ids"], batch["energy_targets"].shape[0]
            plan = ops.edge_plan(dst, n)
            for i, l in enumerate(ccfg.ls):
                rows.append(gnn_kernel_row(
                    torch, ops, ref, f"nequip molecule l={l}", plan,
                    F * (2 * l + 1), "sum", errs, cpu=True,
                    seed=GNN_SEED + 20 + i))
            rows.append(gnn_kernel_row(
                torch, ops, ref, "nequip readout", ops.edge_plan(gid, n_g),
                1, "sum", errs, cpu=True, seed=GNN_SEED + 30))
        else:
            loss_fn = lambda p, bb, ccfg=ccfg, model=model: model.loss_fn(
                p, bb, ccfg)
            if arch == "gat-cora":
                plan = ops.edge_plan(batch.edge_dst, batch.x.shape[0],
                                     batch.edge_mask)
                H = ccfg.n_heads
                rows.append(gnn_kernel_row(
                    torch, ops, ref, "gat-cora minibatch_lg (softmax max)",
                    plan, H, "max", errs, cpu=True, seed=GNN_SEED + 40,
                    profile=True))
                rows.append(gnn_kernel_row(
                    torch, ops, ref, "gat-cora minibatch_lg (messages)",
                    plan, H * ccfg.d_hidden, "sum", errs, cpu=True,
                    seed=GNN_SEED + 41))
        if arch == "gatedgcn":
            # 16 layers: fp32 gradients sit 0.1-1% of a leaf's largest from
            # fp64 on the card and on the CPU alike; held to that floor on
            # full_graph_sm (the CPU's fp32 and fp64 passes at 169,984
            # nodes would take ~80 s of the host)
            small = mod.build_train("full_graph_sm", device=DEVICE,
                                    seed=GNN_SEED + 2)
            scfg = small["cfg"]
            scfg64 = dataclasses.replace(scfg, compute_dtype=torch.float64)
            check = gnn_vs_cpu(
                torch, f"{arch} full_graph_sm (published config)",
                lambda p, bb: model.loss_fn(p, bb, scfg), small["params"],
                small["batch"],
                loss_fn64=lambda p, bb: model.loss_fn(p, bb, scfg64))
            del small
        elif arch == "nequip":
            # its forces' gradients (a gradient of a gradient over energies
            # of ~1e5 a molecule at this random init) meet the same floor
            cfg64 = dataclasses.replace(ccfg, compute_dtype=torch.float64)
            check = gnn_vs_cpu(
                torch, f"{arch} {shape}", loss_fn, cell["params"], batch,
                loss_fn64=lambda p, bb: model.loss_fn(p, bb, cfg64))
        else:
            check = gnn_vs_cpu(torch, f"{arch} {shape}", loss_fn,
                               cell["params"], batch)
        run = gnn_cell(torch, ops, arch, cell, out_dir, steps=GNN_TIMED,
                       trace=True)
        run.update(check=check, shape=shape, build_s=0.0)
        print(f"{arch} train on {card}: {shape} at its published config: "
              f"first step {run['first_step_ms']:.1f} ms, then p50 "
              f"{run['step_p50_ms']:.1f} ms; peak {run['peak_gb']:.2f} GB; "
              f"traced step busy {share_or_not(run['trace']['busy_share'])}; "
              f"launches a step {run['launches_per_step']}; losses "
              f"{[round(x, 5) for x in run['losses']]}", flush=True)
        out[arch] = run
        del cell, batch
        gc.collect()
        torch.cuda.empty_cache()
        parts[arch] = time.perf_counter() - t0

    # ---- the launcher on every GNN's reduced cell, one run replayed
    t0 = time.perf_counter()
    out["launcher"] = phase_train_launcher(torch, GNN_ARCHS, "gatedgcn")
    parts["launcher"] = time.perf_counter() - t0
    out["kernel_rows"] = rows
    out["launches"] = {k: sum(out[a]["launches_per_step"][k]
                              for a in GNN_ARCHS)
                       for k in ("sum_gnn", "max_gnn")}
    out["seconds_by_part"] = parts
    rounded = {k: round(v, 1) for k, v in parts.items()}
    print(f"phase 12 seconds by part: {rounded}", flush=True)
    return out


# ------------------------------------------------------ phase 13: cell tools
def kernel_launches() -> dict:
    """Every kernel module's ``LAUNCHES``, by module name."""
    return {"segment_agg": dict(seg_ops.LAUNCHES),
            "flash_attention": dict(flash_ops.LAUNCHES),
            "embedding_bag": dict(bag_ops.LAUNCHES)}


def reset_kernel_counts() -> None:
    for m in (seg_ops, flash_ops, bag_ops):
        m.reset_launches()


def lm_cell_counts(arch_id: str, shape: str, reduced: dict) -> dict:
    """The flash kernels' counts of one step of an LM serve cell from the
    shapes alone: one call a layer (``flash_ops.prefill_cost`` /
    ``decode_cost``; decode counts every cache row)."""
    from repro_torch.configs import get_arch

    mod = get_arch(arch_id)
    cfg = mod.CFG
    d = mod.SHAPE_DEFS[shape]
    B, S, L = reduced.get("batch", d["batch"]), d["seq"], \
        reduced.get("n_layers", cfg.n_layers)
    es = cfg.compute_dtype.itemsize
    if d["kind"] == "prefill":
        key, w = "prefill", flash_ops.prefill_cost(
            B, cfg.n_heads, cfg.n_kv_heads, S, S, cfg.head_dim, True, es)
    else:
        key, w = "decode", flash_ops.decode_cost(
            B, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, B * S, es)
    return {"flash_attention": {key: dict(calls=L, ops=L * w.ops,
                                          bytes=L * w.bytes)}}


def compress_check(torch) -> dict:
    """``compress_with_feedback`` over ``COMPRESS_STEPS`` seeded steps on
    the card and on the CPU: every dequantized gradient and error state
    bit-equal."""
    from repro_torch.distributed import compression as C

    rng = np.random.default_rng(13)
    steps = [{"w": rng.standard_normal((256, 96), dtype=np.float32) * 0.01,
              "b": {"x": rng.standard_normal(1000, dtype=np.float32)}}
             for _ in range(COMPRESS_STEPS)]

    def run(dev):
        def put(t):
            return {k: put(v) for k, v in t.items()} if isinstance(t, dict) \
                else torch.as_tensor(t, device=dev)
        err = C.init_error_state(put(steps[0]))
        outs = []
        for g in steps:
            cg, err = C.compress_with_feedback(put(g), err)
            outs.append((cg, err))
        return outs

    card, cpu = run(DEVICE), run("cpu")
    n = 0
    for (cg_a, e_a), (cg_b, e_b) in zip(card, cpu):
        for a, b in ((cg_a["w"], cg_b["w"]), (cg_a["b"]["x"], cg_b["b"]["x"]),
                     (e_a["w"], e_b["w"]), (e_a["b"]["x"], e_b["b"]["x"])):
            if not torch.equal(a.cpu(), b):
                raise AssertionError("compress_with_feedback differs between "
                                     "the card and the CPU")
            n += 1
    return dict(steps=COMPRESS_STEPS, tensors_equal=n)


def phase_cells(torch, card, out_dir) -> dict:
    """Phase 13: the cell tools. (a) every assigned cell (and eagr's reduced
    cell: its full engine's host compile takes minutes) built on the meta
    device, the card's allocation unmoved; (b) ``CELL_RUNS`` measured by
    the dry run, each cut by the dry run's ``fit`` (one counted step,
    ``CELL_REPEATS`` timed),
    each launching its kernels and 0 < mfu <= 1, and the roofline table;
    (c) the kernels' counts of each cell's smoke step on the card equal to
    the CPU's, of ``CELL_CPU_COUNTED``'s measured steps too, the LM cells'
    equal to the per-call formulas, and int8 compression bit-equal."""
    from repro_torch.configs import all_cells, get_arch
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.mesh import make_production_mesh

    parts, out = {}, {}
    t_part = time.perf_counter()

    def lap(part: str) -> None:
        nonlocal t_part
        parts[part] = time.perf_counter() - t_part
        t_part = time.perf_counter()

    mesh = make_production_mesh()
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (a) every cell on the meta device
    before = torch.cuda.memory_allocated()
    dry = [dryrun.run_cell(a, s, mesh) for a, s in all_cells()]
    dry.append(dryrun.run_cell("eagr", "stream_mixed", mesh, smoke=True))
    after = torch.cuda.memory_allocated()
    if after != before:
        raise AssertionError(f"the meta builds moved the card's allocation: "
                             f"{before} -> {after} bytes")
    for r in dry:
        print(f"  cell {r['arch']:20s} {r['shape']:15s} args "
              f"{r['arg_bytes'] / 1e9:9.3f} GB, per device on 16x16 "
              f"{r['per_device_arg_bytes'] / 1e9:8.4f} GB, model_flops "
              f"{r['model_flops'] or 0:.4e}, fits one card "
              f"{r['fits_one_card']}", flush=True)
    out["meta"] = dict(cells=dry, allocated_before=before,
                       allocated_after=after)
    lap("meta builds")

    # ---- (b) the measured cells
    recs = []
    for arch_id, shape, want in CELL_RUNS:
        gc.collect()
        torch.cuda.empty_cache()
        reset_kernel_counts()
        t0 = time.perf_counter()
        rec = dryrun.run_cell(arch_id, shape, mesh, measure=True,
                              device=DEVICE, repeats=CELL_REPEATS)
        rec["phase_s"] = time.perf_counter() - t0
        launches = kernel_launches()
        rec["launches"] = launches
        for mod, keys in want.items():
            for key in keys:
                counted = rec["kernels"].get(mod, {}).get(
                    "prefill" if key == "prefill_wgmma" else key, {})
                # warm-up, counted and timed steps all launch
                steps = 2 + CELL_REPEATS
                if not counted.get("calls") or \
                        launches[mod][key] != steps * counted["calls"]:
                    raise AssertionError(
                        f"{arch_id} {shape}: {mod}.{key} launched "
                        f"{launches[mod][key]} times in {steps} steps, "
                        f"counted {counted.get('calls')} a step")
        row = roofline.analyze([rec])[0]
        rec["mfu"] = row["mfu"]
        rec["useful_ratio"] = row["useful_ratio"]
        if not (row["mfu"] and 0 < row["mfu"] <= 1.0):
            raise AssertionError(f"{arch_id} {shape}: mfu {row['mfu']} "
                                 f"outside (0, 1]")
        print(f"  measured {arch_id} {shape} {rec['reduced']}: step p50 "
              f"{rec['seconds'] * 1e3:.3f} ms, flops {rec['flops']:.4e} "
              f"(aten {rec['aten_flops']:.4e}, kernels "
              f"{rec['kernel_ops']:.4e}), model_flops "
              f"{rec['model_flops']:.4e}, mfu {row['mfu']:.5f}, bytes "
              f"{rec['bytes_accessed']:.4e}, temp "
              f"{rec['temp_bytes'] / 1e9:.3f} GB, args "
              f"{rec['arg_bytes'] / 1e9:.3f} GB ({rec['phase_s']:.1f} s)",
              flush=True)
        recs.append(rec)
    table = roofline.format_table(roofline.analyze(recs))
    print(f"  roofline on {card}:\n" + "\n".join(
        "    " + ln for ln in table.splitlines()), flush=True)
    out["measured"] = recs
    out["table"] = table
    lap("measured cells")

    # ---- (c) the counts: the card's against the CPU's
    gc.collect()
    torch.cuda.empty_cache()
    smoke = {}
    for arch_id, shape, _ in CELL_RUNS:
        got = {}
        for dev in (DEVICE, "cpu"):
            plan = get_arch(arch_id).ARCH.build_smoke(shape, device=dev)
            plan.fn(*plan.args)
            got[dev] = dryrun.count_step(plan, dev)["kernels"]
        if got[DEVICE] != got["cpu"] or not got["cpu"]:
            raise AssertionError(f"{arch_id} {shape} smoke: the card counted "
                                 f"{got[DEVICE]}, the CPU {got['cpu']}")
        smoke[f"{arch_id} {shape}"] = got["cpu"]
    full = {}
    for rec in recs:
        key = (rec["arch"], rec["shape"])
        if key in CELL_CPU_COUNTED:
            plan = get_arch(rec["arch"]).ARCH.build(
                rec["shape"], device="cpu", reduced=rec["reduced"] or None)
            want = dryrun.count_step(plan, "cpu")["kernels"]
            plan = None
        elif get_arch(rec["arch"]).FAMILY == "lm":
            want = lm_cell_counts(rec["arch"], rec["shape"], rec["reduced"])
        else:
            continue
        if rec["kernels"] != want:
            raise AssertionError(f"{key}: the card counted {rec['kernels']}, "
                                 f"the CPU or the formula {want}")
        full[" ".join(key)] = want
    out["counts"] = dict(smoke=smoke, full=full)
    out["compress"] = compress_check(torch)
    print(f"  counts: {len(smoke)} smoke cells and {len(full)} measured "
          f"cells count the same kernel work on the card as on the CPU (or "
          f"by formula); compress_with_feedback bit-equal over "
          f"{COMPRESS_STEPS} steps", flush=True)
    lap("counts")
    out["parts"] = parts
    print(f"phase 13 seconds by part: "
          f"{ {k: round(v, 1) for k, v in parts.items()} }", flush=True)
    with open(os.path.join(out_dir, "cells.json"), "w") as f:
        json.dump(out, f, indent=1, default=str)
    return out


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
            "decode": 0.0, "bag": 0.0, "sum_active": 0.0, "max_active": 0.0,
            "bag_backward": 0.0, "sum_gnn": 0.0, "max_gnn": 0.0}
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
    # phase 9 compiles these again in bf16 mode: each group's overlay and
    # decisions as registered (the engines replace, never edit, them)
    bf16_bases = {g.agg.name: (g.engine.overlay,
                               np.array(g.engine.plan.decision))
                  for g in session._groups.values()}

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
    lm_cfg = dataclasses.replace(
        granite_3_2b.CFG,
        n_layers=args.lm_layers or granite_3_2b.CFG.n_layers)
    lm = phase_serve_lm(torch, lm_cfg, args.prompt, args.gen, out_dir,
                        depth=granite_3_2b.CFG.n_layers)
    print(f"LM serve on {card}: {lm['arch']} {lm['n_layers']} layers, "
          f"{lm['param_gb']:.2f} GB of bf16/fp32 serving parameters: prefill "
          f"{lm['batch']} x {lm['prompt']} tokens in {lm['prefill_ms']:.3f} "
          f"ms; {lm['gen']} greedy decode steps in {lm['decode_ms']:.3f} ms = "
          f"{lm['decode_tok_s']:.1f} tokens/s; peak memory "
          f"{lm['peak_gb']:.2f} GB; flash launches {lm['launches']}",
          flush=True)
    print(f"  logits vs blocked_attention (teacher-forced): kernels "
          f"{fmt_logits(lm['logits_vs_plain'])}; floor (attention_ref) "
          f"{fmt_logits(lm['logits_floor'])}; kernel calls held on their "
          f"inputs {lm['kernel_calls']}; greedy agreement per step min "
          f"{min(lm['greedy_agreement_teacher_forced']):.3f}; plain path "
          f"prefill {lm['plain_prefill_ms']:.3f} ms, decode "
          f"{lm['plain_decode_ms']:.3f} ms", flush=True)
    check_lm_logits(lm)
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

    # ---- 9. bf16 edge values on phase 3's overlay and decisions
    t0 = time.perf_counter()
    bf16 = phase_bf16(torch, ops, ref, bf16_bases, writers, readers, errs,
                      out_dir)
    bf16["seconds"] = time.perf_counter() - t0
    print(f"bf16 edge values: {bf16['seconds']:.1f} s", flush=True)
    report["bf16"] = bf16

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
    # the fused active entry at the largest level of the phase-6 batch,
    # F=1 (its library_ms: index_select, the sign's multiply and
    # index_add_ / index_reduce_); launches from phase 6's counted sparse
    # run
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
            held_ms=top["held_ms"],
            library_device_ms=top["library_device_ms"]))
    # the shard-batched entries at phase 8's largest level, F=1; launches
    # from phase 8's counted stream (dense, then sparse, then the reads)
    for row in shards["kernel"]:
        key = f"{row['op']}_{row['entry']}"
        kernels.append(dict(
            name=f"segment_agg_{key}", route="cuda", source=SOURCE,
            replaces=KERNELS[row["op"]][1], design=DESIGNS[row["entry"]],
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
    # the bf16 instances of the fused entries at phase 9's largest levels,
    # F=1 (the dense entry at S = 1 is the single engine's bf16 dense
    # level); launches from phase 9's counted runs: the single engines'
    # dense and sparse runs, and the stack's
    bf16_launches = {
        "dense": bf16["single_launches"]["dense"],
        "active": bf16["single_launches"]["sparse"],
        "stacked": bf16["stacked_launches"],
        "active_stacked": bf16["stacked_launches"]}
    for row in bf16["timed"]:
        entry, op = row["entry"], row["op"]
        key = f"{op}_{'stacked' if entry == 'dense' else entry}_bf16"
        n = bf16_launches[entry][key]
        if n <= 0:
            raise AssertionError(f"segment_agg_{key} was not launched on "
                                 f"phase 9's {entry} path")
        kernels.append(dict(
            name=f"segment_agg_{op}_{entry}_bf16", route="cuda",
            source=SOURCE, replaces=KERNELS[op][1], design=DESIGNS["bf16"],
            launches=n, max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            held_ms=row["held_ms"], fp32_held_ms=row["fp32_held_ms"],
            shards=row["shards"]))

    # ---- 10. the rest of the serve path at full width, on a card freed of
    # the EAGr phases' sessions
    del session, handles, finals, bf16_bases
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 10: {torch.cuda.memory_allocated() / 1e9:.3f} GB still "
          f"allocated", flush=True)
    t0 = time.perf_counter()
    rest = phase_serve_rest(torch, args.prompt, args.gen, card, out_dir, errs)
    rest["seconds"] = time.perf_counter() - t0
    print(f"rest of the serve path: {rest['seconds']:.1f} s", flush=True)
    report["serve_rest"] = rest
    # the flash kernels at each arch's shapes; launches from its counted
    # serve run
    for arch_id, lm in rest["archs"].items():
        tag = arch_id.replace("-", "_").replace(".", "_")
        for name, key, n in (("flash_attention", "prefill",
                              lm["launches"]["prefill_wgmma"]),
                             ("flash_decode", "decode",
                              lm["launches"]["decode"])):
            row = rest["flash"][arch_id][key]
            kernels.append(dict(
                name=f"{name}_{tag}", route="cuda", source=FLASH_SOURCE,
                replaces=FLASH_REPLACES, design=DESIGNS[key], launches=n,
                max_abs_err=row["max_abs_err"], ms=row["ms"],
                plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                bound_by=row["bound_by"], library_ms=row["library_ms"],
                device_ms=row["device_ms"],
                library_device_ms=row["library_device_ms"],
                shape={k: row[k] for k in ("B", "Hq", "Hkv", "S", "d")}))

    # ---- 11. training, on a card freed of phase 10's models
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train = phase_train(torch, card, out_dir, errs)
    train["seconds"] = time.perf_counter() - t0
    print(f"training: {train['seconds']:.1f} s", flush=True)
    report["train"] = train
    # the bag's backward at DIEN's profile lookup (batch 512); launches from
    # phase 11's counted DIEN train steps
    row = train["bag_backward"]
    kernels.append(dict(
        name="embedding_bag_backward", route="cuda", source=BAG_SOURCE,
        replaces=BAG_BACKWARD_REPLACES,
        note="no Pallas counterpart (the JAX package differentiates "
             "jnp.take); the gradient of the function _bag_kernel computes, "
             "which the port's forward runs",
        design=DESIGNS["bag_backward"],
        launches=train["dien"]["launches"]["embedding_bag_backward"],
        max_abs_err=errs["bag_backward"], ms=row["ms"],
        plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
        bound_by=row["bound_by"], library_ms=row["library_ms"],
        device_ms=row["device_ms"], kernel_device_ms=row["kernel_device_ms"],
        library_device_ms=row["library_device_ms"]))

    # ---- 12. the GNNs, on a card freed of phase 11's models
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gnn = phase_gnn(torch, card, out_dir, errs)
    gnn["seconds"] = time.perf_counter() - t0
    print(f"GNNs: {gnn['seconds']:.1f} s", flush=True)
    report["gnn"] = gnn
    # the graph entry at GraphCast's mesh set (sum, F 512) and GAT's
    # softmax shift (max, F 8); launches from phase 12's counted train step
    # of each cell
    for op, pick in (("sum", "graphcast mesh (sum into dst)"),
                     ("max", "gat-cora minibatch_lg (softmax max)")):
        row = next(r for r in gnn["kernel_rows"] if r["name"] == pick)
        n = gnn["launches"][f"{op}_gnn"]
        if n <= 0:
            raise AssertionError(f"segment_agg_{op}_gnn was not launched on "
                                 f"phase 12's train steps")
        kernels.append(dict(
            name=f"segment_agg_{op}_gnn", route="cuda", source=SOURCE,
            replaces=KERNELS[op][1], design=DESIGNS["gnn"], launches=n,
            max_abs_err=errs[f"{op}_gnn"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            device_ms=row.get("device_ms"),
            library_device_ms=row.get("library_device_ms"),
            shape=dict(F=row["F"], edges=row["live"], rows=row["rows"])))

    # ---- 13. the cell tools, on a card freed of phase 12's models
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cells = phase_cells(torch, card, out_dir)
    cells["seconds"] = time.perf_counter() - t0
    print(f"cell tools: {cells['seconds']:.1f} s", flush=True)
    report["cells"] = {k: cells[k] for k in ("measured", "table", "counts",
                                             "compress", "parts", "seconds")}

    bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
           or m == "repro" or m.startswith("repro.")]
    if bad:
        raise AssertionError(f"the port loaded {bad[:5]}")

    report["kernels"] = kernels
    report["profiler_fallbacks"] = PROFILER_FALLBACKS
    print(f"device_ms timed by held CUDA events for want of a profiler "
          f"record: {len(PROFILER_FALLBACKS)} calls", flush=True)
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
