// Sorted-segment aggregation for NVIDIA Hopper (sm_90a), by hand.
//
// Replaces the Pallas TPU kernels `_sum_kernel` and `_max_kernel` of
// src/repro/kernels/segment_agg/segment_agg.py (launched there by
// `segment_agg_call`). It computes the same function:
//
//   out[seg[e]] (+)= x[e]     over edge slots e, seg[e] == -1 dropped,
//
// on the host-built block layout of ops.py: slots come in E_BLK = 256 slot
// blocks, block b routes to row tile tile_of_block[b] (R_BLK = 128 rows), a
// tile's blocks are consecutive and the first one carries
// first_of_tile[b] == 1. A run is a block with first_of_tile == 1 and the
// blocks after it that keep first_of_tile == 0 and the same tile (trailing
// padding blocks carry the last tile's id and extend its run). Sum starts a
// tile at 0, max at -3e38, exactly as the TPU kernel; every run writes all
// 128 rows of its tile; rows of tiles that no run visits are left unwritten
// (the caller masks by the level's touched rows).
//
// Bound. Per level the function must move E_pad * 4 B of seg, 4 * F B of x
// for each live slot and 4 * F B of output for each row of a visited tile.
// It does one add or max per live slot and feature, far below the card's
// fp32 rate, so it is bound by bytes. At the EAGr reference deployment
// (100k nodes / 800k edges) the pull level holds 8,192 blocks of which
// ~2,200 are live; a hub tile holds 113 live blocks and the last tile's run,
// padding included, ~6,000 blocks.
//
// Design. The TPU kernel scatters with a one-hot (128 x 256) matmul on the
// MXU because the TPU has no scatter.
// - Windows. Blocks are cut into windows of `win` blocks aligned to the
//   absolute block index (ops.run_chunk: 16 blocks for F <= 4, 4 for
//   F > 4), one CTA each, so a long run is spread over as many CTAs as it
//   has windows. The cut depends on the block count and F alone, never on
//   which blocks are live or on launch order.
// - A piece is a run's part inside one window. A run that lies wholly in its
//   window is written to `out` directly by that window's CTA, its sole
//   writer. Every other piece writes its 128 x F partial rows to `part`
//   (two slots a window: the piece holding the window's first block, and
//   the piece running past its end), with flags that say whether the piece
//   held a live slot and whether its run goes on. The second kernel combines a run's pieces in
//   window order, skipping the flagged-dead ones (a dead piece is the op's
//   identity: adding +0 or taking max with -3e38 changes nothing, so
//   skipping it is bit-equal to adding it). No float atomics anywhere.
// - A CTA reduces all its window's blocks at once, each block into its own
//   copy of its tile's rows in shared memory, and then each piece folds its
//   live blocks' copies in block order.
// - F <= 4 (slot lanes): 8 warps, an FC x 128 copy a block. A warp loads a
//   block's seg, then every live slot's values (two round trips a block);
//   then, per round of 32 slots (lane = slot), a stretch of lanes with one
//   row (the sorted case) is reduced by a shuffle tree, and stretches of
//   one row in one round (seg unsorted inside the tile, as churn leaves it)
//   are added in lane order.
// - F > 4 (feature lanes): 4 warps, a 128 x 32 copy a block, one pass per
//   32 features; lane = feature, and a warp walks its block's slots in
//   order, loading the next 32 slots' values while it adds the current
//   ones, with a register for the current row.
// Either way the work is per live slot, not per (row, slot), and a block
// whose 256 slots are all padding is skipped after its seg is read, without
// touching x.
// So a row's values are added in a fixed order that depends on the plan's
// layout and F alone (blocks, windows, slot positions), never on which
// blocks are live: reruns are bit-equal. Scalar aggregates (F = 1), avg
// (F = 2) and top-k (F = domain) are not padded to 128 lanes.
//
// The active entry (segment_agg_active_f32) computes a whole frontier-sparse
// level in one launch: over a subset of a level's blocks (the steps'
// active set, `active` ascending block indices padded with n_blocks), for
// each live slot e of an active block
//
//   sum: out[seg[e]] += val[src[e]] * sign[e]
//   max: out[seg[e]]  = max(out[seg[e]], val[src[e]])
//   min: the max of -val[src[e]], negated on store (the engine's -max(-x)),
//
// and the level's row mask hit[seg[e]] = 1 (the entry clears the mask with
// an async memset first). The JAX package gathers
// x = val[src] * sign in XLA and runs the same TPU kernel on it
// (src/repro/core/engine.py, `_level_reduce_active`); here the gather, the
// sign and the mask move into the kernel, so x never reaches device memory.
// - Grid: one CTA per active entry; the entry that opens its window (the
//   first active block of it) works the window, the others and the pads
//   exit. Windows are cut by each block's own index, exactly as the dense
//   pass cuts them.
// - A CTA touches only its window's active blocks, a warp each (16
//   slot-lane warps, or 4 feature-lane warps for a window of 4): their seg
//   and src rows, and for sum their sign rows (contiguous 1 KB rows), are
//   staged into shared memory by cp.async, every block's copies in flight
//   at once (a warp with a second block reduces its first while the second
//   lands);
//   values are gathered from `val` straight into registers (all of a
//   block's slots' loads in flight) and reduced in the dense pass's order
//   (feature_block, or slot_block_overlapped: slot_block's additions in
//   slot_block's order), so each block's partial rows are bit-equal to the
//   dense kernel's on the gathered values. A block that is not active
//   costs nothing: no staging, no shared-memory copy, no fold.
// - One launch, deterministic. A piece whose run lies wholly in the window
//   is written to `out` directly as v (not identity (+) v). Every other
//   piece writes its partial rows to `part` and its live flag, and then
//   takes an integer ticket on its run's tile: each piece adds its count c
//   of the run's active entries, the run's first piece also adds the
//   index of its first entry and the run's last piece subtracts the index
//   past its last one. The sum of any strict subset of a run's pieces is
//   nonzero and the sum of all of them is zero, so the CTA whose
//   atomicAdd brings the ticket to zero is the last to arrive, and the
//   ticket is back at zero for the next launch without a memset. That CTA
//   combines the run's pieces in window order from the op's identity,
//   skipping the dead ones, exactly as the dense combine does; a run with
//   one piece is combined by its own CTA without a ticket. A barrier orders
//   the CTA's part and flag writes before thread 0's ticket, an atomic add
//   with release and acquire semantics at GPU scope, so the combiner sees
//   every piece's writes; it reads `part`, `flag` and the run's first/last
//   entries (`run`, written by the first and last pieces) through L2. No
//   float atomics.
// - Latency, not bytes, bounds a sparse level: a CTA is a chain of
//   dependent steps (entries, then the window's tables and the staged rows,
//   then the gathered values, the block reduce, the fold, the ticket). The
//   entries around the window come in one load; the piece table is built by
//   one warp in parallel while the rows land; a block's 8 rounds of slot
//   shuffles run overlapped (slot_block_overlapped) before their heads add
//   in order.
// So on every row an active block routes to, the output is bit-equal to
// the dense pass over the level's gathered values with the inactive
// blocks' values set to the identity, and to the JAX package's composition
// up to the order of a row's additions. With n_shards > 1 it runs S
// shards' levels in one launch, grid z the shard, its pointers moved as the
// stacked dense entry's are (below); ragged active lists are padded to the
// widest shard with n_blocks, and a pad entry never opens a window nor
// counts in a run.
//
// The stacked dense entry (segment_agg_dense_stacked_f32) computes a whole
// dense level of S aligned shards in one launch, the counterpart of the
// TPU kernel under `vmap` over a shard axis (src/repro/distributed/
// stacked.py) applied to the values the JAX package's `_level_reduce`
// gathers: for each shard z and each live slot e of the level
//
//   sum: out[z, seg[z,e]] += val[z, src[z,e]] * sign[z,e]
//   max: out[z, seg[z,e]]  = max(out[z, seg[z,e]], val[z, src[z,e]])
//   min: the max of -val[z, src[z,e]], negated on store.
//
// Bound: per shard every slot's seg (4 B), the src rows (and for sum the
// sign rows) of the blocks holding a live slot (1 or 2 KB a block), `val`
// once per distinct source (4 * F B), tob and fot (8 B a block) and the
// visited tiles' rows (4 * F B a row); one add or max per live slot and
// feature (and a multiply for sum): bound by bytes. About three quarters
// of a level's padded slots are dead at the plans' 2x headroom.
// - Grid: one CTA per window of `win` blocks (windows cut as the dense pass
//   cuts them), grid z the shard; each CTA first moves every pointer to its
//   shard's slice (seg, src, sign, tob and fot by the tables' shard strides,
//   which may exceed one level's size; val, out, part, flag, the tickets and
//   the run table by their own sizes).
// - A warp a block (16 slot-lane warps, or 4 feature-lane warps for a
//   window of 4). The window's seg rows are staged by cp.async while its
//   tob/fot load; a block with no live slot of its tile stops there, and
//   only the live blocks' src rows (and sign rows for sum) are staged, all
//   of the window's in flight at once; values are gathered from `val`
//   straight into registers and reduced as the active entry reduces them,
//   so each block's partial rows equal the dense kernel's on the gathered
//   values bit for bit.
// - Pieces fold in block order and a run crossing windows is combined in
//   the same launch by the last of its pieces to take an integer ticket, as
//   in the active entry, with windows for entries: each piece adds 1, the
//   run's first piece also the index of its window and its last piece
//   subtracts the index past its own.
// So shard z's output is bit-equal to the single-shard dense entry's on its
// gathered values (val[src] * sign for sum, val[src] for max, -val[src]
// then negated for min), which is what the engine's single-shard level
// computes.
//
// bf16 edge values (the JAX package's EAGR_SEGAGG_BF16 mode). Both fused
// entries take a bf16 flag, which picks their BF16 instance: each slot's
// value, val[src] * sign for sum (after the multiply) or val[src] for max
// and min (before min's negation), is rounded to bfloat16, to nearest even,
// and then reduced in fp32 exactly as above. The rounding has one site,
// GatherSlots::at, so every entry, dense or active, one shard or S, rounds
// the same slots the same way, and a bf16 sparse level stays bit-equal to
// the bf16 dense one. The TPU kernel streams x into VMEM as bf16 for block
// headroom; here the values never reach memory as x, and `val` stays fp32
// state, so the bytes bound is the fp32 instance's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <mutex>

namespace {

constexpr int E_BLK = 256;  // slots per edge block
constexpr int R_BLK = 128;  // rows per tile
constexpr int MAX_WIN = 64;
constexpr int ACT_MAX_WIN = 16;  // the fused entries' widest window
constexpr int CF = 8;       // features per combine CTA
constexpr int PIPE = 8;     // pieces a combine thread loads at a time
constexpr int MAX_DEVICES = 64;

constexpr int OP_SUM = 0, OP_MAX = 1, OP_MIN = 2;  // the fused entries' ops

// A kernel's dynamic shared-memory limit, raised on each device only when a
// launch needs more than was set there before (the attribute call is not
// repeated on every launch); one per kernel instance.
struct SmemLimit {
  std::mutex m;
  int set[MAX_DEVICES] = {};
};

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, SmemLimit& lim) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> hold(lim.m);
  if (lim.set[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) lim.set[dev] = bytes;
  return err;
}

// Programmatic dependent launch: the combine kernel is launched while the
// window kernel's last CTAs run, and waits here for all of their writes.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_prerequisites() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <bool MAX>
__device__ __forceinline__ float combine(float a, float b) {
  return MAX ? fmaxf(a, b) : a + b;
}

template <bool MAX>
__device__ __forceinline__ float identity() {
  return MAX ? -3.0e38f : 0.0f;  // the TPU kernel's identities
}

// A block's slots as the dense pass reads them: seg in device memory at
// the block's own position, slot s's values at xb + s * F.
struct DenseSlots {
  const float* __restrict__ xb;
  const int* __restrict__ sg;
  int F;
  __device__ __forceinline__ int seg(int s) const { return sg[s]; }
  __device__ __forceinline__ float at(int s, int j) const {
    return xb[static_cast<size_t>(s) * F + j];
  }
  __device__ __forceinline__ void mark(int, const int (&)[E_BLK / 32]) const {
  }
};

// An active block's slots: its seg, src and sign rows staged in shared
// memory (st: seg at [0, 256), src at [256, 512), sign's bits at
// [512, 768)); slot s's feature j is val[src[s]] * sign[s] (sum; an
// unfused multiply, as the engine's gather rounds it), val[src[s]] (max)
// or -val[src[s]] (min); BF16 rounds the value (after the multiply, before
// the negation) to bfloat16, to nearest even. mark() sets the row mask of
// the block's live slots when hit is given.
template <int OP, bool BF16>
struct GatherSlots {
  const float* __restrict__ val;
  const int* st;
  unsigned char* hit;
  int F;
  __device__ __forceinline__ int seg(int s) const { return st[s]; }
  __device__ __forceinline__ float at(int s, int j) const {
    float v = __ldg(val + static_cast<size_t>(st[E_BLK + s]) * F + j);
    if (OP == OP_SUM) v = __fmul_rn(v, __int_as_float(st[2 * E_BLK + s]));
    if (BF16) v = __bfloat162float(__float2bfloat16_rn(v));
    return OP == OP_MIN ? -v : v;
  }
  __device__ __forceinline__ void mark(int row0,
                                       const int (&loc)[E_BLK / 32]) const {
    if (hit == nullptr) return;
#pragma unroll
    for (int r = 0; r < E_BLK / 32; ++r) {
      if (loc[r] >= 0) hit[row0 + loc[r]] = 1;
    }
  }
};

// The block's seg, as row offsets in the tile (-1: padding or another
// tile), slot r * 32 + lane in loc[r]; returns whether any slot is live.
template <class Slots>
__device__ __forceinline__ bool block_rows(const Slots& sl, int row0,
                                           int lane,
                                           int (&loc)[E_BLK / 32]) {
  bool any = false;
#pragma unroll
  for (int r = 0; r < E_BLK / 32; ++r) {
    const int s = sl.seg(r * 32 + lane);
    loc[r] = (s >= 0 && static_cast<unsigned>(s - row0) < R_BLK) ? s - row0
                                                                 : -1;
    any |= loc[r] >= 0;
  }
  return __any_sync(0xffffffffu, any);
}

// Slot lanes (F <= 4): one block's slots, lane = slot, into the warp's
// accumulators wacc[j * 128 + row]. Every live slot's values are loaded
// first (one round trip); then per round of 32 slots, a stretch of lanes
// with one row (the sorted case) is reduced by a shuffle tree so its first
// lane holds the total, and the first lanes that share a row (seg unsorted
// inside the tile) are added in lane order by the lowest of them. Returns
// whether the block held a live slot.
template <int FC, bool MAX, class Slots>
__device__ bool slot_block(const Slots& sl, int row0, int F, float* wacc,
                           float* xs, int lane) {
  int loc[E_BLK / 32];
  if (!block_rows(sl, row0, lane, loc)) return false;
  sl.mark(row0, loc);
  float v[E_BLK / 32][FC];
#pragma unroll
  for (int r = 0; r < E_BLK / 32; ++r) {
#pragma unroll
    for (int j = 0; j < FC; ++j) {
      v[r][j] = loc[r] >= 0 && j < F ? sl.at(r * 32 + lane, j)
                                     : identity<MAX>();
    }
  }
#pragma unroll
  for (int r = 0; r < E_BLK / 32; ++r) {
    const int lc = loc[r];
    const bool valid = lc >= 0;
    if (!__any_sync(0xffffffffu, valid)) continue;
    const int nxt = __shfl_down_sync(0xffffffffu, lc, 1);
    const int prv = __shfl_up_sync(0xffffffffu, lc, 1);
    const unsigned tails =
        __ballot_sync(0xffffffffu, valid && (lane == 31 || nxt != lc));
    const bool head = valid && (lane == 0 || prv != lc);
    // the stretch's last lane: the first tail at or above this lane
    const int end = valid ? lane + __ffs(tails >> lane) - 1 : lane;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
      for (int j = 0; j < FC; ++j) {
        const float t = __shfl_down_sync(0xffffffffu, v[r][j], o);
        if (lane + o <= end) v[r][j] = combine<MAX>(v[r][j], t);
      }
    }
    const unsigned heads = __ballot_sync(0xffffffffu, head);
    const unsigned same =
        __match_any_sync(0xffffffffu, head ? lc : -1) & heads;
    if (head) {
#pragma unroll
      for (int j = 0; j < FC; ++j) xs[lane * (FC + 1) + j] = v[r][j];
    }
    __syncwarp();
    if (head && lane == __ffs(same) - 1) {
#pragma unroll
      for (int j = 0; j < FC; ++j) {
        if (j < F) {
          float a = wacc[j * R_BLK + lc];
          for (unsigned m = same; m; m &= m - 1) {
            a = combine<MAX>(a, xs[(__ffs(m) - 1) * (FC + 1) + j]);
          }
          wacc[j * R_BLK + lc] = a;
        }
      }
    }
    __syncwarp();
  }
  return true;
}

// slot_block for the active entry, the same additions in the same order
// with the rounds overlapped: every round's stretches are reduced first
// (independent shuffle trees, so their latencies overlap), then the heads
// add into wacc in round order, each row's heads in lane order. A round
// whose heads all have rows of their own adds straight from registers; one
// where a row has several heads (seg unsorted in the tile) stages them in
// xs as slot_block does.
template <int FC, bool MAX, class Slots>
__device__ bool slot_block_overlapped(const Slots& sl, int row0, int F,
                                      float* wacc, float* xs, int lane) {
  constexpr int NR = E_BLK / 32;
  int loc[NR];
  if (!block_rows(sl, row0, lane, loc)) return false;
  sl.mark(row0, loc);
  float v[NR][FC];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
#pragma unroll
    for (int j = 0; j < FC; ++j) {
      v[r][j] = loc[r] >= 0 && j < F ? sl.at(r * 32 + lane, j)
                                     : identity<MAX>();
    }
  }
  unsigned same[NR];
  bool head[NR];
  unsigned multi = 0;  // bit r: round r has a row with several heads
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int lc = loc[r];
    const bool valid = lc >= 0;
    const int nxt = __shfl_down_sync(0xffffffffu, lc, 1);
    const int prv = __shfl_up_sync(0xffffffffu, lc, 1);
    const unsigned tails =
        __ballot_sync(0xffffffffu, valid && (lane == 31 || nxt != lc));
    head[r] = valid && (lane == 0 || prv != lc);
    const int end = valid ? lane + __ffs(tails >> lane) - 1 : lane;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
      for (int j = 0; j < FC; ++j) {
        const float t = __shfl_down_sync(0xffffffffu, v[r][j], o);
        if (lane + o <= end) v[r][j] = combine<MAX>(v[r][j], t);
      }
    }
    const unsigned heads = __ballot_sync(0xffffffffu, head[r]);
    same[r] = __match_any_sync(0xffffffffu, head[r] ? lc : -1) & heads;
    multi |= (__any_sync(0xffffffffu, head[r] && (same[r] & (same[r] - 1)))
                  ? 1u
                  : 0u)
             << r;
  }
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int lc = loc[r];
    if ((multi >> r) & 1u) {
      if (head[r]) {
#pragma unroll
        for (int j = 0; j < FC; ++j) xs[lane * (FC + 1) + j] = v[r][j];
      }
      __syncwarp();
      if (head[r] && lane == __ffs(same[r]) - 1) {
#pragma unroll
        for (int j = 0; j < FC; ++j) {
          if (j < F) {
            float a = wacc[j * R_BLK + lc];
            for (unsigned m = same[r]; m; m &= m - 1) {
              a = combine<MAX>(a, xs[(__ffs(m) - 1) * (FC + 1) + j]);
            }
            wacc[j * R_BLK + lc] = a;
          }
        }
      }
    } else if (head[r]) {
#pragma unroll
      for (int j = 0; j < FC; ++j) {
        if (j < F) {
          wacc[j * R_BLK + lc] = combine<MAX>(wacc[j * R_BLK + lc], v[r][j]);
        }
      }
    }
    __syncwarp();  // a row's next head may be another lane's, next round
  }
  return true;
}

// Feature lanes (F > 4): lane = feature f of the warp's 32, the block's
// slots walked in order (rows in sl, the warp's 256 ints of shared memory),
// rounds of 32 padding slots skipped; round r + 1's 32 values are loaded
// while round r's are added, and a
// stretch of slots with one row is combined in a register and added to
// wacc[row * 32 + lane] when the row changes.
template <bool MAX, class Slots>
__device__ bool feature_block(const Slots& slots, int row0, int F, int f,
                              float* wacc, int* sl, int lane) {
  int loc[E_BLK / 32];
  if (!block_rows(slots, row0, lane, loc)) return false;
  slots.mark(row0, loc);
#pragma unroll
  for (int r = 0; r < E_BLK / 32; ++r) sl[r * 32 + lane] = loc[r];
  __syncwarp();
  unsigned rounds = 0;  // bit r: round r holds a live slot
#pragma unroll
  for (int r = 0; r < E_BLK / 32; ++r) {
    rounds |= (__ballot_sync(0xffffffffu, loc[r] >= 0) ? 1u : 0u) << r;
  }
  const bool fok = f < F;
  float cur_x[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    cur_x[i] = sl[i] >= 0 && fok ? slots.at(i, f) : identity<MAX>();
  }
  int cur = -1;
  float acc = identity<MAX>();
#pragma unroll 1
  for (int r = 0; r < E_BLK / 32; ++r) {
    float nxt_x[32];
    const int rn = min(r + 1, E_BLK / 32 - 1);  // the last round reloads
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int s = rn * 32 + i;
      nxt_x[i] = sl[s] >= 0 && fok ? slots.at(s, f) : identity<MAX>();
    }
    if (((rounds >> r) & 1u) == 0) {  // all padding: nothing to add
#pragma unroll
      for (int i = 0; i < 32; ++i) cur_x[i] = nxt_x[i];
      continue;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int li = sl[r * 32 + i];
      if (li < 0) continue;
      if (li != cur) {
        if (cur >= 0) {
          wacc[cur * 32 + lane] = combine<MAX>(wacc[cur * 32 + lane], acc);
        }
        cur = li;
        acc = cur_x[i];
      } else {
        acc = combine<MAX>(acc, cur_x[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) cur_x[i] = nxt_x[i];
  }
  if (cur >= 0) {
    wacc[cur * 32 + lane] = combine<MAX>(wacc[cur * 32 + lane], acc);
  }
  __syncwarp();  // sl is rewritten by the next block
  return true;
}

constexpr int SLOT_WARPS = 8;  // slot-lane window kernel
constexpr int FEAT_WARPS = 4;  // feature-lane window kernel: 16 KB a warp
// the fused kernels' slot-lane warps: one per block of its widest window,
// so no warp reduces two blocks in turn
constexpr int ACT_SLOT_WARPS = 16;

// A run's piece in a window: blocks [p0, p1) of the window, where p0 is
// the start of a run (first_of_tile) or the window's first block.
struct Piece {
  int p1, tile, slot;
  bool skip, direct, goes_on;
};

// The piece starting at p0, from the window's tables s_tob/s_fot (entry nw
// is the block after the window: tob -1 and fot 1 past the level's end);
// the window's two part/flag slots are 2 * base and 2 * base + 1.
__device__ __forceinline__ Piece piece_at(const int* s_tob, const int* s_fot,
                                          int p0, int nw, int n_row_tiles,
                                          int base) {
  Piece pc;
  pc.tile = s_tob[p0];
  pc.p1 = p0 + 1;
  while (pc.p1 < nw && s_fot[pc.p1] == 0 && s_tob[pc.p1] == pc.tile) ++pc.p1;
  const bool starts = s_fot[p0] == 1;
  pc.goes_on = pc.p1 == nw && s_fot[nw] == 0 && s_tob[nw] == pc.tile;
  // a piece that neither starts a run nor holds the window's first block
  // is off every run (a tile change without first_of_tile): skipped
  pc.skip = (!starts && p0 != 0) || pc.tile < 0 || pc.tile >= n_row_tiles;
  pc.direct = starts && !pc.goes_on;
  pc.slot = base * 2 + (p0 == 0 ? 0 : 1);
  return pc;
}

__device__ __forceinline__ void load_window(const int* __restrict__ tob,
                                            const int* __restrict__ fot,
                                            int w0, int nw, int n_blocks,
                                            int* s_tob, int* s_fot) {
  const int t = threadIdx.x;
  if (t <= nw) {
    const bool in = w0 + t < n_blocks;
    s_tob[t] = in ? tob[w0 + t] : -1;
    s_fot[t] = in ? fot[w0 + t] : 1;
  }
}

// One CTA per window of `win` blocks. Every block of the window is reduced
// at once, each into its own copy of its tile's rows in shared memory:
// slot lanes (F <= 4, FC = 1, 2, 4): 8 warps, warp w blocks w, w + 8, ...,
// an FC x 128 copy a block, one pass; feature lanes (F > 4, FC = 32): 4
// warps, warp w block w, a 128 x 32 copy a block, one pass per 32
// features. Then each piece folds its live blocks' copies in block order
// into its rows. flag[2 w + s] of a piece written to part: bit 0, it held a
// live slot; bit 1, its run goes on into the next window.
template <int FC, bool MAX>
__global__ void __launch_bounds__((FC == 32 ? FEAT_WARPS : SLOT_WARPS) * 32)
segment_agg_kernel(const float* __restrict__ x, const int* __restrict__ seg,
                   const int* __restrict__ tob, const int* __restrict__ fot,
                   float* __restrict__ out, float* __restrict__ part,
                   int* __restrict__ flag, int n_blocks, int F,
                   int n_row_tiles, int win) {
  constexpr bool FEAT = FC == 32;
  constexpr int NWK = FEAT ? FEAT_WARPS : SLOT_WARPS;
  constexpr int COPY = FC * R_BLK;  // floats a block
  extern __shared__ float smem[];   // win copies, then the warps' staging
  __shared__ int s_tob[MAX_WIN + 1], s_fot[MAX_WIN + 1], s_live[MAX_WIN];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int w = blockIdx.x;
  const int w0 = w * win;
  const int nw = min(win, n_blocks - w0);
  load_window(tob, fot, w0, nw, n_blocks, s_tob, s_fot);
  __syncthreads();
  float* xs = smem + win * COPY + warp * 32 * (FC + 1);           // slots
  int* sl = reinterpret_cast<int*>(smem + win * COPY) + warp * E_BLK;  // feat
  for (int f0 = 0; f0 < F; f0 += FEAT ? 32 : F) {
    const int nf = FEAT ? min(32, F - f0) : F;
    for (int bi = warp; bi < nw; bi += NWK) {
      float* copy = smem + bi * COPY;
      for (int i = lane; i < COPY; i += 32) copy[i] = identity<MAX>();
      __syncwarp();
      const int tile = s_tob[bi];
      bool live = false;
      if (tile >= 0 && tile < n_row_tiles) {
        const size_t e0 = static_cast<size_t>(w0 + bi) * E_BLK;
        const DenseSlots slots{x + e0 * F, seg + e0, F};
        if (FEAT) {
          live = feature_block<MAX>(slots, tile * R_BLK, F, f0 + lane, copy,
                                    sl, lane);
        } else {
          live = slot_block<FC, MAX>(slots, tile * R_BLK, F, copy, xs, lane);
        }
      }
      if (lane == 0 && f0 == 0) s_live[bi] = live;
    }
    __syncthreads();
    for (int p0 = 0; p0 < nw;) {
      const Piece pc = piece_at(s_tob, s_fot, p0, nw, n_row_tiles,
                                blockIdx.x);
      if (!pc.skip) {
        bool live = false;
        for (int bi = p0; bi < pc.p1; ++bi) live |= s_live[bi] != 0;
        if (!pc.direct && f0 == 0 && tid == 0) {
          flag[pc.slot] = (live ? 1 : 0) | (pc.goes_on ? 2 : 0);
        }
        if (pc.direct || live) {
          float* dst = pc.direct
                           ? out + static_cast<size_t>(pc.tile) * R_BLK * F
                           : part + static_cast<size_t>(pc.slot) * R_BLK * F;
          for (int e = tid; e < R_BLK * nf; e += NWK * 32) {
            const int r = e / nf, j = e - r * nf;
            const int at = FEAT ? r * 32 + j : j * R_BLK + r;
            float v = identity<MAX>();
            for (int bi = p0; bi < pc.p1; ++bi) {
              if (s_live[bi]) v = combine<MAX>(v, smem[bi * COPY + at]);
            }
            dst[static_cast<size_t>(r) * F + f0 + j] = v;
          }
        }
      }
      p0 = pc.p1;
    }
    __syncthreads();  // the copies are read before the next pass resets them
  }
  launch_dependents();
}

// Adds, in window order, the partial rows of the pieces listed in s_list
// (n of them, part slot indices) into acc: PIPE pieces' loads in flight at
// a time.
template <bool MAX>
__device__ __forceinline__ void add_pieces(const float* pr, size_t piece,
                                           const int* s_list, int n, int nf,
                                           float (&acc)[CF]) {
  for (int k0 = 0; k0 < n; k0 += PIPE) {
    float buf[PIPE][CF];
#pragma unroll
    for (int k = 0; k < PIPE; ++k) {
      const float* p = k0 + k < n ? pr + s_list[k0 + k] * piece : nullptr;
#pragma unroll
      for (int j = 0; j < CF; ++j) {
        buf[k][j] = p != nullptr && j < nf ? p[j] : identity<MAX>();
      }
    }
#pragma unroll
    for (int k = 0; k < PIPE; ++k) {
#pragma unroll
      for (int j = 0; j < CF; ++j) {
        if (k0 + k < n && j < nf) acc[j] = combine<MAX>(acc[j], buf[k][j]);
      }
    }
  }
}

// Compacts, in thread order, the part slots of the threads (NT of them)
// with `live` into s_list; returns how many there are.
template <int NT>
__device__ __forceinline__ int compact_live(bool live, int slot, int* s_cnt,
                                            int* s_list) {
  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5;
  const unsigned bal = __ballot_sync(0xffffffffu, live);
  if (lane == 0) s_cnt[wp] = __popc(bal);
  __syncthreads();
  int off = 0, n = 0;
#pragma unroll
  for (int q = 0; q < NT / 32; ++q) {
    off += q < wp ? s_cnt[q] : 0;
    n += s_cnt[q];
  }
  if (live) s_list[off + __popc(bal & ((1u << lane) - 1u))] = slot;
  __syncthreads();
  return n;
}

// One CTA per (window, CF features): the run that starts in the window and
// goes on past it, its pieces' partial rows combined in window order.
template <bool MAX>
__global__ void __launch_bounds__(R_BLK)
segment_agg_combine_kernel(const int* __restrict__ tob,
                           const int* __restrict__ fot,
                           const float* __restrict__ part,
                           const int* __restrict__ flag,
                           float* __restrict__ out, int n_blocks, int F,
                           int n_row_tiles, int win) {
  __shared__ int s_last, s_stop;
  __shared__ int s_cnt[R_BLK / 32];
  __shared__ int s_list[R_BLK];
  wait_prerequisites();
  const int tid = threadIdx.x;
  const int w = blockIdx.x, w0 = w * win;
  const int nw = min(win, n_blocks - w0);
  if (tid == 0) s_last = -1;
  __syncthreads();
  if (tid < nw && fot[w0 + tid] == 1) atomicMax(&s_last, tid);
  __syncthreads();
  const int last = s_last;
  if (last < 0) return;
  const int tile = tob[w0 + last];
  if (tile < 0 || tile >= n_row_tiles) return;
  // the window's last run: does it reach the window's end and go on?
  const bool broken = tid > last && tid < nw && tob[w0 + tid] != tile;
  if (__syncthreads_or(broken)) return;
  const int nb = w0 + nw;
  if (nb >= n_blocks || fot[nb] != 0 || tob[nb] != tile) return;
  const int first = w * 2 + (last == 0 ? 0 : 1);

  const int f0 = blockIdx.y * CF;
  const int nf = min(CF, F - f0);
  const float* pr = part + static_cast<size_t>(tid) * F + f0;  // row tid
  const size_t piece = static_cast<size_t>(R_BLK) * F;
  float acc[CF];
#pragma unroll
  for (int j = 0; j < CF; ++j) acc[j] = identity<MAX>();
  if (flag[first] & 1) {
#pragma unroll
    for (int j = 0; j < CF; ++j) {
      if (j < nf) acc[j] = combine<MAX>(acc[j], pr[first * piece + j]);
    }
  }
  const int n_win = (n_blocks + win - 1) / win;
  for (int c0 = w + 1; c0 < n_win; c0 += R_BLK) {
    // the next R_BLK windows' first pieces: the run's while their run went
    // on, compacted in window order when live
    const int c = c0 + tid;
    const int fl = c < n_win ? flag[c * 2] : 0;
    if (tid == 0) s_stop = R_BLK;
    __syncthreads();
    if (c < n_win && !(fl & 2)) atomicMin(&s_stop, tid);  // its last window
    __syncthreads();
    const int stop = s_stop;
    const int n = compact_live<R_BLK>(tid <= stop && (fl & 1), c * 2, s_cnt,
                                      s_list);
    add_pieces<MAX>(pr, piece, s_list, n, nf, acc);
    __syncthreads();  // s_list, s_cnt and s_stop are rewritten next step
    if (stop < R_BLK) break;
  }
  float* o = out + (static_cast<size_t>(tile) * R_BLK + tid) * F + f0;
#pragma unroll
  for (int j = 0; j < CF; ++j) {
    if (j < nf) o[j] = acc[j];
  }
}

// ------------------------------------------------------- the active entry
// An integer add with release and acquire semantics at GPU scope: the
// CTA's writes ordered before it by a barrier are released with it, and the
// writes released by the adds before it are visible after it.
__device__ __forceinline__ int atom_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

// A window's piece (see piece_at) with its active blocks, compact [i0, i1)
struct PieceRec {
  int p0, p1, i0, i1, tile, slot;
  bool skip, direct, goes_on, starts;
};

// One warp builds the window's piece table in parallel, lane = block: a
// piece starts at block 0 and wherever first_of_tile is 1 or the tile
// changes (where piece_at stops), and ends at the next start; its active
// blocks are counted from the window's active-block mask `act` (bit i:
// block i of the window; the dense entry's are all active). Only the
// pieces that are not skipped and hold an active block are listed, in
// window order. Returns whether one of them is not direct (a run of the
// window crosses its edge).
__device__ __forceinline__ bool piece_table(const int* s_tob, const int* s_fot,
                                            unsigned act, int nw,
                                            int n_row_tiles, int base,
                                            PieceRec* s_pc, int* s_npc,
                                            int lane) {
  const bool start = lane < nw && (lane == 0 || s_fot[lane] == 1 ||
                                   s_tob[lane] != s_tob[lane - 1]);
  const unsigned starts = __ballot_sync(0xffffffffu, start);
  PieceRec pc;
  bool keep = false;
  if (start) {
    const unsigned later = starts & ~((2u << lane) - 1u);
    pc.p0 = lane;
    pc.p1 = later ? __ffs(later) - 1 : nw;
    pc.i0 = __popc(act & ((1u << lane) - 1u));
    pc.i1 = __popc(act & ((1u << pc.p1) - 1u));
    pc.tile = s_tob[lane];
    pc.starts = s_fot[lane] == 1;
    pc.goes_on = pc.p1 == nw && s_fot[nw] == 0 && s_tob[nw] == pc.tile;
    pc.skip = (!pc.starts && lane != 0) || pc.tile < 0 ||
              pc.tile >= n_row_tiles;
    pc.direct = pc.starts && !pc.goes_on;
    pc.slot = base * 2 + (lane == 0 ? 0 : 1);
    keep = !pc.skip && pc.i1 > pc.i0;
  }
  const unsigned kept = __ballot_sync(0xffffffffu, keep);
  if (keep) s_pc[__popc(kept & ((1u << lane) - 1u))] = pc;
  if (lane == 0) *s_npc = __popc(kept);
  return __any_sync(0xffffffffu, keep && !pc.direct);
}

struct ActiveArgs {
  const float* val;  // (S, n_val, F)
  const int* seg;    // the level's seg, src and sign: shard stride
  const int* src;    //   seg_stride, n_blocks * 256 each
  const float* sign;
  const int* tob;  // (n_blocks,) a shard, shard stride blk_stride
  const int* fot;
  const int* active;   // (S, n_active) ascending, padded with n_blocks
  float* out;          // (S, n_row_tiles * 128, F)
  unsigned char* hit;  // (S, n_row_tiles * 128), cleared before the launch
  float* part;         // (S, 2 * n_slot, 128, F) scratch
  int* flag;           // (S, 2 * n_slot) scratch
  int* ticket;         // (S, n_row_tiles), zero before and after a launch
  int* run;            // (S, n_row_tiles, 3) scratch: first entry and part
                       // slot of a run's first piece, end of its last
  long long n_val, seg_stride, blk_stride;
  int n_active, n_blocks, F, n_row_tiles, win;
  // a window opener's part/flag slots are 2 b and 2 b + 1, b its window
  // (by_window: fewer windows than entries) or else its entry; n_slot is
  // the smaller of the two counts
  int n_slot, by_window;
};

// The part slot of a run's piece at scan entry c of combine_run, or -1 where
// entry c holds none. The active entry scans its active entries: a piece
// opens at each entry whose block opens a new window (a run that started
// before a window holds its first block, so its entry there is the
// window's first).
struct ActivePieces {
  const int* active;
  int win, by_window;
  __device__ __forceinline__ int slot(int c) const {
    const int ac = active[c];
    if (ac / win == active[c - 1] / win) return -1;
    return 2 * (by_window ? ac / win : c);
  }
};

// The stacked dense entry scans windows: every window after a crossing
// run's first holds a piece of it at its first block.
struct WindowPieces {
  __device__ __forceinline__ int slot(int c) const { return 2 * c; }
};

// Combines a run's pieces into its tile's rows, in window order from the
// op's identity, skipping dead pieces: the first piece at part slot slot0,
// then the pieces at the scan entries in (lo, hi) (`pcs`). Entries are
// scanned NT at a time; a round's result stays in out (un-negated) for the
// next one, and min negates on the last store. All NT threads call it.
template <int OP, int NT, class Pieces>
__device__ void combine_run(const Pieces& pcs, int F, const int* flag,
                            const float* part, float* out, int tile, int lo,
                            int slot0, int hi, int* s_cnt, int* s_list) {
  constexpr bool MX = OP != OP_SUM;
  const int tid = threadIdx.x;
  const size_t piece = static_cast<size_t>(R_BLK) * F;
  float* o = out + static_cast<size_t>(tile) * piece;
  const bool live0 = (__ldcg(flag + slot0) & 1) != 0;
  const float* p0 = part + static_cast<size_t>(slot0) * piece;
  for (int c0 = lo + 1, round = 0;; c0 += NT, ++round) {
    const int c = c0 + tid;
    const int sc = c < hi ? pcs.slot(c) : -1;
    const int fl = sc >= 0 ? __ldcg(flag + sc) : 0;
    const int n = compact_live<NT>(sc >= 0 && (fl & 1), sc, s_cnt, s_list);
    const bool end = c0 + NT >= hi;
    for (int e = tid; e < R_BLK * F; e += NT) {
      float acc = round == 0 ? identity<MX>() : o[e];
      if (round == 0 && live0) acc = combine<MX>(acc, __ldcg(p0 + e));
      for (int q0 = 0; q0 < n; q0 += PIPE) {
        float buf[PIPE];
#pragma unroll
        for (int q = 0; q < PIPE; ++q) {
          buf[q] = q0 + q < n ? __ldcg(part + s_list[q0 + q] * piece + e)
                              : identity<MX>();
        }
#pragma unroll
        for (int q = 0; q < PIPE; ++q) {
          if (q0 + q < n) acc = combine<MX>(acc, buf[q]);
        }
      }
      o[e] = OP == OP_MIN && end ? -acc : acc;
    }
    __syncthreads();  // s_list and s_cnt are rewritten next round
    if (end) break;
  }
}

// A non-direct piece's ticket, taken by thread 0 of its CTA after a
// barrier that orders the CTA's part and flag writes before it: each of a
// run's pieces adds its count c of the run's scan entries, the run's first
// piece (first) also the index lo of its first entry, and its last piece
// (last) subtracts the index hi past its last one. The sum of a strict
// subset of a run's pieces is nonzero and the sum of all of them zero, so
// the add that brings the ticket to zero is the last, and the ticket is
// zero again for the next launch. The first piece records lo and its part
// slot, the last piece hi, in the run's record ri (3 ints). Returns whether
// this piece completes the run, with the run's (lo, first piece's slot, hi)
// in rec.
__device__ __forceinline__ bool settle(int* ticket, int* ri, int slot, int c,
                                       int lo, int hi, bool first, bool last,
                                       int (&rec)[3]) {
  rec[0] = lo;
  rec[1] = slot;
  rec[2] = hi;
  if (first && last) return true;  // the run's only piece
  if (first) {
    ri[0] = lo;
    ri[1] = slot;
  }
  if (last) ri[2] = hi;
  const int d = c + (first ? lo : 0) - (last ? hi : 0);
  if (atom_add_acq_rel(ticket, d) + d != 0) return false;
  if (!first) {
    rec[0] = __ldcg(ri);
    rec[1] = __ldcg(ri + 1);
  }
  if (!last) rec[2] = __ldcg(ri + 2);
  return true;
}

// Folds each listed piece's live blocks' copies (asmem, COPY floats a
// block, `lives` bit i: compact block i held a live slot) in block order
// into its rows for features [f0, f0 + nf): a direct piece into out (min
// negated), any other into its part slot (un-negated), with its live flag
// on the first pass. All NT threads call it.
template <int FC, int OP, int NT>
__device__ __forceinline__ void fold_pieces(const PieceRec* s_pc, int npc,
                                            unsigned lives, const float* asmem,
                                            float* out, float* part,
                                            int* flag, int F, int f0,
                                            int nf) {
  constexpr bool FEAT = FC == 32;
  constexpr bool MX = OP != OP_SUM;
  constexpr int COPY = FC * R_BLK;
  const int tid = threadIdx.x;
  for (int q = 0; q < npc; ++q) {
    const PieceRec pc = s_pc[q];
    const unsigned mine_live =
        lives & ((1u << pc.i1) - 1u) & ~((1u << pc.i0) - 1u);
    if (!pc.direct && f0 == 0 && tid == 0) flag[pc.slot] = mine_live != 0;
    if (!pc.direct && mine_live == 0) continue;
    float* dst = pc.direct ? out + static_cast<size_t>(pc.tile) * R_BLK * F
                           : part + static_cast<size_t>(pc.slot) * R_BLK * F;
    // element e: row e / 32 and feature e % 32 of the pass (feature
    // lanes), or row e % 128 and feature e / 128 (slot lanes)
    for (int e = tid; e < R_BLK * (FEAT ? 32 : FC); e += NT) {
      const int r = FEAT ? e >> 5 : e & (R_BLK - 1);
      const int j = FEAT ? e & 31 : e >> 7;
      if (j >= nf) continue;
      float v = identity<MX>();
      for (unsigned m = mine_live; m; m &= m - 1) {
        v = combine<MX>(v, asmem[(__ffs(m) - 1) * COPY + e]);
      }
      dst[static_cast<size_t>(r) * F + f0 + j] =
          OP == OP_MIN && pc.direct ? -v : v;
    }
  }
}

// One CTA per active entry (grid x), shard blockIdx.z. The entry that opens
// its window works the window's active blocks (slot lanes for F <= 4, FC =
// 1, 2, 4: 16 warps, compact block i to warp i % 16; feature lanes for
// F > 4, FC = 32: 4 warps, one pass per 32 features), folds each piece's
// live active blocks in block order, writes a direct piece to out and every
// other piece to part (its window's two slots, see ActiveArgs), then
// settles the tickets of its at most two non-direct pieces and combines
// the runs it completes (see the header).
template <int FC, int OP, bool BF16>
__global__ void __launch_bounds__((FC == 32 ? FEAT_WARPS : ACT_SLOT_WARPS) *
                                  32)
segment_agg_active_kernel(const ActiveArgs p) {
  constexpr bool FEAT = FC == 32;
  constexpr bool MX = OP != OP_SUM;
  constexpr int NWK = FEAT ? FEAT_WARPS : ACT_SLOT_WARPS;
  constexpr int NT = NWK * 32;
  constexpr int COPY = FC * R_BLK;  // floats a block
  constexpr int STAGE = 3 * E_BLK;  // ints a block: seg, src, sign
  const size_t z = blockIdx.z;
  const int F = p.F, n_blocks = p.n_blocks, n_row_tiles = p.n_row_tiles;
  const int win = p.win, n_active = p.n_active;
  const float* val = p.val + z * p.n_val * F;
  const int* seg = p.seg + z * p.seg_stride;
  const int* src = p.src + z * p.seg_stride;
  const int* sign = reinterpret_cast<const int*>(p.sign) + z * p.seg_stride;
  const int* tob = p.tob + z * p.blk_stride;
  const int* fot = p.fot + z * p.blk_stride;
  const int* active = p.active + z * n_active;
  float* out = p.out + z * n_row_tiles * R_BLK * F;
  unsigned char* hit = p.hit + z * n_row_tiles * R_BLK;
  float* part = p.part + z * 2 * p.n_slot * R_BLK * F;
  int* flag = p.flag + z * 2 * p.n_slot;
  int* ticket = p.ticket + z * n_row_tiles;
  int* run = p.run + z * 3 * n_row_tiles;

  // win copies, then the staged rows of win blocks, then the warps' scratch
  extern __shared__ __align__(16) float asmem[];
  __shared__ int s_tob[ACT_MAX_WIN + 1], s_fot[ACT_MAX_WIN + 1];
  __shared__ int s_e[ACT_MAX_WIN + 2];
  __shared__ unsigned s_live;  // bit i: compact block i held a live slot
  __shared__ int s_run[2][4], s_nrun, s_npc, s_crossing;
  __shared__ PieceRec s_pc[ACT_MAX_WIN];
  __shared__ int s_cnt[NT / 32], s_list[NT];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k = blockIdx.x;
  // entries k - 1 .. k + win in one round trip: s_e[1 + i] is entry k + i
  // (-1 before the list, n_blocks past it)
  if (tid <= win + 1) {
    const int c = k - 1 + tid;
    s_e[tid] = c < 0 ? -1 : c < n_active ? active[c] : n_blocks;
  }
  if (tid == 0) s_live = 0;
  __syncthreads();
  const int a = s_e[1], a_prev = s_e[0];
  if (a < 0 || a >= n_blocks) return;  // a pad entry
  const int w = a / win;
  if (a_prev >= 0 && a_prev / win == w) return;  // not the window's opener
  const int w0 = w * win;
  const int nw = min(win, n_blocks - w0);
  const int* s_ent = s_e + 1;  // the window's active entries: a prefix
  int na = 0;
  while (na < nw && s_ent[na] < w0 + nw) ++na;

  int* stage = reinterpret_cast<int*>(asmem + win * COPY);
  float* xs = reinterpret_cast<float*>(stage + win * STAGE) +
              warp * 32 * (FC + 1);                               // slots
  int* sl = stage + win * STAGE + warp * E_BLK;                   // feat
  // stage every active block's seg and src rows, and for sum its sign row,
  // one cp.async group a block, each warp its own blocks; the window's
  // tables load meanwhile
  constexpr int ROWS = MX ? 2 : 3;  // max and min never read the sign
  int mine = 0;
  for (int i = warp; i < na; i += NWK, ++mine) {
    const size_t e0 = static_cast<size_t>(s_ent[i]) * E_BLK;
    int* st = stage + i * STAGE;
    for (int c = lane; c < ROWS * E_BLK / 4; c += 32) {
      const int row = c / (E_BLK / 4), q = c % (E_BLK / 4);
      const int* g = (row == 0 ? seg : row == 1 ? src : sign) + e0 + q * 4;
      cp_async16(st + row * E_BLK + q * 4, g);
    }
    cp_async_commit();
  }
  load_window(tob, fot, w0, nw, n_blocks, s_tob, s_fot);
  // the tiles of the entries just before and just after the window's: does
  // a run's piece here have others before or after it? Loaded by the last
  // thread, whose warp has the fewest blocks to reduce, for the tickets
  int prev_tile = -1, next_tile = -1;
  if (tid == NT - 1) {
    if (a_prev >= 0) prev_tile = tob[a_prev];
    if (s_ent[na] < n_blocks) next_tile = tob[s_ent[na]];
  }
  __syncthreads();
  if (warp == NWK - 1) {  // the piece table, while the blocks land
    const unsigned act = __reduce_or_sync(
        0xffffffffu, lane < na ? 1u << (s_ent[lane] - w0) : 0u);
    const bool crossing = piece_table(s_tob, s_fot, act, nw, n_row_tiles,
                                      p.by_window ? w : k, s_pc, &s_npc,
                                      lane);
    if (lane == 0) s_crossing = crossing;
  }
  for (int f0 = 0; f0 < F; f0 += FEAT ? 32 : F) {
    const int nf = FEAT ? min(32, F - f0) : F;
    int m = 0;
    for (int i = warp; i < na; i += NWK, ++m) {
      if (f0 == 0) {  // block i's rows have landed (later groups may not)
        if (m + 1 < mine) {
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncwarp();
      }
      float* copy = asmem + i * COPY;
      for (int j = lane; j < COPY; j += 32) copy[j] = identity<MX>();
      __syncwarp();
      const int tile = s_tob[s_ent[i] - w0];
      bool live = false;
      if (tile >= 0 && tile < n_row_tiles) {
        const GatherSlots<OP, BF16> slots{val, stage + i * STAGE,
                                          f0 == 0 ? hit : nullptr, F};
        if (FEAT) {
          live = feature_block<MX>(slots, tile * R_BLK, F, f0 + lane, copy,
                                   sl, lane);
        } else {
          live = slot_block_overlapped<FC, MX>(slots, tile * R_BLK, F, copy,
                                               xs, lane);
        }
      }
      if (lane == 0 && f0 == 0 && live) atomicOr(&s_live, 1u << i);
    }
    __syncthreads();
    fold_pieces<FC, OP, NT>(s_pc, s_npc, s_live, asmem, out, part, flag, F,
                            f0, nf);
    __syncthreads();  // the copies are read before the next pass resets them
  }

  if (!s_crossing) return;
  // tickets: the barrier orders every part and flag write of the CTA
  // before thread 0's release
  if (tid == NT - 1) {
    s_run[0][0] = prev_tile;
    s_run[0][1] = next_tile;
  }
  __syncthreads();
  if (tid == 0) {
    const int prev = s_run[0][0], next = s_run[0][1];
    int nrun = 0;
    for (int q = 0; q < s_npc; ++q) {
      const PieceRec pc = s_pc[q];
      if (pc.direct) continue;
      // a piece that does not start its run holds the window's first block
      // (else it is skipped), so its entry before is k - 1; a piece whose
      // run goes on ends the window, so its entry after is the first past
      // the window's
      const int c = pc.i1 - pc.i0, lo = k + pc.i0;
      const bool first = pc.starts || prev != pc.tile;
      const bool last = !pc.goes_on || next != pc.tile;
      int rec[3];
      if (settle(ticket + pc.tile, run + 3 * pc.tile, pc.slot, c, lo, lo + c,
                 first, last, rec)) {
        // s_run[0] is read above before it is overwritten
        s_run[nrun][0] = pc.tile;
        s_run[nrun][1] = rec[0];
        s_run[nrun][2] = rec[1];
        s_run[nrun][3] = rec[2];
        ++nrun;
      }
    }
    s_nrun = nrun;
  }
  __syncthreads();
  for (int q = 0; q < s_nrun; ++q) {
    combine_run<OP, NT>(ActivePieces{active, win, p.by_window}, F, flag,
                        part, out, s_run[q][0], s_run[q][1], s_run[q][2],
                        s_run[q][3], s_cnt, s_list);
  }
}

// ------------------------------------------- the fused stacked dense entry
struct DenseArgs {
  const float* val;  // (S, n_val, F)
  const int* seg;    // the level's seg, src and sign: shard stride
  const int* src;    //   seg_stride, n_blocks * 256 each
  const float* sign;
  const int* tob;  // (n_blocks,) a shard, shard stride blk_stride
  const int* fot;
  float* out;   // (S, n_row_tiles * 128, F)
  float* part;  // (S, 2 * n_win, 128, F) scratch: a window's two pieces
  int* flag;    // (S, 2 * n_win) scratch
  int* ticket;  // (S, n_row_tiles), zero before and after a launch
  int* run;     // (S, n_row_tiles, 3) scratch: first window and part slot
                // of a run's first piece, the window past its last
  long long n_val, seg_stride, blk_stride;
  int n_blocks, F, n_row_tiles, win;
};

// One CTA per window of win blocks (grid x), shard blockIdx.z (see the
// header): slot lanes for F <= 4 (FC = 1, 2, 4: 16 warps, block i to warp
// i % 16), feature lanes for F > 4 (FC = 32: 4 warps, one pass per 32
// features). The window's seg rows land first; the blocks holding a live
// slot of their tile then stage their src (and for sum sign) rows and are
// reduced, each piece folds its live blocks in block order, and the CTA
// settles the tickets of its at most two non-direct pieces and combines
// the runs it completes.
template <int FC, int OP, bool BF16>
__global__ void __launch_bounds__((FC == 32 ? FEAT_WARPS : ACT_SLOT_WARPS) *
                                  32)
segment_agg_dense_stacked_kernel(const DenseArgs p) {
  constexpr bool FEAT = FC == 32;
  constexpr bool MX = OP != OP_SUM;
  constexpr int NWK = FEAT ? FEAT_WARPS : ACT_SLOT_WARPS;
  constexpr int NT = NWK * 32;
  constexpr int COPY = FC * R_BLK;  // floats a block
  constexpr int STAGE = 3 * E_BLK;  // ints a block: seg, src, sign
  constexpr int ROWS = MX ? 1 : 2;  // rows staged after seg: src (and sign)
  const size_t z = blockIdx.z;
  const int F = p.F, n_blocks = p.n_blocks, n_row_tiles = p.n_row_tiles;
  const int win = p.win;
  const int n_win = (n_blocks + win - 1) / win;
  const float* val = p.val + z * p.n_val * F;
  const int* seg = p.seg + z * p.seg_stride;
  const int* src = p.src + z * p.seg_stride;
  const int* sign = reinterpret_cast<const int*>(p.sign) + z * p.seg_stride;
  const int* tob = p.tob + z * p.blk_stride;
  const int* fot = p.fot + z * p.blk_stride;
  float* out = p.out + z * n_row_tiles * R_BLK * F;
  float* part = p.part + z * 2 * n_win * R_BLK * F;
  int* flag = p.flag + z * 2 * n_win;
  int* ticket = p.ticket + z * n_row_tiles;
  int* run = p.run + z * 3 * n_row_tiles;

  // win copies, then the staged rows of win blocks, then the warps' scratch
  extern __shared__ __align__(16) float asmem[];
  __shared__ int s_tob[ACT_MAX_WIN + 1], s_fot[ACT_MAX_WIN + 1];
  __shared__ unsigned s_live;  // bit i: block i held a live slot
  __shared__ int s_prev, s_run[2][4], s_nrun, s_npc, s_crossing;
  __shared__ PieceRec s_pc[ACT_MAX_WIN];
  __shared__ int s_cnt[NT / 32], s_list[NT];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int w = blockIdx.x, w0 = w * win;
  const int nw = min(win, n_blocks - w0);

  int* stage = reinterpret_cast<int*>(asmem + win * COPY);
  float* xs = reinterpret_cast<float*>(stage + win * STAGE) +
              warp * 32 * (FC + 1);                               // slots
  int* sl = stage + win * STAGE + warp * E_BLK;                   // feat
  // the seg rows of the warp's blocks, one cp.async group; the window's
  // tables and the tile of the block before it load meanwhile
  for (int i = warp; i < nw; i += NWK) {
    const int* g = seg + static_cast<size_t>(w0 + i) * E_BLK;
    int* st = stage + i * STAGE;
    for (int q = lane; q < E_BLK / 4; q += 32) {
      cp_async16(st + q * 4, g + q * 4);
    }
  }
  cp_async_commit();
  load_window(tob, fot, w0, nw, n_blocks, s_tob, s_fot);
  if (tid == NT - 1) s_prev = w0 > 0 ? tob[w0 - 1] : -1;
  if (tid == 0) s_live = 0;
  __syncthreads();
  if (warp == NWK - 1) {  // the piece table, while the rows land
    const bool crossing = piece_table(s_tob, s_fot, (1u << nw) - 1u, nw,
                                      n_row_tiles, w, s_pc, &s_npc, lane);
    if (lane == 0) s_crossing = crossing;
  }
  cp_async_wait<0>();
  __syncwarp();
  // the warp's blocks that hold a live slot of their tile (bit m: its m-th
  // block) stage their src rows, and for sum their sign rows, one group a
  // block; a dead block costs its seg row alone
  unsigned mine = 0;
  int n_mine = 0;
  for (int i = warp, m = 0; i < nw; i += NWK, ++m) {
    const int tile = s_tob[i];
    int* st = stage + i * STAGE;
    int loc[E_BLK / 32];
    if (tile < 0 || tile >= n_row_tiles ||
        !block_rows(GatherSlots<OP, BF16>{val, st, nullptr, F}, tile * R_BLK,
                    lane, loc)) {
      continue;
    }
    mine |= 1u << m;
    ++n_mine;
    const size_t e0 = static_cast<size_t>(w0 + i) * E_BLK;
    for (int c = lane; c < ROWS * E_BLK / 4; c += 32) {
      const int row = c / (E_BLK / 4), q = c % (E_BLK / 4);
      cp_async16(st + (1 + row) * E_BLK + q * 4,
                 (row == 0 ? src : sign) + e0 + q * 4);
    }
    cp_async_commit();
  }
  for (int f0 = 0; f0 < F; f0 += FEAT ? 32 : F) {
    const int nf = FEAT ? min(32, F - f0) : F;
    int k = 0;  // the warp's live blocks reduced so far
    for (int i = warp, m = 0; i < nw; i += NWK, ++m) {
      if (((mine >> m) & 1u) == 0) continue;
      if (f0 == 0) {  // block i's rows have landed (later groups may not)
        if (k + 1 < n_mine) {
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncwarp();
      }
      ++k;
      float* copy = asmem + i * COPY;
      for (int j = lane; j < COPY; j += 32) copy[j] = identity<MX>();
      __syncwarp();
      const int row0 = s_tob[i] * R_BLK;
      const GatherSlots<OP, BF16> slots{val, stage + i * STAGE, nullptr, F};
      bool live;
      if (FEAT) {
        live = feature_block<MX>(slots, row0, F, f0 + lane, copy, sl, lane);
      } else {
        live = slot_block_overlapped<FC, MX>(slots, row0, F, copy, xs, lane);
      }
      if (lane == 0 && f0 == 0 && live) atomicOr(&s_live, 1u << i);
    }
    __syncthreads();
    fold_pieces<FC, OP, NT>(s_pc, s_npc, s_live, asmem, out, part, flag, F,
                            f0, nf);
    __syncthreads();  // the copies are read before the next pass resets them
  }

  // tickets, in windows: the barrier above orders every part and flag
  // write of the CTA before thread 0's release. A piece that does not start
  // its run holds the window's first block (else it is skipped): it goes on
  // from the window before unless the block before has another tile.
  if (!s_crossing) return;
  if (tid == 0) {
    int nrun = 0;
    for (int q = 0; q < s_npc; ++q) {
      const PieceRec pc = s_pc[q];
      if (pc.direct) continue;
      int rec[3];
      if (settle(ticket + pc.tile, run + 3 * pc.tile, pc.slot, 1, w, w + 1,
                 pc.starts || s_prev != pc.tile, !pc.goes_on, rec)) {
        s_run[nrun][0] = pc.tile;
        s_run[nrun][1] = rec[0];
        s_run[nrun][2] = rec[1];
        s_run[nrun][3] = rec[2];
        ++nrun;
      }
    }
    s_nrun = nrun;
  }
  __syncthreads();
  for (int q = 0; q < s_nrun; ++q) {
    combine_run<OP, NT>(WindowPieces{}, F, flag, part, out, s_run[q][0],
                        s_run[q][1], s_run[q][2], s_run[q][3], s_cnt, s_list);
  }
}

template <int FC, bool MAX>
cudaError_t launch_window(int grid, cudaStream_t st, const float* x,
                          const int* seg, const int* tob, const int* fot,
                          float* out, float* part, int* flag, int n_blocks,
                          int F, int n_row_tiles, int win) {
  constexpr bool FEAT = FC == 32;
  constexpr int NWK = FEAT ? FEAT_WARPS : SLOT_WARPS;
  static SmemLimit lim;
  const int smem = win * FC * R_BLK * 4 +
                   (FEAT ? NWK * E_BLK * 4 : NWK * 32 * (FC + 1) * 4);
  const cudaError_t err = allow_smem(segment_agg_kernel<FC, MAX>, smem, lim);
  if (err != cudaSuccess) return err;
  segment_agg_kernel<FC, MAX><<<grid, NWK * 32, smem, st>>>(
      x, seg, tob, fot, out, part, flag, n_blocks, F, n_row_tiles, win);
  return cudaGetLastError();
}

// The window kernel, then (unless every run lies in one window) the
// combine as a programmatic dependent.
template <bool MAX>
int launch(const void* x, const void* seg, const void* tob, const void* fot,
           void* part, void* flag, void* out, int n_blocks, int F,
           int n_row_tiles, int win, void* stream) {
  if (n_blocks <= 0 || F <= 0 || n_row_tiles <= 0 || win <= 0 ||
      win > MAX_WIN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const int* s = static_cast<const int*>(seg);
  const int* t = static_cast<const int*>(tob);
  const int* f = static_cast<const int*>(fot);
  float* o = static_cast<float*>(out);
  float* p = static_cast<float*>(part);
  int* fl = static_cast<int*>(flag);
  const int n_win = (n_blocks + win - 1) / win;
  cudaError_t err;
#define SEGAGG_LAUNCH(FC)                                                   \
  err = launch_window<FC, MAX>(n_win, st, xf, s, t, f, o, p, fl, n_blocks,  \
                               F, n_row_tiles, win)
  if (F == 1) {
    SEGAGG_LAUNCH(1);
  } else if (F == 2) {
    SEGAGG_LAUNCH(2);
  } else if (F <= 4) {
    SEGAGG_LAUNCH(4);
  } else {
    SEGAGG_LAUNCH(32);
  }
#undef SEGAGG_LAUNCH
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_win == 1) return 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_win, (F + CF - 1) / CF);
  cfg.blockDim = dim3(R_BLK);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float* pc = p;
  const int* flc = fl;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, segment_agg_combine_kernel<MAX>, t, f, pc, flc, o, n_blocks, F,
      n_row_tiles, win));
}

// The fused entries' kernels by their arguments' type.
template <int FC, int OP, bool BF16>
auto fused_kernel(const ActiveArgs&) {
  return segment_agg_active_kernel<FC, OP, BF16>;
}
template <int FC, int OP, bool BF16>
auto fused_kernel(const DenseArgs&) {
  return segment_agg_dense_stacked_kernel<FC, OP, BF16>;
}

// A fused entry's launch: one kernel, grid (grid_x, 1, n_shards), the
// shared memory of win blocks' copies and staged rows plus the warps'
// scratch.
template <class Args>
struct LaunchFused {
  const Args& a;
  int grid_x, n_shards;
  cudaStream_t st;
  template <int FC, int OP, bool BF16>
  cudaError_t go() const {
    constexpr int NWK = FC == 32 ? FEAT_WARPS : ACT_SLOT_WARPS;
    static SmemLimit lim;  // one per kernel instance
    const int smem = a.win * (FC * R_BLK + 3 * E_BLK) * 4 +
                     (FC == 32 ? NWK * E_BLK * 4 : NWK * 32 * (FC + 1) * 4);
    const auto kernel = fused_kernel<FC, OP, BF16>(a);
    const cudaError_t err = allow_smem(kernel, smem, lim);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(grid_x, 1, n_shards), NWK * 32, smem, st>>>(a);
    return cudaGetLastError();
  }
};

// l.go<FC, OP, BF16>() for the op code, the bf16 flag and F: FC = 1, 2, 4
// (slot lanes) or 32 (feature lanes).
template <int OP, bool BF16, class L>
cudaError_t by_features(int F, const L& l) {
  if (F == 1) return l.template go<1, OP, BF16>();
  if (F == 2) return l.template go<2, OP, BF16>();
  if (F <= 4) return l.template go<4, OP, BF16>();
  return l.template go<32, OP, BF16>();
}

template <bool BF16, class L>
cudaError_t by_op_of(int op, int F, const L& l) {
  if (op == OP_SUM) return by_features<OP_SUM, BF16>(F, l);
  if (op == OP_MAX) return by_features<OP_MAX, BF16>(F, l);
  return by_features<OP_MIN, BF16>(F, l);
}

template <class L>
cudaError_t by_op(int op, int bf16, int F, const L& l) {
  return bf16 ? by_op_of<true>(op, F, l) : by_op_of<false>(op, F, l);
}

}  // namespace

// x (n_blocks*256, F) f32, seg (n_blocks*256,) i32, tob/fot (n_blocks,) i32,
// part (2*n_win*128*F,) f32 and flag (2*n_win,) i32 scratch with
// n_win = ceil(n_blocks / win), out (n_row_tiles*128, F) f32; all contiguous
// on the current device. Launches on `stream`, does not synchronize, and
// returns cudaGetLastError() of the launches (0 on success).
extern "C" int segment_agg_sum_f32(const void* x, const void* seg,
                                   const void* tob, const void* fot,
                                   void* part, void* flag, void* out,
                                   int n_blocks, int F, int n_row_tiles,
                                   int win, void* stream) {
  return launch<false>(x, seg, tob, fot, part, flag, out, n_blocks, F,
                       n_row_tiles, win, stream);
}

extern "C" int segment_agg_max_f32(const void* x, const void* seg,
                                   const void* tob, const void* fot,
                                   void* part, void* flag, void* out,
                                   int n_blocks, int F, int n_row_tiles,
                                   int win, void* stream) {
  return launch<true>(x, seg, tob, fot, part, flag, out, n_blocks, F,
                      n_row_tiles, win, stream);
}

// The active entry, S = n_shards shards in one launch (1: single shard).
// op 0 sum, 1 max, 2 min; bf16 != 0 rounds each slot's value to bfloat16
// before it is reduced (the BF16 instance). val (S, n_val, F) f32; seg, src (i32) and sign
// (f32) n_blocks*256 a shard, shard z's at + z * seg_stride, 16-byte
// aligned (seg_stride a multiple of 4); tob/fot n_blocks a shard at
// + z * blk_stride; active (S, n_active) i32 ascending block indices padded
// with n_blocks; out (S, n_row_tiles*128, F) f32; hit (S, n_row_tiles*128)
// u8, cleared here (an async memset) before the one kernel launch; scratch
// part (S * 2 * n_slot * 128 * F,) f32, flag (S * 2 * n_slot,) i32, run
// (S * n_row_tiles * 3,) i32 and ticket (S * n_row_tiles,) i32 all zero (a
// launch leaves them zero), n_slot = min(n_active, ceil(n_blocks / win)):
// the windows the active list can open. win <= 16.
// Rows of tiles with no active block are left unwritten; on every row an
// active block routes to, out is bit-equal to the dense entry's over the
// level's gathered values with the other blocks' set to the op's identity,
// and hit is 1 exactly on those rows. Launches on `stream`, does not
// synchronize, and returns cudaGetLastError() (0 on success).
extern "C" int segment_agg_active_f32(
    int op, int bf16, const void* val, long long n_val, const void* seg,
    const void* src, const void* sign, const void* tob, const void* fot,
    const void* active, int n_active, int n_slot, void* out, void* hit,
    void* part, void* flag, void* ticket, void* run, int n_blocks, int F,
    int n_row_tiles, int win, int n_shards, long long seg_stride,
    long long blk_stride, void* stream) {
  if (op < OP_SUM || op > OP_MIN || n_val <= 0 || n_active <= 0 ||
      n_blocks <= 0 || F <= 0 || n_row_tiles <= 0 || win <= 0 ||
      win > ACT_MAX_WIN || n_shards <= 0 || n_shards > 65535 ||
      seg_stride < 0 || seg_stride % 4 != 0 || blk_stride < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_win = (n_blocks + win - 1) / win;
  if (n_slot != (n_active < n_win ? n_active : n_win)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ActiveArgs a{static_cast<const float*>(val),
                     static_cast<const int*>(seg),
                     static_cast<const int*>(src),
                     static_cast<const float*>(sign),
                     static_cast<const int*>(tob),
                     static_cast<const int*>(fot),
                     static_cast<const int*>(active),
                     static_cast<float*>(out),
                     static_cast<unsigned char*>(hit),
                     static_cast<float*>(part),
                     static_cast<int*>(flag),
                     static_cast<int*>(ticket),
                     static_cast<int*>(run),
                     n_val,
                     seg_stride,
                     blk_stride,
                     n_active,
                     n_blocks,
                     F,
                     n_row_tiles,
                     win,
                     n_slot,
                     n_win < n_active ? 1 : 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(
      hit, 0, static_cast<size_t>(n_shards) * n_row_tiles * R_BLK, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      by_op(op, bf16, F, LaunchFused<ActiveArgs>{a, n_active, n_shards, st}));
}

// The stacked dense entry: a dense level of S = n_shards aligned shards in
// one kernel launch. op 0 sum, 1 max, 2 min; bf16 != 0 picks the BF16
// instance, as in the active entry. val (S, n_val, F) f32; seg,
// src (i32) and sign (f32) n_blocks*256 a shard, shard z's at
// + z * seg_stride, 16-byte aligned (seg_stride a multiple of 4); tob/fot
// n_blocks a shard at + z * blk_stride (a level of stacked (S, L, ...)
// tables has strides L * n_blocks * 256 and L * n_blocks); out
// (S, n_row_tiles*128, F) f32; scratch part (S * 2 * n_win * 128 * F,) f32
// and flag (S * 2 * n_win,) i32 with n_win = ceil(n_blocks / win), run
// (S * n_row_tiles * 3,) i32 and ticket (S * n_row_tiles,) i32 all zero (a
// launch leaves them zero). win <= 16. Rows of tiles that no run visits
// are left unwritten; shard z's other rows are bit-equal to the
// single-shard dense entry's over its gathered values (see the header).
// Launches on `stream`, does not synchronize, and returns
// cudaGetLastError() (0 on success).
extern "C" int segment_agg_dense_stacked_f32(
    int op, int bf16, const void* val, long long n_val, const void* seg,
    const void* src, const void* sign, const void* tob, const void* fot,
    void* out, void* part, void* flag, void* ticket, void* run,
    int n_blocks, int F, int n_row_tiles, int win, int n_shards,
    long long seg_stride, long long blk_stride, void* stream) {
  if (op < OP_SUM || op > OP_MIN || n_val <= 0 || n_blocks <= 0 || F <= 0 ||
      n_row_tiles <= 0 || win <= 0 || win > ACT_MAX_WIN || n_shards <= 0 ||
      n_shards > 65535 || seg_stride < 0 || seg_stride % 4 != 0 ||
      blk_stride < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DenseArgs a{static_cast<const float*>(val),
                    static_cast<const int*>(seg),
                    static_cast<const int*>(src),
                    static_cast<const float*>(sign),
                    static_cast<const int*>(tob),
                    static_cast<const int*>(fot),
                    static_cast<float*>(out),
                    static_cast<float*>(part),
                    static_cast<int*>(flag),
                    static_cast<int*>(ticket),
                    static_cast<int*>(run),
                    n_val,
                    seg_stride,
                    blk_stride,
                    n_blocks,
                    F,
                    n_row_tiles,
                    win};
  return static_cast<int>(by_op(
      op, bf16, F, LaunchFused<DenseArgs>{a, (n_blocks + win - 1) / win, n_shards,
                                    static_cast<cudaStream_t>(stream)}));
}
