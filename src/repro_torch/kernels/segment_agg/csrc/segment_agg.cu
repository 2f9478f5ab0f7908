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
// The active entries (segment_agg_{sum,max}_active_f32) run the same
// function over a subset of a level's blocks, the frontier-sparse steps'
// active set: x holds only the active blocks' values, seg/tob/fot stay the
// whole level's. The windows are cut by each active block's own index in
// the level, exactly as the dense pass cuts them, a block that is not
// active is skipped as an all-padding block is, and a run's pieces are
// combined in window order. A skipped block adds the op's identity to
// nothing, so on every row an active block routes to, the output is
// bit-equal to the dense pass over the level with the inactive blocks'
// values set to the identity. Only the windows holding an active block,
// and the runs holding one, do any work: the cost follows the active set,
// not the level.
//
// The stacked entries (segment_agg_{sum,max}[_active]_stacked_f32) run S
// shards' levels of one shape in one launch, the counterpart of the TPU
// kernel under `vmap` over a shard axis: the grid's third axis is the
// shard, and each CTA first moves every pointer to its shard's slice (seg,
// tob and fot by the tables' shard strides, which may exceed one level's
// size; x, out, active, part and flag by their own sizes). A shard's CTAs
// then do exactly what the single-shard entry does on that slice, so each
// shard's output is bit-equal to a launch of the single-shard entry on it.
// Ragged active lists are padded to the widest shard with n_blocks; a pad
// entry never starts a window nor reaches the combine.

#include <cuda_runtime.h>

namespace {

constexpr int E_BLK = 256;  // slots per edge block
constexpr int R_BLK = 128;  // rows per tile
constexpr int MAX_WIN = 64;
constexpr int CF = 8;       // features per combine CTA
constexpr int PIPE = 8;     // pieces a combine thread loads at a time

// Programmatic dependent launch: the combine kernel is launched while the
// window kernel's last CTAs run, and waits here for all of their writes.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_prerequisites() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// A CTA's shard is blockIdx.z. Each kernel first moves its pointers to the
// shard's slice: tables by their shard strides, x by its blocks, out by its
// tiles, part and flag by the grid's two slots a CTA (shard 0 stays put).
struct Shard {
  long long seg_stride, blk_stride;
};

template <bool MAX>
__device__ __forceinline__ float combine(float a, float b) {
  return MAX ? fmaxf(a, b) : a + b;
}

template <bool MAX>
__device__ __forceinline__ float identity() {
  return MAX ? -3.0e38f : 0.0f;  // the TPU kernel's identities
}

// The block's seg, as row offsets in the tile (-1: padding or another
// tile), slot r * 32 + lane in loc[r]; returns whether any slot is live.
__device__ __forceinline__ bool block_rows(const int* __restrict__ seg,
                                           size_t e0, int row0, int lane,
                                           int (&loc)[E_BLK / 32]) {
  bool any = false;
#pragma unroll
  for (int r = 0; r < E_BLK / 32; ++r) {
    const int s = seg[e0 + r * 32 + lane];
    loc[r] = (s >= 0 && static_cast<unsigned>(s - row0) < R_BLK) ? s - row0
                                                                 : -1;
    any |= loc[r] >= 0;
  }
  return __any_sync(0xffffffffu, any);
}

// Slot lanes (F <= 4): one block's slots, lane = slot, into the warp's
// accumulators wacc[j * 128 + row]; xb points at the block's first slot's
// values (seg at the block's own position e0 = b * E_BLK). Every live slot's values are loaded
// first (one round trip); then per round of 32 slots, a stretch of lanes
// with one row (the sorted case) is reduced by a shuffle tree so its first
// lane holds the total, and the first lanes that share a row (seg unsorted
// inside the tile) are added in lane order by the lowest of them. Returns
// whether the block held a live slot.
template <int FC, bool MAX>
__device__ bool slot_block(const float* __restrict__ xb,
                           const int* __restrict__ seg, size_t b, int row0,
                           int F, float* wacc, float* xs, int lane) {
  const size_t e0 = b * E_BLK;
  int loc[E_BLK / 32];
  if (!block_rows(seg, e0, row0, lane, loc)) return false;
  float v[E_BLK / 32][FC];
#pragma unroll
  for (int r = 0; r < E_BLK / 32; ++r) {
    const float* xr = xb + static_cast<size_t>(r * 32 + lane) * F;
#pragma unroll
    for (int j = 0; j < FC; ++j) {
      v[r][j] = loc[r] >= 0 && j < F ? xr[j] : identity<MAX>();
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

// Feature lanes (F > 4): lane = feature f of the warp's 32 (xb as in
// slot_block), the block's slots walked in order (rows in sl, the warp's 256 ints of shared memory),
// rounds of 32 padding slots skipped; round r + 1's 32 values are loaded
// while round r's are added, and a
// stretch of slots with one row is combined in a register and added to
// wacc[row * 32 + lane] when the row changes.
template <bool MAX>
__device__ bool feature_block(const float* __restrict__ xb,
                              const int* __restrict__ seg, size_t b,
                              int row0, int F, int f, float* wacc, int* sl,
                              int lane) {
  const size_t e0 = b * E_BLK;
  int loc[E_BLK / 32];
  if (!block_rows(seg, e0, row0, lane, loc)) return false;
#pragma unroll
  for (int r = 0; r < E_BLK / 32; ++r) sl[r * 32 + lane] = loc[r];
  __syncwarp();
  unsigned rounds = 0;  // bit r: round r holds a live slot
#pragma unroll
  for (int r = 0; r < E_BLK / 32; ++r) {
    rounds |= (__ballot_sync(0xffffffffu, loc[r] >= 0) ? 1u : 0u) << r;
  }
  const bool fok = f < F;
  const float* xf = xb + f;
  float cur_x[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    cur_x[i] = sl[i] >= 0 && fok ? xf[static_cast<size_t>(i) * F]
                                 : identity<MAX>();
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
      nxt_x[i] = sl[s] >= 0 && fok ? xf[static_cast<size_t>(s) * F]
                                   : identity<MAX>();
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
//
// SPARSE (the active entry): the grid runs over the level's active blocks
// instead, `active` (n_active,) ascending block indices padded with
// n_blocks, x holding only their values (active[k]'s slots at rows
// k * E_BLK). CTA k works the window of active[k] when it is that window's
// first active entry (and exits otherwise, as pads do); the window is cut
// as in the dense pass, and a block that is not active is skipped as an
// all-padding block is, so an active row's values are added in the dense
// pass's order. Its part/flag slots are 2 k and 2 k + 1.
template <int FC, bool MAX, bool SPARSE>
__global__ void __launch_bounds__((FC == 32 ? FEAT_WARPS : SLOT_WARPS) * 32)
segment_agg_kernel(const float* __restrict__ x, const int* __restrict__ seg,
                   const int* __restrict__ tob, const int* __restrict__ fot,
                   const int* __restrict__ active, int n_active,
                   float* __restrict__ out, float* __restrict__ part,
                   int* __restrict__ flag, int n_blocks, int F,
                   int n_row_tiles, int win, Shard sh) {
  {
    const size_t z = blockIdx.z, g = gridDim.x;
    x += z * (SPARSE ? n_active : n_blocks) * E_BLK * F;
    seg += z * sh.seg_stride;
    tob += z * sh.blk_stride;
    fot += z * sh.blk_stride;
    if (SPARSE) active += z * n_active;
    out += z * n_row_tiles * R_BLK * F;
    part += z * 2 * g * R_BLK * F;
    flag += z * 2 * g;
  }
  constexpr bool FEAT = FC == 32;
  constexpr int NWK = FEAT ? FEAT_WARPS : SLOT_WARPS;
  constexpr int COPY = FC * R_BLK;  // floats a block
  extern __shared__ float smem[];   // win copies, then the warps' staging
  __shared__ int s_tob[MAX_WIN + 1], s_fot[MAX_WIN + 1], s_live[MAX_WIN];
  __shared__ int s_cmp[SPARSE ? MAX_WIN : 1];  // block -> row of x, or -1
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int w = blockIdx.x;
  if (SPARSE) {
    const int a = active[blockIdx.x];
    if (a < 0 || a >= n_blocks) return;  // a pad entry
    w = a / win;
    if (blockIdx.x > 0 && active[blockIdx.x - 1] / win == w) return;
  }
  const int w0 = w * win;
  const int nw = min(win, n_blocks - w0);
  load_window(tob, fot, w0, nw, n_blocks, s_tob, s_fot);
  if (SPARSE) {
    if (tid < nw) s_cmp[tid] = -1;
    __syncthreads();
    const int k = blockIdx.x + tid;
    if (tid < nw && k < n_active) {
      const int a = active[k];
      if (a >= w0 && a < w0 + nw) s_cmp[a - w0] = k;
    }
  }
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
      const size_t xrow = SPARSE ? static_cast<size_t>(s_cmp[bi]) * E_BLK
                                 : static_cast<size_t>(w0 + bi) * E_BLK;
      if (tile >= 0 && tile < n_row_tiles && (!SPARSE || s_cmp[bi] >= 0)) {
        const size_t b = static_cast<size_t>(w0 + bi);
        const float* xb = x + xrow * F;
        if (FEAT) {
          live = feature_block<MAX>(xb, seg, b, tile * R_BLK, F, f0 + lane,
                                    copy, sl, lane);
        } else {
          live = slot_block<FC, MAX>(xb, seg, b, tile * R_BLK, F, copy, xs,
                                     lane);
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

// Compacts, in thread order, the part slots of the threads with `live`
// into s_list; returns how many there are.
__device__ __forceinline__ int compact_live(bool live, int slot, int* s_cnt,
                                            int* s_list) {
  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5;
  const unsigned bal = __ballot_sync(0xffffffffu, live);
  if (lane == 0) s_cnt[wp] = __popc(bal);
  __syncthreads();
  int off = 0, n = 0;
#pragma unroll
  for (int q = 0; q < R_BLK / 32; ++q) {
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
                           int n_row_tiles, int win, Shard sh) {
  {
    const size_t z = blockIdx.z, g = gridDim.x;
    tob += z * sh.blk_stride;
    fot += z * sh.blk_stride;
    out += z * n_row_tiles * R_BLK * F;
    part += z * 2 * g * R_BLK * F;
    flag += z * 2 * g;
  }
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
    const int n = compact_live(tid <= stop && (fl & 1), c * 2, s_cnt, s_list);
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

// The active entry's combine: one CTA per (active entry, CF features).
// Entry i works the run of block active[i] when it is the run's first
// active block and the run does not lie wholly in that block's window (a
// run inside one window was written by the window kernel). The run's
// pieces that hold an active block are those of its active entries'
// windows: the first one at slot 2 e + s (e the window's first active
// entry; s = 0 if the run holds the window's first block), every later one
// at 2 c (c its window's first active entry, which is the run's, the run
// having started before it). They are added in window order, dead ones
// skipped; a piece without an active block is the identity, as in the
// dense combine. Runs are the layouts' own: a tile's blocks are
// consecutive and only its first carries first_of_tile.
template <bool MAX>
__global__ void __launch_bounds__(R_BLK)
segment_agg_combine_active_kernel(const int* __restrict__ tob,
                                  const int* __restrict__ fot,
                                  const int* __restrict__ active,
                                  int n_active, const float* __restrict__ part,
                                  const int* __restrict__ flag,
                                  float* __restrict__ out, int n_blocks,
                                  int F, int n_row_tiles, int win, Shard sh) {
  {
    const size_t z = blockIdx.z, g = gridDim.x;
    tob += z * sh.blk_stride;
    fot += z * sh.blk_stride;
    active += z * n_active;
    out += z * n_row_tiles * R_BLK * F;
    part += z * 2 * g * R_BLK * F;
    flag += z * 2 * g;
  }
  __shared__ int s_p0, s_p1, s_e, s_stop;
  __shared__ int s_cnt[R_BLK / 32];
  __shared__ int s_list[R_BLK];
  wait_prerequisites();
  const int tid = threadIdx.x;
  const int i = blockIdx.x;
  const int a = active[i];
  if (a < 0 || a >= n_blocks) return;
  const int tile = tob[a];
  if (tile < 0 || tile >= n_row_tiles) return;
  if (i > 0 && tob[active[i - 1]] == tile) return;  // not the run's first
  const int w = a / win, w0 = w * win;
  const int nw = min(win, n_blocks - w0);
  if (tid == 0) {
    s_p0 = nw;
    s_p1 = 0;
    s_e = i;
  }
  __syncthreads();
  if (tid < nw && tob[w0 + tid] == tile) {
    atomicMin(&s_p0, tid);
    atomicMax(&s_p1, tid + 1);
  }
  if (tid >= 1 && tid <= win && i - tid >= 0 &&
      active[i - tid] / win == w) {
    atomicMin(&s_e, i - tid);
  }
  __syncthreads();
  const int p0 = s_p0, p1 = s_p1;
  const bool starts = fot[w0 + p0] == 1;
  const int nb = w0 + nw;
  const bool goes_on = p1 == nw && nb < n_blocks && fot[nb] == 0 &&
                       tob[nb] == tile;
  if (starts && !goes_on) return;  // direct: written by the window kernel
  const int first = s_e * 2 + (p0 == 0 ? 0 : 1);

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
  for (int c0 = i + 1; c0 < n_active; c0 += R_BLK) {
    // the next R_BLK active entries: the run's while they stay in its
    // tile; an entry in a new window holds that window's piece
    const int c = c0 + tid;
    const int ac = c < n_active ? active[c] : n_blocks;
    const bool in_run = ac < n_blocks && tob[ac] == tile;
    if (tid == 0) s_stop = R_BLK;
    __syncthreads();
    if (!in_run) atomicMin(&s_stop, tid);
    __syncthreads();
    const int stop = s_stop;
    const bool opens = in_run && tid < stop && ac / win != active[c - 1] / win;
    const int n = compact_live(opens && (flag[c * 2] & 1), c * 2, s_cnt,
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

template <int FC, bool MAX, bool SPARSE>
cudaError_t launch_window(int grid, cudaStream_t st, const float* x,
                          const int* seg, const int* tob, const int* fot,
                          const int* active, int n_active, float* out,
                          float* part, int* flag, int n_blocks, int F,
                          int n_row_tiles, int win, int n_shards, Shard sh) {
  constexpr bool FEAT = FC == 32;
  constexpr int NWK = FEAT ? FEAT_WARPS : SLOT_WARPS;
  const int smem = win * FC * R_BLK * 4 +
                   (FEAT ? NWK * E_BLK * 4 : NWK * 32 * (FC + 1) * 4);
  const cudaError_t err = cudaFuncSetAttribute(
      segment_agg_kernel<FC, MAX, SPARSE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  segment_agg_kernel<FC, MAX, SPARSE>
      <<<dim3(grid, 1, n_shards), NWK * 32, smem, st>>>(
          x, seg, tob, fot, active, n_active, out, part, flag, n_blocks, F,
          n_row_tiles, win, sh);
  return cudaGetLastError();
}

// The window kernel, then (unless every run lies in one window) the
// combine as a programmatic dependent. Dense: one window CTA per window;
// sparse (active != nullptr): one per active entry; n_shards of each.
template <bool MAX>
int launch(const void* x, const void* seg, const void* tob, const void* fot,
           const void* active, int n_active, void* part, void* flag,
           void* out, int n_blocks, int F, int n_row_tiles, int win,
           int n_shards, long long seg_stride, long long blk_stride,
           void* stream) {
  const bool sparse = active != nullptr;
  if (n_blocks <= 0 || F <= 0 || n_row_tiles <= 0 || win <= 0 ||
      win > MAX_WIN || (sparse && n_active <= 0) || n_shards <= 0 ||
      n_shards > 65535 || seg_stride < 0 || blk_stride < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const int* s = static_cast<const int*>(seg);
  const int* t = static_cast<const int*>(tob);
  const int* f = static_cast<const int*>(fot);
  const int* ac = static_cast<const int*>(active);
  float* o = static_cast<float*>(out);
  float* p = static_cast<float*>(part);
  int* fl = static_cast<int*>(flag);
  const int n_win = (n_blocks + win - 1) / win;
  const int grid = sparse ? n_active : n_win;
  const Shard sh{seg_stride, blk_stride};
  cudaError_t err;
#define SEGAGG_ARGS grid, st, xf, s, t, f, ac, n_active, o, p, fl, n_blocks, \
                    F, n_row_tiles, win, n_shards, sh
#define SEGAGG_LAUNCH(FC)                                                   \
  err = sparse ? launch_window<FC, MAX, true>(SEGAGG_ARGS)                  \
               : launch_window<FC, MAX, false>(SEGAGG_ARGS)
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
#undef SEGAGG_ARGS
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_win == 1) return 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid, (F + CF - 1) / CF, n_shards);
  cfg.blockDim = dim3(R_BLK);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float* pc = p;
  const int* flc = fl;
  if (sparse) {
    return static_cast<int>(cudaLaunchKernelEx(
        &cfg, segment_agg_combine_active_kernel<MAX>, t, f, ac, n_active, pc,
        flc, o, n_blocks, F, n_row_tiles, win, sh));
  }
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, segment_agg_combine_kernel<MAX>, t, f, pc, flc, o, n_blocks, F,
      n_row_tiles, win, sh));
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
  return launch<false>(x, seg, tob, fot, nullptr, 0, part, flag, out,
                       n_blocks, F, n_row_tiles, win, 1, 0, 0, stream);
}

extern "C" int segment_agg_max_f32(const void* x, const void* seg,
                                   const void* tob, const void* fot,
                                   void* part, void* flag, void* out,
                                   int n_blocks, int F, int n_row_tiles,
                                   int win, void* stream) {
  return launch<true>(x, seg, tob, fot, nullptr, 0, part, flag, out,
                      n_blocks, F, n_row_tiles, win, 1, 0, 0, stream);
}

// The active entries: the same level's seg, tob and fot (n_blocks each, as
// above), `active` (n_active,) i32 ascending block indices padded with
// n_blocks, x (n_active*256, F) f32 the active blocks' values in that
// order, part (2*n_active*128*F,) f32 and flag (2*n_active,) i32 scratch.
// Rows of tiles with no active block are left unwritten; on every row an
// active block routes to, out is bit-equal to the dense entry's over the
// whole level with the other blocks' values set to the op's identity.
extern "C" int segment_agg_sum_active_f32(
    const void* x, const void* seg, const void* tob, const void* fot,
    const void* active, int n_active, void* part, void* flag, void* out,
    int n_blocks, int F, int n_row_tiles, int win, void* stream) {
  return launch<false>(x, seg, tob, fot, active, n_active, part, flag, out,
                       n_blocks, F, n_row_tiles, win, 1, 0, 0, stream);
}

extern "C" int segment_agg_max_active_f32(
    const void* x, const void* seg, const void* tob, const void* fot,
    const void* active, int n_active, void* part, void* flag, void* out,
    int n_blocks, int F, int n_row_tiles, int win, void* stream) {
  return launch<true>(x, seg, tob, fot, active, n_active, part, flag, out,
                      n_blocks, F, n_row_tiles, win, 1, 0, 0, stream);
}

// The stacked entries: S shards' levels of one shape in one launch. Shard
// z's seg starts at seg + z * seg_stride, its tob and fot at
// + z * blk_stride (elements: a level of stacked (S, L, ...) tables has
// strides L * n_blocks * 256 and L * n_blocks); x is (S, n_blocks*256, F)
// (dense) or (S, n_active*256, F) (active), active (S, n_active), out
// (S, n_row_tiles*128, F), part (S * 2 * G * 128 * F,) and flag
// (S * 2 * G,) with G = n_win (dense) or n_active (active); all contiguous.
// Each shard's output is bit-equal to the single-shard entry's on its slice.
extern "C" int segment_agg_sum_stacked_f32(
    const void* x, const void* seg, const void* tob, const void* fot,
    void* part, void* flag, void* out, int n_blocks, int F, int n_row_tiles,
    int win, int n_shards, long long seg_stride, long long blk_stride,
    void* stream) {
  return launch<false>(x, seg, tob, fot, nullptr, 0, part, flag, out,
                       n_blocks, F, n_row_tiles, win, n_shards, seg_stride,
                       blk_stride, stream);
}

extern "C" int segment_agg_max_stacked_f32(
    const void* x, const void* seg, const void* tob, const void* fot,
    void* part, void* flag, void* out, int n_blocks, int F, int n_row_tiles,
    int win, int n_shards, long long seg_stride, long long blk_stride,
    void* stream) {
  return launch<true>(x, seg, tob, fot, nullptr, 0, part, flag, out,
                      n_blocks, F, n_row_tiles, win, n_shards, seg_stride,
                      blk_stride, stream);
}

extern "C" int segment_agg_sum_active_stacked_f32(
    const void* x, const void* seg, const void* tob, const void* fot,
    const void* active, int n_active, void* part, void* flag, void* out,
    int n_blocks, int F, int n_row_tiles, int win, int n_shards,
    long long seg_stride, long long blk_stride, void* stream) {
  return launch<false>(x, seg, tob, fot, active, n_active, part, flag, out,
                       n_blocks, F, n_row_tiles, win, n_shards, seg_stride,
                       blk_stride, stream);
}

extern "C" int segment_agg_max_active_stacked_f32(
    const void* x, const void* seg, const void* tob, const void* fot,
    const void* active, int n_active, void* part, void* flag, void* out,
    int n_blocks, int F, int n_row_tiles, int win, int n_shards,
    long long seg_stride, long long blk_stride, void* stream) {
  return launch<true>(x, seg, tob, fot, active, n_active, part, flag, out,
                      n_blocks, F, n_row_tiles, win, n_shards, seg_stride,
                      blk_stride, stream);
}
