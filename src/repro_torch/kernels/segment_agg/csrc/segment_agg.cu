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
// first_of_tile[b] == 1. Sum starts a tile at 0, max at -3e38, exactly as the
// TPU kernel; rows of tiles that no block visits are left unwritten (the
// caller masks by the level's touched rows).
//
// Design. The TPU kernel scatters with a one-hot (128 x 256) matmul on the
// MXU because the TPU has no scatter. Here one CTA owns one run of blocks
// routed to the same tile: the CTA of block b works only if
// first_of_tile[b] == 1 and walks b, b+1, ... while first_of_tile stays 0
// and tile_of_block stays the same (trailing padding blocks carry the last
// tile's id and extend its run). It is the only writer of its 128 rows, so
// there are no atomics, and thread i owns row row0 + i. Per block, the CTA
// stages seg and the block's x rows in shared memory, and every thread scans
// the 256 slots in slot order, combining the values whose seg equals its row.
// The order is fixed, so sums are bit-identical from run to run; seg need not
// be sorted inside a tile's range. Features are processed in chunks of FC
// lanes held in registers (FC = 1, 2, 4, 8, 16 or 32, the smallest that
// covers F, looping for F > 32), so scalar aggregates (F = 1), avg (F = 2)
// and top-k (F = domain) are not padded to 128 lanes.
//
// Padding. A level's block count is bucketed to a power of two and dummy
// levels are all padding, so one tile's run can hold thousands of blocks
// with seg == -1 only. A first pass (one small CTA per block, in parallel
// over the whole card) marks each block that holds any live slot; the run
// walk then reads 128 of those flags per step and skips dead blocks without
// touching their x rows.
//
// Bound. Per level the function must move E_pad * 4 B of seg, 4 * F B of x
// for each live slot and 4 * F B of output for each row of a visited tile:
// at most E_pad * (4 + 4F) + n_rows * 4F bytes. It does one add or max per
// live slot and feature, far below the card's fp32 rate, so it is bound by
// bytes. This first version reads each byte once (coalesced for x when
// F <= 32) but leaves the card partly idle on long runs: one CTA walks a hub
// tile's blocks alone, and the 256-slot scan costs 128 x 256 compares per
// block, the same work as the TPU's one-hot product. Fusing the gather
// val[src] * sign, balancing hub tiles across CTAs and TMA/wgmma staging are
// later work.

#include <cuda_runtime.h>

namespace {

constexpr int E_BLK = 256;       // slots per edge block
constexpr int R_BLK = 128;       // rows per tile == threads per CTA
constexpr int N_WARPS = R_BLK / 32;
constexpr int LIVE_THREADS = 64;

// live[b] = 1 iff block b holds a slot with seg >= 0.
__global__ void __launch_bounds__(LIVE_THREADS)
block_live_kernel(const int* __restrict__ seg, int* __restrict__ live) {
  const int* s = seg + static_cast<size_t>(blockIdx.x) * E_BLK;
  int any = 0;
  for (int i = threadIdx.x; i < E_BLK; i += LIVE_THREADS) any |= (s[i] >= 0);
  any = __syncthreads_or(any);
  if (threadIdx.x == 0) live[blockIdx.x] = any;
}

template <int FC, bool MAX>
__global__ void __launch_bounds__(R_BLK)
segment_agg_kernel(const float* __restrict__ x, const int* __restrict__ seg,
                   const int* __restrict__ tob, const int* __restrict__ fot,
                   const int* __restrict__ live, float* __restrict__ out,
                   int n_blocks, int F, int n_row_tiles) {
  const float neg = -3.0e38f;  // the TPU kernel's max identity
  const int b0 = blockIdx.x;
  if (fot[b0] != 1) return;  // not the first block of a run: no work
  const int tile = tob[b0];
  if (tile < 0 || tile >= n_row_tiles) return;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int my_row = tile * R_BLK + tid;

  __shared__ int s_seg[E_BLK];
  __shared__ float s_x[E_BLK * FC];
  __shared__ int s_list[R_BLK];     // live blocks of the current step, in order
  __shared__ int s_brk[N_WARPS];    // per warp: first position off the run
  __shared__ int s_cnt[N_WARPS];    // per warp: live blocks taken

  for (int f0 = 0; f0 < F; f0 += FC) {
    const int nf = min(FC, F - f0);
    float acc[FC];
#pragma unroll
    for (int j = 0; j < FC; ++j) acc[j] = MAX ? neg : 0.0f;

    for (int c0 = b0;; c0 += R_BLK) {
      // 1. which of the next 128 blocks continue the run
      const int bb = c0 + tid;
      const bool in_run = bb < n_blocks &&
                          (bb == b0 || (fot[bb] == 0 && tob[bb] == tile));
      const unsigned brk = __ballot_sync(0xffffffffu, !in_run);
      if (lane == 0) s_brk[warp] = brk ? warp * 32 + __ffs(brk) - 1 : R_BLK;
      __syncthreads();
      int stop = R_BLK;
#pragma unroll
      for (int w = 0; w < N_WARPS; ++w) stop = min(stop, s_brk[w]);

      // 2. compact the live ones, keeping block order
      const bool take = tid < stop && live[bb] != 0;
      const unsigned tb = __ballot_sync(0xffffffffu, take);
      if (lane == 0) s_cnt[warp] = __popc(tb);
      __syncthreads();
      int off = 0, n_list = 0;
#pragma unroll
      for (int w = 0; w < N_WARPS; ++w) {
        off += (w < warp) ? s_cnt[w] : 0;
        n_list += s_cnt[w];
      }
      if (take) s_list[off + __popc(tb & ((1u << lane) - 1u))] = bb;
      __syncthreads();

      // 3. combine each live block's slots into the owned rows, slot order
      for (int k = 0; k < n_list; ++k) {
        const size_t e0 = static_cast<size_t>(s_list[k]) * E_BLK;
        for (int i = tid; i < E_BLK; i += R_BLK) s_seg[i] = seg[e0 + i];
        for (int i = tid; i < E_BLK * nf; i += R_BLK) {
          const int s = i / nf;
          const int j = i - s * nf;
          s_x[s * FC + j] = x[(e0 + s) * F + f0 + j];
        }
        __syncthreads();
        for (int s = 0; s < E_BLK; ++s) {
          if (s_seg[s] == my_row) {
#pragma unroll
            for (int j = 0; j < FC; ++j) {
              if (j < nf) {
                const float v = s_x[s * FC + j];
                acc[j] = MAX ? fmaxf(acc[j], v) : acc[j] + v;
              }
            }
          }
        }
        __syncthreads();
      }
      if (stop < R_BLK) break;  // the run ended inside this step
    }

    float* o = out + static_cast<size_t>(my_row) * F + f0;
#pragma unroll
    for (int j = 0; j < FC; ++j) {
      if (j < nf) o[j] = acc[j];
    }
  }
}

template <bool MAX>
int launch(const void* x, const void* seg, const void* tob, const void* fot,
           void* live, void* out, int n_blocks, int F, int n_row_tiles,
           void* stream) {
  if (n_blocks <= 0 || F <= 0 || n_row_tiles <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* s = static_cast<const int*>(seg);
  int* lv = static_cast<int*>(live);
  block_live_kernel<<<n_blocks, LIVE_THREADS, 0, st>>>(s, lv);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const float* xf = static_cast<const float*>(x);
  const int* t = static_cast<const int*>(tob);
  const int* f = static_cast<const int*>(fot);
  float* o = static_cast<float*>(out);
#define SEGAGG_LAUNCH(FC_)                                              \
  segment_agg_kernel<FC_, MAX><<<n_blocks, R_BLK, 0, st>>>(             \
      xf, s, t, f, lv, o, n_blocks, F, n_row_tiles)
  if (F == 1) {
    SEGAGG_LAUNCH(1);
  } else if (F == 2) {
    SEGAGG_LAUNCH(2);
  } else if (F <= 4) {
    SEGAGG_LAUNCH(4);
  } else if (F <= 8) {
    SEGAGG_LAUNCH(8);
  } else if (F <= 16) {
    SEGAGG_LAUNCH(16);
  } else {
    SEGAGG_LAUNCH(32);
  }
#undef SEGAGG_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (n_blocks*256, F) f32, seg (n_blocks*256,) i32, tob/fot (n_blocks,) i32,
// live (n_blocks,) i32 scratch, out (n_row_tiles*128, F) f32; all contiguous
// on the current device. Launches on `stream`, does not synchronize, and
// returns cudaGetLastError() of the launches (0 on success).
extern "C" int segment_agg_sum_f32(const void* x, const void* seg,
                                   const void* tob, const void* fot,
                                   void* live, void* out, int n_blocks, int F,
                                   int n_row_tiles, void* stream) {
  return launch<false>(x, seg, tob, fot, live, out, n_blocks, F, n_row_tiles,
                       stream);
}

extern "C" int segment_agg_max_f32(const void* x, const void* seg,
                                   const void* tob, const void* fot,
                                   void* live, void* out, int n_blocks, int F,
                                   int n_row_tiles, void* stream) {
  return launch<true>(x, seg, tob, fot, live, out, n_blocks, F, n_row_tiles,
                      stream);
}
