// Flash (online-softmax) GQA attention for NVIDIA Hopper (sm_90a), by hand.
//
// Replaces the Pallas TPU kernel `_attn_kernel` of
// src/repro/kernels/flash_attention/flash_attention.py (launched there by
// `flash_attention_call`, through `ops.flash_attention` for prefill and
// `ops.flash_decode` for one-token decode). It computes the same function:
//
//   out[b, h, i] = sum_j softmax_j(q[b, h, i] . k[b, h/G, j] / sqrt(d)) v[b, h/G, j]
//
// over the live keys j of row i: j < lengths[b] (when given) and, if causal,
// j <= i + Skv - Sq (the offset of the JAX package's `blocked_attention` and
// `attention_ref`; it is the Pallas kernel's mask when Sq == Skv). G is
// Hq / Hkv: a query head reads kv head h / G, and K/V are never expanded. The
// softmax statistics (m, l) and the output accumulator are fp32; the output
// takes the input type. A row with no live key gives 0, as the Pallas
// kernel's `_finish` does with its `l > 0` guard.
//
// Prefill has two kernels; ops.py picks one from (dtype, head dim) alone:
//
// Prefill on the tensor cores (`flash_prefill_tc_kernel`: bf16, d 64 or
// 128; the LM serve path). Bound: at granite-3-2b's prefill (B 8, S 2,048,
// Hq 32, Hkv 8, d 64, causal) it does 4 d operations per live query-key
// pair, 137.5 GFLOP, against 101 MB of q, k, v and out: 0.139 ms at the bf16
// tensor-core rate (989 TFLOP/s) and 0.030 ms at 3.35 TB/s, so operations
// bound it, and only `wgmma` reaches that rate. Design:
// - A persistent grid, one CTA per SM, walks work items of (128 query rows,
//   query head, batch row): the longest q tiles first (causal work falls
//   16 to 1 across granite's q tiles), and the G query heads of one kv head
//   next to each other, so their shared K/V tiles come from L2.
// - A CTA is two consumer warpgroups of 64 q rows each and a producer
//   warpgroup, which hands its registers to the consumers (setmaxnreg: 40
//   against 232 a thread). One producer thread issues TMA loads (3-D
//   tensor maps over (d, S, B * H), 128-byte swizzle, zero fill past S):
//   the q tile, then K and V tiles of 128 keys into a ring of 2 stages.
//   mbarriers say when a tile has landed and when both warpgroups are done
//   with it: a K slot after its scores, a V slot after its P V, the q tile
//   after the item's last scores, so the next item's loads overlap this
//   item's tail.
// - Per kv tile a warpgroup computes S = Q K^T with `wgmma` m64n128k16 (Q and
//   K K-major in shared memory) and the online softmax on S in registers
//   (fp32, exp2 with the scale folded in, masks element by element only on
//   a tile that crosses the diagonal or lengths[b]), then packs P to bf16
//   in the accumulator's own register layout, which is the A-operand layout
//   of O += P V (`wgmma` m64n{d}k16, V read MN-major from shared memory).
//   Tile t's S is issued together with tile t - 1's P V, and tile t's
//   softmax runs while that P V does, so the tensor cores are not idle
//   during the softmax. P is rounded to bf16 before P V, as in every
//   tensor-core flash kernel.
// The products' order is fixed, so a rerun is bit-equal.
//
// Prefill on the CUDA cores (`flash_prefill_kernel`: fp32 at every head dim,
// bf16 at head dims 16, 32, 48). fp32 inputs keep full fp32 products (TF32
// would break the 2e-5 parity); it is off the serve path. One CTA of 256
// threads per (64 q rows, query head, batch row) walks kv tiles of 64 keys
// staged in shared memory, 4 x 4 register micro-tiles of scores per thread,
// the same early exit at the causal diagonal.
//
// Decode (`flash_decode_kernel` + `flash_decode_combine_kernel`, one query
// row per (b, head); the LM serve path's decode step). Bound: it must read
// every live K and V row once, 2 d bytes a key per kv head in bf16, and
// does 4 d operations a key per query head, ~4 operations a byte at
// granite-3-2b's GQA group of 4: far below the ~20 the CUDA cores can do
// per byte, so bytes bound it (34 MB, 0.0101 ms at 3.35 TB/s at the serve
// path's B 8 against a 2,080-row cache). Design:
// - Split KV: one CTA per (key chunk, kv head, batch row), serving all
//   G = Hq / Hkv query heads of the kv head (up to 8 a CTA), so each live
//   K/V row is read once per GQA group, not once per query head. The chunk
//   length (ops.decode_split) and the grid follow from the cache's shape
//   alone; a CTA whose chunk starts at or past lengths[b] exits at once, so
//   a short row costs one small item and a row of length 0 one CTA that
//   writes 0. At the serve shape that is 576 CTAs of 256 keys on 132 SMs.
// - Inside a CTA, each of 4 warps takes every fourth 16-key sub-tile of the
//   chunk through its own 2-stage cp.async ring (16-byte coalesced loads,
//   K rows padded against bank conflicts) and keeps fp32 (m, l, acc) for
//   its heads: two lanes score a key (half the head dim each), one max per
//   sub-tile across the warp, P.V with a lane on two output columns. No
//   __syncthreads in the key loop; the 4 warps merge in warp order.
// - A row that fits one chunk is written by that chunk's CTA. Otherwise
//   each chunk leaves its partial (m, l, acc) in fp32 scratch, and
//   `flash_decode_combine_kernel` merges a row's chunks in chunk order and
//   rounds the output once. Every order is fixed, so reruns are bit-equal.
//
// Decode over a cache whose rows are spread over ranks (`ops.
// flash_decode_partial` and `ops.flash_decode_merge`; replaces no TPU
// kernel of its own: the JAX package lets GSPMD partition
// `blocked_attention` over the cache's rows). The partial entry runs the
// same two kernels on a rank's rows, every chunk leaving its partial and
// the merge writing the row's partial (acc, m, l) unnormalised, an empty
// partial (0, -3e38, 0) for a row with no live key on the rank. The merge
// entry is the same merge kernel over the all-gathered partials, ranks for
// chunks, in rank order, skipping empty partials. Bound: the partial
// entry is the decode's (the rank's live K and V rows); the merge reads
// R (d + 2) fp32 values a query row and writes d, a few kilobytes.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"

namespace {


constexpr float NEG = -3.0e38f;  // the TPU kernel's mask value

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// --------------------------------------------------- prefill, CUDA cores
constexpr int BQ = 64;         // query rows per CTA
constexpr int BK = 64;         // keys per kv tile
constexpr int P_THREADS = 256; // a 16 x 16 grid: 4 x 4 scores per thread

template <int D>
constexpr int prefill_smem_bytes() {
  return (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1)) *
         static_cast<int>(sizeof(float));
}

template <typename T, int D>
__global__ void __launch_bounds__(P_THREADS)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ lengths,
                     T* __restrict__ out, int Hq, int Hkv, int Sq, int Skv,
                     int causal, float scale) {
  constexpr int DP = D + 1;   // padded row stride of Qs and Ks (no bank
  constexpr int PP = BK + 1;  // conflicts on the column walks)
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;            // BQ x DP
  float* Ks = Qs + BQ * DP;    // BK x DP
  float* Vs = Ks + BK * DP;    // BK x D
  float* Ps = Vs + BK * D;     // BQ x PP

  const int q0 = blockIdx.x * BQ;
  const int hq = blockIdx.y;
  const int b = blockIdx.z;
  const int hkv = hq / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int tx = tid & 15;   // score columns tx + 16 j; output columns
  const int ty = tid >> 4;   // rows 4 ty .. 4 ty + 3

  const T* qb = q + (static_cast<size_t>(b) * Hq + hq) * Sq * D;
  const T* kb = k + (static_cast<size_t>(b) * Hkv + hkv) * Skv * D;
  const T* vb = v + (static_cast<size_t>(b) * Hkv + hkv) * Skv * D;

  for (int i = tid; i < BQ * D; i += P_THREADS) {
    const int r = i / D, c = i - r * D;
    Qs[r * DP + c] =
        q0 + r < Sq ? to_f(qb[static_cast<size_t>(q0 + r) * D + c]) : 0.0f;
  }

  // keys j < kv_len are live by length; causal rows see j <= i + off
  int kv_len = Skv;
  if (lengths != nullptr) kv_len = min(kv_len, max(lengths[b], 0));
  const int off = Skv - Sq;
  int kv_end = kv_len;
  if (causal) kv_end = min(kv_end, min(q0 + BQ, Sq) + off);

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.0f;
  }

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile is done with Ks, Vs and Ps
    for (int i = tid; i < BK * D; i += P_THREADS) {
      const int r = i / D, c = i - r * D;
      const bool in = k0 + r < Skv;
      const size_t g = static_cast<size_t>(k0 + r) * D + c;
      Ks[r * DP + c] = in ? to_f(kb[g]) : 0.0f;
      Vs[r * D + c] = in ? to_f(vb[g]) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int kk = 0; kk < D; ++kk) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * DP + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * DP + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int qpos = q0 + r + off;
      bool live[4];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        live[j] = kpos < kv_len && (!causal || kpos <= qpos);
        s[i][j] = live[j] ? s[i][j] * scale : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads of a row are one half of a warp
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = live[j] ? expf(s[i][j] - m_new) : 0.0f;
        Ps[r * PP + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // Ps complete

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * PP + c];
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) {
        const float vv = Vs[c * D + tx + 16 * cc];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(pv[i], vv, acc[i][cc]);
      }
    }
  }

  T* ob = out + (static_cast<size_t>(b) * Hq + hq) * Sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Sq) continue;
    const float inv = l[i] > 0.0f ? 1.0f / l[i] : 0.0f;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      ob[static_cast<size_t>(r) * D + tx + 16 * c] = from_f<T>(acc[i][c] * inv);
  }
}

// ------------------------------------------------- prefill, tensor cores
namespace tc {

constexpr int BM = 128;                  // query rows per CTA
constexpr int BN = 128;                  // keys per kv tile
constexpr int STAGES = 2;                // K/V ring depth
constexpr int CONSUMERS = 256;            // two warpgroups of 64 q rows
constexpr int THREADS = CONSUMERS + 128;  // and a producer warpgroup
// registers per thread once the producer has handed its share to the
// consumers: 2 x 128 x 232 + 128 x 40 of the SM's 65,536
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int PANEL = 64;                // bf16 columns of one swizzled panel
constexpr int ROW = 128;                 // bytes of one panel row
constexpr int ATOM = 1024;               // bytes of one 8-row swizzle atom

// shared memory, in bytes from a 1024-byte aligned base: the q tile, then
// the K ring, then the V ring (each tile as d / 64 panels of 128-byte rows),
// then the mbarriers (q full and empty, and per stage K full, V full,
// K empty, V empty)
template <int D>
struct Layout {
  static constexpr int PANELS = D / PANEL;
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;  // one K or one V tile
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int BYTES = BAR_OFF + 8 * (2 + 4 * STAGES) + ATOM;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// S = Q K^T of one kv tile: d / 16 steps of k16, each 32 bytes further into
// the panels' swizzled rows (Q and K are K-major)
template <int D>
__device__ __forceinline__ void qk_product(float (&sc)[BN / 2], uint32_t q_wg,
                                           uint32_t ks) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t p = kk / 4, kb = (kk % 4) * 32;
    hopper::wgmma_ss_n128(
        sc, hopper::desc_sw128(q_wg + p * BM * ROW + kb, 16, ATOM),
        hopper::desc_sw128(ks + p * BN * ROW + kb, 16, ATOM), kk > 0);
  }
}

// O += P V of one kv tile: BN / 16 steps of k16, 16 V rows (two swizzle
// atoms) each; V is the MN-major B operand, its d / 64 panels LBO apart
template <int D>
__device__ __forceinline__ void pv_product(float (&o)[D / 2],
                                           const uint32_t (&pa)[BN / 16][4],
                                           uint32_t vs) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    const uint64_t db = hopper::desc_sw128(vs + kk * 2 * ATOM, BN * ROW, ATOM);
    if constexpr (D == 64) {
      hopper::wgmma_rs_n64(o, pa[kk], db);
    } else {
      hopper::wgmma_rs_n128(o, pa[kk], db);
    }
  }
}

// The online-softmax state of a thread's two accumulator rows, a and b.
struct Rows {
  int row_a, row_b;  // query rows
  float m_a, m_b;    // running max, log2 domain (-inf: no live key yet)
  float l_a, l_b;    // this thread's share of the running sum
};

// Turns one tile's scores into probabilities in place, in the log2 domain
// with the scale folded in; masks element by element only when `mask`;
// updates m and l, and returns the factors (a, b) that bring the rows'
// earlier output to the new max.
__device__ __forceinline__ float2 softmax_tile(float (&sc)[BN / 2], Rows& r,
                                               bool mask, int k0, int c,
                                               int kv_len, int causal,
                                               int off, float scale_log2) {
  constexpr float NEG_INF = -INFINITY;
  if (mask) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + 8 * j + 2 * c + (e & 1);
        const int row = (e & 2) ? r.row_b : r.row_a;
        if (kpos >= kv_len || (causal && kpos > row + off))
          sc[4 * j + e] = NEG_INF;
      }
  }
  // the four threads of a row are the four lanes of a quad
  float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    mx_a = fmaxf(mx_a, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx_b = fmaxf(mx_b, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
#pragma unroll
  for (int x = 1; x < 4; x <<= 1) {
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, x));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, x));
  }
  const float mn_a = fmaxf(r.m_a, mx_a * scale_log2);
  const float mn_b = fmaxf(r.m_b, mx_b * scale_log2);
  // a row with no live key so far keeps m = -inf: subtract 0 instead
  const float base_a = mn_a == NEG_INF ? 0.0f : mn_a;
  const float base_b = mn_b == NEG_INF ? 0.0f : mn_b;
  const float2 alpha =
      make_float2(hopper::ex2(r.m_a - base_a), hopper::ex2(r.m_b - base_b));
  float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    sc[4 * j] = hopper::ex2(fmaf(sc[4 * j], scale_log2, -base_a));
    sc[4 * j + 1] = hopper::ex2(fmaf(sc[4 * j + 1], scale_log2, -base_a));
    sc[4 * j + 2] = hopper::ex2(fmaf(sc[4 * j + 2], scale_log2, -base_b));
    sc[4 * j + 3] = hopper::ex2(fmaf(sc[4 * j + 3], scale_log2, -base_b));
    sum_a += sc[4 * j] + sc[4 * j + 1];
    sum_b += sc[4 * j + 2] + sc[4 * j + 3];
  }
  // alpha is the same on the quad, so l stays a per-thread partial sum; the
  // quad's partials are added once, at the end
  r.l_a = r.l_a * alpha.x + sum_a;
  r.l_b = r.l_b * alpha.y + sum_b;
  r.m_a = mn_a;
  r.m_b = mn_b;
  return alpha;
}

// P packed to bf16 as the A operand of P V: k16 step kk takes score columns
// 16 kk .. 16 kk + 15, which are accumulator registers 8 kk .. 8 kk + 7
__device__ __forceinline__ void pack_p(const float (&sc)[BN / 2],
                                       uint32_t (&pa)[BN / 16][4]) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    pa[j / 2][2 * (j % 2)] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
    pa[j / 2][2 * (j % 2) + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
  }
}

template <int N>
__device__ __forceinline__ void scale_rows(float (&o)[N], float2 alpha) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    o[4 * j] *= alpha.x;
    o[4 * j + 1] *= alpha.x;
    o[4 * j + 2] *= alpha.y;
    o[4 * j + 3] *= alpha.y;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_prefill_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        const int* __restrict__ lengths,
                        __nv_bfloat16* __restrict__ out, int B, int Hq,
                        int Hkv, int Sq, int Skv, int causal,
                        float scale_log2) {
  using L = Layout<D>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (hopper::smem_u32(smem_raw) + ATOM - 1) & ~(ATOM - 1u);
  const uint32_t q_s = base, k_s = base + L::K_OFF, v_s = base + L::V_OFF;
  // mbarriers: q full, q empty, then per stage K full, V full, K empty,
  // V empty
  const uint32_t q_full = base + L::BAR_OFF, q_empty = q_full + 8;
  auto k_full = [&](int s) { return q_full + 8 * (2 + s); };
  auto v_full = [&](int s) { return q_full + 8 * (2 + STAGES + s); };
  auto k_empty = [&](int s) { return q_full + 8 * (2 + 2 * STAGES + s); };
  auto v_empty = [&](int s) { return q_full + 8 * (2 + 3 * STAGES + s); };

  // work item i -> (q tile, batch row, query head): the longest q tiles
  // first, and the G query heads of a kv head next to each other
  const int n_qt = (Sq + BM - 1) / BM;
  const int n_items = n_qt * B * Hq;
  const int off = Skv - Sq;
  auto item = [&](int i, int& q0, int& b, int& hq, int& kv_len) {
    q0 = (n_qt - 1 - i / (B * Hq)) * BM;
    b = (i / Hq) % B;
    hq = i % Hq;
    // keys j < kv_len are live by length; causal row r sees j <= r + off
    kv_len = Skv;
    if (lengths != nullptr) kv_len = min(kv_len, max(lengths[b], 0));
    int kv_end = kv_len;
    if (causal) kv_end = min(kv_end, min(q0 + BM, Sq) + off);
    return kv_end > 0 ? (kv_end + BN - 1) / BN : 0;  // kv tiles to walk
  };

  const int tid = threadIdx.x;
  if (tid == 0) {
    hopper::mbar_init(q_full, 1);
    hopper::mbar_init(q_empty, CONSUMERS);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(k_full(s), 1);
      hopper::mbar_init(v_full(s), 1);
      hopper::mbar_init(k_empty(s), CONSUMERS);
      hopper::mbar_init(v_empty(s), CONSUMERS);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- producer warpgroup: one thread keeps the TMA loads in flight,
    // across work items. The q tile is reloaded once both consumer
    // warpgroups have their last scores of the previous one; a K slot is
    // freed once both have their scores of it, a V slot once their P V of
    // it is done (a tile later)
    hopper::set_max_regs_dec<PRODUCER_REGS>();
    if (tid == CONSUMERS) {
      int g = 0, n_q = 0;  // kv tiles and q tiles loaded so far
      for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
        int q0, b, hq, kv_len;
        const int n_tiles = item(i, q0, b, hq, kv_len);
        if (n_tiles == 0) continue;
        if (n_q > 0) hopper::mbar_wait(q_empty, (n_q - 1) & 1);
        hopper::mbar_expect_tx(q_full, L::Q_BYTES);
#pragma unroll
        for (int p = 0; p < L::PANELS; ++p)
          hopper::tma_load_3d(q_s + p * BM * ROW, &qmap, q_full, p * PANEL,
                              q0, b * Hq + hq);
        ++n_q;
        const int bh = b * Hkv + hq / (Hq / Hkv);
        for (int t = 0; t < n_tiles; ++t, ++g) {
          const int s = g % STAGES;
          const uint32_t ph = (g / STAGES) & 1;
          if (g >= STAGES) hopper::mbar_wait(k_empty(s), ph ^ 1);
          hopper::mbar_expect_tx(k_full(s), L::KV_BYTES);
#pragma unroll
          for (int p = 0; p < L::PANELS; ++p)
            hopper::tma_load_3d(k_s + s * L::KV_BYTES + p * BN * ROW, &kmap,
                                k_full(s), p * PANEL, t * BN, bh);
          if (g >= STAGES) hopper::mbar_wait(v_empty(s), ph ^ 1);
          hopper::mbar_expect_tx(v_full(s), L::KV_BYTES);
#pragma unroll
          for (int p = 0; p < L::PANELS; ++p)
            hopper::tma_load_3d(v_s + s * L::KV_BYTES + p * BN * ROW, &vmap,
                                v_full(s), p * PANEL, t * BN, bh);
        }
      }
    }
  } else {
    // ---- consumers: in each work item, warpgroup wg owns q rows q0 + 64 wg
    // .. + 63; this thread holds rows row_a and row_b = row_a + 8 of the
    // wgmma accumulator layout, columns 8 j + 2 c + {0, 1}. Tile t's scores
    // are computed while tile t - 1's P V runs, and tile t's softmax runs
    // while that P V still does.
    hopper::set_max_regs_inc<CONSUMER_REGS>();
    const int wg = tid >> 7;
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const int c = lane & 3;
    int g = 0, n_q = 0;  // kv tiles and q tiles consumed so far
    for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
      int q0, b, hq, kv_len;
      const int n_tiles = item(i, q0, b, hq, kv_len);
      const int r0 = q0 + 64 * wg;
      Rows r;
      r.row_a = r0 + 16 * warp + (lane >> 2);
      r.row_b = r.row_a + 8;
      r.m_a = r.m_b = -INFINITY;
      r.l_a = r.l_b = 0.0f;
      // masks only on a tile that crosses lengths[b] or the diagonal
      auto masked = [&](int t) {
        const int k0 = t * BN;
        return k0 + BN > kv_len || (causal && k0 + BN - 1 > r0 + off);
      };
      float o[D / 2];
#pragma unroll
      for (int j = 0; j < D / 2; ++j) o[j] = 0.0f;

      if (n_tiles > 0) {
        const uint32_t q_wg = q_s + 64 * wg * ROW;  // the warpgroup's rows
        float sc[BN / 2];
        uint32_t pa[BN / 16][4];
        hopper::mbar_wait(q_full, n_q & 1);
        {  // tile 0: scores only
          const int s = g % STAGES;
          hopper::mbar_wait(k_full(s), (g / STAGES) & 1);
          hopper::wgmma_fence();
          qk_product<D>(sc, q_wg, k_s + s * L::KV_BYTES);
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_regs(sc);
          hopper::mbar_arrive(k_empty(s));
          if (n_tiles == 1) hopper::mbar_arrive(q_empty);
          softmax_tile(sc, r, masked(0), 0, c, kv_len, causal, off,
                       scale_log2);
          pack_p(sc, pa);
        }
        for (int t = 1; t < n_tiles; ++t) {
          const int gt = g + t;
          const int s = gt % STAGES, sp = (gt - 1) % STAGES;
          hopper::mbar_wait(k_full(s), (gt / STAGES) & 1);
          hopper::mbar_wait(v_full(sp), ((gt - 1) / STAGES) & 1);
          hopper::wgmma_fence();
          qk_product<D>(sc, q_wg, k_s + s * L::KV_BYTES);
          hopper::wgmma_commit();
          pv_product<D>(o, pa, v_s + sp * L::KV_BYTES);
          hopper::wgmma_commit();
          hopper::wgmma_wait<1>();  // tile t's scores
          hopper::fence_regs(sc);
          hopper::mbar_arrive(k_empty(s));
          if (t == n_tiles - 1) hopper::mbar_arrive(q_empty);
          const float2 alpha = softmax_tile(sc, r, masked(t), t * BN, c,
                                            kv_len, causal, off, scale_log2);
          hopper::wgmma_wait<0>();  // tile t - 1's P V
          hopper::fence_regs(o);
          hopper::fence_regs(pa);
          hopper::mbar_arrive(v_empty(sp));
          scale_rows(o, alpha);
          pack_p(sc, pa);
        }
        // the last tile's P V
        const int gl = g + n_tiles - 1;
        const int sl = gl % STAGES;
        hopper::mbar_wait(v_full(sl), (gl / STAGES) & 1);
        hopper::wgmma_fence();
        pv_product<D>(o, pa, v_s + sl * L::KV_BYTES);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(o);
        hopper::fence_regs(pa);
        hopper::mbar_arrive(v_empty(sl));
        g += n_tiles;
        ++n_q;
      }

      float l_a = r.l_a, l_b = r.l_b;
#pragma unroll
      for (int x = 1; x < 4; x <<= 1) {
        l_a += __shfl_xor_sync(0xffffffffu, l_a, x);
        l_b += __shfl_xor_sync(0xffffffffu, l_b, x);
      }
      const float inv_a = l_a > 0.0f ? 1.0f / l_a : 0.0f;
      const float inv_b = l_b > 0.0f ? 1.0f / l_b : 0.0f;
      __nv_bfloat16* ob = out + (static_cast<size_t>(b) * Hq + hq) * Sq * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int col = 8 * j + 2 * c;
        if (r.row_a < Sq)
          *reinterpret_cast<__nv_bfloat162*>(
              ob + static_cast<size_t>(r.row_a) * D + col) =
              __floats2bfloat162_rn(o[4 * j] * inv_a, o[4 * j + 1] * inv_a);
        if (r.row_b < Sq)
          *reinterpret_cast<__nv_bfloat162*>(
              ob + static_cast<size_t>(r.row_b) * D + col) =
              __floats2bfloat162_rn(o[4 * j + 2] * inv_b,
                                    o[4 * j + 3] * inv_b);
      }
    }
  }
}

// cuTensorMapEncodeTiled lives in libcuda; the CUDA runtime hands out its
// address, so the library needs no link against libcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      return nullptr;
    }
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (heads, rows, d) bf16 tensor as a 3-D map, boxes of 64 columns x
// box_rows rows x 1 head, 128-byte swizzle, zeros past the edges. Returns 0,
// or minus the CUresult of cuTensorMapEncodeTiled.
int make_map(CUtensorMap* map, const void* ptr, int d, int rows, int heads,
             int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -static_cast<int>(CUDA_ERROR_NOT_FOUND);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(rows) * d * 2};
  const cuuint32_t box[3] = {PANEL, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -static_cast<int>(r);
}

constexpr int MAX_DEVICES = 64;

// The kernel's shared-memory opt-in and the SM count belong to the device,
// not to the call: done once per device, the SM count kept (0: not yet).
// Returns 0 and sets *n_sm, or a cudaError_t.
template <int D>
int device_setup(int* n_sm) {
  static std::atomic<int> known[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= MAX_DEVICES)
    return static_cast<int>(cudaErrorInvalidDevice);
  int n = known[dev].load(std::memory_order_acquire);
  if (n == 0) {
    e = cudaFuncSetAttribute(flash_prefill_tc_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Layout<D>::BYTES);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    known[dev].store(n, std::memory_order_release);
  }
  *n_sm = n;
  return 0;
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* out, int B, int Hq, int Hkv, int Sq, int Skv, int causal,
           float scale, cudaStream_t st) {
  if (Skv == 0) {  // no key anywhere: every row is 0
    return static_cast<int>(cudaMemsetAsync(
        out, 0, static_cast<size_t>(B) * Hq * Sq * D * 2, st));
  }
  CUtensorMap qm, km, vm;
  int rc = make_map(&qm, q, D, Sq, B * Hq, BM);
  if (rc == 0) rc = make_map(&km, k, D, Skv, B * Hkv, BN);
  if (rc == 0) rc = make_map(&vm, v, D, Skv, B * Hkv, BN);
  if (rc != 0) return rc;
  constexpr int smem = Layout<D>::BYTES;
  // a persistent grid: one CTA per SM walks the work items
  int n_sm = 0;
  rc = device_setup<D>(&n_sm);
  if (rc != 0) return rc;
  const long long n_items =
      static_cast<long long>((Sq + BM - 1) / BM) * B * Hq;
  if (n_items >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(n_items < n_sm ? n_items : n_sm);
  flash_prefill_tc_kernel<D><<<grid, THREADS, smem, st>>>(
      qm, km, vm, static_cast<const int*>(lengths),
      static_cast<__nv_bfloat16*>(out), B, Hq, Hkv, Sq, Skv, causal,
      scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// ------------------------------------------------------------------- decode
constexpr int DEC_WARPS = 4;
constexpr int DEC_THREADS = DEC_WARPS * 32;
constexpr int DEC_KT = 16;     // keys of a warp's sub-tile, two lanes a key
constexpr int DEC_STAGES = 2;  // sub-tiles a warp keeps in flight

// A warp's sub-tile in shared memory: DEC_KT K rows, each padded by 32
// bytes so that the 8 lanes of a quarter warp (4 keys x 2 halves) read 8
// distinct 16-byte bank groups, then DEC_KT V rows.
template <typename T, int D>
struct DecTile {
  static constexpr int ROW = D * static_cast<int>(sizeof(T));  // bytes
  static constexpr int KROW = ROW + 32;
  static constexpr int PIECES = ROW / 16;          // 16-byte pieces a row
  static constexpr int EP = 16 / static_cast<int>(sizeof(T));  // per piece
  static constexpr int STAGE = DEC_KT * (KROW + ROW);
  static constexpr int NPAIR = (D + 63) / 64;  // P.V column pairs a lane
};

template <typename T, int D, int GT>
constexpr int decode_smem_bytes() {
  return (GT * D + DEC_WARPS * DEC_KT * GT) * 4 +
         DEC_WARPS * DEC_STAGES * DecTile<T, D>::STAGE;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   hopper::smem_u32(smem)),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Programmatic dependent launch: the merge kernel is launched while the
// split kernel's last CTAs run, and waits here for all of its writes.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_prerequisites() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void unpack16(const uint4& u, float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack16_bf16(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const float2 x = __bfloat1622float2(h[t]);
    f[2 * t] = x.x;
    f[2 * t + 1] = x.y;
  }
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// One CTA per (key chunk, kv head and group of up to GT of its query heads,
// batch row). Warp w takes the chunk's sub-tiles w, w + 4, ... through a
// cp.async ring of DEC_STAGES sub-tiles and keeps its own (m, l, acc) for
// each head; the warps are merged in warp order at the end. A row that
// fits one chunk is written here; a longer row (or, with `partial`, every
// row) leaves its partial (m, l, acc) in `part` for
// flash_decode_combine_kernel.
template <typename T, int D, int GT>
__global__ void __launch_bounds__(DEC_THREADS)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lengths,
                    T* __restrict__ out, float* __restrict__ part, int Hq,
                    int Hkv, int S, int chunk, int n_chunks,
                    float scale_log2, int partial) {
  using L = DecTile<T, D>;
  static_assert(DEC_WARPS * GT * (D + 2) * 4 <=
                    DEC_WARPS * DEC_STAGES * L::STAGE,
                "the warp merge reuses the sub-tile ring");
  extern __shared__ __align__(16) unsigned char dsm[];
  float* qs = reinterpret_cast<float*>(dsm);  // GT x D, fp32
  float* ps_all = qs + GT * D;                // per warp: DEC_KT x GT
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      ps_all + DEC_WARPS * DEC_KT * GT);

  const int c = blockIdx.x;
  const int G = Hq / Hkv;
  const int n_hg = (G + GT - 1) / GT;
  const int hkv = blockIdx.y / n_hg;
  const int g0 = (blockIdx.y - hkv * n_hg) * GT;
  const int ng = min(GT, G - g0);
  const int b = blockIdx.z;
  const int hq0 = hkv * G + g0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = min(max(lengths[b], 0), S);
  const size_t qrow = static_cast<size_t>(b) * Hq + hq0;
  if (n == 0) {  // no live key: the row is 0, written by chunk 0
    if (c == 0 && !partial) {
      for (int i = tid; i < ng * D; i += DEC_THREADS) {
        out[qrow * D + i] = from_f<T>(0.0f);
      }
    }
    return;
  }
  const int k0 = c * chunk;
  if (k0 >= n) return;  // past the row's live keys: no work
  const int kend = min(k0 + chunk, n);
  const int n_sub = (kend - k0 + DEC_KT - 1) / DEC_KT;

  for (int i = tid; i < GT * D; i += DEC_THREADS) {
    qs[i] = i < ng * D ? to_f(q[qrow * D + i]) : 0.0f;
  }

  const size_t kv0 = (static_cast<size_t>(b) * Hkv + hkv) * S;
  const char* kg = reinterpret_cast<const char*>(k + kv0 * D);
  const char* vg = reinterpret_cast<const char*>(v + kv0 * D);
  unsigned char* wring = ring + warp * DEC_STAGES * L::STAGE;
  float* ps = ps_all + warp * DEC_KT * GT;
  const int n_mine = warp < n_sub ? (n_sub - warp + DEC_WARPS - 1) / DEC_WARPS
                                  : 0;
  auto issue = [&](int i) {  // the warp's i-th sub-tile into its ring
    const int key0 = k0 + (warp + i * DEC_WARPS) * DEC_KT;
    const int cnt = min(DEC_KT, kend - key0);
    unsigned char* ks = wring + (i % DEC_STAGES) * L::STAGE;
    unsigned char* vs = ks + DEC_KT * L::KROW;
    const size_t g = static_cast<size_t>(key0) * L::ROW;
    for (int e = lane; e < cnt * L::PIECES; e += 32) {
      const int r = e / L::PIECES, p = e - r * L::PIECES;
      cp_async16(ks + r * L::KROW + p * 16, kg + g + e * 16);
      cp_async16(vs + r * L::ROW + p * 16, vg + g + e * 16);
    }
  };
#pragma unroll
  for (int i = 0; i < DEC_STAGES; ++i) {
    if (i < n_mine) issue(i);
    cp_async_commit();
  }
  __syncthreads();  // qs

  const int j = lane >> 1, h = lane & 1;  // scores: key j, half h of d
  float m[GT], l[GT], acc[GT][L::NPAIR][2];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = NEG;
    l[g] = 0.0f;
#pragma unroll
    for (int i = 0; i < L::NPAIR; ++i) acc[g][i][0] = acc[g][i][1] = 0.0f;
  }
  for (int i = 0; i < n_mine; ++i) {
    cp_async_wait<DEC_STAGES - 1>();
    __syncwarp();  // every lane's copies of sub-tile i have landed
    const unsigned char* ks = wring + (i % DEC_STAGES) * L::STAGE;
    const unsigned char* vs = ks + DEC_KT * L::KROW;
    const int key0 = k0 + (warp + i * DEC_WARPS) * DEC_KT;
    const int cnt = min(DEC_KT, kend - key0);

    // s = q . k for key j: half h of the 16-byte pieces, interleaved
    float s[GT];
#pragma unroll
    for (int g = 0; g < GT; ++g) s[g] = 0.0f;
    const unsigned char* krow = ks + j * L::KROW;
#pragma unroll
    for (int pc = 0; pc < L::PIECES / 2; ++pc) {
      const int p = 2 * pc + h;
      const uint4 u = *reinterpret_cast<const uint4*>(krow + p * 16);
      float kf[L::EP];
      if constexpr (sizeof(T) == 2) {
        unpack16_bf16(u, kf);
      } else {
        unpack16(u, kf);
      }
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        const float4* qg =
            reinterpret_cast<const float4*>(qs + g * D + p * L::EP);
#pragma unroll
        for (int e = 0; e < L::EP / 4; ++e) {
          const float4 qq = qg[e];
          s[g] = fmaf(qq.x, kf[4 * e], s[g]);
          s[g] = fmaf(qq.y, kf[4 * e + 1], s[g]);
          s[g] = fmaf(qq.z, kf[4 * e + 2], s[g]);
          s[g] = fmaf(qq.w, kf[4 * e + 3], s[g]);
        }
      }
    }
    const bool live = j < cnt;
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      s[g] += __shfl_xor_sync(0xffffffffu, s[g], 1);
      s[g] = live ? s[g] * scale_log2 : NEG;
      float mt = s[g];
#pragma unroll
      for (int o = 2; o < 32; o <<= 1) {
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      }
      const float m_new = fmaxf(m[g], mt);
      const float alpha = exp2f(m[g] - m_new);
      const float p = live ? exp2f(s[g] - m_new) : 0.0f;
      l[g] = l[g] * alpha + (h == 0 ? p : 0.0f);
      m[g] = m_new;
#pragma unroll
      for (int pi = 0; pi < L::NPAIR; ++pi) {
        acc[g][pi][0] *= alpha;
        acc[g][pi][1] *= alpha;
      }
      if (h == 0) ps[j * GT + g] = p;
    }
    __syncwarp();  // ps

    // acc += p . v, lane on columns 64 pi + 2 lane, keys in order
#pragma unroll
    for (int jj = 0; jj < DEC_KT; ++jj) {
      if (jj < cnt) {
        float pv[GT];
#pragma unroll
        for (int g = 0; g < GT; ++g) pv[g] = ps[jj * GT + g];
        const T* vrow = reinterpret_cast<const T*>(vs + jj * L::ROW);
#pragma unroll
        for (int pi = 0; pi < L::NPAIR; ++pi) {
          const int col = 64 * pi + 2 * lane;
          if (col < D) {
            const float2 vv = load2(vrow + col);
#pragma unroll
            for (int g = 0; g < GT; ++g) {
              acc[g][pi][0] = fmaf(pv[g], vv.x, acc[g][pi][0]);
              acc[g][pi][1] = fmaf(pv[g], vv.y, acc[g][pi][1]);
            }
          }
        }
      }
    }
    __syncwarp();  // the sub-tile and ps are free
    if (i + DEC_STAGES < n_mine) issue(i + DEC_STAGES);
    cp_async_commit();
  }
#pragma unroll
  for (int g = 0; g < GT; ++g) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], o);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with its ring: reuse it

  // merge the warps in warp order: mb[warp][g] = acc[0..D), m, l
  float* mb = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    float* r = mb + (warp * GT + g) * (D + 2);
#pragma unroll
    for (int pi = 0; pi < L::NPAIR; ++pi) {
      const int col = 64 * pi + 2 * lane;
      if (col < D) {
        r[col] = acc[g][pi][0];
        r[col + 1] = acc[g][pi][1];
      }
    }
    if (lane == 0) {
      r[D] = m[g];
      r[D + 1] = l[g];
    }
  }
  __syncthreads();
  // the row's only chunk writes the output, unless the row's partial is
  // asked for
  const bool whole = n <= chunk && !partial;
  float* part_acc = part + static_cast<size_t>(gridDim.z) * Hq * n_chunks * 2;
  for (int e = tid; e < ng * D; e += DEC_THREADS) {
    const int g = e / D, d = e - g * D;
    float M = NEG;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) {
      M = fmaxf(M, mb[(w * GT + g) * (D + 2) + D]);
    }
    float Lsum = 0.0f, O = 0.0f;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) {
      const float* r = mb + (w * GT + g) * (D + 2);
      const float a = exp2f(r[D] - M);
      Lsum += r[D + 1] * a;
      O += r[d] * a;
    }
    if (whole) {
      out[(qrow + g) * D + d] = from_f<T>(O / Lsum);
    } else {
      const size_t pr = (qrow + g) * n_chunks + c;
      part_acc[pr * D + d] = O;
      if (d == 0) {
        part[pr * 2] = M;
        part[pr * 2 + 1] = Lsum;
      }
    }
  }
  launch_dependents();
}

// One CTA per (query head, batch row): partial (m, l, acc) states merged
// in order, the row's (m, l) of partial c at ml[row * ml_row + c * ml_c]
// (+1 for l), its acc at acc[row * acc_row + c * acc_c]. Modes:
// 0, a decode's chunks: the first ceil(n / chunk) of them, n =
//    clamp(lengths[b], 0, S); a row of one chunk was written by it; the
//    output rounded once;
// 1, the same chunks into the row's partial state, written unnormalised
//    to out_part (acc, m, l), also for one chunk or none (the empty
//    partial 0, NEG, 0);
// 2, n_parts partials of disjoint rows (ranks): every one read, the empty
//    ones (l == 0) skipped, 0 where none is live; lengths unread.
template <typename T, int D>
__global__ void __launch_bounds__(D)
flash_decode_combine_kernel(const float* __restrict__ ml,
                            const float* __restrict__ acc, long long ml_row,
                            long long ml_c, long long acc_row,
                            long long acc_c, const int* __restrict__ lengths,
                            T* __restrict__ out, float* __restrict__ out_part,
                            int Hq, int S, int chunk, int n_parts, int mode) {
  wait_prerequisites();
  const int hq = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  int nc = n_parts;
  if (mode != 2) {
    const int n = min(max(lengths[b], 0), S);
    nc = (n + chunk - 1) / chunk;
    if (mode == 0 && nc <= 1) return;  // written by its only chunk
  }
  const size_t row = static_cast<size_t>(b) * Hq + hq;
  extern __shared__ float s_ml[];  // the row's (m, l) of every partial
  for (int i = d; i < nc; i += D) {
    const float* src = ml + row * ml_row + i * ml_c;
    s_ml[2 * i] = src[0];
    s_ml[2 * i + 1] = src[1];
  }
  __syncthreads();
  float M = NEG;
  for (int c = 0; c < nc; ++c) {
    if (mode != 2 || s_ml[2 * c + 1] > 0.0f) M = fmaxf(M, s_ml[2 * c]);
  }
  const float* arow = acc + row * acc_row;
  float Lsum = 0.0f, O = 0.0f;
#pragma unroll 16
  for (int c = 0; c < nc; ++c) {
    if (mode == 2 && !(s_ml[2 * c + 1] > 0.0f)) continue;  // empty
    const float a = exp2f(s_ml[2 * c] - M);
    Lsum += s_ml[2 * c + 1] * a;
    O += arow[c * acc_c + d] * a;
  }
  if (mode == 1) {
    float* o = out_part + row * (D + 2);
    o[d] = O;
    if (d == 0) {
      o[D] = M;
      o[D + 1] = Lsum;
    }
  } else {
    out[row * D + d] = from_f<T>(Lsum > 0.0f ? O / Lsum : 0.0f);
  }
}

// ------------------------------------------------------------------ launch
template <typename T, int D>
int launch_prefill(const void* q, const void* k, const void* v,
                   const void* lengths, void* out, int B, int Hq, int Hkv,
                   int Sq, int Skv, int causal, float scale,
                   cudaStream_t st) {
  constexpr int smem = prefill_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_prefill_kernel<T, D><<<grid, P_THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lengths),
      static_cast<T*>(out), Hq, Hkv, Sq, Skv, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// out_part non-null: the partial entry (the rows' partial states into
// out_part, not the output into out)
template <typename T, int D, int GT>
int launch_decode_gt(const void* q, const void* k, const void* v,
                     const void* lengths, void* out, void* part,
                     void* out_part, int B, int Hq, int Hkv, int S,
                     int chunk, int n_chunks, float scale, cudaStream_t st) {
  const int partial = out_part != nullptr;
  constexpr int smem = decode_smem_bytes<T, D, GT>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_decode_kernel<T, D, GT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_hg = (Hq / Hkv + GT - 1) / GT;
  if (static_cast<long long>(Hkv) * n_hg > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(n_chunks, Hkv * n_hg, B);
  flash_decode_kernel<T, D, GT><<<grid, DEC_THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lengths),
      static_cast<T*>(out), static_cast<float*>(part), Hq, Hkv, S, chunk,
      n_chunks, scale * 1.4426950408889634f, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess || (n_chunks == 1 && !partial)) {
    return static_cast<int>(err);
  }
  const size_t ml_bytes = static_cast<size_t>(n_chunks) * 2 * sizeof(float);
  if (ml_bytes > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Hq, B);
  cfg.blockDim = dim3(D);
  cfg.dynamicSmemBytes = ml_bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float* ml = static_cast<const float*>(part);
  const float* acc = ml + static_cast<size_t>(B) * Hq * n_chunks * 2;
  const long long ml_row = 2LL * n_chunks, ml_c = 2;
  const long long acc_row = static_cast<long long>(n_chunks) * D, acc_c = D;
  const int* lens = static_cast<const int*>(lengths);
  T* o = static_cast<T*>(out);
  float* op = static_cast<float*>(out_part);
  const int mode = partial ? 1 : 0;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, flash_decode_combine_kernel<T, D>, ml, acc, ml_row, ml_c,
      acc_row, acc_c, lens, o, op, Hq, S, chunk, n_chunks, mode));
}

// The merge of R ranks' partials (R, B, Hq, D + 2) fp32 into out (B, Hq, D)
template <typename T, int D>
int launch_merge(const void* parts, void* out, int R, int B, int Hq,
                 cudaStream_t st) {
  const size_t ml_bytes = static_cast<size_t>(R) * 2 * sizeof(float);
  if (ml_bytes > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const float* p = static_cast<const float*>(parts);
  const long long row = D + 2;
  const long long rank = static_cast<long long>(B) * Hq * (D + 2);
  flash_decode_combine_kernel<T, D><<<dim3(Hq, B), D, ml_bytes, st>>>(
      p + D, p, row, rank, row, rank, nullptr, static_cast<T*>(out),
      nullptr, Hq, 0, 1, R, 2);
  return static_cast<int>(cudaGetLastError());
}

// GT, the query heads a CTA serves: the group size G rounded up to a power
// of two, at most 8 (larger groups take several CTAs per kv head)
template <typename T, int D>
int launch_decode(const void* q, const void* k, const void* v,
                  const void* lengths, void* out, void* part, void* out_part,
                  int B, int Hq, int Hkv, int S, int chunk, int n_chunks,
                  float scale, cudaStream_t st) {
  const int G = Hq / Hkv;
  if (G == 1) {
    return launch_decode_gt<T, D, 1>(q, k, v, lengths, out, part, out_part,
                                     B, Hq, Hkv, S, chunk, n_chunks, scale,
                                     st);
  }
  if (G == 2) {
    return launch_decode_gt<T, D, 2>(q, k, v, lengths, out, part, out_part,
                                     B, Hq, Hkv, S, chunk, n_chunks, scale,
                                     st);
  }
  if (G <= 4) {
    return launch_decode_gt<T, D, 4>(q, k, v, lengths, out, part, out_part,
                                     B, Hq, Hkv, S, chunk, n_chunks, scale,
                                     st);
  }
  return launch_decode_gt<T, D, 8>(q, k, v, lengths, out, part, out_part, B,
                                   Hq, Hkv, S, chunk, n_chunks, scale, st);
}

bool shapes_ok(int B, int Hq, int Hkv) {
  return B > 0 && Hq > 0 && Hkv > 0 && Hq % Hkv == 0 && Hq <= 65535 &&
         B <= 65535;
}

}  // namespace

#define FA_DISPATCH(FN, ...)                                          \
  switch (D) {                                                        \
    case 16: return bf16 ? FN<__nv_bfloat16, 16>(__VA_ARGS__)         \
                         : FN<float, 16>(__VA_ARGS__);                \
    case 32: return bf16 ? FN<__nv_bfloat16, 32>(__VA_ARGS__)         \
                         : FN<float, 32>(__VA_ARGS__);                \
    case 48: return bf16 ? FN<__nv_bfloat16, 48>(__VA_ARGS__)         \
                         : FN<float, 48>(__VA_ARGS__);                \
    case 64: return bf16 ? FN<__nv_bfloat16, 64>(__VA_ARGS__)         \
                         : FN<float, 64>(__VA_ARGS__);                \
    case 128: return bf16 ? FN<__nv_bfloat16, 128>(__VA_ARGS__)       \
                          : FN<float, 128>(__VA_ARGS__);              \
    default: return static_cast<int>(cudaErrorInvalidValue);          \
  }

// The CUDA-core prefill: fp32 at every head dim, bf16 at 16, 32 and 48 (bf16
// at 64 and 128 is the tensor-core kernel's). q (B, Hq, Sq, D), k/v (B, Hkv,
// Skv, D), out (B, Hq, Sq, D), all contiguous and of one type (bf16 != 0:
// bfloat16, else float32); lengths (B,) int32 or null. Launches on `stream`,
// does not synchronize, and returns cudaGetLastError() of the launch (0 on
// success).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, const void* lengths,
                                   void* out, int B, int Hq, int Hkv, int Sq,
                                   int Skv, int D, int causal, int bf16,
                                   float scale, void* stream) {
  if (!shapes_ok(B, Hq, Hkv) || Sq < 0 || Skv < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (Sq == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FA_PREFILL_ARGS q, k, v, lengths, out, B, Hq, Hkv, Sq, Skv, causal, \
                        scale, st
  switch (D) {
    case 16: return bf16 ? launch_prefill<__nv_bfloat16, 16>(FA_PREFILL_ARGS)
                         : launch_prefill<float, 16>(FA_PREFILL_ARGS);
    case 32: return bf16 ? launch_prefill<__nv_bfloat16, 32>(FA_PREFILL_ARGS)
                         : launch_prefill<float, 32>(FA_PREFILL_ARGS);
    case 48: return bf16 ? launch_prefill<__nv_bfloat16, 48>(FA_PREFILL_ARGS)
                         : launch_prefill<float, 48>(FA_PREFILL_ARGS);
    case 64: return bf16 ? static_cast<int>(cudaErrorInvalidValue)
                         : launch_prefill<float, 64>(FA_PREFILL_ARGS);
    case 128: return bf16 ? static_cast<int>(cudaErrorInvalidValue)
                          : launch_prefill<float, 128>(FA_PREFILL_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FA_PREFILL_ARGS
}

// The tensor-core prefill: bf16, D 64 or 128; the same arguments and layout
// as flash_attention_fwd (all pointers 16-byte aligned). Returns 0, a CUDA
// error code, or minus the CUresult of cuTensorMapEncodeTiled when a tensor
// map cannot be made.
extern "C" int flash_attention_wgmma_fwd(const void* q, const void* k,
                                         const void* v, const void* lengths,
                                         void* out, int B, int Hq, int Hkv,
                                         int Sq, int Skv, int D, int causal,
                                         float scale, void* stream) {
  if (!shapes_ok(B, Hq, Hkv) || Sq < 0 || Skv < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (Sq == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return tc::launch<64>(q, k, v, lengths, out, B, Hq, Hkv, Sq,
                                   Skv, causal, scale, st);
    case 128: return tc::launch<128>(q, k, v, lengths, out, B, Hq, Hkv, Sq,
                                     Skv, causal, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q (B, Hq, D), k/v caches (B, Hkv, S, D), out (B, Hq, D), lengths (B,)
// int32; the caches' rows must start on 16-byte boundaries. Keys are cut
// into ceil(S / chunk) chunks (chunk a positive multiple of 16); when that
// is more than one, part is fp32 scratch of B * Hq * n_chunks * (D + 2)
// floats for the chunks' partial (m, l, acc). Launches on `stream`, does
// not synchronize, and returns cudaGetLastError() of the launches.
extern "C" int flash_decode_fwd(const void* q, const void* k, const void* v,
                                const void* lengths, void* out, void* part,
                                int B, int Hq, int Hkv, int S, int D,
                                int bf16, int chunk, float scale,
                                void* stream) {
  if (!shapes_ok(B, Hq, Hkv) || S < 0 || lengths == nullptr || chunk <= 0 ||
      chunk % DEC_KT != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_chunks = S > chunk ? (S + chunk - 1) / chunk : 1;
  if (n_chunks > 1 && part == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FA_DISPATCH(launch_decode, q, k, v, lengths, out, part, nullptr, B, Hq,
              Hkv, S, chunk, n_chunks, scale, st)
}

// The partial entry: the arguments of flash_decode_fwd, with out_part
// (B, Hq, D + 2) fp32 for the rows' partial states (acc, m, l) in place of
// the output, and part always given (B * Hq * n_chunks * (D + 2) floats,
// n_chunks = ceil(S / chunk), at least 1).
extern "C" int flash_decode_partial_fwd(const void* q, const void* k,
                                        const void* v, const void* lengths,
                                        void* out_part, void* part, int B,
                                        int Hq, int Hkv, int S, int D,
                                        int bf16, int chunk, float scale,
                                        void* stream) {
  if (!shapes_ok(B, Hq, Hkv) || S < 0 || lengths == nullptr || chunk <= 0 ||
      chunk % DEC_KT != 0 || out_part == nullptr || part == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_chunks = S > chunk ? (S + chunk - 1) / chunk : 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FA_DISPATCH(launch_decode, q, k, v, lengths, nullptr, part, out_part, B,
              Hq, Hkv, S, chunk, n_chunks, scale, st)
}

// The merge entry: R partials (R, B, Hq, D + 2) fp32 of disjoint rows
// merged in order 0..R-1 into out (B, Hq, D) of the output type.
extern "C" int flash_decode_merge_fwd(const void* parts, void* out, int R,
                                      int B, int Hq, int D, int bf16,
                                      void* stream) {
  if (R <= 0 || B <= 0 || Hq <= 0 || B > 65535 || Hq > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FA_DISPATCH(launch_merge, parts, out, R, B, Hq, st)
}
