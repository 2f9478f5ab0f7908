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
// Three kernels; ops.py picks one from (dtype, head dim) alone:
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
// Decode (`flash_decode_kernel`, one query row per (b, head)): one CTA of 128
// threads per (query head, batch row); each thread scores one key of a
// 128-key tile (16-byte vector loads), a block reduction updates m and l, and
// the threads split P.V as d columns x (128 / d) key groups. It reads each
// live cache row once per query head and is bound by bytes; a split-KV
// design that reads a kv row once per GQA group is later work.

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
constexpr int D_THREADS = 128;  // one key per thread in a tile
constexpr int D_WARPS = D_THREADS / 32;

// q . row over D elements, sixteen bytes of the row at a time
template <int D>
__device__ __forceinline__ float dot_row(const float* qs, const float* row) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  float acc = 0.0f;
#pragma unroll
  for (int c = 0; c < D / 4; ++c) {
    const float4 x = r4[c];
    acc = fmaf(qs[4 * c + 0], x.x, acc);
    acc = fmaf(qs[4 * c + 1], x.y, acc);
    acc = fmaf(qs[4 * c + 2], x.z, acc);
    acc = fmaf(qs[4 * c + 3], x.w, acc);
  }
  return acc;
}

template <int D>
__device__ __forceinline__ float dot_row(const float* qs,
                                         const __nv_bfloat16* row) {
  const uint4* r4 = reinterpret_cast<const uint4*>(row);
  float acc = 0.0f;
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    const uint4 x = r4[c];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float2 f = __bfloat1622float2(h[t]);
      acc = fmaf(qs[8 * c + 2 * t], f.x, acc);
      acc = fmaf(qs[8 * c + 2 * t + 1], f.y, acc);
    }
  }
  return acc;
}

template <typename T, int D>
__global__ void __launch_bounds__(D_THREADS)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lengths,
                    T* __restrict__ out, int Hq, int Hkv, int S, float scale) {
  constexpr int G = D_THREADS / D > 0 ? D_THREADS / D : 1;  // P.V key groups
  __shared__ float qs[D];
  __shared__ float ps[D_THREADS];
  __shared__ float red_max[D_WARPS];
  __shared__ float red_sum[D_WARPS];
  __shared__ float part[G][D];

  const int hq = blockIdx.x;
  const int b = blockIdx.y;
  const int hkv = hq / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = tid / D, col = tid - g * D;  // P.V role (active if g < G)

  const T* qrow = q + (static_cast<size_t>(b) * Hq + hq) * D;
  const T* kb = k + (static_cast<size_t>(b) * Hkv + hkv) * S * D;
  const T* vb = v + (static_cast<size_t>(b) * Hkv + hkv) * S * D;
  for (int i = tid; i < D; i += D_THREADS) qs[i] = to_f(qrow[i]);
  const int n = min(max(lengths[b], 0), S);
  __syncthreads();

  float m = NEG, l = 0.0f, acc = 0.0f;
  for (int k0 = 0; k0 < n; k0 += D_THREADS) {
    const int key = k0 + tid;
    const bool live = key < n;
    const float s =
        live ? dot_row<D>(qs, kb + static_cast<size_t>(key) * D) * scale : NEG;

    float mx = s;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (lane == 0) red_max[warp] = mx;
    __syncthreads();
    mx = red_max[0];
#pragma unroll
    for (int w = 1; w < D_WARPS; ++w) mx = fmaxf(mx, red_max[w]);
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    const float p = live ? expf(s - m_new) : 0.0f;
    ps[tid] = p;
    float sum = p;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) red_sum[warp] = sum;
    __syncthreads();  // ps and red_sum complete
    sum = 0.0f;
#pragma unroll
    for (int w = 0; w < D_WARPS; ++w) sum += red_sum[w];
    l = l * alpha + sum;
    m = m_new;
    acc *= alpha;
    if (g < G) {
      const int cnt = min(D_THREADS, n - k0);
      for (int t = g; t < cnt; t += G)
        acc = fmaf(ps[t], to_f(vb[static_cast<size_t>(k0 + t) * D + col]),
                   acc);
    }
    __syncthreads();  // the tile is done with ps, red_max and red_sum
  }

  if (g < G) part[g][col] = acc;
  __syncthreads();
  if (tid < D) {
    float o = 0.0f;
#pragma unroll
    for (int gg = 0; gg < G; ++gg) o += part[gg][tid];
    out[(static_cast<size_t>(b) * Hq + hq) * D + tid] =
        from_f<T>(l > 0.0f ? o / l : 0.0f);
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

template <typename T, int D>
int launch_decode(const void* q, const void* k, const void* v,
                  const void* lengths, void* out, int B, int Hq, int Hkv,
                  int S, float scale, cudaStream_t st) {
  const dim3 grid(Hq, B);
  flash_decode_kernel<T, D><<<grid, D_THREADS, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lengths),
      static_cast<T*>(out), Hq, Hkv, S, scale);
  return static_cast<int>(cudaGetLastError());
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
// int32; the caches' rows must start on 16-byte boundaries.
extern "C" int flash_decode_fwd(const void* q, const void* k, const void* v,
                                const void* lengths, void* out, int B, int Hq,
                                int Hkv, int S, int D, int bf16, float scale,
                                void* stream) {
  if (!shapes_ok(B, Hq, Hkv) || S < 0 || lengths == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FA_DISPATCH(launch_decode, q, k, v, lengths, out, B, Hq, Hkv, S, scale, st)
}
