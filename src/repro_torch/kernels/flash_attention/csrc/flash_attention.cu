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
// softmax and both products run in fp32 whatever the input type (fp32 or
// bf16); the output takes the input type. A row with no live key gives 0, as
// the Pallas kernel's `_finish` does with its `l > 0` guard.
//
// Prefill. One CTA of 256 threads per (q tile of 64 rows, query head, batch
// row). It stages the q tile in shared memory, then walks the kv tiles of 64
// keys: it stops at the last tile that holds a key some row of the q tile
// may see, so tiles wholly above the causal diagonal (and past lengths[b])
// are never read. Per tile the 16 x 16 thread grid computes the 64 x 64 score
// block as 4 x 4 register micro-tiles, applies the mask, and updates each
// row's running max m and normaliser l (fp32, in registers, reduced across
// the 16 threads that share a row with warp shuffles); the probabilities go
// through shared memory into the P.V product, whose 64 x d accumulator stays
// in registers (4 rows x d/16 columns per thread).
//
// Decode. One CTA of 128 threads per (query head, batch row): the single
// query row sits in shared memory, each thread scores one key of a 128-key
// tile (16-byte vector loads along its key's row), a block reduction updates
// m and l, and the threads split P.V as d columns x (128 / d) key groups. The
// TPU kernel's padding of q to 8 rows (its fp32 sublane tile) is not carried
// over.
//
// Bound. Prefill does 4 * B * Hq * d * (live q-k pairs) operations on
// B * (Hq * Sq + 2 * Hkv * Skv) * d elements in and B * Hq * Sq * d out: at
// the serve path's shapes (S = 2,048, d = 64) it is bound by operations, and
// this kernel runs them on the fp32 CUDA cores (67 TFLOP/s on the H100), not
// on the tensor cores (989 TFLOP/s bf16), so it stays far above the bound.
// Decode reads each live cache row once per query head, G times per kv head,
// and does 4 * d operations per key: it is bound by bytes. Tensor cores
// (wgmma), TMA staging, splitting a long cache across CTAs and reading each
// kv row once per GQA group are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

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

// ------------------------------------------------------------------ prefill
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

// q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D), out (B, Hq, Sq, D), all contiguous
// and of one type (bf16 != 0: bfloat16, else float32); lengths (B,) int32 or
// null. Launches on `stream`, does not synchronize, and returns
// cudaGetLastError() of the launch (0 on success).
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
  FA_DISPATCH(launch_prefill, q, k, v, lengths, out, B, Hq, Hkv, Sq, Skv,
              causal, scale, st)
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
