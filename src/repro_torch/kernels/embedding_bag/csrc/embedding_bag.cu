// EmbeddingBag (gather + weighted sum per bag) for NVIDIA Hopper (sm_90a),
// by hand.
//
// Replaces the Pallas TPU kernel `_bag_kernel` of
// src/repro/kernels/embedding_bag/embedding_bag.py (launched there by
// `embedding_bag_call` through `ops.embedding_bag`). It computes the same
// function, in the torch-style (ids, offsets) convention:
//
//   out[b] = sum over i in [offsets[b], offsets[b + 1]) with ids[i] >= 0
//            of w[i] * table[ids[i]]        (the last bag ends at n_ids)
//
// with fp32 accumulation; w[i] = 1 when no weights are given. Negative ids
// are padding and are skipped; an empty bag gives a row of zeros.
//
// Bound. The function reads each live id's table row once (4 * D bytes),
// the ids, offsets and weights once, and writes n_bags * D * 4 bytes; it
// does 2 * D operations per live id. It is bound by bytes: at DIEN's profile
// lookup (512 bags of 16 ids, D = 18) about 0.69 MB, 0.0002 ms at
// 3.35 TB/s. What sets the time instead is latency: a bag's table rows can
// only be fetched once its ids have arrived, and its ids once its offsets
// have.
//
// Design. One warp per bag, its lanes over the D features (lane, lane + 32,
// ...). For 16 ids at a time the warp issues every id and weight load (each
// lane reads the same address: one broadcast transaction) and then every
// table-row load before it uses any row, so the 16 rows of a DIEN bag are
// in flight together and a bag costs three dependent trips to memory
// (offsets, ids, rows) instead of two per id. Handing the ids out from one
// coalesced load with __shfl_sync instead was slower (the shuffles sit
// between the id and row loads). The rows are then added in id order, each
// product rounded before the add (__fmul_rn, __fadd_rn: no fused
// multiply-add), so the sum is the plain version's on the CPU bit for bit,
// and there is one writer per bag: no atomics, the same result on every
// run. The TPU kernel's
// tricks are not carried over: it appends a zero-weight sentinel id per bag
// so that every output block is visited (here the warp of an empty bag
// simply writes zeros), and it pads D to D_BLK = 512 lanes for its DMA (here
// a lane past D loads nothing; DIEN's D = 18 leaves 14 lanes idle).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int BAGS_PER_CTA = THREADS / 32;
constexpr int IN_FLIGHT = 16;  // table rows a warp loads before it adds them

__global__ void __launch_bounds__(THREADS)
embedding_bag_kernel(const float* __restrict__ table,
                     const int* __restrict__ ids,
                     const int* __restrict__ offsets,
                     const float* __restrict__ weights,
                     float* __restrict__ out, int V, int D, int n_ids,
                     int n_bags) {
  const int bag = blockIdx.x * BAGS_PER_CTA + (threadIdx.x >> 5);
  if (bag >= n_bags) return;
  const int lane = threadIdx.x & 31;
  const int lo = max(offsets[bag], 0);
  const int hi = min(bag + 1 < n_bags ? offsets[bag + 1] : n_ids, n_ids);
  float* o = out + static_cast<size_t>(bag) * D;
  for (int f0 = 0; f0 < D; f0 += 32) {
    const int f = f0 + lane;
    const bool has_f = f < D;
    float acc = 0.0f;
    for (int c0 = lo; c0 < hi; c0 += IN_FLIGHT) {
      float row[IN_FLIGHT], w[IN_FLIGHT];
      bool live[IN_FLIGHT];
      // every id, weight and row load of the group is issued before any
      // row is used (the warp's lanes read one id: a broadcast load)
#pragma unroll
      for (int u = 0; u < IN_FLIGHT; ++u) {
        const int i = c0 + u;
        const int id = i < hi ? __ldg(ids + i) : -1;
        w[u] = weights != nullptr && i < hi ? __ldg(weights + i) : 1.0f;
        live[u] = id >= 0 && id < V;  // padding (and ids off the table)
        row[u] = live[u] && has_f
                     ? __ldg(table + static_cast<size_t>(id) * D + f)
                     : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < IN_FLIGHT; ++u)
        if (live[u]) acc = __fadd_rn(acc, __fmul_rn(w[u], row[u]));
    }
    if (has_f) o[f] = acc;
  }
}

}  // namespace

// table (V, D) f32, ids (n_ids,) i32, offsets (n_bags,) i32 non-decreasing,
// weights (n_ids,) f32 or null, out (n_bags, D) f32; all contiguous on the
// current device. Launches on `stream`, does not synchronize, and returns
// cudaGetLastError() of the launch (0 on success).
extern "C" int embedding_bag_f32(const void* table, const void* ids,
                                 const void* offsets, const void* weights,
                                 void* out, int V, int D, int n_ids,
                                 int n_bags, void* stream) {
  if (V < 0 || D <= 0 || n_ids < 0 || n_bags < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_bags == 0) return 0;
  const int grid = (n_bags + BAGS_PER_CTA - 1) / BAGS_PER_CTA;
  embedding_bag_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const int*>(ids),
      static_cast<const int*>(offsets), static_cast<const float*>(weights),
      static_cast<float*>(out), V, D, n_ids, n_bags);
  return static_cast<int>(cudaGetLastError());
}
