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
// Design. One warp per bag, its lanes over the D features (lane, lane + 32,
// ...). The warp walks its bag's ids in order and adds w[i] * table[ids[i]]
// into registers, then writes the row once: each bag has one writer, so
// there are no atomics and the sum's order is fixed: deterministic from run
// to run. The plain version in ref.py is a segment sum whose order is not
// fixed on the card, so the two agree exactly on integer-valued tables and
// to rounding (1e-6) on others. The TPU kernel's tricks are
// not carried over: it appends a zero-weight sentinel id per bag so that
// every output block is visited (here the warp of an empty bag simply
// writes zeros), and it pads D to D_BLK = 512 lanes for its DMA (here a
// lane past D does nothing: DIEN's D is 18).
//
// Bound. The function reads each live id's table row once (4 * D bytes),
// the ids, offsets and weights once, and writes n_bags * D * 4 bytes; it
// does 2 * D operations per live id. It is bound by bytes. At DIEN's
// profile lookup (512 bags of 16 ids, D = 18) that is about 0.65 MB, well
// under a microsecond at 3.35 TB/s, so the launch itself dominates; a warp
// of 32 lanes over D = 18 features also leaves 14 lanes idle.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int BAGS_PER_CTA = THREADS / 32;

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
    float acc = 0.0f;
    for (int i = lo; i < hi; ++i) {
      const int id = ids[i];
      if (id < 0 || id >= V) continue;  // padding (and ids off the table)
      const float w = weights != nullptr ? weights[i] : 1.0f;
      // the product rounded, then added (no fused multiply-add), as the
      // plain version rounds its products before it sums them
      if (f < D) {
        acc = __fadd_rn(acc,
                        __fmul_rn(w, table[static_cast<size_t>(id) * D + f]));
      }
    }
    if (f < D) o[f] = acc;
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
