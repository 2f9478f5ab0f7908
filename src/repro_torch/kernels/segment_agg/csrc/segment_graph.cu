// The segment kernel's graph entry (ops.segment_agg_graph) for NVIDIA Hopper
// (sm_90a), by hand: every GNN aggregation, sum and max, forward and
// backward.
//
// Serves, on the GNN path, the Pallas TPU kernels `_sum_kernel` (:41) and
// `_max_kernel` (:59) of src/repro/kernels/segment_agg/segment_agg.py. It
// computes
//
//   out[r] = sum (or max) of val[e] over the plan's live edges e with
//            index[e] == r;   rows with no live edge read 0,
//
// for val (E, F) in fp32 or bf16 (accumulated in fp32, rows written in
// val's dtype, rounded to nearest even), out (n_rows, F).
//
// The plan (ops.EdgePlan, built once per index array on the host). The live
// edges are make_plan's layout: sorted stably by row into 256-slot blocks,
// a 128-row tile's edges padded to whole blocks. A segment is one row's
// slots inside one block. The tables (ops.graph_tables):
// - slots (n_live, 2): per live slot in layout order, its edge (bits 0-29)
//   with bit 31 set on the last slot of its segment, and the segment's
//   destination: its row when the row has one segment, else -1 - p for
//   partial p;
// - task (n_task + 1): slot offsets cutting the slots into tasks of about
//   32 slots, each a whole number of segments;
// - blocks (n_blocks + 1): slot offsets of the blocks that hold a live
//   slot (a block's live slots are a prefix of it);
// - part (n_part, 4): per partial, its row's first partial and count
//   (a crossing row's partials are consecutive, one a block, in block
//   order), the row's first block (its blocks are consecutive) and the
//   row;
// - empty (n_empty): the rows no live edge reaches.
//
// Order of additions (sum), bit-equal to the stacked route (the stacked
// dense entry of segment_agg.cu at S = 1 over the same layout, which the
// graph entry ran before this kernel):
// 1. Block sum c_b. F > 4: feature_block walks the block's slots in order,
//    keeps a row's stretch in a register (acc = x0; acc += x1; ...) and adds
//    it into the block's copy of the row, which starts at the identity +0:
//    c_b = 0 + (((x0 + x1) + x2) + ...), the left fold from +0 of the
//    row's slots. F <= 4: slot_block_overlapped takes the block in 8 rounds
//    of 32 slots (lane = slot); a row's slots in one round are summed by a
//    shuffle tree anchored at its first lane there (lanes i and i + o add
//    for o = 1, 2, 4, 8, 16, i a multiple of 2o counted from that lane, a
//    partner past the row's last lane skipped), and the rounds' totals add
//    into the copy in round order from +0.
// 2. Window sum. Windows are ops.run_chunk(n_blocks, F) blocks (4 for
//    F > 4), aligned to the block index. fold_pieces folds a run's live
//    blocks' copies in block order from +0: W = ((0 + c_b1) + c_b2) + ...;
//    a block without the row adds +0, which changes nothing (after a +0
//    start no partial is -0).
// 3. Row total. A run inside one window writes W; combine_run folds a
//    crossing run's pieces in window order from +0: ((0 + W1) + W2) + ...
// So a row's total is the fold from +0, over its windows, of the fold from
// +0, over its blocks in the window, of its block sums. This kernel
// computes exactly that: a segment's sum (the block sum) in registers, the
// partials of a crossing row folded per window and then across windows.
// Max folds with fmaxf from -3e38 (the TPU kernel's identity), in any
// order; a row with a live edge keeps what that gives.
//
// Bound: bytes. A call must read each live edge's row of val (F values)
// and write each output row once, plus 8 B of slot table a live edge; it
// does one add or max a value, far below the card's rate. The stacked
// route ran at 9-11x that bound at F 512: 4 warps a CTA over a window of 4
// blocks, a 128 x 32 copy of the tile in shared memory a block (81,920 B a
// CTA, ~8 warps an SM), 16 passes over the features in series, one float a
// lane a load.
// Design:
// - Grid: (lane groups, feature chunks). A lane group of L lanes (L a power
//   of two, 32 when a row has 32 or more vectors) covers L vectors of V
//   values of a row: V = 4 fp32 / 8 bf16 (16-byte loads) where F and val's
//   alignment allow, else 2 or 1. Wide rows split into chunks of 32 vectors
//   along grid y, so no CTA loops over features. Narrow rows put 32 / L
//   groups in a warp, each on its own tasks, so F 8 or 32 still fills the
//   card.
// - A group streams its tasks' slots in order (1 to 4 consecutive tasks,
//   picked so that the card holds about one wave): the next 8 slots'
//   records are loaded while the current 8 slots' rows are in flight, and
//   the running segment sum stays in registers; no shared memory.
// - The last slot of a segment writes its sum: straight to the output row,
//   or for a crossing row to its partial in scratch. A group keeps its
//   partials' indices and settles them together (at 2 pending, and at the
//   end), so that the groups of a warp settle side by side rather than one
//   after another: its writes fenced, an integer ticket on (row, chunk)
//   each; the last of a row's partials to arrive folds them in block
//   order, per window and across windows (4 partials' loads in flight),
//   writes the row and sets the ticket back to 0. No float atomics.
// - Sum at F <= 4 keeps the round trees of step 1 in a kernel of its own:
//   a warp a block, lane = slot, as the stacked route's slot lanes (all of
//   a block's loads in flight at once), the round totals of a segment
//   carried across rounds in registers.
// - Groups past the tasks (or blocks) write the empty rows' zeros, so
//   every row is written once and the wrapper adds no pass.
// - bf16 values are read as bf16 and widened exactly; fp32 sums round once
//   to bf16 at the store, as the stacked route's cast, fp32 reduce, cast
//   did.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <mutex>
#include <type_traits>

namespace {

constexpr int OP_SUM = 0, OP_MAX = 1;
constexpr int WARPS = 4;        // warps a CTA
constexpr int U = 8;            // slots a group keeps in flight
constexpr int ZERO_ROWS = 16;   // empty rows a group zeroes
constexpr int MAX_PER_GROUP = 4;  // tasks a group may stream
constexpr int SRC_MASK = 0x3fffffff;  // bit 31, the sign: segment's last
constexpr int MAX_DEVICES = 64;

// Matches ops._GraphPlanC.
struct GraphPlan {
  const int2* slots;
  const int* task;
  const int* blocks;
  const int4* part;  // lo, n, first block, row
  const int* empty;
  int n_live, n_task, n_blocks, n_part, n_empty, n_rows;
  int win_narrow, win_wide, device;
};

struct Launch {
  GraphPlan p;
  const void* val;
  void* out;
  float* part;   // (n_part, F) scratch
  int* ticket;   // (n_part, chunks), zero before and after a launch
  int F, win, lanes, chunks, per_group, task_groups, zero_groups;
};

constexpr int SETTLE_AT = 2;  // settled once a chunk of slots leaves this
// Crossing rows' segments that end in U consecutive slots, at most (checked
// by ops.graph_tables when it builds the plan, as ops.CHUNK_ENDS): such a
// segment ends at a full block's last slot or is the first segment of a
// block, so a block adds at most two; a block of fewer than U slots is its
// tile's last, which no row leaves, and the next tile's first block starts
// no crossing row's continuation. So U slots touching blocks b, b + 1, ...
// hold at most b's two and b + 1's first: 3.
constexpr int CHUNK_ENDS = 3;
// partials a group holds unsettled: SETTLE_AT - 1 carried over from earlier
// chunks, and the chunk's own
constexpr int PEND = SETTLE_AT - 1 + CHUNK_ENDS;
constexpr int FOLD = 4;       // partials' loads in flight in a fold

template <int OP>
__device__ __forceinline__ float comb(float a, float b) {
  return OP == OP_MAX ? fmaxf(a, b) : __fadd_rn(a, b);
}

template <int OP>
__device__ __forceinline__ float ident() {
  return OP == OP_MAX ? -3.0e38f : 0.0f;
}

__device__ __forceinline__ float lo_bf16(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_bf16(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ unsigned pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}

// N values of a row at p: one N-wide load (VEC; 16 B at most, p aligned to
// its width) or nf scalar loads (N at most 4).
template <class T, int N, bool VEC>
__device__ __forceinline__ void get(const T* p, int nf, float (&v)[N]) {
  if constexpr (!VEC) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if constexpr (std::is_same<T, float>::value) {
        v[j] = j < nf ? __ldg(p + j) : 0.0f;
      } else {
        v[j] = j < nf ? lo_bf16(__ldg(reinterpret_cast<const unsigned short*>(
                            p + j)))
                      : 0.0f;
      }
    }
  } else if constexpr (std::is_same<T, float>::value) {
    if constexpr (N == 4) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(p));
      v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    } else if constexpr (N == 2) {
      const float2 a = __ldg(reinterpret_cast<const float2*>(p));
      v[0] = a.x, v[1] = a.y;
    } else {
      v[0] = __ldg(p);
    }
  } else {
    if constexpr (N == 8) {
      const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
      const unsigned w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) v[2 * i] = lo_bf16(w[i]), v[2 * i + 1] = hi_bf16(w[i]);
    } else if constexpr (N == 4) {
      const uint2 a = __ldg(reinterpret_cast<const uint2*>(p));
      v[0] = lo_bf16(a.x), v[1] = hi_bf16(a.x);
      v[2] = lo_bf16(a.y), v[3] = hi_bf16(a.y);
    } else if constexpr (N == 2) {
      const unsigned a = __ldg(reinterpret_cast<const unsigned*>(p));
      v[0] = lo_bf16(a), v[1] = hi_bf16(a);
    } else {
      v[0] = lo_bf16(__ldg(reinterpret_cast<const unsigned short*>(p)));
    }
  }
}

// Writes N values (the first nf) to a row of T at p, rounded to nearest
// even for bf16.
template <class T, int N, bool VEC>
__device__ __forceinline__ void put(T* p, int nf, const float (&v)[N]) {
  if constexpr (!VEC) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (j < nf) {
        if constexpr (std::is_same<T, float>::value) {
          p[j] = v[j];
        } else {
          p[j] = __float2bfloat16_rn(v[j]);
        }
      }
    }
  } else if (nf > 0) {
    if constexpr (std::is_same<T, float>::value) {
      if constexpr (N == 4) {
        *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
      } else if constexpr (N == 2) {
        *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
      } else {
        *p = v[0];
      }
    } else {
      if constexpr (N == 8) {
        *reinterpret_cast<uint4*>(p) =
            make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                       pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
      } else if constexpr (N == 4) {
        *reinterpret_cast<uint2*>(p) =
            make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
      } else if constexpr (N == 2) {
        *reinterpret_cast<unsigned*>(p) = pack_bf16(v[0], v[1]);
      } else {
        *p = __float2bfloat16_rn(v[0]);
      }
    }
  }
}

// A partial's N fp32 values (the first nf), written, or read through L2
// (written by other CTAs in this launch).
template <int N>
__device__ __forceinline__ void put_part(float* p, int nf,
                                         const float (&v)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (j < nf) p[j] = v[j];
  }
}
template <int N>
__device__ __forceinline__ void get_part(const float* p, int nf,
                                         float (&v)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = j < nf ? __ldcg(p + j) : 0.0f;
}

// Settles the group's pending partials pend[0, n) (written already): the
// writes fenced, then per partial an integer ticket on (its row, chunk);
// the last of a row's partials to arrive folds them (sum: per window from
// +0, then across windows from +0; max: fmaxf from -3e38), writes the row
// and puts the ticket back to 0. Every lane of the group calls it with the
// same list, so the groups of a warp settle side by side.
template <class T, int OP, int N, bool VEC>
__device__ void settle(const Launch& a, const int (&pend)[PEND], int n,
                       int f0, int nf, unsigned gmask, int leader,
                       int lane) {
  const int F = a.F;
  __threadfence();
  __syncwarp(gmask);
  int4 info[PEND];
#pragma unroll
  for (int i = 0; i < PEND; ++i) {
    if (i < n) info[i] = __ldg(a.p.part + pend[i]);
  }
  unsigned last = 0;
  if (lane == leader) {
#pragma unroll
    for (int i = 0; i < PEND; ++i) {
      if (i < n) {
        int* t = a.ticket + static_cast<size_t>(info[i].x) * a.chunks +
                 blockIdx.y;
        if (atomicAdd(t, 1) == info[i].y - 1) {
          *t = 0;
          last |= 1u << i;
        }
      }
    }
  }
  last = __shfl_sync(gmask, last, leader);
  if (last == 0) return;
  __threadfence();
  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < PEND; ++i) {
    if (!((last >> i) & 1u)) continue;
    const int lo = info[i].x, hi = lo + info[i].y, b0 = info[i].z;
    float tot[N], wsum[N];
#pragma unroll
    for (int j = 0; j < N; ++j) tot[j] = wsum[j] = ident<OP>();
    int wcur = b0 / a.win;
    for (int q0 = lo; q0 < hi; q0 += FOLD) {
      float c[FOLD][N];
#pragma unroll
      for (int k = 0; k < FOLD; ++k) {
        get_part<N>(a.part + static_cast<size_t>(q0 + k) * F + f0,
                    q0 + k < hi ? nf : 0, c[k]);
      }
#pragma unroll
      for (int k = 0; k < FOLD; ++k) {
        if (q0 + k >= hi) break;
        if (OP == OP_SUM) {
          const int w = (b0 + q0 + k - lo) / a.win;
          if (w != wcur) {
#pragma unroll
            for (int j = 0; j < N; ++j) {
              tot[j] = comb<OP>(tot[j], wsum[j]);
              wsum[j] = ident<OP>();
            }
            wcur = w;
          }
#pragma unroll
          for (int j = 0; j < N; ++j) wsum[j] = comb<OP>(wsum[j], c[k][j]);
        } else {
#pragma unroll
          for (int j = 0; j < N; ++j) tot[j] = comb<OP>(tot[j], c[k][j]);
        }
      }
    }
    if (OP == OP_SUM) {
#pragma unroll
      for (int j = 0; j < N; ++j) tot[j] = comb<OP>(tot[j], wsum[j]);
    }
    put<T, N, VEC>(out + static_cast<size_t>(info[i].w) * F + f0, nf, tot);
  }
}

// One lane group (see the header) per grid slot: a group of a.lanes lanes,
// N = V values a lane at feature f0, vector loads.
template <class T, int OP, int N>
__global__ void __launch_bounds__(WARPS * 32)
    segment_agg_graph_kernel(const Launch a) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int L = a.lanes;
  const int gi = lane / L, li = lane - gi * L;
  const int leader = gi * L;
  const unsigned gmask =
      (L == 32 ? 0xffffffffu : ((1u << L) - 1u)) << leader;
  const int group = (blockIdx.x * WARPS + warp) * (32 / L) + gi;
  const int F = a.F;
  const int f0 = (blockIdx.y * L + li) * N;
  const int nf = f0 < F ? N : 0;
  const T* val = static_cast<const T*>(a.val);
  T* out = static_cast<T*>(a.out);

  if (group >= a.task_groups) {  // the empty rows' zeros
    const int z0 = (group - a.task_groups) * ZERO_ROWS;
    const int z1 = min(z0 + ZERO_ROWS, a.p.n_empty);
    float zero[N];
#pragma unroll
    for (int j = 0; j < N; ++j) zero[j] = 0.0f;
    for (int i = z0; i < z1; ++i) {
      put<T, N, true>(out + static_cast<size_t>(__ldg(a.p.empty + i)) * F + f0,
                      nf, zero);
    }
    return;
  }
  const int t0 = group * a.per_group;
  const int s_begin = __ldg(a.p.task + t0);
  const int s_end = __ldg(a.p.task + min(t0 + a.per_group, a.p.n_task));

  float acc[N];
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j] = ident<OP>();
  int pend[PEND];  // partials written, not yet settled
  int n_pend = 0;
  int2 nx[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    nx[u] = s_begin + u < s_end ? __ldg(a.p.slots + s_begin + u)
                                : make_int2(0, 0);
  }
  for (int s = s_begin; s < s_end; s += U) {
    int2 cur[U];
    float v[U][N];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      cur[u] = nx[u];
      if (s + u < s_end && nf > 0) {
        get<T, N, true>(val + static_cast<size_t>(cur[u].x & SRC_MASK) * F + f0,
                        nf, v[u]);
      } else {
#pragma unroll
        for (int j = 0; j < N; ++j) v[u][j] = 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int sn = s + U + u;
      nx[u] = sn < s_end ? __ldg(a.p.slots + sn) : make_int2(0, 0);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (s + u >= s_end) break;  // the same for the group's lanes
#pragma unroll
      for (int j = 0; j < N; ++j) acc[j] = comb<OP>(acc[j], v[u][j]);
      if (cur[u].x < 0) {  // the segment's last slot
        const int dst = cur[u].y;
        if (dst >= 0) {
          put<T, N, true>(out + static_cast<size_t>(dst) * F + f0, nf, acc);
        } else {
          put_part<N>(a.part + static_cast<size_t>(-1 - dst) * F + f0, nf,
                      acc);
#pragma unroll
          for (int i = 0; i < PEND; ++i) {
            if (i == n_pend) pend[i] = -1 - dst;
          }
          ++n_pend;
        }
#pragma unroll
        for (int j = 0; j < N; ++j) acc[j] = ident<OP>();
      }
    }
    // at most SETTLE_AT - 1 carried in plus CHUNK_ENDS of this chunk, so
    // n_pend <= PEND (tests/test_torch_graph_plan.py's "pending" plan
    // reaches PEND)
    if (n_pend >= SETTLE_AT) {
      settle<T, OP, N, true>(a, pend, n_pend, f0, nf, gmask, leader, lane);
      n_pend = 0;
    }
  }
  if (n_pend > 0) {
    settle<T, OP, N, true>(a, pend, n_pend, f0, nf, gmask, leader, lane);
  }
}

// Sum at F <= 4: one warp a block that holds a live slot, lane = slot of a
// 32-slot round (the block's live slots are a prefix of it), every slot's
// loads in flight at once. A segment's stretch in a round is summed by the
// stacked route's shuffle tree, the round totals folded from +0 in round
// order (a segment running past lane 31 carried to lane 0 of the next
// round), and the sum written at the segment's last slot; the lanes that
// wrote crossing rows' partials (at most 2 a block) settle them at the end.
// Groups past the blocks zero the empty rows, a lane a row.
template <class T>
__global__ void __launch_bounds__(WARPS * 32)
    segment_agg_graph_tree_kernel(const Launch a) {
  constexpr int N = 4, NR = 256 / 32;
  constexpr unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int F = a.F;
  const T* val = static_cast<const T*>(a.val);
  T* out = static_cast<T*>(a.out);
  if (w >= a.task_groups) {
    const int i = (w - a.task_groups) * ZERO_ROWS + lane;
    if (lane < ZERO_ROWS && i < a.p.n_empty) {
      const float zero[N] = {0.0f, 0.0f, 0.0f, 0.0f};
      put<T, N, false>(out + static_cast<size_t>(__ldg(a.p.empty + i)) * F,
                       F, zero);
    }
    return;
  }
  const int s0 = __ldg(a.p.blocks + w), s1 = __ldg(a.p.blocks + w + 1);
  int2 rec[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int s = s0 + r * 32 + lane;
    rec[r] = s < s1 ? __ldg(a.p.slots + s) : make_int2(0, INT_MIN);
  }
  float v[NR][N];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    get<T, N, false>(val + static_cast<size_t>(rec[r].x & SRC_MASK) * F,
                     s0 + r * 32 + lane < s1 ? F : 0, v[r]);
  }
  float carry[N];  // the sum so far of the segment going on past lane 31
  int carry_d = INT_MIN;
  int pend[PEND];
  int n_pend = 0;
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    if (s0 + r * 32 >= s1) break;  // the same for the warp
    const int d = rec[r].y;  // the segment's destination: INT_MIN past s1
    const bool valid = d != INT_MIN;
    const int nxt = __shfl_down_sync(FULL, d, 1);
    const int prv = __shfl_up_sync(FULL, d, 1);
    const unsigned tails =
        __ballot_sync(FULL, valid && (lane == 31 || nxt != d));
    const bool head = valid && (lane == 0 || prv != d);
    const int end = valid ? lane + __ffs(tails >> lane) - 1 : lane;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float t = __shfl_down_sync(FULL, v[r][j], o);
        if (lane + o <= end) v[r][j] = comb<OP_SUM>(v[r][j], t);
      }
    }
    const bool ends = __shfl_sync(FULL, rec[r].x < 0 ? 1 : 0, end) != 0;
    float acc[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      acc[j] = comb<OP_SUM>(lane == 0 && d == carry_d ? carry[j] : 0.0f,
                            v[r][j]);
    }
    if (head && ends) {
      if (d >= 0) {
        put<T, N, false>(out + static_cast<size_t>(d) * F, F, acc);
      } else {
        put_part<N>(a.part + static_cast<size_t>(-1 - d) * F, F, acc);
#pragma unroll
        for (int i = 0; i < PEND; ++i) {
          if (i == n_pend) pend[i] = -1 - d;
        }
        ++n_pend;
      }
    }
    const unsigned goes = __ballot_sync(FULL, head && !ends);
    carry_d = INT_MIN;
    if (goes) {
      const int hc = __ffs(goes) - 1;
#pragma unroll
      for (int j = 0; j < N; ++j) carry[j] = __shfl_sync(FULL, acc[j], hc);
      carry_d = __shfl_sync(FULL, d, hc);
    }
  }
  if (n_pend > 0) {
    settle<T, OP_SUM, N, false>(a, pend, n_pend, 0, F, 1u << lane, lane,
                                lane);
  }
}

template <class T, int OP, int N>
cudaError_t go(const Launch& a, int grid_x, cudaStream_t st) {
  segment_agg_graph_kernel<T, OP, N>
      <<<dim3(grid_x, a.chunks), WARPS * 32, 0, st>>>(a);
  return cudaGetLastError();
}

template <class T, int OP>
cudaError_t by_width(const Launch& a, int V, bool tree, int grid_x,
                     cudaStream_t st) {
  if (tree) {
    segment_agg_graph_tree_kernel<T><<<grid_x, WARPS * 32, 0, st>>>(a);
    return cudaGetLastError();
  }
  if constexpr (std::is_same<T, float>::value) {
    if (V == 4) return go<T, OP, 4>(a, grid_x, st);
  } else {
    if (V == 8) return go<T, OP, 8>(a, grid_x, st);
    if (V == 4) return go<T, OP, 4>(a, grid_x, st);
  }
  if (V == 2) return go<T, OP, 2>(a, grid_x, st);
  return go<T, OP, 1>(a, grid_x, st);
}

std::mutex sm_lock;
int sm_count[MAX_DEVICES] = {};

int sms(int dev) {
  std::lock_guard<std::mutex> hold(sm_lock);
  if (sm_count[dev] == 0 &&
      cudaDeviceGetAttribute(&sm_count[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess) {
    sm_count[dev] = 132;
  }
  return sm_count[dev];
}

}  // namespace

// One graph-entry call. plan: a GraphPlan (ops._GraphPlanC) whose tables lie
// on plan->device; op 0 sum, 1 max; bf16 != 0: val and out bfloat16, else
// float32. val (n_edges, F) contiguous on that device, out (n_rows, F) of
// val's dtype, 16-byte aligned; part (n_part * F,) f32 scratch; ticket
// (n_part * ceil(F / 32),) i32, all zero (a launch leaves it zero). Every
// output row is written. Launches on `stream` (on plan->device, the
// caller's current device restored after), does not synchronize, and
// returns cudaGetLastError() (0 on success).
extern "C" int segment_agg_graph_run(const void* plan, int op, int bf16,
                                     const void* val, void* out, void* part,
                                     void* ticket, int F, void* stream) {
  const GraphPlan& p = *static_cast<const GraphPlan*>(plan);
  if (op < OP_SUM || op > OP_MAX || F <= 0 || p.n_rows <= 0 ||
      p.device < 0 || p.device >= MAX_DEVICES ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool tree = op == OP_SUM && F <= 4;
  const int es = bf16 ? 2 : 4;
  const uintptr_t ad = reinterpret_cast<uintptr_t>(val);
  int V = 1;
  if (!tree) {
    for (int c = 16 / es; c > 1; c /= 2) {
      if (F % c == 0 && ad % (c * es) == 0) {
        V = c;
        break;
      }
    }
  }
  const int n_vec = F / V;
  int L = 32;  // the tree kernel: a warp a block
  if (!tree) {
    L = 1;
    while (L < 32 && L < n_vec) L *= 2;
  }
  const int G = 32 / L;
  Launch a{p, val, out, static_cast<float*>(part), static_cast<int*>(ticket),
           F, F <= 4 ? p.win_narrow : p.win_wide, L,
           tree ? 1 : (n_vec + L - 1) / L, 1, 0, 0};
  if (tree) {
    a.task_groups = p.n_blocks;
  } else {
    // about one wave: a group takes up to 4 consecutive tasks while the
    // card would still hold 32 warps an SM
    const long long warps =
        static_cast<long long>((p.n_task + G - 1) / G) * a.chunks;
    const long long wave = 32LL * sms(p.device);
    a.per_group = static_cast<int>(
        warps / wave < 1 ? 1 : warps / wave > MAX_PER_GROUP ? MAX_PER_GROUP
                                                             : warps / wave);
    a.task_groups = (p.n_task + a.per_group - 1) / a.per_group;
  }
  a.zero_groups = (p.n_empty + ZERO_ROWS - 1) / ZERO_ROWS;
  const long long groups =
      static_cast<long long>(a.task_groups) + a.zero_groups;
  const long long per_cta = static_cast<long long>(WARPS) * G;
  const long long grid_x = (groups + per_cta - 1) / per_cta;
  if (grid_x <= 0) return 0;
  if (grid_x > 0x7fffffffLL || a.chunks > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int cur = 0;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (cur != p.device && (err = cudaSetDevice(p.device)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int gx = static_cast<int>(grid_x);
  if (bf16) {
    err = op == OP_SUM ? by_width<__nv_bfloat16, OP_SUM>(a, V, tree, gx, st)
                       : by_width<__nv_bfloat16, OP_MAX>(a, V, tree, gx, st);
  } else {
    err = op == OP_SUM ? by_width<float, OP_SUM>(a, V, tree, gx, st)
                       : by_width<float, OP_MAX>(a, V, tree, gx, st);
  }
  if (cur != p.device) cudaSetDevice(cur);
  return static_cast<int>(err);
}
