// Row evaluation of the §V testbed functions for bench_eval, de_step,
// ga_step and eval_select, designed for the H100.
//
// Replaces, for those four kernels, eval_tile.cuh (the first row
// evaluation, which pso_step still uses); both stand for `_eval_tile` of
// src/repro/kernels/bench_eval.py, which evaluates a (pop_block, dim_pad)
// VMEM tile with a lane mask.
//
// Bound: memory. A row of D float32 lanes is read once. At Table I's shapes
// the arithmetic (about 12 operations a lane for Rosenbrock) is a few percent
// of the card's float32 rate, so the time is the bytes and the latency of
// getting them in flight.
//
// What eval_tile.cuh lost: one 256-thread block per row, whose threads
// stride over the row in a loop with a runtime bound, so each thread issued
// one 4-byte load, used it, and issued the next (four dependent round trips
// at D = 1000); Rosenbrock read lane d+1 with a second load; the reduction
// went through shared memory and a barrier, finished serially on thread 0 and
// broadcast the result with a second barrier; and 100 rows gave 100 blocks.
//
// This design:
// - The wrapper picks the geometry (kernels/bench_eval.py::launch_geometry):
//   W warps share a row (1, 2, 4 or 8), R rows share a block (R * W <= 8),
//   and each thread holds K slots of the row in registers (K <= 4). A slot
//   is four lanes read as one 16-byte float4 where every pointer is 16-byte
//   aligned and D % 4 == 0 (V = 4), else one lane read by a scalar load
//   (V = 1).
// - Warp w of a row owns slots [w * S, (w + 1) * S), S = 32 * ceil(slots /
//   (32 W)); in iteration k its lane l holds slot w * S + 32 k + l, so each
//   warp-wide load covers 512 (or 128) contiguous bytes. The slots are
//   unrolled register arrays: every load of a batch is issued before any
//   arithmetic.
// - Rosenbrock's lane d+1 comes from registers: inside a slot from the same
//   thread, across slots from lane l+1 by __shfl_down_sync. Lane 31's last
//   pair waits (`carry`) for lane 0 of the next iteration; a warp's last
//   pair waits for the next warp's first lane (`head`) and is added where
//   the warps combine. Nothing is loaded twice.
// - Reduction: a shuffle butterfly in each warp; with W > 1 one barrier,
//   after which the combining warp reads the W partials from shared memory
//   and runs one more butterfly. Every lane of a combining warp ends with the
//   fitness, so the kernels that write the row need no broadcast barrier.
// - A row longer than one batch (more than 8 * 32 * K slots) is walked in
//   batches by eight warps; the carry crosses batches.
//
// Numerics as eval_tile.cuh: float32 throughout, accurate sinf/cosf/expf/
// sqrtf (no --use_fast_math), constants rounded to float32, x**20 by
// repeated squaring. Only the order of the sum changes: each thread adds its
// own lanes in increasing order, then the butterflies combine the threads
// (tests/test_torch_eval_geometry.py repeats this order in float32 torch).
#pragma once

#include <cuda_runtime.h>

#include "eval_tile.cuh"  // Tag, sq, pow20, the constants, POPT_DISPATCH_TAG

namespace popt {
namespace row {

constexpr int kMaxWarps = 8;  // warps per block: R * W <= 8
constexpr int kBlockThreads = 32 * kMaxWarps;
constexpr int kMaxSlots = 4;  // slots a thread holds per batch
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr bool is_rosenbrock(int tag) {
  return tag == kRosenbrock || tag == kShiftedRosenbrock;
}

// V consecutive lanes of a row.
template <int V>
struct Slot {
  float v[V];
};

// Slot s of p. kStream: data read once (evict first from L1 and L2, so
// what is read again, such as de_step's donor rows, stays in L2).
template <int V, bool kStream = false>
__device__ __forceinline__ Slot<V> load(const float* __restrict__ p, int s) {
  Slot<V> x;
  if constexpr (V == 4) {
    const float4* q4 = reinterpret_cast<const float4*>(p) + s;
    const float4 q = kStream ? __ldcs(q4) : __ldg(q4);
    x.v[0] = q.x;
    x.v[1] = q.y;
    x.v[2] = q.z;
    x.v[3] = q.w;
  } else {
    x.v[0] = kStream ? __ldcs(p + s) : __ldg(p + s);
  }
  return x;
}

// Writes slot s of p as streaming data (evict first).
template <int V>
__device__ __forceinline__ void store(float* __restrict__ p, int s, const Slot<V>& x) {
  if constexpr (V == 4) {
    __stcs(reinterpret_cast<float4*>(p) + s, make_float4(x.v[0], x.v[1], x.v[2], x.v[3]));
  } else {
    __stcs(p + s, x.v[0]);
  }
}

// Where this thread works: lane, warp w of its row, row group g of the
// block, row r, and its warp's slots [seg0, seg_end) walked in `iters`
// iterations of 32 slots. An inactive row (past the last) owns no slot but
// still reaches the barrier.
struct Place {
  int lane, w, g, r, seg0, seg_end, iters;
  bool active;

  // W is a power of two (the C entries check it), so this is shifts only.
  __device__ __forceinline__ Place(int W, int rows, int slots) {
    const int lw = __ffs(W) - 1;
    lane = threadIdx.x & 31;
    const int wid = threadIdx.x >> 5;
    w = wid & (W - 1);
    g = wid >> lw;
    r = static_cast<int>(blockIdx.x) * static_cast<int>(blockDim.x >> (5 + lw)) + g;
    active = r < rows;
    iters = (slots + (32 << lw) - 1) >> (5 + lw);
    seg0 = w * 32 * iters;
    seg_end = active ? min(seg0 + 32 * iters, slots) : 0;
  }
  // Slot of iteration k of the batch that starts at iteration kb, and
  // whether this thread holds it.
  __device__ __forceinline__ int slot(int kb, int k) const { return seg0 + 32 * (kb + k) + lane; }
  __device__ __forceinline__ bool holds(int kb, int k) const {
    return kb + k < iters && slot(kb, k) < seg_end;
  }
};

// Loads this thread's slots of batch kb of `row`; slots it does not hold
// are zero.
template <int V, int K, bool kStream = false>
__device__ __forceinline__ void load_batch(const float* __restrict__ row, const Place& at,
                                           int kb, Slot<V> (&x)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    x[k] = Slot<V>{};
    if (at.holds(kb, k)) x[k] = load<V, kStream>(row, at.slot(kb, k));
  }
}

// x - shift, and + 1 for the CEC'2008 shifted Rosenbrock (z = x - o + 1).
template <int TAG, int V, int K>
__device__ __forceinline__ void prepare(Slot<V> (&x)[K], const Slot<V> (&sh)[K], bool shifted) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (shifted) x[k].v[j] = x[k].v[j] - sh[k].v[j];
      if constexpr (TAG == kShiftedRosenbrock) x[k].v[j] = x[k].v[j] + 1.0f;
    }
}

__device__ __forceinline__ float rosen_pair(float x0, float x1) {
  return 100.0f * sq(x1 - x0 * x0) + sq(1.0f - x0);
}

// One thread's sums. `a` is always a sum; `b` a sum (ackley's cosines) or a
// product (griewank). Rosenbrock: lane 31's `carry` is the left lane of a
// pair whose right lane is lane 0's next slot (`pending`); lane 0's `head`
// is the first lane of its warp's segment.
template <int TAG>
struct Acc {
  float a = 0.0f;
  float b = (TAG == kGriewank) ? 1.0f : 0.0f;
  float carry = 0.0f;
  float head = 0.0f;
  bool pending = false;
};

template <int TAG>
__device__ __forceinline__ void lane_term(Acc<TAG>& acc, float x, int d, int D) {
  if constexpr (TAG == kSphere || TAG == kDropwave) {
    acc.a += x * x;
  } else if constexpr (TAG == kRastrigin) {
    acc.a += x * x - 10.0f * cosf(kTwoPi * x) + 10.0f;
  } else if constexpr (TAG == kAckley) {
    acc.a += x * x;
    acc.b += cosf(kTwoPi * x);
  } else if constexpr (TAG == kGriewank) {
    acc.a += x * x;
    acc.b *= cosf(x / sqrtf(static_cast<float>(d + 1)));
  } else if constexpr (TAG == kSchwefel) {
    acc.a += x * sinf(sqrtf(fabsf(x)));
  } else if constexpr (TAG == kLevy) {
    const float w = 1.0f + (x - 1.0f) / 4.0f;
    if (d == 0) acc.a += sq(sinf(kPi * w));
    if (d < D - 1) acc.a += sq(w - 1.0f) * (1.0f + 10.0f * sq(sinf(kPi * w + 1.0f)));
    if (d == D - 1) acc.a += sq(w - 1.0f) * (1.0f + sq(sinf(kTwoPi * w)));
  } else if constexpr (TAG == kMichalewicz) {
    const float i = static_cast<float>(d + 1);
    acc.a += sinf(x) * pow20(sinf(i * x * x / kPi));
  }
}

// Adds the terms of batch kb (prepared lanes z) to this thread's sums. Every
// lane of the warp must call it (the shuffles); the batch bound is
// warp-uniform.
template <int TAG, int V, int K>
__device__ __forceinline__ void add_batch(Acc<TAG>& acc, const Slot<V> (&z)[K],
                                          const Place& at, int kb, int D) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (kb + k >= at.iters) break;
    const bool held = at.holds(kb, k);
    const int d0 = at.slot(kb, k) * V;
    if constexpr (is_rosenbrock(TAG)) {
      const float first = __shfl_sync(kFull, z[k].v[0], 0);
      if (at.lane == 31 && acc.pending) acc.a += rosen_pair(acc.carry, first);
#pragma unroll
      for (int j = 0; j + 1 < V; ++j)
        if (held && d0 + j < D - 1) acc.a += rosen_pair(z[k].v[j], z[k].v[j + 1]);
      const float right = __shfl_down_sync(kFull, z[k].v[0], 1);
      const bool pair = held && d0 + V - 1 < D - 1;
      if (at.lane < 31) {
        if (pair) acc.a += rosen_pair(z[k].v[V - 1], right);
      } else {
        acc.carry = z[k].v[V - 1];
        acc.pending = pair;
      }
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (held) lane_term<TAG>(acc, z[k].v[j], d0 + j, D);
    }
  }
}

// Sum (or product) over the warp; every lane gets the same value.
template <bool kProd>
__device__ __forceinline__ float butterfly(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(kFull, v, o);
    v = kProd ? v * u : v + u;
  }
  return v;
}

template <int TAG>
__device__ __forceinline__ float finish(float a, float b, int D, float bias) {
  const float dim = static_cast<float>(D);
  if constexpr (TAG == kAckley) {
    const float s1 = a / dim;
    const float s2 = b / dim;
    return -20.0f * expf(-0.2f * sqrtf(s1)) - expf(s2) + 20.0f + kE + bias;
  } else if constexpr (TAG == kGriewank) {
    return a / 4000.0f - b + 1.0f + bias;
  } else if constexpr (TAG == kSchwefel) {
    return static_cast<float>(418.9829 * static_cast<double>(D)) - a + bias;
  } else if constexpr (TAG == kDropwave) {
    return -(1.0f + cosf(12.0f * sqrtf(a))) / (0.5f * a + 2.0f) + bias;
  } else if constexpr (TAG == kMichalewicz) {
    return -a + bias;
  } else {
    return a + bias;
  }
}

// The row's fitness, in every lane of warp 0 of the row, or of every warp
// of the row when `every_warp`. W == 1: shuffles only. W > 1: one barrier,
// which every thread of the block must reach.
template <int TAG>
__device__ __forceinline__ float fitness(const Acc<TAG>& acc, int W, const Place& at,
                                         int D, float bias, bool every_warp) {
  constexpr bool kProdB = (TAG == kGriewank);
  constexpr bool kHasB = (TAG == kAckley || TAG == kGriewank);
  float a = butterfly<false>(acc.a);
  float b = kHasB ? butterfly<kProdB>(acc.b) : acc.b;
  if (W == 1) return finish<TAG>(a, b, D, bias);

  __shared__ float s_a[kMaxWarps], s_b[kMaxWarps], s_head[kMaxWarps], s_carry[kMaxWarps];
  __shared__ bool s_pending[kMaxWarps];
  const int wid = threadIdx.x >> 5;
  if (at.lane == 0) {
    s_a[wid] = a;
    s_b[wid] = b;
    if constexpr (is_rosenbrock(TAG)) s_head[wid] = acc.head;
  }
  if constexpr (is_rosenbrock(TAG)) {
    if (at.lane == 31) {
      s_carry[wid] = acc.carry;
      s_pending[wid] = acc.pending;
    }
  }
  __syncthreads();
  if (!every_warp && at.w != 0) return 0.0f;
  a = 0.0f;
  b = kProdB ? 1.0f : 0.0f;
  if (at.lane < W) {
    const int i = at.g * W + at.lane;
    a = s_a[i];
    b = s_b[i];
    // The pair across warps lane and lane + 1 (only a warp that is not
    // the row's last can have one pending).
    if constexpr (is_rosenbrock(TAG))
      if (s_pending[i]) a += rosen_pair(s_carry[i], s_head[i + 1]);
  }
  a = butterfly<false>(a);
  if constexpr (kHasB) b = butterfly<kProdB>(b);
  return finish<TAG>(a, b, D, bias);
}

// Evaluates the slots x of batch kb (shift slots sh where `shifted`) into
// acc; x is left as it is, for the kernel to write.
template <int TAG, int V, int K>
__device__ __forceinline__ void eval_batch(Acc<TAG>& acc, const Place& at, int kb,
                                           const Slot<V> (&x)[K], const Slot<V> (&sh)[K],
                                           bool shifted, int D) {
  Slot<V> z[K];
#pragma unroll
  for (int k = 0; k < K; ++k) z[k] = x[k];
  prepare<TAG, V, K>(z, sh, shifted);
  if (kb == 0) acc.head = z[0].v[0];
  add_batch<TAG, V, K>(acc, z, at, kb, D);
}

// Writes this thread's slots of batch kb of `out`: x where `first`, else y.
template <int V, int K>
__device__ __forceinline__ void store_batch(float* __restrict__ out, const Place& at, int kb,
                                            bool first, const Slot<V> (&x)[K],
                                            const Slot<V> (&y)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (at.holds(kb, k)) store<V>(out, at.slot(kb, k), first ? x[k] : y[k]);
}

}  // namespace row
}  // namespace popt
