// Row evaluation of the §V testbed functions, shared by bench_eval.cu and
// de_step.cu.
//
// Replaces `_eval_tile` of src/repro/kernels/bench_eval.py, which evaluates a
// (pop_block, dim_pad) VMEM tile with a lane mask. On Hopper one thread block
// owns one row: its threads stride over the D lanes, each accumulates its
// lanes' terms in registers, and a warp-shuffle plus shared-memory reduction
// combines them. The ragged edge is the loop bound `d < D`; nothing is padded.
//
// Each function contributes at most two accumulators per lane: `a` is always
// a sum; `b` is a sum (ackley's cosine term) or a product (griewank). The
// finishing formula runs once per row on thread 0 and is broadcast through
// shared memory, so every thread of the block sees the row's fitness.
//
// Numerics follow the JAX kernel: float32 throughout, accurate sinf/cosf/
// expf/sqrtf (never --use_fast_math), constants rounded to float32 as JAX
// rounds its weak-typed Python floats, and x**20 by repeated squaring as
// lax.integer_pow does. Summation order differs from the CPU reference, and
// nvcc contracts a*b+c into FMAs by default: both cost ulps, which the
// 1e-5 (1e-4 for michalewicz) relative bounds allow.
#pragma once

#include <cuda_runtime.h>

namespace popt {

// Order matches EVAL_TAGS in kernels/bench_eval.py.
enum Tag : int {
  kSphere = 0,
  kRastrigin = 1,
  kRosenbrock = 2,
  kAckley = 3,
  kShiftedRosenbrock = 4,
  kGriewank = 5,
  kSchwefel = 6,
  kLevy = 7,
  kDropwave = 8,
  kMichalewicz = 9,
  kNumTags = 10,
};

constexpr int kThreads = 256;  // threads per row block
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr float kE = 2.71828182845904523536f;

__device__ __forceinline__ float sq(float v) { return v * v; }

// s**20 as lax.integer_pow computes it: s**4 * s**16.
__device__ __forceinline__ float pow20(float s) {
  float s2 = s * s;
  float s4 = s2 * s2;
  float s8 = s4 * s4;
  float s16 = s8 * s8;
  return s4 * s16;
}

template <bool kProd>
__device__ __forceinline__ float warp_reduce(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    float u = __shfl_down_sync(0xffffffffu, v, o);
    v = kProd ? v * u : v + u;
  }
  return v;
}

// Fitness of one row. `load(d)` returns lane d of the (shifted) row, for
// 0 <= d < D. Every thread of the block must call this; all get the result.
template <int TAG, class Load>
__device__ float row_eval(const Load& load, int D, float bias) {
  constexpr bool kProdB = (TAG == kGriewank);
  float a = 0.0f;
  float b = kProdB ? 1.0f : 0.0f;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float x = load(d);
    if constexpr (TAG == kSphere || TAG == kDropwave) {
      a += x * x;
    } else if constexpr (TAG == kRastrigin) {
      a += x * x - 10.0f * cosf(kTwoPi * x) + 10.0f;
    } else if constexpr (TAG == kRosenbrock || TAG == kShiftedRosenbrock) {
      // Pairs (d, d+1): lane d+1 is read again by this thread.
      if (d < D - 1) {
        float x0 = x;
        float x1 = load(d + 1);
        if constexpr (TAG == kShiftedRosenbrock) {
          x0 = x0 + 1.0f;  // z = x - o + 1, o applied by load()
          x1 = x1 + 1.0f;
        }
        a += 100.0f * sq(x1 - x0 * x0) + sq(1.0f - x0);
      }
    } else if constexpr (TAG == kAckley) {
      a += x * x;
      b += cosf(kTwoPi * x);
    } else if constexpr (TAG == kGriewank) {
      a += x * x;
      b *= cosf(x / sqrtf(static_cast<float>(d + 1)));
    } else if constexpr (TAG == kSchwefel) {
      a += x * sinf(sqrtf(fabsf(x)));
    } else if constexpr (TAG == kLevy) {
      float w = 1.0f + (x - 1.0f) / 4.0f;
      if (d == 0) a += sq(sinf(kPi * w));
      if (d < D - 1) a += sq(w - 1.0f) * (1.0f + 10.0f * sq(sinf(kPi * w + 1.0f)));
      if (d == D - 1) a += sq(w - 1.0f) * (1.0f + sq(sinf(kTwoPi * w)));
    } else if constexpr (TAG == kMichalewicz) {
      float i = static_cast<float>(d + 1);
      a += sinf(x) * pow20(sinf(i * x * x / kPi));
    }
  }

  __shared__ float red_a[kThreads / 32];
  __shared__ float red_b[kThreads / 32];
  __shared__ float result;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  a = warp_reduce<false>(a);
  b = warp_reduce<kProdB>(b);
  if (lane == 0) {
    red_a[warp] = a;
    red_b[warp] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    a = red_a[0];
    b = red_b[0];
    for (int i = 1; i < n_warps; ++i) {
      a += red_a[i];
      b = kProdB ? b * red_b[i] : b + red_b[i];
    }
    const float dim = static_cast<float>(D);
    float f;
    if constexpr (TAG == kAckley) {
      float s1 = a / dim;
      float s2 = b / dim;
      f = -20.0f * expf(-0.2f * sqrtf(s1)) - expf(s2) + 20.0f + kE + bias;
    } else if constexpr (TAG == kGriewank) {
      f = a / 4000.0f - b + 1.0f + bias;
    } else if constexpr (TAG == kSchwefel) {
      f = static_cast<float>(418.9829 * static_cast<double>(D)) - a + bias;
    } else if constexpr (TAG == kDropwave) {
      f = -(1.0f + cosf(12.0f * sqrtf(a))) / (0.5f * a + 2.0f) + bias;
    } else if constexpr (TAG == kMichalewicz) {
      f = -a + bias;
    } else {
      f = a + bias;
    }
    result = f;
  }
  __syncthreads();
  return result;
}

}  // namespace popt

// Instantiates LAUNCH(TAG) for the runtime tag; returns cudaErrorInvalidValue
// for an unknown tag.
#define POPT_DISPATCH_TAG(tag, LAUNCH)                     \
  switch (tag) {                                           \
    case popt::kSphere: LAUNCH(popt::kSphere); break;      \
    case popt::kRastrigin: LAUNCH(popt::kRastrigin); break; \
    case popt::kRosenbrock: LAUNCH(popt::kRosenbrock); break; \
    case popt::kAckley: LAUNCH(popt::kAckley); break;      \
    case popt::kShiftedRosenbrock: LAUNCH(popt::kShiftedRosenbrock); break; \
    case popt::kGriewank: LAUNCH(popt::kGriewank); break;  \
    case popt::kSchwefel: LAUNCH(popt::kSchwefel); break;  \
    case popt::kLevy: LAUNCH(popt::kLevy); break;          \
    case popt::kDropwave: LAUNCH(popt::kDropwave); break;  \
    case popt::kMichalewicz: LAUNCH(popt::kMichalewicz); break; \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }
