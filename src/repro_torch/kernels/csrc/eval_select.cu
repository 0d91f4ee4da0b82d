// eval_select: evaluate candidate rows and accept them against incumbents.
//
// Replaces src/repro/kernels/eval_select.py::eval_select (pallas_call at :86).
//
// Per row r:
//   tfit = f(trial - shift) + bias
//   dF   = tfit - fit
//   accept where (dF <= 0) | (dF < thresh)   (a NaN tfit never accepts)
//   npop = accept ? trial : pop,  nfit = accept ? tfit : fit.
// thresh = 0 is greedy selection; thresh = -T * ln(u) is SA's Metropolis
// rule (u = 0 gives +inf, which accepts every finite trial).
//
// Bound: memory. The function reads pop and trial (P x D float32 each) and
// writes the new population: at SA's Table I shape (800 x 1000) that is
// 9.6 MB, about 2.9 us at 3.35 TB/s. Design: one 256-thread block per row,
// as bench_eval. Pass 1 reduces the trial's fitness (row_eval); pass 2
// writes the trial or the incumbent. The kernel has no cross-row state, so
// island-stacked input (I, P, D) is simply I * P rows.
#include <cstdint>

#include "eval_tile.cuh"

namespace {

struct RowLoad {
  const float* row;
  const float* shift;  // nullptr when unshifted
  __device__ __forceinline__ float operator()(int d) const {
    float x = row[d];
    return shift ? x - shift[d] : x;
  }
};

template <int TAG>
__global__ void __launch_bounds__(popt::kThreads)
eval_select_kernel(const float* __restrict__ pop, const float* __restrict__ fit,
                   const float* __restrict__ trial,
                   const float* __restrict__ thresh,
                   const float* __restrict__ shift, float* __restrict__ npop,
                   float* __restrict__ nfit, bool* __restrict__ acc, int D,
                   float bias) {
  const int r = blockIdx.x;
  const size_t off = static_cast<size_t>(r) * D;
  RowLoad load{trial + off, shift};
  const float tfit = popt::row_eval<TAG>(load, D, bias);
  const float f = fit[r];
  const float dF = __fsub_rn(tfit, f);
  const float th = thresh ? thresh[r] : 0.0f;
  const bool accept = (dF <= 0.0f) || (dF < th);
  if (threadIdx.x == 0) {
    nfit[r] = accept ? tfit : f;
    acc[r] = accept;
  }
  const float* src = accept ? trial + off : pop + off;
  float* out = npop + off;
  for (int d = threadIdx.x; d < D; d += blockDim.x) out[d] = src[d];
}

}  // namespace

// pop, trial (R, D) float32; fit (R,); thresh (R,) or null (greedy);
// shift (D,) or null. Writes npop (R, D), nfit (R,) and acc (R,) bool on
// `stream` and returns cudaGetLastError().
extern "C" int eval_select_launch(const float* pop, const float* fit,
                                  const float* trial, const float* thresh,
                                  const float* shift, float* npop, float* nfit,
                                  bool* acc, int R, int D, int tag, float bias,
                                  void* stream) {
  if (R <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(T)                                                          \
  eval_select_kernel<T><<<R, popt::kThreads, 0, s>>>(                      \
      pop, fit, trial, thresh, shift, npop, nfit, acc, D, bias)
  POPT_DISPATCH_TAG(tag, LAUNCH)
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}
