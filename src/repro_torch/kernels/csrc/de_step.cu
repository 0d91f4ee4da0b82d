// de_step: one fused DE/rand/1/bin generation, for one island or many.
//
// Replaces src/repro/kernels/de_step.py::de_step (pallas_call at :85).
//
// Per row r (island i = r / P):
//   mutant = clip(pa + w * (pb - pc), lo, hi)     donors a, b, c of island i
//   trial  = (u < px) | (d == jrand) ? mutant : pop
//   tfit   = f(trial - shift) + bias
//   keep the trial where tfit <= fit (a NaN tfit keeps the parent).
//
// Bound: memory. The function reads pop and u (P x D float32 each) and
// writes the new population; at the Table I shape that is 9.6 MB, about
// 2.9 us at 3.35 TB/s. The kernel itself also reads three donor rows per
// row, gathered from pop (mostly L2 hits: pop is 3.2 MB of a 50 MB L2), and
// reads its row's inputs twice. Design: one 256-thread block per row. Pass 1
// computes the trial lane by lane and reduces its fitness (row_eval);
// pass 2 recomputes the trial from the same inputs and writes either it or
// the parent. Recomputing instead of staging the trial in shared memory
// puts no limit on D. Donor indices are local to the island and clamped to
// [0, P) as JAX's gather clamps. The mutation is one fused multiply-add
// (__fmaf_rn), as XLA contracts it, so trial vectors are bit-exact with the
// plain version.
#include <cstdint>

#include "eval_tile.cuh"

namespace {

struct TrialLoad {
  const float* pop_row;
  const float* pa;
  const float* pb;
  const float* pc;
  const float* u_row;
  const float* shift;  // nullptr when unshifted
  int64_t jrand;
  float w, px, lo, hi;

  __device__ __forceinline__ float trial(int d) const {
    if (!(u_row[d] < px) && d != jrand) return pop_row[d];
    float m = __fmaf_rn(w, __fsub_rn(pb[d], pc[d]), pa[d]);
    return fminf(fmaxf(m, lo), hi);
  }
  __device__ __forceinline__ float operator()(int d) const {
    float t = trial(d);
    return shift ? t - shift[d] : t;
  }
};

__device__ __forceinline__ int64_t clamp_row(int64_t i, int P) {
  return i < 0 ? 0 : (i >= P ? P - 1 : i);
}

template <int TAG>
__global__ void __launch_bounds__(popt::kThreads)
de_step_kernel(const float* __restrict__ pop, const float* __restrict__ fit,
               const int64_t* __restrict__ idx, const float* __restrict__ u,
               const int64_t* __restrict__ jrand,
               const float* __restrict__ shift, float* __restrict__ npop,
               float* __restrict__ nfit, int R, int P, int D, float bias,
               float w, float px, float lo, float hi) {
  const int r = blockIdx.x;
  const size_t base = static_cast<size_t>(r - r % P);  // island's first row
  const size_t off = static_cast<size_t>(r) * D;
  TrialLoad t;
  t.pop_row = pop + off;
  t.pa = pop + (base + clamp_row(idx[r], P)) * D;
  t.pb = pop + (base + clamp_row(idx[R + r], P)) * D;
  t.pc = pop + (base + clamp_row(idx[2 * static_cast<size_t>(R) + r], P)) * D;
  t.u_row = u + off;
  t.shift = shift;
  t.jrand = jrand[r];
  t.w = w;
  t.px = px;
  t.lo = lo;
  t.hi = hi;

  const float tfit = popt::row_eval<TAG>(t, D, bias);
  const float f = fit[r];
  const bool better = tfit <= f;
  if (threadIdx.x == 0) nfit[r] = better ? tfit : f;
  float* out = npop + off;
  for (int d = threadIdx.x; d < D; d += blockDim.x)
    out[d] = better ? t.trial(d) : t.pop_row[d];
}

}  // namespace

// pop, u (R, D) float32 with R = islands * P rows, island-major; fit (R,);
// idx (3, R) int64 donor rows local to each island; jrand (R,) int64;
// shift (D,) or null. Writes npop (R, D) and nfit (R,) on `stream` and
// returns cudaGetLastError().
extern "C" int de_step_launch(const float* pop, const float* fit,
                              const int64_t* idx, const float* u,
                              const int64_t* jrand, const float* shift,
                              float* npop, float* nfit, int R, int P, int D,
                              int tag, float bias, float w, float px,
                              float lo, float hi, void* stream) {
  if (R <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(T)                                                      \
  de_step_kernel<T><<<R, popt::kThreads, 0, s>>>(                      \
      pop, fit, idx, u, jrand, shift, npop, nfit, R, P, D, bias, w, px, \
      lo, hi)
  POPT_DISPATCH_TAG(tag, LAUNCH)
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}
