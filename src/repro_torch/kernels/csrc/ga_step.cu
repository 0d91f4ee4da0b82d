// ga_step: one fused wave of GA offspring competing for their slots.
//
// Replaces src/repro/kernels/ga_step.py::ga_step (pallas_call at :98).
//
// Per offspring row r, lane d:
//   child = (co < pc) ? (d < cut ? p1 : p2) : p1      1-point crossover
//   child = child + (um < pm ? sigma_m * noise : 0)   Gaussian mutation
//   child = clip(child, lo, hi)
//   cfit  = f(child - shift) + bias
//   take where cfit < slot_f (strict; NaN never): the slot gets the child.
// The mutation is a product and a sum rounded separately, as the reference
// computes it (__fmul_rn / __fadd_rn keep nvcc from contracting them), so
// children are bit-exact with the plain version.
//
// Bound: memory. The function reads p1, p2, the slot rows, um and noise and
// writes the slot rows (6 x N x D float32): at Table I's shape with
// n_off = 200 offspring that is 4.8 MB, about 1.4 us at 3.35 TB/s.
// Design: one 256-thread block per offspring row, as de_step. Pass 1 builds
// the child lane by lane and reduces its fitness (row_eval); pass 2 rebuilds
// it from the same inputs and writes the child or the old occupant. The
// parents are gathered by the caller, so rows are independent and
// island-stacked input is simply more rows.
#include <cstdint>

#include "eval_tile.cuh"

namespace {

struct Child {
  const float* p1;
  const float* p2;
  const float* um;
  const float* nz;
  const float* shift;  // nullptr when unshifted
  int64_t cut;
  bool do_co;
  float pm, sigma_m, lo, hi;

  __device__ __forceinline__ float child(int d) const {
    float c = (!do_co || d < cut) ? p1[d] : p2[d];
    c = __fadd_rn(c, um[d] < pm ? __fmul_rn(sigma_m, nz[d]) : 0.0f);
    return fminf(fmaxf(c, lo), hi);
  }
  __device__ __forceinline__ float operator()(int d) const {
    const float c = child(d);
    return shift ? c - shift[d] : c;
  }
};

template <int TAG>
__global__ void __launch_bounds__(popt::kThreads)
ga_step_kernel(const float* __restrict__ p1, const float* __restrict__ p2,
               const float* __restrict__ slot, const float* __restrict__ slot_f,
               const int64_t* __restrict__ cut, const float* __restrict__ co,
               const float* __restrict__ um, const float* __restrict__ nz,
               const float* __restrict__ shift, float* __restrict__ nslot,
               float* __restrict__ nslot_f, bool* __restrict__ take, int D,
               float bias, float pc, float pm, float sigma_m, float lo,
               float hi) {
  const int r = blockIdx.x;
  const size_t off = static_cast<size_t>(r) * D;
  Child c;
  c.p1 = p1 + off;
  c.p2 = p2 + off;
  c.um = um + off;
  c.nz = nz + off;
  c.shift = shift;
  c.cut = cut[r];
  c.do_co = co[r] < pc;
  c.pm = pm;
  c.sigma_m = sigma_m;
  c.lo = lo;
  c.hi = hi;

  const float cfit = popt::row_eval<TAG>(c, D, bias);
  const float f_old = slot_f[r];
  const bool tk = cfit < f_old;
  if (threadIdx.x == 0) {
    nslot_f[r] = tk ? cfit : f_old;
    take[r] = tk;
  }
  const float* old = slot + off;
  float* out = nslot + off;
  for (int d = threadIdx.x; d < D; d += blockDim.x)
    out[d] = tk ? c.child(d) : old[d];
}

}  // namespace

// p1, p2, slot, um, noise (N, D) float32; slot_f, co (N,) float32; cut (N,)
// int64; shift (D,) or null. Writes nslot (N, D), nslot_f (N,) and take
// (N,) bool on `stream` and returns cudaGetLastError().
extern "C" int ga_step_launch(const float* p1, const float* p2,
                              const float* slot, const float* slot_f,
                              const int64_t* cut, const float* co,
                              const float* um, const float* nz,
                              const float* shift, float* nslot, float* nslot_f,
                              bool* take, int N, int D, int tag, float bias,
                              float pc, float pm, float sigma_m, float lo,
                              float hi, void* stream) {
  if (N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(T)                                                          \
  ga_step_kernel<T><<<N, popt::kThreads, 0, s>>>(                          \
      p1, p2, slot, slot_f, cut, co, um, nz, shift, nslot, nslot_f, take,  \
      D, bias, pc, pm, sigma_m, lo, hi)
  POPT_DISPATCH_TAG(tag, LAUNCH)
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}
