// pso_step: one fused particle-swarm generation, for one island or many.
//
// Replaces src/repro/kernels/pso_step.py::pso_step (pallas_call at :98).
//
// Per row r (island i = r / P), lane d:
//   nv = clip(w*v + fp*r1*(pbest - x) + fg*r2*(gbest_i - x), -vmax, vmax)
//   nx = clip(x + nv, lo, hi)
//   fit = f(nx - shift) + bias
//   pbest, pbest_f take (nx, fit) where fit < pbest_f (strict; NaN never).
// clip keeps a NaN, as jnp.clip does: a NaN velocity stays NaN.
// The velocity is rounded as XLA contracts it on the CPU, two fused
// multiply-adds: fma(fg*r2, g - x, fma(w, v, (fp*r1)*(pb - x))); the other
// products and sums are separate roundings (__fmul_rn / __fadd_rn keep nvcc
// from contracting them), so velocities and positions are bit-exact with
// the plain version.
//
// Bound: memory. The function reads x, v, pbest, r1, r2 and writes x, v
// and pbest (8 x P x D float32): at Table I's shape (800 x 1000) that is
// 25.6 MB, about 7.6 us at 3.35 TB/s. Design: one block per row (its
// threads from kernels/autotune.py, at most 256), as de_step was. Pass 1
// builds the new position lane by lane and reduces its fitness (row_eval);
// pass 2 recomputes the lane from the same inputs and writes position,
// velocity and pbest, so there is no shared-memory limit on D.
//
// Storage: x, v, pbest, r1, r2, gbest, the shift and the three (R, D)
// outputs are float32 here; pso_step_bf16.cu includes this file with
// bfloat16 (POPT_STORAGE). Then every lane widens to float32 as it is
// loaded, the velocity, position and fitness are float32 (the fitness of
// the unrounded position, as the reference evaluates it), and the outputs
// are rounded to bfloat16 as they are stored; pbest_f stays float32.
#include "bf16.cuh"
#include "eval_tile.cuh"

// The storage type of the (R, D) rows, gbest and the shift, and the C
// entry's name.
#ifndef POPT_STORAGE
#define POPT_STORAGE float
#define POPT_ENTRY pso_step_launch
#endif

namespace {

using popt::to_f;

template <typename T>
struct Particle {
  const T* x;
  const T* v;
  const T* pb;
  const T* r1;
  const T* r2;
  const T* g;      // the island's gbest row
  const T* shift;  // nullptr when unshifted
  float w, fp, fg, vmax, lo, hi;

  __device__ __forceinline__ float vel(int d) const {
    const float xd = to_f(x[d]);
    const float cog = __fmul_rn(__fmul_rn(fp, to_f(r1[d])), __fsub_rn(to_f(pb[d]), xd));
    const float a = __fmaf_rn(w, to_f(v[d]), cog);
    const float nv = __fmaf_rn(__fmul_rn(fg, to_f(r2[d])), __fsub_rn(to_f(g[d]), xd), a);
    return popt::clip(nv, -vmax, vmax);
  }
  __device__ __forceinline__ float pos(int d, float nv) const {
    return popt::clip(__fadd_rn(to_f(x[d]), nv), lo, hi);
  }
  __device__ __forceinline__ float operator()(int d) const {
    const float p = pos(d, vel(d));
    return shift ? p - to_f(shift[d]) : p;
  }
};

template <int TAG, typename T>
__global__ void __launch_bounds__(popt::kThreads)
pso_step_kernel(const T* __restrict__ x, const T* __restrict__ v,
                const T* __restrict__ pb, const float* __restrict__ pbf,
                const T* __restrict__ r1, const T* __restrict__ r2,
                const T* __restrict__ gbest,
                const T* __restrict__ shift, T* __restrict__ nx,
                T* __restrict__ nv, float* __restrict__ nf,
                T* __restrict__ npb, float* __restrict__ npbf, int P,
                int D, float bias, float w, float fp, float fg, float vmax,
                float lo, float hi) {
  const int r = blockIdx.x;
  const size_t off = static_cast<size_t>(r) * D;
  Particle<T> p;
  p.x = x + off;
  p.v = v + off;
  p.pb = pb + off;
  p.r1 = r1 + off;
  p.r2 = r2 + off;
  p.g = gbest + static_cast<size_t>(r / P) * D;
  p.shift = shift;
  p.w = w;
  p.fp = fp;
  p.fg = fg;
  p.vmax = vmax;
  p.lo = lo;
  p.hi = hi;

  const float fit = popt::row_eval<TAG>(p, D, bias);
  const float f_old = pbf[r];
  const bool imp = fit < f_old;
  if (threadIdx.x == 0) {
    nf[r] = fit;
    npbf[r] = imp ? fit : f_old;
  }
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    const float vd = p.vel(d);
    const float xd = p.pos(d, vd);
    const T xs = popt::from_f<T>(xd);
    nv[off + d] = popt::from_f<T>(vd);
    nx[off + d] = xs;
    npb[off + d] = imp ? xs : p.pb[d];
  }
}

}  // namespace

// x, v, pbest, r1, r2 (R, D) of the storage type with R = islands * P rows,
// island-major; pbest_f (R,) float32; gbest (R / P, D) and shift (D,) (or
// null) of the storage type; `threads` per block (a multiple of 32, at most
// 256; from kernels/autotune.py). Writes nx, nv, npb (R, D) and nf, npbf
// (R,) on `stream` and returns cudaGetLastError(), or cudaErrorInvalidValue
// for a block the kernel does not take.
extern "C" int POPT_ENTRY(const POPT_STORAGE* x, const POPT_STORAGE* v,
                          const POPT_STORAGE* pb, const float* pbf,
                          const POPT_STORAGE* r1, const POPT_STORAGE* r2,
                          const POPT_STORAGE* gbest, const POPT_STORAGE* shift,
                          POPT_STORAGE* nx, POPT_STORAGE* nv, float* nf,
                          POPT_STORAGE* npb, float* npbf, int R, int P, int D,
                          int tag, float bias, float w, float fp, float fg,
                          float vmax, float lo, float hi, int threads,
                          void* stream) {
  if (R <= 0) return 0;
  if (threads < 32 || threads > popt::kThreads || threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(TAG)                                                        \
  pso_step_kernel<TAG, POPT_STORAGE><<<R, threads, 0, s>>>(                \
      x, v, pb, pbf, r1, r2, gbest, shift, nx, nv, nf, npb, npbf, P, D,     \
      bias, w, fp, fg, vmax, lo, hi)
  POPT_DISPATCH_TAG(tag, LAUNCH)
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}
