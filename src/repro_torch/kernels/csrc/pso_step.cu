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
// 25.6 MB, about 7.6 us at 3.35 TB/s. Design: one 256-thread block per row,
// as de_step. Pass 1 builds the new position lane by lane and reduces its
// fitness (row_eval); pass 2 recomputes the lane from the same inputs and
// writes position, velocity and pbest, so there is no shared-memory limit
// on D.
#include "eval_tile.cuh"

namespace {

struct Particle {
  const float* x;
  const float* v;
  const float* pb;
  const float* r1;
  const float* r2;
  const float* g;      // the island's gbest row
  const float* shift;  // nullptr when unshifted
  float w, fp, fg, vmax, lo, hi;

  __device__ __forceinline__ float vel(int d) const {
    const float xd = x[d];
    const float cog = __fmul_rn(__fmul_rn(fp, r1[d]), __fsub_rn(pb[d], xd));
    const float a = __fmaf_rn(w, v[d], cog);
    const float nv = __fmaf_rn(__fmul_rn(fg, r2[d]), __fsub_rn(g[d], xd), a);
    return popt::clip(nv, -vmax, vmax);
  }
  __device__ __forceinline__ float pos(int d, float nv) const {
    return popt::clip(__fadd_rn(x[d], nv), lo, hi);
  }
  __device__ __forceinline__ float operator()(int d) const {
    const float p = pos(d, vel(d));
    return shift ? p - shift[d] : p;
  }
};

template <int TAG>
__global__ void __launch_bounds__(popt::kThreads)
pso_step_kernel(const float* __restrict__ x, const float* __restrict__ v,
                const float* __restrict__ pb, const float* __restrict__ pbf,
                const float* __restrict__ r1, const float* __restrict__ r2,
                const float* __restrict__ gbest,
                const float* __restrict__ shift, float* __restrict__ nx,
                float* __restrict__ nv, float* __restrict__ nf,
                float* __restrict__ npb, float* __restrict__ npbf, int P,
                int D, float bias, float w, float fp, float fg, float vmax,
                float lo, float hi) {
  const int r = blockIdx.x;
  const size_t off = static_cast<size_t>(r) * D;
  Particle p;
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
    nv[off + d] = vd;
    nx[off + d] = xd;
    npb[off + d] = imp ? xd : p.pb[d];
  }
}

}  // namespace

// x, v, pbest, r1, r2 (R, D) float32 with R = islands * P rows, island-major;
// pbest_f (R,); gbest (R / P, D); shift (D,) or null. Writes nx, nv, npb
// (R, D) and nf, npbf (R,) on `stream` and returns cudaGetLastError().
extern "C" int pso_step_launch(const float* x, const float* v, const float* pb,
                               const float* pbf, const float* r1,
                               const float* r2, const float* gbest,
                               const float* shift, float* nx, float* nv,
                               float* nf, float* npb, float* npbf, int R, int P,
                               int D, int tag, float bias, float w, float fp,
                               float fg, float vmax, float lo, float hi,
                               void* stream) {
  if (R <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(T)                                                          \
  pso_step_kernel<T><<<R, popt::kThreads, 0, s>>>(                         \
      x, v, pb, pbf, r1, r2, gbest, shift, nx, nv, nf, npb, npbf, P, D,     \
      bias, w, fp, fg, vmax, lo, hi)
  POPT_DISPATCH_TAG(tag, LAUNCH)
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}
