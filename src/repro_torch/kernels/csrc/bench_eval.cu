// bench_eval: fitness of every row of a population, f(pop - shift) + bias.
//
// Replaces src/repro/kernels/bench_eval.py::bench_eval (pallas_call at :136).
//
// Bound: memory. The function reads the (P, D) float32 population once and
// the (D,) shift, and writes P floats: at Table I's shape (800 x 1000) 3.2 MB,
// about 0.96 us at 3.35 TB/s; at the chunked path's 100-row chunk 0.4 MB,
// where the launch and one round trip to memory set the floor. The
// arithmetic (about 12 operations a lane for Rosenbrock, more for the
// trigonometric tags) is far below the card's float32 rate.
//
// The first design (one 256-thread block per row over eval_tile.cuh) lost to
// dependent one-float loads, a second load for Rosenbrock's neighbour, a
// two-barrier reduction and, at 100 rows, a grid of 100 blocks. This design
// evaluates rows with eval_row.cuh: the wrapper's geometry (W warps per row,
// R rows per block), every load of a row in flight at once (16-byte loads
// where aligned), the neighbour from registers, and at most one barrier; the
// writing lane computes the finishing formula. Rows longer than one batch of
// registers are walked in batches.
#include "eval_row.cuh"

namespace {

using namespace popt::row;

template <int TAG, int V>
__global__ void __launch_bounds__(kBlockThreads)
bench_eval_kernel(const float* __restrict__ pop, const float* __restrict__ shift,
                  float* __restrict__ out, int P, int D, float bias, int W) {
  constexpr int K = kMaxSlots;
  const Place at(W, P, D / V);
  const float* row = pop + static_cast<size_t>(at.active ? at.r : 0) * D;
  popt::row::Acc<TAG> acc;
  for (int kb = 0; kb < at.iters; kb += K) {
    Slot<V> x[K], sh[K];
    load_batch<V, K>(row, at, kb, x);
    if (shift) load_batch<V, K>(shift, at, kb, sh);
    prepare<TAG, V, K>(x, sh, shift != nullptr);
    if (kb == 0) acc.head = x[0].v[0];
    add_batch<TAG, V, K>(acc, x, at, kb, D);
  }
  const float f = fitness<TAG>(acc, W, at, D, bias, false);
  if (at.active && at.w == 0 && at.lane == 0) out[at.r] = f;
}

template <int TAG>
int launch(const float* pop, const float* shift, float* out, int P, int D,
           float bias, int vec, int W, int R, cudaStream_t s) {
  const dim3 grid((P + R - 1) / R), block(32 * W * R);
  if (vec)
    bench_eval_kernel<TAG, 4><<<grid, block, 0, s>>>(pop, shift, out, P, D, bias, W);
  else
    bench_eval_kernel<TAG, 1><<<grid, block, 0, s>>>(pop, shift, out, P, D, bias, W);
  return 0;
}

}  // namespace

// pop (P, D) float32 rows; shift (D,) float32 or null; out (P,). Geometry
// from kernels/bench_eval.py::launch_geometry: `vec` (16-byte loads; needs
// D % 4 == 0 and 16-byte aligned pop and shift), W warps per row (a power
// of two), R rows per block (W * R <= 8). Launches on `stream` and returns
// cudaGetLastError(), or cudaErrorInvalidValue for a geometry the kernel
// does not take.
extern "C" int bench_eval_launch(const float* pop, const float* shift,
                                 float* out, int P, int D, int tag,
                                 float bias, int vec, int W, int R,
                                 void* stream) {
  if (P <= 0) return 0;
  if (W < 1 || (W & (W - 1)) != 0 || R < 1 || W * R > kMaxWarps || (vec && D % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(T) launch<T>(pop, shift, out, P, D, bias, vec, W, R, s)
  POPT_DISPATCH_TAG(tag, LAUNCH)
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}
