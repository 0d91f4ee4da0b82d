// bench_eval: fitness of every row of a population, f(pop - shift) + bias.
//
// Replaces src/repro/kernels/bench_eval.py::bench_eval (pallas_call at :136).
//
// Bound: memory. The kernel reads the (P, D) float32 population once and the
// (D,) shift once per row (it stays in L1/L2), and writes P floats. At the
// Table I shape (800 x 1000) that is 3.2 MB, about 1 us at 3.35 TB/s; the
// arithmetic (about 10 flops per element, more for the trigonometric tags)
// is far below the card's float32 rate. Design: one 256-thread block per
// row, threads striding over D so consecutive threads read consecutive
// floats (coalesced), one block reduction per row; 800 blocks fit in one
// wave on 132 SMs. The TPU kernel's padding of D to 128 lanes and of P to
// pop_block has no counterpart: the grid is exactly P blocks and the lane
// loop stops at D.
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
bench_eval_kernel(const float* __restrict__ pop, const float* __restrict__ shift,
                  float* __restrict__ out, int D, float bias) {
  const int r = blockIdx.x;
  RowLoad load{pop + static_cast<size_t>(r) * D, shift};
  float f = popt::row_eval<TAG>(load, D, bias);
  if (threadIdx.x == 0) out[r] = f;
}

}  // namespace

// pop (P, D) float32 contiguous; shift (D,) float32 or null; out (P,).
// Launches on `stream` and returns cudaGetLastError().
extern "C" int bench_eval_launch(const float* pop, const float* shift,
                                 float* out, int P, int D, int tag,
                                 float bias, void* stream) {
  if (P <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(T) \
  bench_eval_kernel<T><<<P, popt::kThreads, 0, s>>>(pop, shift, out, D, bias)
  POPT_DISPATCH_TAG(tag, LAUNCH)
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}
