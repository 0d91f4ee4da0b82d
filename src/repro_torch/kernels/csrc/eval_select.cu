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
// 9.6 MB, about 2.9 us at 3.35 TB/s. The kernel has no cross-row state, so
// island-stacked input (I, P, D) is simply I * P rows.
//
// The first design (one 256-thread block per row over eval_tile.cuh) made
// two passes: it reduced the trial's fitness from dependent one-float loads
// with two barriers, then read the trial or the incumbent again to write
// it. This design (eval_row.cuh, the wrapper's geometry) makes one pass
// where the row fits in registers (the staged kernel): each thread loads
// the row's head (fit, thresh) with its slots of the trial, the shift and
// the incumbent, evaluates the trial with at most one barrier, after which
// every warp of the row holds the fitness, and writes the trial or the
// incumbent from registers. A longer row (the stream kernel) is evaluated
// in batches, then the trial or the incumbent is copied in batches.
//
// The staged kernel reads the incumbent with the trial, whether or not the
// trial is accepted: one round trip, for simplicity. Reading it after the
// decision, only where the trial was not accepted, was 0.4-1.6% faster on
// the H100 at half the rows accepted (PERF.md).
#include <cstdint>

#include "eval_row.cuh"

namespace {

using namespace popt::row;

struct Args {
  const float* pop;
  const float* fit;
  const float* trial;
  const float* thresh;  // nullptr: greedy (a threshold of 0)
  const float* shift;   // nullptr when unshifted
  float* npop;
  float* nfit;
  bool* acc;
  int rows, D;
  float bias;
};

// The incumbent's fitness and the row's threshold.
struct Head {
  float fit = 0.0f;
  float thresh = 0.0f;
};

__device__ __forceinline__ Head load_head(const Args& a, const Place& at) {
  Head h;
  if (at.active) {
    h.fit = a.fit[at.r];
    if (a.thresh) h.thresh = a.thresh[at.r];
  }
  return h;
}

// The decision: the new fitness and the accept flag, written once.
__device__ __forceinline__ bool decide(const Args& a, const Place& at, const Head& h,
                                       float tfit) {
  const float dF = __fsub_rn(tfit, h.fit);
  const bool accept = (dF <= 0.0f) || (dF < h.thresh);
  if (at.w == 0 && at.lane == 0) {
    a.nfit[at.r] = accept ? tfit : h.fit;
    a.acc[at.r] = accept;
  }
  return accept;
}

// The whole row in registers (at.iters <= K): one pass.
template <int TAG, int V, int K>
__global__ void __launch_bounds__(kBlockThreads)
eval_select_staged(const Args a, int W) {
  const Place at(W, a.rows, a.D / V);
  const Head h = load_head(a, at);
  const size_t off = static_cast<size_t>(at.active ? at.r : 0) * a.D;
  Slot<V> t[K], sh[K], p[K];
  load_batch<V, K>(a.trial + off, at, 0, t);
  if (a.shift) load_batch<V, K>(a.shift, at, 0, sh);
  load_batch<V, K>(a.pop + off, at, 0, p);
  popt::row::Acc<TAG> acc;
  eval_batch<TAG, V, K>(acc, at, 0, t, sh, a.shift != nullptr, a.D);
  const float tfit = fitness<TAG>(acc, W, at, a.D, a.bias, true);
  if (!at.active) return;
  store_batch<V, K>(a.npop + off, at, 0, decide(a, at, h, tfit), t, p);
}

// A row longer than one batch: pass 1 evaluates the trial batch by batch,
// pass 2 copies the trial or the incumbent batch by batch.
template <int TAG, int V>
__global__ void __launch_bounds__(kBlockThreads)
eval_select_stream(const Args a, int W) {
  constexpr int K = kMaxSlots;
  const Place at(W, a.rows, a.D / V);
  const Head h = load_head(a, at);
  const size_t off = static_cast<size_t>(at.active ? at.r : 0) * a.D;
  Slot<V> x[K], sh[K];
  popt::row::Acc<TAG> acc;
  for (int kb = 0; kb < at.iters; kb += K) {
    load_batch<V, K>(a.trial + off, at, kb, x);
    if (a.shift) load_batch<V, K>(a.shift, at, kb, sh);
    eval_batch<TAG, V, K>(acc, at, kb, x, sh, a.shift != nullptr, a.D);
  }
  const float tfit = fitness<TAG>(acc, W, at, a.D, a.bias, true);
  if (!at.active) return;
  const float* src = (decide(a, at, h, tfit) ? a.trial : a.pop) + off;
  for (int kb = 0; kb < at.iters; kb += K) {
    load_batch<V, K>(src, at, kb, x);
    store_batch<V, K>(a.npop + off, at, kb, true, x, x);
  }
}

template <int TAG, int V>
int launch_v(const Args& a, int W, int R, int K, int staged, cudaStream_t s) {
  const dim3 grid((a.rows + R - 1) / R), block(32 * W * R);
  if (!staged) {
    eval_select_stream<TAG, V><<<grid, block, 0, s>>>(a, W);
    return 0;
  }
  const int slots = a.D / V;
  if (slots > 32 * W * K) return static_cast<int>(cudaErrorInvalidValue);
  switch (K) {
    case 2: eval_select_staged<TAG, V, 2><<<grid, block, 0, s>>>(a, W); break;
    case 4: eval_select_staged<TAG, V, 4><<<grid, block, 0, s>>>(a, W); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

template <int TAG>
int launch(const Args& a, int vec, int W, int R, int K, int staged, cudaStream_t s) {
  return vec ? launch_v<TAG, 4>(a, W, R, K, staged, s)
             : launch_v<TAG, 1>(a, W, R, K, staged, s);
}

}  // namespace

// pop, trial (rows, D) float32; fit (rows,); thresh (rows,) or null (greedy);
// shift (D,) or null. Geometry from kernels/bench_eval.py::launch_geometry:
// `vec` (16-byte loads; needs D % 4 == 0 and pop, trial, shift and npop
// 16-byte aligned), W warps per row (a power of two), R rows per block
// (W * R <= 8), K slots per thread (2 or 4), and `staged` (the row fits
// W * 32 * K slots: one pass) or not (two passes in batches). Writes npop
// (rows, D), nfit (rows,) and acc (rows,) bool on `stream` and returns
// cudaGetLastError(), or cudaErrorInvalidValue for a geometry the kernel
// does not take.
extern "C" int eval_select_launch(const float* pop, const float* fit,
                                  const float* trial, const float* thresh,
                                  const float* shift, float* npop, float* nfit,
                                  bool* acc, int rows, int D, int tag, float bias,
                                  int vec, int W, int R, int K, int staged,
                                  void* stream) {
  if (rows <= 0) return 0;
  if (W < 1 || (W & (W - 1)) != 0 || R < 1 || W * R > kMaxWarps || (vec && D % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{pop, fit, trial, thresh, shift, npop, nfit, acc, rows, D, bias};
  int err = 0;
#define LAUNCH(T) err = launch<T>(a, vec, W, R, K, staged, s)
  POPT_DISPATCH_TAG(tag, LAUNCH)
#undef LAUNCH
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
