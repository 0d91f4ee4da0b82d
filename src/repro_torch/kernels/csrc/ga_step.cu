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
// computes it (__fmul_rn / __fadd_rn keep nvcc from contracting them), and
// the clip keeps a NaN as jnp.clip and torch.clamp do, so children are
// bit-exact with the plain version.
//
// Bound: memory. The function reads, of each lane, the parent the child
// takes, the slot row, um and noise, and writes the slot row (5 x N x D
// float32): at Table I's wave of 200 offspring 4.0 MB, about 1.2 us at
// 3.35 TB/s; 32 MB for 8 islands. The parents and slot rows are gathered
// by the caller, so rows are independent and island-stacked input is
// simply more rows.
//
// The first design (one 256-thread block per row over eval_tile.cuh) made
// two passes: it built the child lane by lane with dependent one-float
// loads, reduced its fitness with two barriers, then rebuilt the child from
// p1, p2, um and noise to write it or the old slot row. This design
// (eval_row.cuh, the wrapper's geometry) makes one pass where the row fits
// in registers (the staged kernel): each thread loads the row's head (cut,
// co, slot_f) with its slots of um, noise, the shift and the old slot row;
// then, once the head has arrived, of each slot only the parent its lanes
// take (lane by lane from both in the one 16-byte slot that straddles the
// cut). It builds the child in registers, evaluates it with at most one
// barrier, after which every warp of the row holds the fitness, and writes
// the child or the old slot row from registers. A longer row (the stream
// kernel) is walked in batches twice: the second pass rebuilds each
// batch's child where it took, or copies the old slot row.
//
// Noise and the old slot row are read with um, whether or not a lane
// mutates or the child takes: two dependent round trips (the head, then
// the parent lanes) and no third. On the H100, reading noise only for
// slots where a lane mutates was 2-5% slower at every shape the main path
// launches; reading the old slot row only where the child did not take
// was up to 4.5% slower at 200 and 8 x 1 rows, up to 1.7% faster at
// 8 x 200 (PERF.md).
//
// Storage: p1, p2, the slot rows, um, noise and the shift are float32 here;
// ga_step_bf16.cu includes this file with bfloat16 (POPT_STORAGE). Then
// every lane widens to float32 as it is loaded, the child is built and
// evaluated in float32 and rounded to bfloat16 as it is stored; slot_f and
// co stay float32.
#include <cstdint>

#include "eval_row.cuh"

// The storage type of the (N, D) rows and the shift, and the C entry's name.
#ifndef POPT_STORAGE
#define POPT_STORAGE float
#define POPT_ENTRY ga_step_launch
#endif

namespace {

using namespace popt::row;

template <typename T>
struct Args {
  const T* p1;
  const T* p2;
  const T* slot;
  const float* slot_f;
  const int64_t* cut;
  const float* co;
  const T* um;
  const T* nz;
  const T* shift;  // nullptr when unshifted
  T* nslot;
  float* nslot_f;
  bool* take;
  int rows, D;
  float bias, pc, pm, sigma_m, lo, hi;
};

// The row's head: lanes below `split` come from p1, the others from p2
// (split = cut where co < pc, else D); the competing slot's fitness.
struct Head {
  int64_t split = 0;
  float slot_f = 0.0f;
};

template <typename T>
__device__ __forceinline__ Head load_head(const Args<T>& a, const Place& at) {
  Head h;
  if (at.active) {
    const int64_t cut = a.cut[at.r];
    h.split = a.co[at.r] < a.pc ? cut : a.D;
    h.slot_f = a.slot_f[at.r];
  }
  return h;
}

// Slot s of the child's parent lanes: p1 below `split`, p2 from it on. The
// one slot that straddles `split` is read lane by lane from both.
template <int V, typename T>
__device__ __forceinline__ Slot<V> load_parent(const T* __restrict__ p1,
                                               const T* __restrict__ p2, int s,
                                               int64_t split) {
  const int64_t d0 = static_cast<int64_t>(s) * V;
  if (d0 + V <= split) return load<V>(p1, s);
  if (d0 >= split) return load<V>(p2, s);
  Slot<V> x;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int d = static_cast<int>(d0) + j;
    x.v[j] = load<1>(d < split ? p1 : p2, d).v[0];
  }
  return x;
}

// Batch kb of the row at `off`: loads um, noise and (`with_shift`) the
// shift sh; then, once the head has arrived, the parent lanes the child
// takes; builds the child c.
template <int V, int K, typename T>
__device__ __forceinline__ void child_batch(const Args<T>& a, const Place& at, const Head& h,
                                            size_t off, int kb, bool with_shift,
                                            Slot<V> (&c)[K], Slot<V> (&sh)[K]) {
  Slot<V> uu[K], nz[K];
  load_batch<V, K, true>(a.um + off, at, kb, uu);
  if (with_shift) load_batch<V, K>(a.shift, at, kb, sh);
  load_batch<V, K, true>(a.nz + off, at, kb, nz);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    c[k] = Slot<V>{};
    if (at.holds(kb, k)) c[k] = load_parent<V>(a.p1 + off, a.p2 + off, at.slot(kb, k), h.split);
  }
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float m = uu[k].v[j] < a.pm ? __fmul_rn(a.sigma_m, nz[k].v[j]) : 0.0f;
      c[k].v[j] = popt::clip(__fadd_rn(c[k].v[j], m), a.lo, a.hi);
    }
}

// The decision: the slot's new fitness and the take flag, written once.
template <typename T>
__device__ __forceinline__ bool decide(const Args<T>& a, const Place& at, const Head& h,
                                       float cfit) {
  const bool take = cfit < h.slot_f;
  if (at.w == 0 && at.lane == 0) {
    a.nslot_f[at.r] = take ? cfit : h.slot_f;
    a.take[at.r] = take;
  }
  return take;
}

// The whole row in registers (at.iters <= K): one pass.
template <int TAG, int V, int K, typename T>
__global__ void __launch_bounds__(kBlockThreads)
ga_step_staged(const Args<T> a, int W) {
  const Place at(W, a.rows, a.D / V);
  const Head h = load_head(a, at);
  const size_t off = static_cast<size_t>(at.active ? at.r : 0) * a.D;
  Slot<V> c[K], sh[K], old[K];
  load_batch<V, K>(a.slot + off, at, 0, old);
  child_batch<V, K>(a, at, h, off, 0, a.shift != nullptr, c, sh);
  popt::row::Acc<TAG> acc;
  eval_batch<TAG, V, K>(acc, at, 0, c, sh, a.shift != nullptr, a.D);
  const float cfit = fitness<TAG>(acc, W, at, a.D, a.bias, true);
  if (!at.active) return;
  store_batch<V, K>(a.nslot + off, at, 0, decide(a, at, h, cfit), c, old);
}

// A row longer than one batch: pass 1 evaluates the child batch by batch,
// pass 2 rebuilds each batch's child where it took (or reads the old slot
// row) and writes it.
template <int TAG, int V, typename T>
__global__ void __launch_bounds__(kBlockThreads)
ga_step_stream(const Args<T> a, int W) {
  constexpr int K = kMaxSlots;
  const Place at(W, a.rows, a.D / V);
  const Head h = load_head(a, at);
  const size_t off = static_cast<size_t>(at.active ? at.r : 0) * a.D;
  Slot<V> c[K], sh[K];
  popt::row::Acc<TAG> acc;
  for (int kb = 0; kb < at.iters; kb += K) {
    child_batch<V, K>(a, at, h, off, kb, a.shift != nullptr, c, sh);
    eval_batch<TAG, V, K>(acc, at, kb, c, sh, a.shift != nullptr, a.D);
  }
  const float cfit = fitness<TAG>(acc, W, at, a.D, a.bias, true);
  if (!at.active) return;
  const bool take = decide(a, at, h, cfit);
  for (int kb = 0; kb < at.iters; kb += K) {
    if (take)
      child_batch<V, K>(a, at, h, off, kb, false, c, sh);
    else
      load_batch<V, K>(a.slot + off, at, kb, c);
    store_batch<V, K>(a.nslot + off, at, kb, true, c, c);
  }
}

template <int TAG, int V, typename T>
int launch_v(const Args<T>& a, int W, int R, int K, int staged, cudaStream_t s) {
  const dim3 grid((a.rows + R - 1) / R), block(32 * W * R);
  if (!staged) {
    ga_step_stream<TAG, V, T><<<grid, block, 0, s>>>(a, W);
    return 0;
  }
  const int slots = a.D / V;
  if (slots > 32 * W * K) return static_cast<int>(cudaErrorInvalidValue);
  switch (K) {
    case 2: ga_step_staged<TAG, V, 2, T><<<grid, block, 0, s>>>(a, W); break;
    case 4: ga_step_staged<TAG, V, 4, T><<<grid, block, 0, s>>>(a, W); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

template <int TAG, typename T>
int launch(const Args<T>& a, int vec, int W, int R, int K, int staged, cudaStream_t s) {
  return vec ? launch_v<TAG, 4>(a, W, R, K, staged, s)
             : launch_v<TAG, 1>(a, W, R, K, staged, s);
}

}  // namespace

// p1, p2, slot, um, noise (N, D) of the storage type with N = islands *
// offspring rows; slot_f, co (N,) float32; cut (N,) int64; shift (D,) of
// the storage type or null. Geometry from kernels/autotune.py: `vec` (4-lane
// vector loads; needs D % 4 == 0 and every row pointer aligned to 4
// elements), W warps per row (a power of two), R rows per block (W * R <=
// 8), K slots per thread (2 or 4), and `staged` (the row fits W * 32 * K
// slots: one pass) or not (two passes in batches). Writes nslot (N, D),
// nslot_f (N,) and take (N,) bool on `stream` and returns
// cudaGetLastError(), or cudaErrorInvalidValue for a geometry the kernel
// does not take.
extern "C" int POPT_ENTRY(const POPT_STORAGE* p1, const POPT_STORAGE* p2,
                          const POPT_STORAGE* slot, const float* slot_f,
                          const int64_t* cut, const float* co,
                          const POPT_STORAGE* um, const POPT_STORAGE* nz,
                          const POPT_STORAGE* shift, POPT_STORAGE* nslot,
                          float* nslot_f, bool* take, int N, int D, int tag,
                          float bias, float pc, float pm, float sigma_m,
                          float lo, float hi, int vec, int W, int R, int K,
                          int staged, void* stream) {
  if (N <= 0) return 0;
  if (W < 1 || (W & (W - 1)) != 0 || R < 1 || W * R > kMaxWarps || (vec && D % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args<POPT_STORAGE> a{p1, p2, slot, slot_f, cut, co, um, nz, shift, nslot,
                            nslot_f, take, N, D, bias, pc, pm, sigma_m, lo, hi};
  int err = 0;
#define LAUNCH(T) err = launch<T>(a, vec, W, R, K, staged, s)
  POPT_DISPATCH_TAG(tag, LAUNCH)
#undef LAUNCH
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
