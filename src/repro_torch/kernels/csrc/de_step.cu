// de_step: one fused DE/rand/1/bin generation, for one island or many.
//
// Replaces src/repro/kernels/de_step.py::de_step (pallas_call at :85).
//
// Per row r (island i = r / P):
//   mutant = clip(pa + w * (pb - pc), lo, hi)     donors a, b, c of island i
//   trial  = (u < px) | (d == jrand) ? mutant : pop
//   tfit   = f(trial - shift) + bias
//   keep the trial where tfit <= fit (a NaN tfit keeps the parent).
// clip keeps a NaN, as jnp.clip does, so a NaN mutant lane gives a NaN
// trial fitness and the parent stays.
//
// Bound: memory. The function reads pop and u (P x D float32 each) and
// writes the new population: at Table I's shape 9.6 MB, about 2.9 us at
// 3.35 TB/s. The kernel also gathers three donor rows per row from pop
// (mostly L2 hits: pop is 3.2 MB of a 50 MB L2; u is read and the new
// population written as streaming data, evicted first, so that at 8 x 800
// rows the 25.6 MB of populations stays in L2 for the gathers).
//
// The first design (one 256-thread block per row over eval_tile.cuh) made two
// passes: it built the trial lane by lane with dependent one-float loads,
// reduced its fitness with two barriers, then re-read the row, u and the
// three donor rows to build the trial again and write it or the parent.
// This design makes one pass where the row fits in registers (the staged
// kernel: up to 8 warps x 32 threads x K slots, eval_row.cuh): each thread
// loads idx, jrand and fit, and with them its slots of pop, u and shift;
// then, once idx and u have arrived, its slots of the three donor rows
// that take a mutant lane (two dependent round trips in all; at px = 0.2 a
// 16-byte slot needs its donors with probability 1 - 0.8^4 = 0.59). It
// builds the trial once, evaluates it with the neighbour from registers
// and at most one barrier, after which every warp of the row holds the
// fitness, and writes the trial or the parent from registers. A longer
// row (the stream kernel) is walked in batches twice: the second pass
// rebuilds each batch's trial and writes it, which puts no limit on D.
// Donor indices are local to the island and clamped to [0, P) as JAX's
// gather clamps. The mutation is one fused multiply-add (__fmaf_rn), as
// XLA contracts it, so trial vectors are bit-exact with the plain version.
#include <cstdint>

#include "eval_row.cuh"

namespace {

using namespace popt::row;

struct Args {
  const float* pop;
  const float* fit;
  const int64_t* idx;
  const float* u;
  const int64_t* jrand;
  const float* shift;  // nullptr when unshifted
  float* npop;
  float* nfit;
  int rows, P, D;
  float bias, w, px, lo, hi;
};

__device__ __forceinline__ int64_t clamp_row(int64_t i, int P) {
  return i < 0 ? 0 : (i >= P ? P - 1 : i);
}

// The row's indices (idx, jrand) and fitness, loaded first.
struct Head {
  int64_t ia = 0, ib = 0, ic = 0, jrand = -1;
  float fit = 0.0f;
};

__device__ __forceinline__ Head load_head(const Args& a, const Place& at) {
  Head h;
  if (at.active) {
    const size_t R = static_cast<size_t>(a.rows);
    h.ia = a.idx[at.r];
    h.ib = a.idx[R + at.r];
    h.ic = a.idx[2 * R + at.r];
    h.jrand = a.jrand[at.r];
    h.fit = a.fit[at.r];
  }
  return h;
}

__device__ __forceinline__ const float* donor(const Args& a, const Place& at, int64_t i) {
  const size_t base = static_cast<size_t>(at.r - at.r % a.P);  // island's first row
  return a.pop + (base + clamp_row(i, a.P)) * a.D;
}

// Which of this thread's slots of batch kb take a mutant lane: the donors
// are read for those slots only.
template <int V, int K>
__device__ __forceinline__ void crossed(const Args& a, const Place& at, int kb, int64_t jrand,
                                        const Slot<V> (&uu)[K], bool (&cross)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int64_t d0 = static_cast<int64_t>(at.slot(kb, k)) * V;
    bool any = jrand >= d0 && jrand < d0 + V;
#pragma unroll
    for (int j = 0; j < V; ++j) any |= uu[k].v[j] < a.px;
    cross[k] = any && at.holds(kb, k);
  }
}

// Loads the slots of batch kb of donor row `row` that `cross` marks; the
// others are zero.
template <int V, int K>
__device__ __forceinline__ void load_donor(const float* __restrict__ row, const Place& at, int kb,
                                           const bool (&cross)[K], Slot<V> (&x)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    x[k] = Slot<V>{};
    if (cross[k]) x[k] = load<V>(row, at.slot(kb, k));
  }
}

// Batch kb of the row at `off`: loads the parent p, u and (`with_shift`)
// the shift sh; then, once u and the row's indices have arrived, the donor
// slots that take a mutant lane; and builds the trial t.
template <int V, int K>
__device__ __forceinline__ void trial_batch(const Args& a, const Place& at, const Head& h,
                                            size_t off, int kb, bool with_shift,
                                            Slot<V> (&p)[K], Slot<V> (&sh)[K],
                                            Slot<V> (&t)[K]) {
  Slot<V> uu[K], da[K], db[K], dc[K];
  bool cross[K];
  load_batch<V, K>(a.pop + off, at, kb, p);
  load_batch<V, K, true>(a.u + off, at, kb, uu);
  if (with_shift) load_batch<V, K>(a.shift, at, kb, sh);
  crossed<V, K>(a, at, kb, h.jrand, uu, cross);
  load_donor<V, K>(donor(a, at, h.ia), at, kb, cross, da);
  load_donor<V, K>(donor(a, at, h.ib), at, kb, cross, db);
  load_donor<V, K>(donor(a, at, h.ic), at, kb, cross, dc);
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int64_t d = static_cast<int64_t>(at.slot(kb, k)) * V + j;
      const bool take = (uu[k].v[j] < a.px) || d == h.jrand;
      const float m = __fmaf_rn(a.w, __fsub_rn(db[k].v[j], dc[k].v[j]), da[k].v[j]);
      t[k].v[j] = take ? popt::clip(m, a.lo, a.hi) : p[k].v[j];
    }
}

// The whole row in registers (at.iters <= K): one pass.
template <int TAG, int V, int K>
__global__ void __launch_bounds__(kBlockThreads)
de_step_staged(const Args a, int W) {
  const Place at(W, a.rows, a.D / V);
  const Head h = load_head(a, at);
  const size_t off = static_cast<size_t>(at.active ? at.r : 0) * a.D;
  Slot<V> p[K], sh[K], t[K];
  trial_batch<V, K>(a, at, h, off, 0, a.shift != nullptr, p, sh, t);
  popt::row::Acc<TAG> acc;
  eval_batch<TAG, V, K>(acc, at, 0, t, sh, a.shift != nullptr, a.D);
  const float tfit = fitness<TAG>(acc, W, at, a.D, a.bias, true);
  const bool better = tfit <= h.fit;
  if (!at.active) return;
  if (at.w == 0 && at.lane == 0) a.nfit[at.r] = better ? tfit : h.fit;
  store_batch<V, K>(a.npop + off, at, 0, better, t, p);
}

// A row longer than one batch: pass 1 evaluates the trial batch by batch,
// pass 2 rebuilds each batch's trial (or reads the parent) and writes it.
template <int TAG, int V>
__global__ void __launch_bounds__(kBlockThreads)
de_step_stream(const Args a, int W) {
  constexpr int K = kMaxSlots;
  const Place at(W, a.rows, a.D / V);
  const Head h = load_head(a, at);
  const size_t off = static_cast<size_t>(at.active ? at.r : 0) * a.D;
  Slot<V> p[K], sh[K], t[K];
  popt::row::Acc<TAG> acc;
  for (int kb = 0; kb < at.iters; kb += K) {
    trial_batch<V, K>(a, at, h, off, kb, a.shift != nullptr, p, sh, t);
    eval_batch<TAG, V, K>(acc, at, kb, t, sh, a.shift != nullptr, a.D);
  }
  const float tfit = fitness<TAG>(acc, W, at, a.D, a.bias, true);
  const bool better = tfit <= h.fit;
  if (!at.active) return;
  if (at.w == 0 && at.lane == 0) a.nfit[at.r] = better ? tfit : h.fit;
  for (int kb = 0; kb < at.iters; kb += K) {
    if (better)
      trial_batch<V, K>(a, at, h, off, kb, false, p, sh, t);
    else
      load_batch<V, K>(a.pop + off, at, kb, p);
    store_batch<V, K>(a.npop + off, at, kb, better, t, p);
  }
}

template <int TAG, int V>
int launch_v(const Args& a, int W, int R, int K, int staged, cudaStream_t s) {
  const dim3 grid((a.rows + R - 1) / R), block(32 * W * R);
  if (!staged) {
    de_step_stream<TAG, V><<<grid, block, 0, s>>>(a, W);
    return 0;
  }
  const int slots = a.D / V;
  if (slots > 32 * W * K) return static_cast<int>(cudaErrorInvalidValue);
  switch (K) {
    case 2: de_step_staged<TAG, V, 2><<<grid, block, 0, s>>>(a, W); break;
    case 4: de_step_staged<TAG, V, 4><<<grid, block, 0, s>>>(a, W); break;
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

// pop, u (R, D) float32 with R = islands * P rows, island-major; fit (R,);
// idx (3, R) int64 donor rows local to each island; jrand (R,) int64;
// shift (D,) or null. Geometry from kernels/bench_eval.py::launch_geometry:
// `vec` (16-byte loads; needs D % 4 == 0 and pop, u, shift and npop 16-byte
// aligned), W warps per row (a power of two), R rows per block (W * R <= 8),
// K slots per
// thread (1, 2 or 4), and `staged` (the row fits W * 32 * K slots: one
// pass) or not (two passes in batches). Writes npop (R, D) and nfit (R,) on
// `stream` and returns cudaGetLastError(), or cudaErrorInvalidValue for a
// geometry the kernel does not take.
extern "C" int de_step_launch(const float* pop, const float* fit,
                              const int64_t* idx, const float* u,
                              const int64_t* jrand, const float* shift,
                              float* npop, float* nfit, int rows, int P, int D,
                              int tag, float bias, float w, float px,
                              float lo, float hi, int vec, int W, int R, int K,
                              int staged, void* stream) {
  if (rows <= 0) return 0;
  if (W < 1 || (W & (W - 1)) != 0 || R < 1 || W * R > kMaxWarps || (vec && D % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{pop, fit, idx, u, jrand, shift, npop, nfit, rows, P, D, bias, w, px, lo, hi};
  int err = 0;
#define LAUNCH(T) err = launch<T>(a, vec, W, R, K, staged, s)
  POPT_DISPATCH_TAG(tag, LAUNCH)
#undef LAUNCH
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
