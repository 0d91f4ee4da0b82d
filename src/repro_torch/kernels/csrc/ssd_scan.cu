// ssd_scan: the Mamba2 SSD scan, y_t = C_t . state_t with
// state_t = exp(dt_t * A) * state_{t-1} + B_t (x) (x_t * dt_t), state_0 = 0.
//
// Replaces src/repro/kernels/ssd_scan.py::ssd_scan (pallas_call at :72).
//
// xh (BH, S, P) and Bm, Cm (R, S, N) float32 or bfloat16, dt (BH, S) and
// A (BH,) float32; row bh of the scan reads row bh / H of Bm and Cm, where
// H = BH / R heads share one B/C row (Mamba2's single group: H = heads, and
// H = 1 for per-row B/C as the Pallas signature has them). The state and all
// arithmetic are float32; y is written in xh's type.
//
// Bound: at mamba2-370m's batch 4 x 2048 (BH 128, P 64, N 128, chunk 256)
// the function moves 72 MB (x and y 33.5 MB each in bfloat16, B and C per
// batch row, dt): 22 us at 3.35 TB/s. Its chunked form (the Pallas kernel's
// matrix products, on the causal half of each (Q, Q) tile) does 21.5 GFLOP,
// 22 us on the bf16 tensor cores; this kernel runs the recurrence on the
// CUDA cores instead, 4 * S * N * P flops
// per row (8.6 GFLOP in all, 0.13 ms at 67 TFLOP/s), which is less work than
// the chunked form but is sequential in t. The Pallas kernel walks the chunks
// in order with the (N, P) state in VMEM; here the P columns of the state
// evolve independently, so the grid is (P / 16 column groups, BH): at mamba2's
// shape 512 blocks, none needing another's result. A block is 64 threads:
// thread (c, q) holds state[n][c] for the N / 4 rows n of slice q in
// registers, so y_t[c] is four partial sums joined by two shuffles and no
// thread waits on another within a step. B, C, x * dt and exp(dt * A) for 32
// steps at a time are staged in shared memory (B and C as float32, each slice
// padded by 4 floats so the four slices' float4 reads fall in different
// banks); y goes back through shared memory for coalesced stores. The
// chunk size does not enter: the recurrence gives the chunked form's y.
#include <cstdint>

#include "bf16.cuh"

namespace {

constexpr int PB = 16;          // state columns per block
constexpr int kThreads = 4 * PB;
constexpr int TT = 32;          // time steps staged at once

using popt::from_f;
using popt::to_f;

template <typename T, int NPT>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, T* __restrict__ y, int S, int P, int H) {
  constexpr int N = 4 * NPT;
  constexpr int LDS = NPT + 4;  // padded slice length
  __shared__ __align__(16) float Bs[TT * 4 * LDS];
  __shared__ __align__(16) float Cs[TT * 4 * LDS];
  __shared__ float Xs[TT * PB];   // x * dt
  __shared__ float Ys[TT * PB];
  __shared__ float Ad[TT];        // exp(dt * A)

  const int bh = blockIdx.y;
  const int p0 = blockIdx.x * PB;
  const int tid = threadIdx.x, c = tid >> 2, q = tid & 3;
  const float a_h = A[bh];
  const float* dtb = dt + static_cast<size_t>(bh) * S;
  const T* xb = x + static_cast<size_t>(bh) * S * P;
  const T* Bb = Bm + static_cast<size_t>(bh / H) * S * N;
  const T* Cb = Cm + static_cast<size_t>(bh / H) * S * N;
  T* yb = y + static_cast<size_t>(bh) * S * P;

  float st[NPT];
#pragma unroll
  for (int i = 0; i < NPT; ++i) st[i] = 0.0f;

  for (int t0 = 0; t0 < S; t0 += TT) {
    const int nt = min(TT, S - t0);
    // Unrolled so that several loads are in flight before the first store.
#pragma unroll 8
    for (int i = tid; i < nt * N; i += kThreads) {
      const int t = i / N, n = i % N;
      const int dst = (t * 4 + n / NPT) * LDS + n % NPT;
      const size_t src = static_cast<size_t>(t0 + t) * N + n;
      Bs[dst] = to_f(Bb[src]);
      Cs[dst] = to_f(Cb[src]);
    }
#pragma unroll 4
    for (int i = tid; i < nt * PB; i += kThreads) {
      const int t = i / PB, cc = i % PB, p = p0 + cc;
      Xs[i] = p < P ? to_f(xb[static_cast<size_t>(t0 + t) * P + p]) * dtb[t0 + t] : 0.0f;
    }
    for (int t = tid; t < nt; t += kThreads) Ad[t] = expf(dtb[t0 + t] * a_h);
    __syncthreads();

    for (int t = 0; t < nt; ++t) {
      const float a = Ad[t], xd = Xs[t * PB + c];
      const float* b = &Bs[(t * 4 + q) * LDS];
      const float* cv = &Cs[(t * 4 + q) * LDS];
      float y4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < NPT; i += 4) {
        const float4 b4 = *reinterpret_cast<const float4*>(&b[i]);
        const float4 c4 = *reinterpret_cast<const float4*>(&cv[i]);
        st[i] = st[i] * a + b4.x * xd;
        st[i + 1] = st[i + 1] * a + b4.y * xd;
        st[i + 2] = st[i + 2] * a + b4.z * xd;
        st[i + 3] = st[i + 3] * a + b4.w * xd;
        y4[0] = fmaf(c4.x, st[i], y4[0]);
        y4[1] = fmaf(c4.y, st[i + 1], y4[1]);
        y4[2] = fmaf(c4.z, st[i + 2], y4[2]);
        y4[3] = fmaf(c4.w, st[i + 3], y4[3]);
      }
      float yp = (y4[0] + y4[1]) + (y4[2] + y4[3]);
      yp += __shfl_xor_sync(0xffffffffu, yp, 1);
      yp += __shfl_xor_sync(0xffffffffu, yp, 2);
      if (q == 0) Ys[t * PB + c] = yp;
    }
    __syncthreads();
    for (int i = tid; i < nt * PB; i += kThreads) {
      const int t = i / PB, p = p0 + i % PB;
      if (p < P) yb[static_cast<size_t>(t0 + t) * P + p] = from_f<T>(Ys[i]);
    }
    // The next tile's staging writes Bs/Cs/Xs/Ad, which this tile's steps
    // have finished reading (the barrier above); its steps write Ys only
    // after its own barrier, once these stores have read it.
  }
}

template <typename T>
int dispatch_n(const void* x, const float* dt, const float* A, const void* Bm,
               const void* Cm, void* y, int BH, int S, int P, int N, int H,
               cudaStream_t s) {
  const dim3 grid((P + PB - 1) / PB, BH);
#define LAUNCH(NPT)                                                           \
  ssd_kernel<T, NPT><<<grid, kThreads, 0, s>>>(                               \
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),             \
      static_cast<const T*>(Cm), static_cast<T*>(y), S, P, H)
  switch (N) {
    case 16: LAUNCH(4); break;
    case 32: LAUNCH(8); break;
    case 64: LAUNCH(16); break;
    case 128: LAUNCH(32); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xh (BH, S, P), Bm and Cm (BH / H, S, N) of type `dtype` (0 float32,
// 1 bfloat16); dt (BH, S) and A (BH,) float32; y (BH, S, P) of xh's type.
// N is 16, 32, 64 or 128. Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for what the kernel does not take).
extern "C" int ssd_scan_launch(const void* xh, const float* dt, const float* A,
                               const void* Bm, const void* Cm, void* y, int BH,
                               int S, int P, int N, int H, int dtype,
                               void* stream) {
  if (H < 1 || BH % H != 0 || BH > 65535 || P < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (BH <= 0 || S <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_n<float>(xh, dt, A, Bm, Cm, y, BH, S, P, N, H, s);
  if (dtype == 1) return dispatch_n<__nv_bfloat16>(xh, dt, A, Bm, Cm, y, BH, S, P, N, H, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
