// ssd_scan_bwd: the gradient of the Mamba2 SSD scan (dx, ddt, dA, dB, dC).
//
// Replaces no TPU kernel: the JAX package has no backward kernel, and its
// training path differentiates the jnp chunked form (_ssd_chunked). The
// port's model sends the scan through its ssd_scan kernel (models/ssm.py),
// so training on the card needs that kernel's gradient as a kernel too. It
// is the gradient of src/repro/kernels/ssd_scan.py::ssd_scan (pallas_call at
// :72), as jax.grad of repro.kernels.ref.ssd_ref gives it.
//
// The forward, per scan row bh with B/C row b = bh / H, a_t = exp(dt_t A):
//   state_t = a_t state_{t-1} + B_t (x) (x_t dt_t),  y_t = C_t . state_t.
// Given dy, the adjoint g_t of state_t runs in reverse time,
//   g_t = C_t (x) dy_t + a_{t+1} g_{t+1},
// and with u_t = B_t . g_t (a P-vector) and v_t = x_t . u_t:
//   dC_t = state_t . dy_t,  dB_t = g_t . (x_t dt_t),  dx_t = dt_t u_t,
//   ddt_t = v_t + A Q_t,   dA = sum_t dt_t Q_t,
// where Q_t = <g_t, a_t state_{t-1}> is the gradient of the log-decay
// dt_t A. Q_t needs a forward and a reverse quantity at once; it is taken
// instead from the identity Q_t = sum_{k >= t} (r_k - dt_k v_k) with
// r_k = C_k . dC_k (= dy_k . y_k): the decayed pairs (i >= t, j < t) of
// y's quadratic form, as the sum over k >= t of each row's whole sum less
// its pairs (i >= k, j = k). So the kernel walks the sequence twice and
// stores no state: pass 1 forward in time (state, dC_t and r_t; r_t is
// parked in ddt), pass 2 backward (g, u_t, dx_t, dB_t, v_t and the running
// Q). dB and dC are summed over the H heads that share a B/C row by a
// second kernel, in head order, from per-row float32 scratch: no atomics,
// so two runs give the same bits.
//
// xh (BH, S, P), Bm, Cm (R, S, N) and dy (BH, S, P) float32 or bfloat16;
// dt (BH, S), A (BH,) float32; float32 arithmetic; dx in xh's type, dB and
// dC in Bm's, ddt and dA float32. N is 16, 32, 64 or 128 and P at most 64.
//
// Bound: bytes. At mamba2-370m's training shape (BH 256 = 8 x 32 heads, S
// 512, P 64, N 128, bf16) the function reads x, dy, B, C, dt, A and writes
// dx, dB, dC, ddt, dA once each: 55.6 MB, 16.6 us at 3.35 TB/s; it does 8 BH S N P
// flops in the two recurrences and the four contractions (8.6 GFLOP, 0.13
// ms at 67 TFLOP/s float32). Design: one block of 256 threads per scan row,
// thread (ng, pg) holding the state (pass 1) or g (pass 2) at rows n of
// group ng (N / 16 of them) and columns pg + 16 j: the reductions over P
// (dC, dB) stay inside a half warp (shuffles), those over N (u) take one
// shuffle and a pass through shared memory. Inputs for TT steps are staged
// in shared memory at a time and the steps of a tile run without a block
// barrier. The per-row partials of dB and dC (BH S N floats each) cost two
// extra writes and reads of that size.
#include <cstdint>

#include "bf16.cuh"

namespace {

constexpr int kThreads = 256;   // 16 row groups x 16 column groups
constexpr int kWarps = kThreads / 32;
constexpr int TT = 16;          // steps staged at once

using popt::from_f;
using popt::to_f;

template <int N, int PP>
constexpr size_t smem_floats() {
  // B, C, Red [TT][N]; X, DY [TT][PP]; Up [TT][kWarps][PP]; dt, a, r, v [TT].
  return 3 * TT * N + 2 * TT * PP + TT * kWarps * PP + 4 * TT;
}

template <typename T, int NPT, int PPT>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm,
               const T* __restrict__ Cm, const T* __restrict__ dy, T* __restrict__ dx,
               float* __restrict__ ddt, float* __restrict__ dA, float* __restrict__ dB_part,
               float* __restrict__ dC_part, int S, int P, int H) {
  constexpr int N = 16 * NPT, PP = 16 * PPT;
  extern __shared__ float4 smem4[];
  float* Bs = reinterpret_cast<float*>(smem4);   // [TT][N]
  float* Cs = Bs + TT * N;                        // [TT][N]
  float* Red = Cs + TT * N;                       // [TT][N]: dC_t or dB_t, complete
  float* Xs = Red + TT * N;                       // [TT][PP]: x dt (pass 1), x (pass 2)
  float* DYs = Xs + TT * PP;                      // [TT][PP]
  float* Up = DYs + TT * PP;                      // [TT][kWarps][PP]: u partials
  float* Dts = Up + TT * kWarps * PP;             // [TT]
  float* As = Dts + TT;                           // [TT]: exp(dt A)
  float* Rs = As + TT;                            // [TT]: r_t (pass 2)
  float* Vs = Rs + TT;                            // [TT]: v_t (pass 2)

  const int bh = blockIdx.x;
  const int tid = threadIdx.x, pg = tid & 15, ng = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const float a_h = A[bh];
  const float* dtb = dt + static_cast<size_t>(bh) * S;
  const T* xb = x + static_cast<size_t>(bh) * S * P;
  const T* dyb = dy + static_cast<size_t>(bh) * S * P;
  const T* Bb = Bm + static_cast<size_t>(bh / H) * S * N;
  const T* Cb = Cm + static_cast<size_t>(bh / H) * S * N;
  float* ddtb = ddt + static_cast<size_t>(bh) * S;
  float* dBb = dB_part + static_cast<size_t>(bh) * S * N;
  float* dCb = dC_part + static_cast<size_t>(bh) * S * N;
  T* dxb = dx + static_cast<size_t>(bh) * S * P;

  // Steps [t0, t0 + nt) into shared memory; x times dt when `xdt`.
  auto stage = [&](int t0, int nt, bool xdt) {
    for (int i = tid; i < nt * N; i += kThreads) {
      const size_t src = static_cast<size_t>(t0) * N + i;
      Bs[i] = to_f(Bb[src]);
      Cs[i] = to_f(Cb[src]);
    }
    for (int i = tid; i < nt * PP; i += kThreads) {
      const int t = i / PP, p = i % PP;
      const size_t src = static_cast<size_t>(t0 + t) * P + p;
      const float xv = p < P ? to_f(xb[src]) : 0.0f;
      Xs[i] = xdt ? xv * dtb[t0 + t] : xv;
      DYs[i] = p < P ? to_f(dyb[src]) : 0.0f;
    }
    for (int t = tid; t < nt; t += kThreads) {
      Dts[t] = dtb[t0 + t];
      As[t] = expf(dtb[t0 + t] * a_h);
    }
  };

  // Pass 1, forward: state, dC_t = state_t . dy_t, r_t = C_t . dC_t.
  float st[NPT][PPT];
#pragma unroll
  for (int i = 0; i < NPT; ++i)
#pragma unroll
    for (int j = 0; j < PPT; ++j) st[i][j] = 0.0f;
  for (int t0 = 0; t0 < S; t0 += TT) {
    const int nt = min(TT, S - t0);
    __syncthreads();   // the previous tile's readers are done
    stage(t0, nt, true);
    __syncthreads();
    for (int t = 0; t < nt; ++t) {
      const float a = As[t];
      float xd[PPT], dyv[PPT];
#pragma unroll
      for (int j = 0; j < PPT; ++j) {
        xd[j] = Xs[t * PP + pg + 16 * j];
        dyv[j] = DYs[t * PP + pg + 16 * j];
      }
      float part[NPT];
#pragma unroll
      for (int i = 0; i < NPT; ++i) {
        const float b = Bs[t * N + ng * NPT + i];
        part[i] = 0.0f;
#pragma unroll
        for (int j = 0; j < PPT; ++j) {
          st[i][j] = fmaf(st[i][j], a, b * xd[j]);
          part[i] = fmaf(st[i][j], dyv[j], part[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < NPT; ++i)
#pragma unroll
        for (int w = 8; w > 0; w >>= 1) part[i] += __shfl_xor_sync(0xffffffffu, part[i], w);
      if (pg == 0) {
#pragma unroll
        for (int i = 0; i < NPT; ++i) Red[t * N + ng * NPT + i] = part[i];
      }
    }
    __syncthreads();
    for (int i = tid; i < nt * N; i += kThreads) dCb[static_cast<size_t>(t0) * N + i] = Red[i];
    for (int t = warp; t < nt; t += kWarps) {
      float r = 0.0f;
      for (int n = lane; n < N; n += 32) r = fmaf(Cs[t * N + n], Red[t * N + n], r);
#pragma unroll
      for (int w = 16; w > 0; w >>= 1) r += __shfl_xor_sync(0xffffffffu, r, w);
      if (lane == 0) ddtb[t0 + t] = r;   // r_t, read back in pass 2
    }
  }

  // Pass 2, backward: g, dB_t = g_t . (x_t dt_t), u_t = B_t . g_t, dx_t,
  // v_t, and Q_t as a running sum from the end (thread 0).
  float g[NPT][PPT];
#pragma unroll
  for (int i = 0; i < NPT; ++i)
#pragma unroll
    for (int j = 0; j < PPT; ++j) g[i][j] = 0.0f;
  float q_run = 0.0f, da = 0.0f;
  for (int t0 = (S - 1) / TT * TT; t0 >= 0; t0 -= TT) {
    const int nt = min(TT, S - t0);
    __syncthreads();   // the previous tile's readers are done
    stage(t0, nt, false);
    for (int t = tid; t < nt; t += kThreads) Rs[t] = ddtb[t0 + t];
    __syncthreads();
    for (int t = nt - 1; t >= 0; --t) {
      const float d = Dts[t], a = As[t];
      float xv[PPT], dyv[PPT];
#pragma unroll
      for (int j = 0; j < PPT; ++j) {
        xv[j] = Xs[t * PP + pg + 16 * j];
        dyv[j] = DYs[t * PP + pg + 16 * j];
      }
      float part[NPT], up[PPT];
#pragma unroll
      for (int j = 0; j < PPT; ++j) up[j] = 0.0f;
#pragma unroll
      for (int i = 0; i < NPT; ++i) {
        const float c = Cs[t * N + ng * NPT + i], b = Bs[t * N + ng * NPT + i];
        part[i] = 0.0f;
#pragma unroll
        for (int j = 0; j < PPT; ++j) {
          g[i][j] = fmaf(c, dyv[j], g[i][j]);            // g_t
          part[i] = fmaf(g[i][j], xv[j], part[i]);
          up[j] = fmaf(b, g[i][j], up[j]);
        }
      }
#pragma unroll
      for (int i = 0; i < NPT; ++i)
#pragma unroll
        for (int w = 8; w > 0; w >>= 1) part[i] += __shfl_xor_sync(0xffffffffu, part[i], w);
      if (pg == 0) {
#pragma unroll
        for (int i = 0; i < NPT; ++i) Red[t * N + ng * NPT + i] = part[i] * d;
      }
#pragma unroll
      for (int j = 0; j < PPT; ++j) {
        up[j] += __shfl_xor_sync(0xffffffffu, up[j], 16);   // the warp's two row groups
        if (lane < 16) Up[(t * kWarps + warp) * PP + pg + 16 * j] = up[j];
      }
#pragma unroll
      for (int i = 0; i < NPT; ++i)
#pragma unroll
        for (int j = 0; j < PPT; ++j) g[i][j] *= a;        // a_t g_t, for step t - 1
    }
    __syncthreads();
    for (int i = tid; i < nt * N; i += kThreads) dBb[static_cast<size_t>(t0) * N + i] = Red[i];
    for (int t = warp; t < nt; t += kWarps) {
      float v = 0.0f;
      for (int p = lane; p < PP; p += 32) {
        float u = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) u += Up[(t * kWarps + w) * PP + p];
        if (p < P) dxb[static_cast<size_t>(t0 + t) * P + p] = from_f<T>(Dts[t] * u);
        v = fmaf(Xs[t * PP + p], u, v);
      }
#pragma unroll
      for (int w = 16; w > 0; w >>= 1) v += __shfl_xor_sync(0xffffffffu, v, w);
      if (lane == 0) Vs[t] = v;
    }
    __syncthreads();
    if (tid == 0) {
      for (int t = nt - 1; t >= 0; --t) {
        q_run += Rs[t] - Dts[t] * Vs[t];   // Q_t
        ddtb[t0 + t] = Vs[t] + a_h * q_run;
        da = fmaf(Dts[t], q_run, da);
      }
    }
  }
  if (tid == 0) dA[bh] = da;
}

// out[r, e] = sum over h < H of part[r * H + h, e], in order of h, for each
// of the R B/C rows and their `row` = S * N elements.
template <typename T>
__global__ void __launch_bounds__(kThreads)
head_sum_kernel(const float* __restrict__ part, T* __restrict__ out, long long total,
                long long row, int H) {
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    const long long r = i / row, e = i % row;
    const float* src = part + r * H * row + e;
    float s = 0.0f;
    for (int h = 0; h < H; ++h) s += src[h * row];
    out[i] = from_f<T>(s);
  }
}

template <typename T, int NPT, int PPT>
int launch(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
           const void* dy, void* dx, float* ddt, float* dA, float* dBp, float* dCp, int BH,
           int S, int P, int H, cudaStream_t s) {
  constexpr size_t bytes = sizeof(float) * smem_floats<16 * NPT, 16 * PPT>();
  cudaError_t e = cudaFuncSetAttribute(ssd_bwd_kernel<T, NPT, PPT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_bwd_kernel<T, NPT, PPT><<<BH, kThreads, bytes, s>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      static_cast<const T*>(dy), static_cast<T*>(dx), ddt, dA, dBp, dCp, S, P, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NPT>
int dispatch_p(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
               const void* dy, void* dx, float* ddt, float* dA, float* dBp, float* dCp,
               int BH, int S, int P, int H, cudaStream_t s) {
  if (P <= 16) return launch<T, NPT, 1>(x, dt, A, Bm, Cm, dy, dx, ddt, dA, dBp, dCp, BH, S, P, H, s);
  if (P <= 32) return launch<T, NPT, 2>(x, dt, A, Bm, Cm, dy, dx, ddt, dA, dBp, dCp, BH, S, P, H, s);
  return launch<T, NPT, 4>(x, dt, A, Bm, Cm, dy, dx, ddt, dA, dBp, dCp, BH, S, P, H, s);
}

template <typename T>
int dispatch(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
             const void* dy, void* dx, float* ddt, float* dA, float* dBp, float* dCp,
             void* dBm, void* dCm, int BH, int S, int P, int N, int H, cudaStream_t s) {
  int rc;
  switch (N) {
    case 16: rc = dispatch_p<T, 1>(x, dt, A, Bm, Cm, dy, dx, ddt, dA, dBp, dCp, BH, S, P, H, s); break;
    case 32: rc = dispatch_p<T, 2>(x, dt, A, Bm, Cm, dy, dx, ddt, dA, dBp, dCp, BH, S, P, H, s); break;
    case 64: rc = dispatch_p<T, 4>(x, dt, A, Bm, Cm, dy, dx, ddt, dA, dBp, dCp, BH, S, P, H, s); break;
    case 128: rc = dispatch_p<T, 8>(x, dt, A, Bm, Cm, dy, dx, ddt, dA, dBp, dCp, BH, S, P, H, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  const long long row = static_cast<long long>(S) * N, total = row * (BH / H);
  const long long want = (total + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 65536 ? want : 65536);
  head_sum_kernel<T><<<blocks, kThreads, 0, s>>>(dBp, static_cast<T*>(dBm), total, row, H);
  head_sum_kernel<T><<<blocks, kThreads, 0, s>>>(dCp, static_cast<T*>(dCm), total, row, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xh, dy (BH, S, P) and Bm, Cm (BH / H, S, N) of type `dtype` (0 float32,
// 1 bfloat16); dt (BH, S), A (BH,) float32. Writes dx (BH, S, P) of xh's
// type, ddt (BH, S) and dA (BH,) float32, dBm and dCm (BH / H, S, N) of Bm's
// type, through the float32 scratch dB_part and dC_part (BH, S, N). N is 16,
// 32, 64 or 128 and 1 <= P <= 64. Launches three kernels on `stream` and
// returns cudaGetLastError() (cudaErrorInvalidValue for what they do not
// take).
extern "C" int ssd_scan_bwd_launch(const void* xh, const float* dt, const float* A,
                                   const void* Bm, const void* Cm, const void* dy, void* dx,
                                   float* ddt, float* dA, float* dB_part, float* dC_part,
                                   void* dBm, void* dCm, int BH, int S, int P, int N, int H,
                                   int dtype, void* stream) {
  if (H < 1 || BH % H != 0 || P < 1 || P > 64) return static_cast<int>(cudaErrorInvalidValue);
  if (BH <= 0 || S <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(xh, dt, A, Bm, Cm, dy, dx, ddt, dA, dB_part, dC_part, dBm, dCm, BH,
                           S, P, N, H, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(xh, dt, A, Bm, Cm, dy, dx, ddt, dA, dB_part, dC_part, dBm,
                                   dCm, BH, S, P, N, H, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
