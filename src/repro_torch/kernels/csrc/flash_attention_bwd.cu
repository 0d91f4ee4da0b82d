// flash_attention_bwd: the gradient of flash_attention (dQ, dK, dV).
//
// Replaces no TPU kernel: the JAX package has no backward kernel, and its
// training path differentiates jnp attention. The port's model sends
// attention through its flash_attention kernel (models/layers.py), so
// training on the card needs that kernel's gradient as a kernel too. It is
// the gradient of src/repro/kernels/flash_attention.py::flash_attention
// (pallas_call at :99), as jax.grad of repro.kernels.ref.flash_attention_ref
// gives it.
//
// q, o, dO (BH, S, hd); k, v (BH, T, hd), KV heads already expanded;
// float32 or bfloat16, computed in float32; lse (BH, S) float32, the
// forward's per-row log-sum-exp (flash_attention.cu, flash_attention_tc.cu).
// With s = (q . k) * scale, t = c * tanh(s / c) when c > 0 (else t = s), the
// forward's causal and window masks, and P = exp(t - lse) (0 where masked):
//   D_i  = sum_d dO_id O_id                       (one float per row)
//   dV   = P^T dO,  dP = dO V^T,  dT = P o (dP - D),
//   dS   = dT o (1 - (t / c)^2)   (dT without a softcap),
//   dQ   = scale dS K,  dK = scale dS^T Q;
// dQ, dK, dV are written in q's type. A row with no valid key (possible
// only when S > T) gets no gradient; every training row sees its diagonal.
//
// Deterministic: no atomics. A first kernel writes D; then one pass over
// query tiles for each key tile computes dK and dV in that block's
// registers, and one pass over key tiles for each query tile computes dQ.
// Each output element is summed by one thread in a fixed order, so two runs
// on the same inputs give the same bits (the resume drill relies on it).
//
// Bound: operations. Per kept (query, key) pair and head dim the backward
// does five products of two flops (S and dP recomputed, dV, dQ, dK): 10 BH
// hd flops a pair. At llama3.2-1b's training shape (BH 256, S = T = 512, hd
// 64, causal: 131,328 pairs a row) that is 21.5 GFLOP: 21.8 us on the bf16
// tensor cores, 0.32 ms at the float32 CUDA-core rate (67 TFLOP/s) this
// kernel runs at. Design: CUDA cores, float32, 256 threads as 16 x 16;
// 64-row tiles (32 at head dim 256, for shared memory), Q, dO, K and V tiles
// staged row-major in shared memory with rows padded by one float (the
// threads of a half warp read neighbouring rows at the same column, in 16
// banks). Thread (ty, tx) computes scores for rows ty R.. and keys tx +
// 16 j, and accumulates output rows ty R.. at columns tx + 16 j. Tiles wholly
// above the causal diagonal or outside the window are skipped. Tensor cores
// are later work.
#include <cstdint>

#include "bf16.cuh"

namespace {

constexpr int kThreads = 256;   // 16 x 16: thread (ty, tx)

using popt::from_f;
using popt::to_f;

// Rows of a query tile and of a key tile, by padded head dim.
template <int HDP>
__host__ __device__ constexpr int tile() { return HDP >= 256 ? 32 : 64; }

template <int HDP>
__host__ __device__ constexpr size_t smem_floats() {
  constexpr int B = tile<HDP>();
  // Four staged (B, HDP + 1) tiles, two (B, B + 1) probability tiles, lse, D.
  return 4 * B * (HDP + 1) + 2 * B * (B + 1) + 2 * B;
}

// D[row] = sum_d dO[row, d] O[row, d] in float32: one warp a row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dot_rows_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                float* __restrict__ D, int rows, int hd) {
  const int row = (blockIdx.x * kThreads + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (row >= rows) return;   // the whole warp
  const T* a = o + static_cast<size_t>(row) * hd;
  const T* b = dout + static_cast<size_t>(row) * hd;
  float s = 0.0f;
  for (int d = lane; d < hd; d += 32) s = fmaf(to_f(a[d]), to_f(b[d]), s);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
  if (lane == 0) D[row] = s;
}

// Rows [r0, r0 + ROWS) of a (n_rows, hd) matrix into dst[ROWS][HDP + 1] as
// float32; rows past n_rows and columns past hd are zero.
template <typename T, int HDP, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int r0, int n_rows,
                                          int hd) {
  constexpr int LDH = HDP + 1;
  for (int i = threadIdx.x; i < ROWS * HDP; i += kThreads) {
    const int r = i / HDP, d = i % HDP;
    dst[r * LDH + d] =
        (r0 + r < n_rows && d < hd) ? to_f(src[static_cast<size_t>(r0 + r) * hd + d]) : 0.0f;
  }
}

// lse and D of rows [q0, q0 + B) into shared memory (0 past S: those rows
// are masked).
template <int B>
__device__ __forceinline__ void load_row_stats(float* lse_s, float* D_s, const float* lse,
                                               const float* D, int q0, int S) {
  for (int i = threadIdx.x; i < B; i += kThreads) {
    const bool ok = q0 + i < S;
    lse_s[i] = ok ? lse[q0 + i] : 0.0f;
    D_s[i] = ok ? D[q0 + i] : 0.0f;
  }
}

// P and dS (without the scale) of this thread's scores: query rows
// q0 + ty * R + i, keys k0 + tx + 16 j, from the staged Q, dO (rows of the
// query tile) and K, V (rows of the key tile).
template <int HDP, int B>
__device__ __forceinline__ void probs_and_grads(
    const float* Qs, const float* dOs, const float* Ks, const float* Vs, const float* lse_s,
    const float* D_s, int q0, int k0, int S, int Tk, float scale, int causal, int window,
    float softcap, float (&p)[B / 16][B / 16], float (&ds)[B / 16][B / 16]) {
  constexpr int LDH = HDP + 1, R = B / 16;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float s[R][R], dp[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < HDP; ++d) {
    float qv[R], ov[R], kv[R], vv[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      qv[i] = Qs[(ty * R + i) * LDH + d];
      ov[i] = dOs[(ty * R + i) * LDH + d];
      kv[i] = Ks[(tx + 16 * i) * LDH + d];
      vv[i] = Vs[(tx + 16 * i) * LDH + d];
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + ty * R + i;
    const float l = lse_s[ty * R + i], dd = D_s[ty * R + i];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int kj = k0 + tx + 16 * j;
      bool ok = qi < S && kj < Tk;
      if (causal) ok = ok && qi >= kj;
      if (window > 0) ok = ok && qi - kj < window;
      float x = s[i][j] * scale, deriv = 1.0f;
      if (softcap > 0.0f) {
        const float t = softcap * tanhf(x / softcap);
        const float u = t / softcap;
        deriv = 1.0f - u * u;
        x = t;
      }
      const float pr = ok ? expf(x - l) : 0.0f;
      p[i][j] = pr;
      ds[i][j] = pr * (dp[i][j] - dd) * deriv;
    }
  }
}

// One block per (key tile, bh): dK and dV of the tile's keys over every
// query tile that sees one of them.
template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ D, T* __restrict__ dk, T* __restrict__ dv, int S,
            int Tk, int hd, float scale, int causal, int window, float softcap) {
  constexpr int B = tile<HDP>(), LDH = HDP + 1, LDP = B + 1, R = B / 16, CPT = HDP / 16;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + B * LDH;
  float* Qs = Vs + B * LDH;
  float* dOs = Qs + B * LDH;
  float* Ps = dOs + B * LDH;
  float* dSs = Ps + B * LDP;
  float* lse_s = dSs + B * LDP;
  float* D_s = lse_s + B;

  const int bh = blockIdx.y, k0 = blockIdx.x * B;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const size_t qoff = static_cast<size_t>(bh) * S * hd, koff = static_cast<size_t>(bh) * Tk * hd;
  load_rows<T, HDP, B>(Ks, k + koff, k0, Tk, hd);
  load_rows<T, HDP, B>(Vs, v + koff, k0, Tk, hd);

  float dk_acc[R][CPT], dv_acc[R][CPT];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.0f;

  // Query tiles holding a row that sees a key of this tile: rows >= k0
  // (causal) and rows < k0 + B - 1 + window (window).
  const int n_qt = (S + B - 1) / B;
  int qt_begin = 0, qt_end = n_qt;
  if (causal) qt_begin = k0 / B;
  if (window > 0) qt_end = min(qt_end, (k0 + B + window - 2) / B + 1);

  for (int qt = qt_begin; qt < qt_end; ++qt) {
    const int q0 = qt * B;
    __syncthreads();   // the previous tile's readers are done
    load_rows<T, HDP, B>(Qs, q + qoff, q0, S, hd);
    load_rows<T, HDP, B>(dOs, dout + qoff, q0, S, hd);
    load_row_stats<B>(lse_s, D_s, lse + static_cast<size_t>(bh) * S,
                      D + static_cast<size_t>(bh) * S, q0, S);
    __syncthreads();
    float p[R][R], ds[R][R];
    probs_and_grads<HDP, B>(Qs, dOs, Ks, Vs, lse_s, D_s, q0, k0, S, Tk, scale, causal,
                            window, softcap, p, ds);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        Ps[(ty * R + i) * LDP + tx + 16 * j] = p[i][j];
        dSs[(ty * R + i) * LDP + tx + 16 * j] = ds[i][j];
      }
    __syncthreads();
    // dV[c][d] += sum_r P[r][c] dO[r][d];  dK[c][d] += sum_r dS[r][c] Q[r][d]
    // for keys c = ty * R + i and columns d = tx + 16 j.
#pragma unroll 2
    for (int r = 0; r < B; ++r) {
      float pv[R], sv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        pv[i] = Ps[r * LDP + ty * R + i];
        sv[i] = dSs[r * LDP + ty * R + i];
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float o = dOs[r * LDH + tx + 16 * j], qq = Qs[r * LDH + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          dv_acc[i][j] = fmaf(pv[i], o, dv_acc[i][j]);
          dk_acc[i][j] = fmaf(sv[i], qq, dk_acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int c = k0 + ty * R + i;
    if (c >= Tk) continue;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) {
        dk[koff + static_cast<size_t>(c) * hd + d] = from_f<T>(dk_acc[i][j] * scale);
        dv[koff + static_cast<size_t>(c) * hd + d] = from_f<T>(dv_acc[i][j]);
      }
    }
  }
}

// One block per (query tile, bh): dQ of the tile's rows over every key tile
// one of them sees. Query tiles are issued last-first, so the blocks with
// the most key tiles start first.
template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ D, T* __restrict__ dq, int S, int Tk, int hd,
          float scale, int causal, int window, float softcap) {
  constexpr int B = tile<HDP>(), LDH = HDP + 1, LDP = B + 1, R = B / 16, CPT = HDP / 16;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + B * LDH;
  float* Qs = Vs + B * LDH;
  float* dOs = Qs + B * LDH;
  float* dSs = dOs + B * LDH + B * LDP;   // the second probability tile
  float* lse_s = dSs + B * LDP;
  float* D_s = lse_s + B;

  const int bh = blockIdx.y, q0 = (gridDim.x - 1 - blockIdx.x) * B;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const size_t qoff = static_cast<size_t>(bh) * S * hd, koff = static_cast<size_t>(bh) * Tk * hd;
  load_rows<T, HDP, B>(Qs, q + qoff, q0, S, hd);
  load_rows<T, HDP, B>(dOs, dout + qoff, q0, S, hd);
  load_row_stats<B>(lse_s, D_s, lse + static_cast<size_t>(bh) * S,
                    D + static_cast<size_t>(bh) * S, q0, S);

  float dq_acc[R][CPT];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) dq_acc[i][j] = 0.0f;

  // Key tiles holding a key some row of this tile sees: keys <= the last
  // row (causal) and keys > the first row - window (window).
  const int n_kt = (Tk + B - 1) / B;
  int kt_begin = 0, kt_end = n_kt;
  if (causal) kt_end = min(kt_end, (q0 + B - 1) / B + 1);
  if (window > 0) kt_begin = max(0, q0 - window + 1) / B;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * B;
    __syncthreads();   // the previous tile's readers are done
    load_rows<T, HDP, B>(Ks, k + koff, k0, Tk, hd);
    load_rows<T, HDP, B>(Vs, v + koff, k0, Tk, hd);
    __syncthreads();
    float p[R][R], ds[R][R];
    probs_and_grads<HDP, B>(Qs, dOs, Ks, Vs, lse_s, D_s, q0, k0, S, Tk, scale, causal,
                            window, softcap, p, ds);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) dSs[(ty * R + i) * LDP + tx + 16 * j] = ds[i][j];
    __syncthreads();
    // dQ[r][d] += sum_c dS[r][c] K[c][d] for rows r = ty * R + i and
    // columns d = tx + 16 j.
#pragma unroll 2
    for (int c = 0; c < B; ++c) {
      float sv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) sv[i] = dSs[(ty * R + i) * LDP + c];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float kk = Ks[c * LDH + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < R; ++i) dq_acc[i][j] = fmaf(sv[i], kk, dq_acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = q0 + ty * R + i;
    if (r >= S) continue;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) dq[qoff + static_cast<size_t>(r) * hd + d] = from_f<T>(dq_acc[i][j] * scale);
    }
  }
}

template <typename T, int HDP>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, float* D, void* dq, void* dk, void* dv, int BH, int S, int Tk,
           int hd, float scale, int causal, int window, float softcap, cudaStream_t stream) {
  constexpr int B = tile<HDP>();
  constexpr size_t bytes = sizeof(float) * smem_floats<HDP>();
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const int rows = BH * S;
  dot_rows_kernel<T><<<(rows + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0, stream>>>(
      static_cast<const T*>(o), dot, D, rows, hd);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  // Above 48 KB of dynamic shared memory a kernel must opt in (per device).
  e = cudaFuncSetAttribute(dkdv_kernel<T, HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(dq_kernel<T, HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  dkdv_kernel<T, HDP><<<dim3((Tk + B - 1) / B, BH), kThreads, bytes, stream>>>(
      qt, kt, vt, dot, lse, D, static_cast<T*>(dk), static_cast<T*>(dv), S, Tk, hd, scale,
      causal, window, softcap);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  dq_kernel<T, HDP><<<dim3((S + B - 1) / B, BH), kThreads, bytes, stream>>>(
      qt, kt, vt, dot, lse, D, static_cast<T*>(dq), S, Tk, hd, scale, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, const void* o, const void* dout,
                const float* lse, float* D, void* dq, void* dk, void* dv, int BH, int S,
                int Tk, int hd, float scale, int causal, int window, float softcap,
                cudaStream_t s) {
#define FLASH_BWD(HDP)                                                                   \
  launch<T, HDP>(q, k, v, o, dout, lse, D, dq, dk, dv, BH, S, Tk, hd, scale, causal, \
                 window, softcap, s)
  if (hd <= 32) return FLASH_BWD(32);
  if (hd <= 64) return FLASH_BWD(64);
  if (hd <= 128) return FLASH_BWD(128);
  return FLASH_BWD(256);
#undef FLASH_BWD
}

}  // namespace

// q, o, dout (BH, S, hd) and k, v (BH, T, hd), all contiguous of type `dtype`
// (0 float32, 1 bfloat16); lse (BH, S) float32 from the forward; D (BH, S)
// float32 scratch; dq (BH, S, hd), dk and dv (BH, T, hd) of q's type;
// 1 <= hd <= 256. Launches three kernels on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for what the kernels do not take).
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const float* lse,
                                          float* D, void* dq, void* dk, void* dv, int BH,
                                          int S, int Tk, int hd, int dtype, float scale,
                                          int causal, int window, float softcap,
                                          void* stream) {
  if (hd < 1 || hd > 256 || Tk < 1 || BH > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (BH <= 0 || S <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(q, k, v, o, dout, lse, D, dq, dk, dv, BH, S, Tk, hd, scale,
                              causal, window, softcap, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(q, k, v, o, dout, lse, D, dq, dk, dv, BH, S, Tk, hd,
                                      scale, causal, window, softcap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
