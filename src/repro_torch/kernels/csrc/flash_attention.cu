// flash_attention: causal / windowed / softcapped streaming-softmax attention.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention (pallas_call
// at :99).
//
// q (BH, S, hd); k, v (BH, T, hd), KV heads already expanded; float32 or
// bfloat16, computed in float32 as the Pallas kernel does, output in q's type:
//   s = (q . k) * scale;  s = c * tanh(s / c) when c > 0;
//   s = -1e30 where k_idx >= T, (causal and q_idx < k_idx) or
//       (window > 0 and q_idx - k_idx >= window), indices from 0;
//   online softmax over key tiles: m' = max(m, rowmax s), p = exp(s - m'),
//   l = l * exp(m - m') + sum p, acc = acc * exp(m - m') + p v;
//   out = acc / max(l, 1e-30).
// The running max starts at -1e30 as in the Pallas kernel, so a row whose
// first visited tile is all masked collects exp(0) = 1 terms there, and the
// first tile that holds one of its keys multiplies them by exp(-1e30 - m) = 0.
// Given a non-null `lse` (BH, S) float32, each row's log-sum-exp
// m + log(max(l, 1e-30)) is written there for the backward kernel
// (flash_attention_bwd.cu); with null nothing else changes.
//
// Bound: operations. Causal prefill does 4 * BH * S * T * hd / 2 flops on
// (3 BH S hd + BH S hd) elements: at llama3.2-1b's batch 4 x 2048 (BH 128,
// hd 64) that is 68.7 GFLOP against 134 MB, 69 us on the bf16 tensor cores
// and 40 us of memory. This first version runs on the CUDA cores in
// float32 (67 TFLOP/s, about 1 ms for the same work); wgmma and TMA come
// later. Design: one 256-thread block per (bh, 64-row query tile), the query
// tile transposed in shared memory for the whole block; a loop over 64-key
// tiles of K (transposed) and V staged in shared memory. Each thread owns a
// 4 x 4 block of the 64 x 64 score tile (rows 4ty.., keys 4tx..), so the
// row max and sum reduce over the 16 lanes of a half warp by shuffles, and
// the same 4 rows x hd/16 columns of the output accumulator, in registers.
// The probabilities pass through shared memory (transposed) to the P V
// product. Key tiles wholly above the causal diagonal or outside the window
// are skipped: their every term is exp(-1e30 - m) = 0. Query tiles are
// issued last-first, so the blocks with the most key tiles start first.
#include <cstdint>

#include "bf16.cuh"

namespace {

constexpr int BM = 64;          // query rows per block
constexpr int BN = 64;          // keys per tile
constexpr int kThreads = 256;   // 16 x 16: thread (ty, tx)
constexpr int LD = BM + 4;      // row length of transposed tiles (16-byte aligned)
constexpr float kNegInf = -1e30f;

using popt::from_f;
using popt::to_f;

// Shared memory floats for padded head dim HDP: Qt, Kt [HDP][LD], Vs [BN][HDP],
// Pt [BN][LD]. At 256: 222,208 bytes, one block an SM (the opt-in ceiling
// is 232,448).
template <int HDP>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * HDP * LD + BN * HDP + BN * LD);
}

// Blocks an SM holds by shared memory (228 KiB an SM, 1 KiB reserved a
// block), at most 2: __launch_bounds__ caps registers at 65,536 / (256 x
// that), which buys occupancy only where shared memory allows it. 2 below
// hd 128, 1 at 128 and 256.
template <int HDP>
constexpr int min_blocks() {
  return 2 * (smem_bytes<HDP>() + 1024) <= 233472 ? 2 : 1;
}

// Output column j (< HDP / 16) of thread tx: groups of four, 64 apart.
template <int HDP>
__device__ __forceinline__ int out_col(int tx, int j) {
  if constexpr (HDP >= 64) return tx * 4 + (j / 4) * 64 + (j % 4);
  else return tx * (HDP / 16) + j;
}

template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads, min_blocks<HDP>())
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
             int S, int Tk, int hd, float scale, int causal, int window, float softcap) {
  constexpr int CPT = HDP / 16;   // output columns per thread
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);
  float* Kt = Qt + HDP * LD;
  float* Vs = Kt + HDP * LD;
  float* Pt = Vs + BN * HDP;

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const T* qb = q + static_cast<size_t>(bh) * S * hd;
  const T* kb = k + static_cast<size_t>(bh) * Tk * hd;
  const T* vb = v + static_cast<size_t>(bh) * Tk * hd;

  for (int i = tid; i < BM * HDP; i += kThreads) {
    const int r = i / HDP, d = i % HDP;
    Qt[d * LD + r] = (q0 + r < S && d < hd)
                         ? to_f(qb[static_cast<size_t>(q0 + r) * hd + d]) : 0.0f;
  }

  // Key tiles this block visits: none wholly above the diagonal (causal)
  // or wholly at distance >= window below every row.
  const int n_tiles = (Tk + BN - 1) / BN;
  int kt_end = n_tiles, kt_begin = 0;
  if (causal) kt_end = min(kt_end, (q0 + BM - 1) / BN + 1);
  if (window > 0) {
    const int x = q0 - BN + 2 - window;
    if (x > 0) kt_begin = (x + BN - 1) / BN;
  }
  if (kt_begin >= kt_end) { kt_begin = 0; kt_end = n_tiles; }

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.0f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();   // the previous tile's readers are done
    for (int i = tid; i < BN * HDP; i += kThreads) {
      const int c = i / HDP, d = i % HDP;
      float kx = 0.0f, vx = 0.0f;
      if (k0 + c < Tk && d < hd) {
        const size_t off = static_cast<size_t>(k0 + c) * hd + d;
        kx = to_f(kb[off]);
        vx = to_f(vb[off]);
      }
      Kt[d * LD + c] = kx;
      Vs[c * HDP + d] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < HDP; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qt[d * LD + ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Kt[d * LD + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx * 4 + j;
        float x = s[i][j] * scale;
        if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
        bool ok = kj < Tk;
        if (causal) ok = ok && qi >= kj;
        if (window > 0) ok = ok && qi - kj < window;
        s[i][j] = ok ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, w);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Pt[(tx * 4 + j) * LD + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BN; ++c) {
      const float4 p4 = *reinterpret_cast<const float4*>(&Pt[c * LD + ty * 4]);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
      float vv[CPT];
      if constexpr (HDP >= 64) {
#pragma unroll
        for (int g = 0; g < CPT / 4; ++g) {
          const float4 v4 = *reinterpret_cast<const float4*>(&Vs[c * HDP + tx * 4 + g * 64]);
          vv[4 * g] = v4.x; vv[4 * g + 1] = v4.y; vv[4 * g + 2] = v4.z; vv[4 * g + 3] = v4.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < CPT; ++j) vv[j] = Vs[c * HDP + out_col<HDP>(tx, j)];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  T* ob = o + static_cast<size_t>(bh) * S * hd;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    if (lse != nullptr && tx == 0) lse[static_cast<size_t>(bh) * S + r] = m[i] + logf(den);
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int col = out_col<HDP>(tx, j);
      if (col < hd) ob[static_cast<size_t>(r) * hd + col] = from_f<T>(acc[i][j] / den);
    }
  }
}

template <typename T, int HDP>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int BH,
           int S, int Tk, int hd, float scale, int causal, int window, float softcap,
           cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<HDP>();
  // Above 48 KB of dynamic shared memory a kernel must opt in (per device).
  cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<T, HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((S + BM - 1) / BM, BH);
  flash_kernel<T, HDP><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, S, Tk, hd, scale, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, void* o, float* lse, int BH,
                int S, int Tk, int hd, float scale, int causal, int window,
                float softcap, cudaStream_t s) {
  if (hd <= 32) return launch<T, 32>(q, k, v, o, lse, BH, S, Tk, hd, scale, causal, window, softcap, s);
  if (hd <= 64) return launch<T, 64>(q, k, v, o, lse, BH, S, Tk, hd, scale, causal, window, softcap, s);
  if (hd <= 128) return launch<T, 128>(q, k, v, o, lse, BH, S, Tk, hd, scale, causal, window, softcap, s);
  return launch<T, 256>(q, k, v, o, lse, BH, S, Tk, hd, scale, causal, window, softcap, s);
}

}  // namespace

// q (BH, S, hd), k and v (BH, T, hd), out (BH, S, hd), all contiguous, of
// type `dtype` (0 float32, 1 bfloat16); 1 <= hd <= 256; lse (BH, S) float32
// or null. Launches on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for a shape or type the kernel does not take).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* out, float* lse, int BH, int S, int Tk, int hd,
                                      int dtype, float scale, int causal,
                                      int window, float softcap, void* stream) {
  if (hd < 1 || hd > 256 || Tk < 1 || BH > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (BH <= 0 || S <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(q, k, v, out, lse, BH, S, Tk, hd, scale, causal, window, softcap, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(q, k, v, out, lse, BH, S, Tk, hd, scale, causal, window,
                                      softcap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
