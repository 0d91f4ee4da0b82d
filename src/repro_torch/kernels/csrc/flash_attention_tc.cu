// flash_attention, bfloat16 route: the function of flash_attention.cu on
// Hopper's tensor cores (wgmma). The float32 route stays in that file.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention (pallas_call
// at :99) for bfloat16 q, k, v (BH, S, hd) / (BH, T, hd), 1 <= hd <= 256.
//
// Arithmetic, as the Pallas kernel and flash_attention.cu: s = (q . k) *
// scale in float32; c * tanh(s / c) when c > 0; -1e30 where a key is past T,
// above the diagonal (causal) or at distance >= window; running max from
// -1e30; out = acc / max(l, 1e-30). The one new rounding: the probabilities
// p enter the P V product as bfloat16 (l sums them in float32).
//
// Bound: operations. Causal prefill does 4 * BH * S * T * hd / 2 flops on
// 4 BH S hd bf16 elements: at llama3.2-1b's batch 4 x 2048 (BH 128, hd 64)
// 68.7 GFLOP against 134 MB, 69 us on the bf16 tensor cores (989 TFLOP/s)
// and 40 us of memory. Design: one block of two warpgroups per (bh, 128
// query rows), query tiles issued last-first so the longest causal rows
// start first; each warpgroup owns 64 rows. Q is staged once; 64-key tiles
// of K and V pass through a ring of kStages<HDP> stages in shared memory,
// the copies of the next kStages - 1 tiles in flight while one is
// computed, one block barrier a tile (TMA would need 16-byte row strides, which hd not a multiple of 8
// lacks; the copies here fall back to plain loads for such hd). S = Q K^T is a wgmma
// m64n64k16 with both operands K-major in shared memory and a float32
// accumulator; the online softmax runs on that accumulator in registers,
// row max and sum over the 4 lanes of a quad; P is packed to bf16 in
// registers as the A operand of O += P V (wgmma, V read MN-major with the
// transpose bit; m64n256k16 at hd 256, whose accumulator is 128 floats a
// thread). hd is padded to 16, 32, 64, 128 or 256 in shared memory (zero
// columns). At 256 the ring has two stages: Q's 64 KiB and three stages of
// K and V (3 x 2 x 32 KiB) would need 256 KiB, over the 227 KiB a block
// may hold; two stages take 192 KiB, the next tile's copies in flight
// while one is computed. The descriptors' byte offsets at 256 (4096 along
// M/N of Q and K, 4096 along K of V) are 256 after the shift by 4, inside
// their 14-bit fields. Key tiles wholly above a warpgroup's diagonal or outside its
// window are skipped, per 64-row tile exactly as in flash_attention.cu;
// tiles wholly inside every row's valid keys skip the mask arithmetic.
// Given a non-null `lse` (BH, S) float32, each row's log-sum-exp
// m + log(max(l, 1e-30)) (l summed in float32) is written there for the
// backward kernel (flash_attention_bwd.cu); with null nothing else changes.
#include <cstdint>

#include "tc.cuh"

namespace {

constexpr int kWG = 2;              // warpgroups per block
constexpr int BM = 64;              // query rows per warpgroup
constexpr int BN = 64;              // keys per tile
constexpr int kThreads = 128 * kWG;
constexpr float kNegInf = -1e30f;

using bf16 = __nv_bfloat16;
using namespace popt;

// Byte offsets between core matrices of the V tile read MN-major: along K
// (keys, 8-row groups of the tile) and along N (head-dim chunks).
template <int HDP> constexpr uint32_t kVLbo = HDP * 16;
constexpr uint32_t kVSbo = 128;

// K/V ring depth: three stages, two at hd 256 (shared memory).
template <int HDP> constexpr int kStages = HDP >= 256 ? 2 : 3;
template <int HDP> __host__ __device__ constexpr int q_bytes() { return kWG * BM * HDP * 2; }
template <int HDP> __host__ __device__ constexpr int kv_bytes() { return BN * HDP * 2; }
template <int HDP> __host__ __device__ constexpr int smem_bytes() {
  return q_bytes<HDP>() + 2 * kStages<HDP> * kv_bytes<HDP>();
}

// Rows [r0, r0 + rows) of a (n_rows, hd) matrix into the core-matrix layout
// of an HDP-column tile at `dst`; rows past n_rows and columns past hd are
// zero. `vec`: 16-byte chunks by cp.async (hd % 8 == 0, aligned rows);
// otherwise plain loads. Eight neighbouring threads fill one 128-byte core
// matrix.
template <int HDP>
__device__ __forceinline__ void stage_tile(uint8_t* dst, const bf16* src, int r0, int rows,
                                           int n_rows, int hd, bool vec, int tid) {
  constexpr int CPR = HDP / 8;
  for (int i = tid; i < rows * CPR; i += kThreads) {
    const int rest = i >> 3;
    const int r = (rest / CPR) * 8 + (i & 7), col = (rest % CPR) * 8;
    const int row = r0 + r;
    uint8_t* d = dst + cm_offset(r, col, HDP);
    if (vec) {
      const bool ok = row < n_rows && col < hd;
      cp_async16(smem_addr(d), ok ? src + static_cast<size_t>(row) * hd + col : src,
                 ok ? 16 : 0);
    } else {
      __align__(16) bf16 v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = (row < n_rows && col + e < hd) ? src[static_cast<size_t>(row) * hd + col + e]
                                              : __float2bfloat16(0.0f);
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(v);
    }
  }
}

// Key tiles [begin, end) that a 64-row query tile from q0 visits: none
// wholly above the diagonal (causal) or wholly at distance >= window.
__device__ __forceinline__ void key_range(int q0, int Tk, int causal, int window,
                                          int& begin, int& end) {
  const int n_tiles = (Tk + BN - 1) / BN;
  end = n_tiles;
  begin = 0;
  if (causal) end = min(end, (q0 + BM - 1) / BN + 1);
  if (window > 0) {
    const int x = q0 - BN + 2 - window;
    if (x > 0) begin = (x + BN - 1) / BN;
  }
  if (begin >= end) { begin = 0; end = n_tiles; }
}

template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                int S, int Tk, int hd, float scale, int causal, int window, float softcap,
                int vec) {
  constexpr int NO = HDP / 2;     // output accumulator floats per thread
  constexpr int ST = kStages<HDP>;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* Qs = smem;
  uint8_t* Ks = smem + q_bytes<HDP>();          // stage s at + s * kv_bytes
  uint8_t* Vs = Ks + ST * kv_bytes<HDP>();

  const int bh = blockIdx.y;
  const int qb0 = (gridDim.x - 1 - blockIdx.x) * (kWG * BM);
  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int q0 = qb0 + wg * BM;
  const bf16* qb = q + static_cast<size_t>(bh) * S * hd;
  const bf16* kb = k + static_cast<size_t>(bh) * Tk * hd;
  const bf16* vb = v + static_cast<size_t>(bh) * Tk * hd;

  // This warpgroup's key tiles, and the block's: their union over the
  // warpgroups that hold rows (the first always does).
  int kt_begin = 0, kt_end = 0, blo = 1 << 30, bhi = 0;
#pragma unroll
  for (int w = 0; w < kWG; ++w) {
    if (qb0 + w * BM >= S) continue;
    int b, e;
    key_range(qb0 + w * BM, Tk, causal, window, b, e);
    blo = min(blo, b);
    bhi = max(bhi, e);
    if (w == wg) { kt_begin = b; kt_end = e; }
  }

  // Q and the first ST - 1 key tiles, one copy group each (Q with the
  // first); tile kt goes to stage (kt - blo) % ST.
  stage_tile<HDP>(Qs, qb, qb0, kWG * BM, S, hd, vec, tid);
#pragma unroll
  for (int j = 0; j < ST - 1; ++j) {
    if (blo + j >= bhi) break;
    stage_tile<HDP>(Ks + j * kv_bytes<HDP>(), kb, (blo + j) * BN, BN, Tk, hd, vec, tid);
    stage_tile<HDP>(Vs + j * kv_bytes<HDP>(), vb, (blo + j) * BN, BN, Tk, hd, vec, tid);
    cp_async_commit();
  }

  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.0f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;   // this thread's rows
  const uint32_t q_base = smem_addr(Qs + wg * BM * HDP * 2);

  for (int kt = blo, st = 0; kt < bhi; ++kt, st = st == ST - 1 ? 0 : st + 1) {
    // Tile kt is in once at most the ST - 2 tiles after it are pending;
    // after the barrier every thread is done with the stage tile kt - 1
    // used, which tile kt + ST - 1 then fills.
    if (kt + ST - 2 < bhi) cp_async_wait<ST - 2>();
    else cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    if (kt + ST - 1 < bhi) {
      const int nx = st == 0 ? ST - 1 : st - 1;
      stage_tile<HDP>(Ks + nx * kv_bytes<HDP>(), kb, (kt + ST - 1) * BN, BN, Tk, hd, vec, tid);
      stage_tile<HDP>(Vs + nx * kv_bytes<HDP>(), vb, (kt + ST - 1) * BN, BN, Tk, hd, vec, tid);
      cp_async_commit();
    }

    if (kt >= kt_begin && kt < kt_end) {
      const uint32_t k_base = smem_addr(Ks + st * kv_bytes<HDP>());
      const uint32_t v_base = smem_addr(Vs + st * kv_bytes<HDP>());
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.0f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk)
        wgmma_ss_m64n64k16(s, smem_desc(q_base + kk * 256, 128, HDP * 16),
                           smem_desc(k_base + kk * 256, 128, HDP * 16), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();

      // Scores of rows r0 (s[4j], s[4j+1]) and r1 (s[4j+2], s[4j+3]),
      // keys k0 + 8j + 2t (+1). A tile with every key valid for every row
      // of the warpgroup skips the mask.
      const int k0 = kt * BN;
      const bool full = k0 + BN <= Tk && (!causal || k0 + BN - 1 <= q0) &&
                        (window <= 0 || q0 + BM - 1 - k0 < window);
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[4 * j + e] * scale;
          if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
          if (!full) {
            const int qi = e < 2 ? r0 : r1;
            const int kj = k0 + j * 8 + 2 * t + (e & 1);
            bool ok = kj < Tk;
            if (causal) ok = ok && qi >= kj;
            if (window > 0) ok = ok && qi - kj < window;
            x = ok ? x : kNegInf;
          }
          s[4 * j + e] = x;
          if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
        }
      }
#pragma unroll
      for (int w = 1; w <= 2; w <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, w));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, w));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float c0 = __expf(m0 - mn0), c1 = __expf(m1 - mn1);
      float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[4 * j] = __expf(s[4 * j] - mn0);
        s[4 * j + 1] = __expf(s[4 * j + 1] - mn0);
        s[4 * j + 2] = __expf(s[4 * j + 2] - mn1);
        s[4 * j + 3] = __expf(s[4 * j + 3] - mn1);
        rs0 += s[4 * j] + s[4 * j + 1];
        rs1 += s[4 * j + 2] + s[4 * j + 3];
      }
#pragma unroll
      for (int w = 1; w <= 2; w <<= 1) {
        rs0 += __shfl_xor_sync(0xffffffffu, rs0, w);
        rs1 += __shfl_xor_sync(0xffffffffu, rs1, w);
      }
      l0 = l0 * c0 + rs0;
      l1 = l1 * c1 + rs1;
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int j = 0; j < NO / 4; ++j) {
        acc[4 * j] *= c0;
        acc[4 * j + 1] *= c0;
        acc[4 * j + 2] *= c1;
        acc[4 * j + 3] *= c1;
      }
      // P as the A operand: keys 16kk.. are the n8 blocks 2kk and 2kk + 1.
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_tb<HDP>(acc, pa[kk],
                         smem_desc(v_base + kk * 2 * HDP * 16, kVLbo<HDP>, kVSbo), 1);
      wgmma_commit();
      wgmma_wait<0>();
    }
  }

  bf16* ob = o + static_cast<size_t>(bh) * S * hd;
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  if (lse != nullptr && t == 0) {
    if (r0 < S) lse[static_cast<size_t>(bh) * S + r0] = m0 + logf(d0);
    if (r1 < S) lse[static_cast<size_t>(bh) * S + r1] = m1 + logf(d1);
  }
#pragma unroll
  for (int j = 0; j < NO / 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e < 2 ? r0 : r1, col = j * 8 + 2 * t + (e & 1);
      if (r < S && col < hd)
        ob[static_cast<size_t>(r) * hd + col] =
            __float2bfloat16_rn(acc[4 * j + e] / (e < 2 ? d0 : d1));
    }
  }
}

template <int HDP>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int BH, int S,
           int Tk, int hd, float scale, int causal, int window, float softcap, int vec,
           cudaStream_t stream) {
  constexpr int bytes = smem_bytes<HDP>();
  cudaError_t e = cudaFuncSetAttribute(flash_tc_kernel<HDP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((S + kWG * BM - 1) / (kWG * BM), BH);
  flash_tc_kernel<HDP><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, S, Tk, hd, scale, causal, window, softcap, vec);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// q (BH, S, hd), k and v (BH, T, hd), out (BH, S, hd), all contiguous
// bfloat16; 1 <= hd <= 256; lse (BH, S) float32 or null. Launches on
// `stream` and returns cudaGetLastError() (cudaErrorInvalidValue for a shape
// it does not take).
extern "C" int flash_attention_tc_launch(const void* q, const void* k, const void* v,
                                         void* out, float* lse, int BH, int S, int Tk, int hd,
                                         float scale, int causal, int window,
                                         float softcap, void* stream) {
  if (hd < 1 || hd > 256 || Tk < 1 || BH > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (BH <= 0 || S <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = hd % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  if (hd <= 16) return launch<16>(q, k, v, out, lse, BH, S, Tk, hd, scale, causal, window, softcap, vec, s);
  if (hd <= 32) return launch<32>(q, k, v, out, lse, BH, S, Tk, hd, scale, causal, window, softcap, vec, s);
  if (hd <= 64) return launch<64>(q, k, v, out, lse, BH, S, Tk, hd, scale, causal, window, softcap, vec, s);
  if (hd <= 128) return launch<128>(q, k, v, out, lse, BH, S, Tk, hd, scale, causal, window, softcap, vec, s);
  return launch<256>(q, k, v, out, lse, BH, S, Tk, hd, scale, causal, window, softcap, vec, s);
}
