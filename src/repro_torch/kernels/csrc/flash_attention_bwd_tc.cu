// flash_attention_bwd, bfloat16 route: the gradient of flash_attention (dQ,
// dK, dV) on Hopper's tensor cores (wgmma). The float32 route, and bfloat16
// at head dims over 128, stay on the CUDA cores in flash_attention_bwd.cu.
//
// Replaces no TPU kernel: the JAX package has no backward kernel, and its
// training path differentiates jnp attention. It is the gradient of
// src/repro/kernels/flash_attention.py::flash_attention (pallas_call at :99)
// as jax.grad of repro.kernels.ref.flash_attention_ref gives it, for
// bfloat16 q, o, dO (BH, S, hd) and k, v (BH, T, hd), 1 <= hd <= 128, with
// lse (BH, S) float32, the forward's row log-sum-exp (flash_attention_tc.cu).
//
// The math is flash_attention_bwd.cu's: s = (q . k) * scale, t = c tanh(s /
// c) when c > 0, the causal and window masks, P = exp(t - lse) (0 where
// masked), D_i = sum_d dO_id O_id, dV = P^T dO, dP = dO V^T, dS = P o (dP -
// D) o (1 - (t / c)^2), dQ = scale dS K, dK = scale dS^T Q.
//
// Rounding: q, k, v and dO enter their products as they are (bfloat16); P
// enters P^T dO as bfloat16, as the forward rounds P for P V, and dS enters
// dS^T Q and dS K as bfloat16. Every product sums in float32; t, P, dP, D
// and dS are computed in float32 registers; dQ, dK and dV are rounded to
// bfloat16 once, at the end.
//
// Design: blocks of one warpgroup (128 threads) in two roles, two launches
// of one kernel template (the role a template argument, so each keeps only
// its own registers), both over the same shared-memory layout: two "fixed"
// 64-row tiles staged once, and a ring of "streamed" 64-row tile pairs,
// the next tiles' cp.async copies in flight while one is computed (three
// stages up to hd 64, two at 128; tools/bwd_tc_breakdown.py: two within
// 2%, four up to 10% slower). A thread's share of a tile copy is worked
// out once.
//  - dQ blocks first, one per (bh, 64 queries), three an SM: fixed Q and dO
//    with their rows' lse, and D of those rows computed from O and dO at
//    the start (two threads a row) and written for the second launch.
//    For each key tile: S = Q K^T and dP = dO V^T (wgmma m64n64k16, both
//    operands K-major in shared memory), P and dS in registers with the
//    masks and the softcap, and dQ += dS K (wgmma with A from registers,
//    packed to bfloat16, and K read MN-major with the transpose bit, as the
//    forward reads V).
//  - dK/dV blocks, one per (bh, 64 keys), two an SM: fixed K and V,
//    streamed Q and dO with their rows' lse and D. For each query tile:
//    S^T = K Q^T, dP^T = V dO^T, P^T and dS^T, dV += P^T dO and dK += dS^T
//    Q. dK and dV accumulate in float32 registers.
// S and dP are computed in both roles: seven products a kept tile pair in
// all, not five, in exchange for no atomics and no scratch for dS. Every
// output element is summed by one thread over the tiles in order, so two
// runs give the same bits. Tiles wholly above the causal diagonal or
// outside the window are skipped; a pair of tiles inside every row's valid
// keys skips the mask arithmetic; the softcap is a template argument.
// Blocks are ordered bh-major (a head's blocks share its tiles in L2), the
// longest first within a head. The outputs leave through shared memory in
// whole 16-byte rows. hd is padded to 16, 32, 64 or 128 in shared memory
// (zero columns). At 256 dK and dV alone would take 256 accumulator floats
// a thread, over the 255 registers a thread may hold, so hd 256 stays on
// flash_attention_bwd.cu.
//
// Bound, at llama3.2-1b's training shape (BH 256, S = T = 512, hd 64,
// causal, 131,328 kept pairs a row): bytes. The function reads q, k, v, o,
// dO and lse and writes dq, dk, dv once: 134 MB, 40.2 us at 3.35 TB/s. It
// needs five products, 10 BH hd flops a kept pair: 21.5 GFLOP, 21.7 us on
// the bf16 tensor cores (989 TFLOP/s); this design does seven, counted on
// whole 64 x 64 tiles (36 of the 64 tile pairs a head): 30.1 GFLOP, 30.5
// us. Its shared-memory traffic from L2: each dK/dV block reads the Q and
// dO tiles it visits and each dQ block the K and V tiles, 36 tile pairs x
// 2 x 8 KiB a head for each role: 302 MB.
#include <cstdint>

#include "tc.cuh"

namespace {

constexpr int BM = 64;            // rows of a tile: keys (dK/dV) or queries (dQ)
constexpr int kThreads = 128;     // one warpgroup

using bf16 = __nv_bfloat16;
using namespace popt;

template <int HDP> __host__ __device__ constexpr int tile_bytes() { return BM * HDP * 2; }
// Ring depth of the streamed tiles: three stages (the next two tiles'
// copies in flight while one is computed) up to hd 64, two at 128, where
// three would leave room for one block an SM.
template <int HDP> constexpr int kStages = HDP <= 64 ? 3 : 2;
// Two fixed tiles, kStages x two streamed tiles, and kStages x (lse, D) of
// BM rows.
template <int HDP> __host__ __device__ constexpr int smem_bytes() {
  return 2 * tile_bytes<HDP>() + kStages<HDP> * 2 * tile_bytes<HDP>() +
         kStages<HDP> * 2 * BM * 4;
}


// 4 bytes global -> shared; src_bytes 0 writes a zero.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

// A BM-row tile of a (n_rows, hd) matrix into the core-matrix layout of an
// HDP-column tile in shared memory (tc.cuh); rows past n_rows and columns
// past hd are zero. Thread tid fills the 16-byte chunks of rows r0 + j DR
// (j < NCH) at column `col`, worked out once: eight neighbouring threads
// fill one 128-byte core matrix. `vec` (hd % 8 == 0, 16-byte aligned rows):
// cp.async; otherwise plain loads.
template <int HDP>
struct TileCopy {
  static constexpr int CPR = HDP / 8;            // 16-byte chunks a row
  static constexpr int DR = kThreads * 8 / HDP;  // rows between a thread's chunks
  static constexpr int NCH = HDP / 16;           // chunks a thread copies
  int r0, col, goff, hd;
  uint32_t soff;
  bool col_ok, vec;
  __device__ __forceinline__ TileCopy(int tid, int hd_, bool vec_) : hd(hd_), vec(vec_) {
    r0 = ((tid >> 3) / CPR) * 8 + (tid & 7);
    col = ((tid >> 3) % CPR) * 8;
    goff = r0 * hd + col;
    soff = cm_offset(r0, col, HDP);
    col_ok = col < hd;
  }
  // Rows [first, first + BM) of `src`, of which n_rows exist, into `dst`.
  __device__ __forceinline__ void operator()(uint8_t* dst, const bf16* src, int first,
                                             int n_rows) const {
    const bf16* s = src + static_cast<size_t>(first) * hd;
    const int rows = n_rows - first;
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const int r = r0 + j * DR;
      const uint32_t off = soff + j * (DR / 8) * (HDP * 16);
      if (vec) {
        const bool ok = col_ok && r < rows;
        cp_async16(smem_addr(dst) + off, ok ? s + goff + j * DR * hd : s, ok ? 16 : 0);
      } else {
        __align__(16) bf16 v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = (r < rows && col + e < hd) ? s[static_cast<size_t>(r) * hd + col + e]
                                            : __float2bfloat16(0.0f);
        *reinterpret_cast<uint4*>(dst + off) = *reinterpret_cast<const uint4*>(v);
      }
    }
  }
};

// lse and (when D is not null) D of rows [r0, r0 + BM) into dst[0..BM) and
// dst[BM..2 BM); 0 past n_rows (those rows are masked).
__device__ __forceinline__ void stage_stats(float* dst, const float* lse, const float* D,
                                            int r0, int n_rows, int tid) {
  for (int i = tid; i < (D ? 2 : 1) * BM; i += kThreads) {
    const int row = r0 + (i & (BM - 1));
    const bool ok = row < n_rows;
    cp_async4(smem_addr(dst + i), (i < BM ? lse : D) + (ok ? row : 0), ok ? 4 : 0);
  }
}

// Blocks an SM should hold: the dQ blocks, with one accumulator, fit three.
template <bool kKV> constexpr int kMinBlocks = kKV ? 2 : 3;

// kKV: a dK/dV block, else a dQ block; kCap: softcap > 0 (the tanh and its
// derivative). Template arguments, so that each role keeps only its own
// registers and the common case carries no branch in its element loop.
template <int HDP, bool kCap, bool kKV>
__global__ void __launch_bounds__(kThreads, kMinBlocks<kKV>)
flash_bwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ o,
                    const bf16* __restrict__ dout, const float* __restrict__ lse,
                    float* __restrict__ D,
                    bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv, int S,
                    int Tk, int hd, float scale, int causal, int window, float softcap,
                    int vec) {
  constexpr int NO = HDP / 2;     // accumulator floats a thread of a 64 x HDP product
  constexpr int TB = tile_bytes<HDP>();
  constexpr int ST = kStages<HDP>;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* F0 = smem;
  uint8_t* F1 = smem + TB;
  uint8_t* ring = smem + 2 * TB;                                  // stage s: T0, T1
  float* stats = reinterpret_cast<float*>(ring + ST * 2 * TB);   // stage s: lse, D

  const int bh = blockIdx.y;
  constexpr bool kv = kKV;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const bf16* qb = q + static_cast<size_t>(bh) * S * hd;
  const bf16* ob = dout + static_cast<size_t>(bh) * S * hd;
  const bf16* kb = k + static_cast<size_t>(bh) * Tk * hd;
  const bf16* vb = v + static_cast<size_t>(bh) * Tk * hd;
  const float* lb = lse + static_cast<size_t>(bh) * S;
  float* Db = D + static_cast<size_t>(bh) * S;

  // The fixed tile's first row f0, and the streamed tiles [begin, end)
  // holding a pair some mask keeps.
  int f0, begin = 0, end;
  if (kv) {
    f0 = blockIdx.x * BM;
    end = (S + BM - 1) / BM;
    if (causal) begin = f0 / BM;                              // rows >= the first key
    if (window > 0) end = min(end, (f0 + BM + window - 2) / BM + 1);
  } else {
    f0 = (gridDim.x - 1 - blockIdx.x) * BM;
    end = (Tk + BM - 1) / BM;
    if (causal) end = min(end, (f0 + BM - 1) / BM + 1);       // keys <= the last row
    if (window > 0) begin = max(0, f0 - window + 1) / BM;
  }
  const bf16* fa = kv ? kb : qb;       // fixed: K, V or Q, dO
  const bf16* fb = kv ? vb : ob;
  const bf16* sa = kv ? qb : kb;       // streamed: Q, dO or K, V
  const bf16* sb = kv ? ob : vb;
  const int f_rows = kv ? Tk : S, s_rows = kv ? S : Tk;

  // Streamed tile `it` into ring stage `st`, with its rows' lse and D in
  // the dK/dV blocks.
  const TileCopy<HDP> copy(tid, hd, vec);
  auto stage_streamed = [&](int it, int st) {
    copy(ring + st * 2 * TB, sa, it * BM, s_rows);
    copy(ring + st * 2 * TB + TB, sb, it * BM, s_rows);
    if (kv) stage_stats(stats + st * 2 * BM, lb, Db, it * BM, S, tid);
  };
  // The fixed tiles (and in the dQ blocks their rows' lse and D, kept in
  // stage 0's statistics, which only the dK/dV blocks stream) with the
  // first streamed tile, then the next ST - 2, a copy group each.
  copy(F0, fa, f0, f_rows);
  copy(F1, fb, f0, f_rows);
  if (!kv) stage_stats(stats, lb, nullptr, f0, S, tid);
  for (int j = 0; j < ST - 1; ++j) {
    if (begin + j < end) stage_streamed(begin + j, j);
    cp_async_commit();
  }

  float acc0[NO], acc1[kKV ? NO : 1];   // dK and dV, or dQ in acc0
#pragma unroll
  for (int i = 0; i < NO; ++i) acc0[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < (kKV ? NO : 1); ++i) acc1[i] = 0.0f;
  const uint32_t f0_base = smem_addr(F0), f1_base = smem_addr(F1);
  // This thread's fixed rows (accumulator rows g and g + 8 of its warp).
  const int row0 = f0 + warp * 16 + g, row1 = row0 + 8;
  float l_row[2] = {0.0f, 0.0f}, d_row[2] = {0.0f, 0.0f};   // dQ blocks: lse, D of row0, row1

  if constexpr (!kKV) {
    // D of this block's rows, for itself (stage 0's statistics) and for
    // the dK/dV blocks (device memory, which they read after this launch):
    // two threads a row, each summing alternate 8-column chunks, then the
    // two sums.
    const int r = tid >> 1, half = tid & 1, row = f0 + r;
    float dsum = 0.0f;
    if (row < S) {
      const bf16* a = o + (static_cast<size_t>(bh) * S + row) * hd;
      const bf16* b = dout + (static_cast<size_t>(bh) * S + row) * hd;
      for (int d = 8 * half; d < hd; d += 16) {
        if (vec) {
          const uint4 av = *reinterpret_cast<const uint4*>(a + d);
          const uint4 bv = *reinterpret_cast<const uint4*>(b + d);
          const __nv_bfloat162* ap = reinterpret_cast<const __nv_bfloat162*>(&av);
          const __nv_bfloat162* bp = reinterpret_cast<const __nv_bfloat162*>(&bv);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 x = __bfloat1622float2(ap[e]), y = __bfloat1622float2(bp[e]);
            dsum = fmaf(x.x, y.x, dsum);
            dsum = fmaf(x.y, y.y, dsum);
          }
        } else {
          for (int e = d; e < min(d + 8, hd); ++e)
            dsum = fmaf(__bfloat162float(a[e]), __bfloat162float(b[e]), dsum);
        }
      }
    }
    dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
    if (half == 0) {
      stats[BM + r] = dsum;
      if (row < S) Db[row] = dsum;
    }
  }

  for (int it = begin, st = 0; it < end; ++it, st = st == ST - 1 ? 0 : st + 1) {
    // Tile `it` is in once the ST - 2 groups after it are all that is in
    // flight; after the barrier every thread is done with the stage the
    // previous tile used, which tile it + ST - 1 then fills.
    cp_async_wait<ST - 2>();
    fence_proxy_async();
    __syncthreads();
    if (it + ST - 1 < end) stage_streamed(it + ST - 1, st == 0 ? ST - 1 : st - 1);
    cp_async_commit();   // (empty past the last tile, so the count above holds)
    if (!kv && it == begin) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l_row[h] = stats[warp * 16 + g + 8 * h];
        d_row[h] = stats[BM + warp * 16 + g + 8 * h];
      }
    }
    const uint32_t t0_base = smem_addr(ring + st * 2 * TB), t1_base = t0_base + TB;
    const float* sst = stats + st * 2 * BM;   // dK/dV blocks: this tile's lse, D

    // S (or S^T) and dP (or dP^T): fixed rows against streamed rows.
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk)
      wgmma_ss_m64n64k16(s, smem_desc(f0_base + kk * 256, 128, HDP * 16),
                         smem_desc(t0_base + kk * 256, 128, HDP * 16), kk > 0);
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk)
      wgmma_ss_m64n64k16(dp, smem_desc(f1_base + kk * 256, 128, HDP * 16),
                         smem_desc(t1_base + kk * 256, 128, HDP * 16), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();

    // Element 4j + e: fixed row (e < 2 ? row0 : row1), streamed row c0 +
    // 8j + 2t + (e & 1). P into s, dS into dp.
    const int c0 = it * BM;
    const int qlo = kv ? c0 : f0, klo = kv ? f0 : c0;
    const bool full = qlo + BM <= S && klo + BM <= Tk && (!causal || qlo >= klo + BM - 1) &&
                      (window <= 0 || qlo + BM - 1 - klo < window);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // dK/dV blocks: lse and D of the streamed columns 8j + 2t (+1).
      const float2 lc = *reinterpret_cast<const float2*>(sst + 8 * j + 2 * t);
      const float2 dc = *reinterpret_cast<const float2*>(sst + BM + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * j + e] * scale, deriv = 1.0f;
        if (kCap) {
          const float tc = softcap * tanhf(x / softcap);
          const float u = tc / softcap;
          deriv = 1.0f - u * u;
          x = tc;
        }
        bool ok = true;
        if (!full) {
          const int fr = e < 2 ? row0 : row1, sc = c0 + 8 * j + 2 * t + (e & 1);
          const int qi = kv ? sc : fr, kj = kv ? fr : sc;
          ok = qi < S && kj < Tk;
          if (causal) ok = ok && qi >= kj;
          if (window > 0) ok = ok && qi - kj < window;
        }
        const float l = kv ? (e & 1 ? lc.y : lc.x) : l_row[e >> 1];
        const float dd = kv ? (e & 1 ? dc.y : dc.x) : d_row[e >> 1];
        const float p = ok ? __expf(x - l) : 0.0f;
        s[4 * j + e] = p;
        dp[4 * j + e] = kCap ? p * (dp[4 * j + e] - dd) * deriv : p * (dp[4 * j + e] - dd);
      }
    }
    // P and dS as A operands: streamed rows 16kk.. are the n8 blocks 2kk
    // and 2kk + 1 of the accumulator.
    uint32_t da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      da[kk][0] = pack_bf16(dp[8 * kk], dp[8 * kk + 1]);
      da[kk][1] = pack_bf16(dp[8 * kk + 2], dp[8 * kk + 3]);
      da[kk][2] = pack_bf16(dp[8 * kk + 4], dp[8 * kk + 5]);
      da[kk][3] = pack_bf16(dp[8 * kk + 6], dp[8 * kk + 7]);
    }
    if constexpr (kKV) {
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
      for (int kk = 0; kk < 4; ++kk)   // dV += P^T dO
        wgmma_rs_tb<HDP>(acc1, pa[kk], smem_desc(t1_base + kk * 2 * HDP * 16, HDP * 16, 128), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)   // dK += dS^T Q
        wgmma_rs_tb<HDP>(acc0, da[kk], smem_desc(t0_base + kk * 2 * HDP * 16, HDP * 16, 128), 1);
      wgmma_commit();
      wgmma_wait<0>();
    } else {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)   // dQ += dS K
        wgmma_rs_tb<HDP>(acc0, da[kk], smem_desc(t0_base + kk * 2 * HDP * 16, HDP * 16, 128), 1);
      wgmma_commit();
      wgmma_wait<0>();
    }
  }

  // The outputs as bfloat16 through shared memory (the ring, free once
  // every thread is past its last tile), then whole rows to device memory.
  // Accumulator element 4j + e: row (e < 2 ? row0 : row1) - f0, column 8j
  // + 2t + (e & 1).
  constexpr int LDO = HDP + 8;
  bf16* out_s = reinterpret_cast<bf16*>(ring);   // [2][BM][LDO]
  cp_async_wait<0>();   // (a block with no tile still has its first copies)
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NO / 4; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + g + 8 * h, col = j * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(out_s + r * LDO + col) =
          pack_bf16(acc0[4 * j + 2 * h] * scale, acc0[4 * j + 2 * h + 1] * scale);
      if constexpr (kKV)
        *reinterpret_cast<uint32_t*>(out_s + (BM + r) * LDO + col) =
            pack_bf16(acc1[4 * j + 2 * h], acc1[4 * j + 2 * h + 1]);
    }
  }
  __syncthreads();
  const size_t off = static_cast<size_t>(bh) * f_rows * hd;
  for (int which = 0; which < (kv ? 2 : 1); ++which) {
    bf16* dst = (kv ? (which ? dv : dk) : dq) + off;
    const bf16* src = out_s + which * BM * LDO;
    for (int i = tid; i < BM * (HDP / 8); i += kThreads) {
      const int r = i / (HDP / 8), col = (i % (HDP / 8)) * 8;
      if (f0 + r >= f_rows || col >= hd) continue;
      bf16* d = dst + static_cast<size_t>(f0 + r) * hd + col;
      if (vec) {
        *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(src + r * LDO + col);
      } else {
        for (int e = 0; e < 8 && col + e < hd; ++e) d[e] = src[r * LDO + col + e];
      }
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// One role's blocks: n_f fixed tiles (keys or queries) of each of the BH rows.
template <int HDP, bool kCap, bool kKV>
int launch_role(const bf16* q, const bf16* k, const bf16* v, const bf16* o, const bf16* dout,
                const float* lse, float* D, bf16* dq, bf16* dk, bf16* dv, int BH, int S, int Tk, int hd,
                float scale, int causal, int window, float softcap, int vec, int n_f,
                cudaStream_t stream) {
  constexpr int bytes = smem_bytes<HDP>();
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_tc_kernel<HDP, kCap, kKV>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  // All of the SM's unified memory as shared memory, so kMinBlocks blocks fit.
  e = cudaFuncSetAttribute(flash_bwd_tc_kernel<HDP, kCap, kKV>,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_tc_kernel<HDP, kCap, kKV><<<dim3(n_f, BH), kThreads, bytes, stream>>>(
      q, k, v, o, dout, lse, D, dq, dk, dv, S, Tk, hd, scale, causal, window, softcap, vec);
  return static_cast<int>(cudaGetLastError());
}

// The dQ blocks (which also write D), then the dK/dV blocks.
template <int HDP, bool kCap>
int launch_main(const bf16* q, const bf16* k, const bf16* v, const bf16* o, const bf16* dout,
                const float* lse, float* D, bf16* dq, bf16* dk, bf16* dv, int BH, int S, int Tk,
                int hd, float scale, int causal, int window, float softcap, int vec, int n_kt,
                int n_qt, cudaStream_t stream) {
  const int rc = launch_role<HDP, kCap, false>(q, k, v, o, dout, lse, D, dq, dk, dv, BH, S, Tk,
                                               hd, scale, causal, window, softcap, vec, n_qt,
                                               stream);
  if (rc != 0) return rc;
  return launch_role<HDP, kCap, true>(q, k, v, o, dout, lse, D, dq, dk, dv, BH, S, Tk, hd,
                                      scale, causal, window, softcap, vec, n_kt, stream);
}

template <int HDP>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o, const bf16* dout,
           const float* lse, float* D, bf16* dq, bf16* dk, bf16* dv, int BH, int S, int Tk,
           int hd, float scale, int causal, int window, float softcap, int vec,
           cudaStream_t stream) {
  const int n_kt = (Tk + BM - 1) / BM, n_qt = (S + BM - 1) / BM;
  return softcap > 0.0f
             ? launch_main<HDP, true>(q, k, v, o, dout, lse, D, dq, dk, dv, BH, S, Tk, hd,
                                      scale, causal, window, softcap, vec, n_kt, n_qt, stream)
             : launch_main<HDP, false>(q, k, v, o, dout, lse, D, dq, dk, dv, BH, S, Tk, hd,
                                       scale, causal, window, softcap, vec, n_kt, n_qt, stream);
}

}  // namespace

// q, o, dout (BH, S, hd) and k, v (BH, T, hd), all contiguous bfloat16, 1 <=
// hd <= 128; lse (BH, S) float32 from the forward; D (BH, S) float32
// scratch (written by the dQ kernel, read by the dK/dV kernel); dq (BH, S,
// hd), dk and dv (BH, T, hd) bfloat16. Launches the two kernels on `stream`
// and returns cudaGetLastError() (cudaErrorInvalidValue for what the
// kernels do not take).
extern "C" int flash_attention_bwd_tc_launch(const void* q, const void* k, const void* v,
                                             const void* o, const void* dout, const float* lse,
                                             float* D, void* dq, void* dk, void* dv, int BH,
                                             int S, int Tk, int hd, float scale, int causal,
                                             int window, float softcap, void* stream) {
  if (hd < 1 || hd > 128 || Tk < 1 || BH > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (BH <= 0 || S <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = hd % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o) &&
                  aligned16(dout) && aligned16(dq) && aligned16(dk) && aligned16(dv);
#define FLASH_BWD_TC(HDP)                                                                  \
  launch<HDP>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),                    \
              static_cast<const bf16*>(v), static_cast<const bf16*>(o),                    \
              static_cast<const bf16*>(dout), lse, D, static_cast<bf16*>(dq),              \
              static_cast<bf16*>(dk), static_cast<bf16*>(dv), BH, S, Tk, hd, scale, causal, \
              window, softcap, vec, s)
  if (hd <= 16) return FLASH_BWD_TC(16);
  if (hd <= 32) return FLASH_BWD_TC(32);
  if (hd <= 64) return FLASH_BWD_TC(64);
  return FLASH_BWD_TC(128);
#undef FLASH_BWD_TC
}
