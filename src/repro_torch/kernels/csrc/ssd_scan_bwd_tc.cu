// ssd_scan_bwd, bfloat16 route: the gradient of the Mamba2 SSD scan (dx,
// ddt, dA, dB, dC) in its chunked form on Hopper's tensor cores
// (mma.sync). The float32 route stays on the recurrence in ssd_scan_bwd.cu.
//
// Replaces no TPU kernel: the JAX package has no backward kernel, and its
// training path differentiates the jnp chunked form. It is the gradient of
// src/repro/kernels/ssd_scan.py::ssd_scan (pallas_call at :72) as jax.grad
// of repro.kernels.ref.ssd_ref gives it, for bfloat16 xh, dy (BH, S, P) and
// Bm, Cm (R, S, N), R = BH / H (row bh reads B/C row bh / H), dt (BH, S)
// and A (BH,) float32. N is 16, 32, 64 or 128 and P at most 64.
//
// The math, per scan row and chunk of Q = 64 steps (the forward's chunk,
// ssd_scan_tc.cu; the last chunk padded with dt = 0 and x = B = C = dy =
// 0), with seg = cumsum(dt A) inside the chunk, total = seg[Q - 1], e_i =
// exp(seg_i), ex_j = exp(total - seg_j), w_j = dt_j ex_j, L_ij = exp(seg_i
// - seg_j) for i >= j (else 0), H_c the state entering chunk c (H_0 = 0)
// and G_{c+1} the gradient of the state leaving it (G after the last chunk
// is 0):
//   H_{c+1} = exp(total) H_c + B^T diag(w) X,
//   G_c     = exp(total) G_{c+1} + C^T diag(e) dY            (N x P),
//   Mx = (dY X^T) o L o dt_j,   Lc = (C B^T) o L             (Q x Q),
//   U  = Lc^T dY + diag(ex) B G_{c+1},   dx = diag(dt) U     (Q x P),
//   dC = Mx B + diag(e) dY H_c^T,   dB = Mx^T C + diag(w) X G_{c+1}^T,
// and for the log-decay a_t = dt_t A, whose gradient Q_t gives ddt_t = v_t
// + A Q_t (v_t = x_t . U_t, the gradient through x dt) and dA = sum_t dt_t
// Q_t. Q_t sums the pairs (i >= t, j < t) of y's terms, dy_i . (C_i . B_j)
// exp(seg_i - seg_j) dt_j x_j over the whole sequence, as the chunk splits
// them:
//   Q_t = sum_{k >= t} (rowsum_k - colsum_k)            (i, j in the chunk)
//       + sum_{k >= t} e_k C_k . (H_c dy_k)             (j in earlier chunks)
//       + sum_{j < t} w_j x_j . (G_{c+1}^T B_j)         (i in later chunks)
//       + exp(total) <G_{c+1}, H_c>                     (both outside),
// with R_ij = (dY X^T)_ij (C B^T)_ij L_ij dt_j in float32, rowsum_k =
// sum_j R_kj and colsum_k = sum_i R_ik. (ssd_scan_bwd.cu uses the global
// identity Q_t = sum_{k >= t} (dy_k . y_k - dt_k v_k) instead, a
// difference of two running sums over the whole row that cancels; with
// bfloat16 operands the cancellation would amplify their rounding, so this
// kernel sums only the pairs each Q_t holds, R in float32.)
//
// Design: three kernels.
//  1. States, one block per two heads that share a B/C row (one when H is
//     odd), eight warps a head: a forward walk over the chunks (H_{c+1} by
//     mma.sync, H in float32 registers, each H_c for c >= 1 written as
//     bfloat16), then a reverse walk (G_c, each G_{c+1} for c <= nC - 2
//     written as bfloat16). The only sequential passes: S / 64 - 1 steps
//     each (7 at mamba2-370m's training shape), the next three chunks' B
//     or C, x or dy and dt in flight through a four-stage ring (cp.async)
//     while one is computed. A warp holds 16 rows of a head's state, so
//     the A operand (B^T or C^T) is read once a row block; the states
//     leave through shared memory in whole 16-byte rows.
//  2. Chunks, one block of 16 warps per (chunk, B/C row, group of heads):
//     all chunks in parallel. The block stages the chunk's C and B and
//     computes C B^T once, then walks its group's heads in order (x, dy,
//     dt, H_c and G_{c+1} of the next head in flight through a two-stage
//     ring): every warp scans the chunk's log-decay itself; Mx and Lc
//     (bfloat16, in shared memory), U, dx (out through shared memory), dC,
//     dB and the pieces of Q_t on mma.sync m16n8k16 with ldmatrix; then one
//     warp scans Q_t for ddt and the chunk's share of dA. dB and dC of the
//     group's heads are summed in float32 registers, in head order, and
//     written once per group as float32.
//  3. Sums: dB and dC over the groups in order (bfloat16), dA over the
//     chunks in order. No atomics: two runs give the same bits.
// Groups: the largest divisor G of H with nC R G <= 132 blocks (one wave
// on an H100), else 1 (kernels/ssd_scan_bwd.py, head_groups; 2 at mamba2's
// training shape).
//
// Rounding: x, dy, B and C enter as they are; Mx, Lc, diag(w) X and diag(e)
// dY (the states' operands) and the states H and G are rounded to bfloat16
// as operands (the states are carried in float32 across chunks); C B^T, dY
// X^T, R and every product sum in float32; dx, dB and dC are rounded to
// bfloat16 once, at the end; ddt and dA are float32.
//
// Bound, at mamba2-370m's training shape (BH 256 = 8 x 32 heads, S 512, P
// 64, N 128, bf16): bytes. The function reads x, dy, B, C, dt, A and writes
// dx, dB, dC, ddt, dA once: 55.6 MB, 16.6 us at 3.35 TB/s. This design's
// products: 6.3 MFLOP a (head, chunk), 12.9 GFLOP, 13.0 us on the tensor
// cores. Its scratch: H and G states, BH (nC - 1) N P bf16 each (29.4 MB
// each, written once and read once: 117 MB of traffic), the groups' dB and
// dC (2 R G S N float32 = 8.4 MB at G = 2, written and read: 17 MB), and
// dA's BH nC floats: 134 MB in all, against the 268 MB of the CUDA-core
// design's per-row partials.
#include <cstdint>

#include "tc.cuh"

namespace {

constexpr int Q = 64;              // steps per chunk
constexpr int kThreads = 512;      // chunk kernel: 16 warps
constexpr int kWarps = kThreads / 32;
constexpr int WQ = kWarps / 4;     // its column groups: warp w = 4 qt + mi
constexpr int JW = Q / WQ;         // columns of Q and of P a warp holds
constexpr int JT = JW / 8;         // their n8 blocks
constexpr int PP = 64;             // P padded in the chunk kernel
constexpr int LDP = PP + 8;
constexpr int LDQ = Q + 8;
constexpr int kSumThreads = 256;

// Flags of the launch: which copies may move 16 bytes at a time.
constexpr int kVecBC = 1, kVecX = 2, kVecDX = 4;

using bf16 = __nv_bfloat16;
using namespace popt;

// 4 bytes global -> shared; src_bytes 0 writes a zero.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

// Up to 8 bf16 (n of them valid, the rest zero) into 16 bytes of shared
// memory: one cp.async (`vec`: n is 0 or 8 and src 16-byte aligned) or
// plain loads. `base` stands in for src when n is 0.
__device__ __forceinline__ void copy8(bf16* dst, const bf16* src, const bf16* base, int n,
                                      bool vec) {
  if (vec) {
    cp_async16(smem_addr(dst), n > 0 ? src : base, n > 0 ? 16 : 0);
    return;
  }
  uint4 v = make_uint4(0, 0, 0, 0);
  bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
  for (int k = 0; k < 8; ++k)
    if (k < n) e[k] = src[k];
  *reinterpret_cast<uint4*>(dst) = v;
}

// Fragments of mma.sync m16n8k16 (tc.cuh) by ldmatrix from row-major bf16
// tiles with `ld` elements a row (a multiple of 8).
// A (16 x 16 at rows m0, columns k0) of an [m][k] tile.
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* tile, int ld, int m0,
                                       int k0, int lane) {
  ldsm_x4(a, tile + (m0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * ld + k0 + 8 * (lane >> 4));
}
// A (16 x 16) of the transpose of a [k][m] tile.
__device__ __forceinline__ void frag_at(uint32_t (&a)[4], const bf16* tile, int ld, int m0,
                                        int k0, int lane) {
  ldsm_x4_t(a, tile + (k0 + (lane & 7) + 8 * (lane >> 4)) * ld + m0 + 8 * ((lane >> 3) & 1));
}
// B of two n8 blocks (k0..k0 + 15 x n0..n0 + 15): b[0], b[1] for columns
// n0.., b[2], b[3] for n0 + 8.., from a [k][n] tile.
__device__ __forceinline__ void frag_b(uint32_t (&b)[4], const bf16* tile, int ld, int k0,
                                       int n0, int lane) {
  ldsm_x4_t(b, tile + (k0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * ld + n0 + 8 * (lane >> 4));
}
// The same from an [n][k] tile (the transpose).
__device__ __forceinline__ void frag_bt(uint32_t (&b)[4], const bf16* tile, int ld, int k0,
                                        int n0, int lane) {
  ldsm_x4(b, tile + (n0 + (lane & 7) + 8 * (lane >> 4)) * ld + k0 + 8 * ((lane >> 3) & 1));
}

// The cumulative log-decay of one chunk, lane l holding steps 2l and 2l + 1
// (seg s0, s1) of dt (d0, d1); returns the chunk's total.
__device__ __forceinline__ float chunk_scan(float d0, float d1, float a_h, int lane, float& s0,
                                            float& s1) {
  const float a0 = d0 * a_h, a1 = d1 * a_h;
  float v = a0 + a1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  s0 = v - a1;
  s1 = v;
  return __shfl_sync(0xffffffffu, v, 31);
}

// ---------------------------------------------------------------- states

constexpr int PV = 64;             // P padded in the states kernel's x, dy and W tiles
constexpr int LDV = PV + 8;
constexpr int kStStages = 4;       // its ring: three chunks in flight while one is computed

template <int N, int HS>
struct StSmem {
  static constexpr int LDN = N + 8;
  static constexpr int kM = 0;                         // B or C [Q][LDN]
  static constexpr int kV = kM + Q * LDN * 2;          // x or dy [HS][Q][LDV]
  static constexpr int kDt = kV + HS * Q * LDV * 2;    // dt [HS][Q] float
  static constexpr int kStage = kDt + HS * Q * 4;
  static constexpr int kW = kStStages * kStage;        // W or E [HS][Q][LDV]
  static constexpr int kO = kW + HS * Q * LDV * 2;      // a state [HS][N][LDV]
  static constexpr int kBytes = kO + HS * N * LDV * 2;
};

// Chunk c's B or C rows (`m`, shared by the block's heads) and, for each of
// the HS heads from bh0, x or dy (`xv`) and dt into stage `st`.
template <int N, int HS>
__device__ __forceinline__ void stage_states(uint8_t* st, const bf16* m, const bf16* xv,
                                             const float* dt, int bh0, int c, int S, int P,
                                             int flags, int tid) {
  using L = StSmem<N, HS>;
  constexpr int LDN = L::LDN, T = 256 * HS;
  bf16* Ms = reinterpret_cast<bf16*>(st + L::kM);
  bf16* Vs = reinterpret_cast<bf16*>(st + L::kV);
  float* Ds = reinterpret_cast<float*>(st + L::kDt);
  const int t0 = c * Q, nt = min(Q, S - t0);
  for (int i = tid; i < Q * N / 8; i += T) {
    const int t = i / (N / 8), n = (i % (N / 8)) * 8;
    copy8(Ms + t * LDN + n, m + (static_cast<size_t>(t0 + t)) * N + n, m, t < nt ? 8 : 0,
          flags & kVecBC);
  }
  for (int i = tid; i < HS * Q * PV / 8; i += T) {
    const int h = i / (Q * PV / 8), rest = i % (Q * PV / 8);
    const int t = rest / (PV / 8), p = (rest % (PV / 8)) * 8;
    const int ok = t < nt ? max(0, min(8, P - p)) : 0;
    copy8(Vs + (h * Q + t) * LDV + p,
          xv + (static_cast<size_t>(bh0 + h) * S + t0 + t) * P + p, xv, ok, flags & kVecX);
  }
  for (int i = tid; i < HS * Q; i += T) {
    const int h = i / Q, t = i % Q;
    cp_async4(smem_addr(Ds + i), dt + static_cast<size_t>(bh0 + h) * S + (t < nt ? t0 + t : 0),
              t < nt ? 4 : 0);
  }
}

// The chunk-entry states H_c (c >= 1) and the gradients G_{c+1} (c <= nC -
// 2) of HS heads that share a B/C row, written as bfloat16 (BH, nC - 1, N,
// PS) at Hst[bh][c - 1] and Gst[bh][c]. Eight warps a head: warp wi of head
// hw writes the W (or E) tile's columns 8 wi.. (its lanes holding steps 2
// lane, 2 lane + 1 of the chunk's scan), then holds the state's rows 16 mt..
// and the cg-th of CG column groups (mt = wi % MT, cg = wi / MT), so the
// A operand (B^T or C^T) is read once a row block and not once a column
// group.
template <int N, int HS>
__global__ void __launch_bounds__(256 * HS, 1)
ssd_bwd_states_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ A, const bf16* __restrict__ Bm,
                      const bf16* __restrict__ Cm, const bf16* __restrict__ dy,
                      bf16* __restrict__ Hst, bf16* __restrict__ Gst, int S, int P, int PS,
                      int H, int nC, int flags) {
  using L = StSmem<N, HS>;
  constexpr int LDN = L::LDN;
  constexpr int MT = N / 16;         // m16 row blocks of the state
  constexpr int CG = 8 / MT;         // column groups of a head
  constexpr int NTW = PV / 8 / CG;   // n8 blocks of a warp
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int hw = w >> 3, wi = w & 7, mt = wi % MT, cg = wi / MT;
  const int bh0 = blockIdx.x * HS, bh = bh0 + hw, r = bh0 / H;
  bf16* Ws = reinterpret_cast<bf16*>(smem + L::kW) + hw * Q * LDV;
  const float a_h = A[bh];
  const bf16* Bb = Bm + static_cast<size_t>(r) * S * N;
  const bf16* Cb = Cm + static_cast<size_t>(r) * S * N;
  const size_t plane = static_cast<size_t>(N) * PS;
  const int p0 = cg * (PV / CG);   // this warp's first state column

  float st[NTW][4];
#pragma unroll
  for (int n = 0; n < NTW; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) st[n][e] = 0.0f;

  // st as bfloat16 into this head's staging tile (rows 16 mt + g (+8),
  // columns p0 + 8 n + 2 tq (+1)); after a block barrier, copy_out writes
  // the staged states of the block's heads to their planes at chunk index
  // k, in 16-byte pieces of whole rows.
  bf16* Os = reinterpret_cast<bf16*>(smem + L::kO);
  auto store = [&]() {
#pragma unroll
    for (int n = 0; n < NTW; ++n) {
      bf16* sp = Os + (hw * N + 16 * mt + g) * LDV + p0 + 8 * n + 2 * tq;
      *reinterpret_cast<uint32_t*>(sp) = pack_bf16(st[n][0], st[n][1]);
      *reinterpret_cast<uint32_t*>(sp + 8 * LDV) = pack_bf16(st[n][2], st[n][3]);
    }
  };
  auto copy_out = [&](bf16* base, int k) {
    for (int i = tid; i < HS * N * (PS / 8); i += 256 * HS) {
      const int h = i / (N * (PS / 8)), rest = i % (N * (PS / 8));
      const int n = rest / (PS / 8), p = (rest % (PS / 8)) * 8;
      bf16* d = base + (static_cast<size_t>(bh0 + h) * (nC - 1) + k) * plane +
                static_cast<size_t>(n) * PS + p;
      *reinterpret_cast<uint4*>(d) =
          *reinterpret_cast<const uint4*>(Os + (h * N + n) * LDV + p);
    }
  };
  // Ws rows 2 lane, 2 lane + 1, columns 8 wi..: this head's x or dy times
  // f0, f1.
  auto scale_rows = [&](const uint8_t* stg, float f0, float f1) {
    const bf16* Vs = reinterpret_cast<const bf16*>(stg + L::kV) + hw * Q * LDV;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = 2 * lane + h;
      const float f = h ? f1 : f0;
      const uint4 v = *reinterpret_cast<const uint4*>(Vs + t * LDV + 8 * wi);
      const bf16* e = reinterpret_cast<const bf16*>(&v);
      uint4 o;
      uint32_t* op = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        op[k] = pack_bf16(__bfloat162float(e[2 * k]) * f, __bfloat162float(e[2 * k + 1]) * f);
      *reinterpret_cast<uint4*>(Ws + t * LDV + 8 * wi) = o;
    }
  };
  // st = et st + M^T Ws (M = B or C of the stage, its rows as K).
  auto update = [&](const uint8_t* stg, float et) {
    const bf16* Ms = reinterpret_cast<const bf16*>(stg + L::kM);
#pragma unroll
    for (int n = 0; n < NTW; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] *= et;
#pragma unroll
    for (int k2 = 0; k2 < 2; ++k2) {
      uint32_t a0[4], a1[4];
      frag_at(a0, Ms, LDN, 16 * mt, 32 * k2, lane);
      frag_at(a1, Ms, LDN, 16 * mt, 32 * k2 + 16, lane);
#pragma unroll
      for (int n = 0; n < NTW; ++n) {
        uint32_t b[4];     // key slices 2 k2 (b[0], b[1]) and 2 k2 + 1 (b[2], b[3])
        ldsm_x4_t(b, Ws + (32 * k2 + lane) * LDV + p0 + 8 * n);
        mma_16816(st[n], a0, b[0], b[1]);
        mma_16816(st[n], a1, b[2], b[3]);
      }
    }
  };

  // One walk over nC - 1 chunks, chunk(j) the j-th, kStStages - 1 chunks'
  // copies in flight while one is computed; step(j, stage) computes one.
  const int nW = nC - 1;
  auto walk = [&](const bf16* m, const bf16* xv, auto chunk, auto step) {
    for (int j = 0; j < kStStages - 1 && j < nW; ++j) {
      stage_states<N, HS>(smem + j * L::kStage, m, xv, dt, bh0, chunk(j), S, P, flags, tid);
      cp_async_commit();
    }
    for (int j = 0; j < nW; ++j) {
      // Chunk j is in once at most the groups after it are pending.
      if (j + 2 < nW) cp_async_wait<kStStages - 2>();
      else if (j + 1 < nW) cp_async_wait<1>();
      else cp_async_wait<0>();
      __syncthreads();   // every reader of the stage chunk j + kStStages - 1 takes is done
      if (j + kStStages - 1 < nW) {
        stage_states<N, HS>(smem + ((j + kStStages - 1) % kStStages) * L::kStage, m, xv, dt,
                            bh0, chunk(j + kStStages - 1), S, P, flags, tid);
        cp_async_commit();
      }
      step(j, smem + (j % kStStages) * L::kStage);
    }
  };

  // Forward: H_{c+1} = exp(total) H_c + B^T diag(w) X, for c = 0..nC - 2.
  walk(Bb, x, [](int j) { return j; }, [&](int c, const uint8_t* stg) {
    const float* Ds = reinterpret_cast<const float*>(stg + L::kDt) + hw * Q;
    const float d0 = Ds[2 * lane], d1 = Ds[2 * lane + 1];
    float s0, s1;
    const float total = chunk_scan(d0, d1, a_h, lane, s0, s1);
    if (c > 0) store();
    scale_rows(stg, d0 * __expf(total - s0), d1 * __expf(total - s1));
    __syncthreads();   // the W tiles and the staged H_c are written
    if (c > 0) copy_out(Hst, c - 1);
    update(stg, __expf(total));
  });
  if (nC > 1) {
    __syncthreads();   // every copy of the staging tile is done
    store();
    __syncthreads();
    copy_out(Hst, nC - 2);
  }

  // Reverse: G_c = exp(total) G_{c+1} + C^T diag(e) dY, for c = nC - 1..1.
#pragma unroll
  for (int n = 0; n < NTW; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) st[n][e] = 0.0f;
  __syncthreads();     // every reader of the ring is done
  walk(Cb, dy, [nC](int j) { return nC - 1 - j; }, [&](int j, const uint8_t* stg) {
    const int c = nC - 1 - j;
    const float* Ds = reinterpret_cast<const float*>(stg + L::kDt) + hw * Q;
    float s0, s1;
    const float total = chunk_scan(Ds[2 * lane], Ds[2 * lane + 1], a_h, lane, s0, s1);
    if (c < nC - 1) store();
    scale_rows(stg, __expf(s0), __expf(s1));
    __syncthreads();
    if (c < nC - 1) copy_out(Gst, c);
    update(stg, __expf(total));
  });
  if (nC > 1) {
    __syncthreads();
    store();
    __syncthreads();
    copy_out(Gst, 0);
  }
}

// ---------------------------------------------------------------- chunks

template <int N>
struct ChSmem {
  static constexpr int LDN = N + 8;
  static constexpr int kC = 0;                     // C [Q][LDN]
  static constexpr int kB = kC + Q * LDN * 2;      // B [Q][LDN]
  static constexpr int kMx = kB + Q * LDN * 2;     // Mx [Q][LDQ]
  static constexpr int kLc = kMx + Q * LDQ * 2;    // Lc [Q][LDQ]
  static constexpr int kDX = kLc + Q * LDQ * 2;    // dx [Q][LDP]
  // Floats: by column group, the row sums of R, v, the G part of v and the
  // H part of r [4][WQ][Q]; by row block the column sums of R [4][Q];
  // <G, H> partials [kWarps].
  static constexpr int kF = kDX + Q * LDP * 2;
  static constexpr int kRing = kF + ((4 * WQ + 4) * Q + kWarps) * 4;
  // One stage of the ring: one head's inputs.
  static constexpr int sX = 0;                     // x [Q][LDP]
  static constexpr int sY = sX + Q * LDP * 2;      // dy [Q][LDP]
  static constexpr int sH = sY + Q * LDP * 2;      // H_c [N][LDP]
  static constexpr int sG = sH + N * LDP * 2;      // G_{c+1} [N][LDP]
  static constexpr int sDt = sG + N * LDP * 2;     // dt [Q] float
  static constexpr int kStage = sDt + Q * 4;
  static constexpr int kBytes = kRing + 2 * kStage;
};

// One head's x, dy, dt of chunk c and its H_c and G_{c+1} (zero where the
// state is 0) into stage `st`.
template <int N>
__device__ __forceinline__ void stage_head(uint8_t* st, const bf16* x, const bf16* dy,
                                           const float* dt, const bf16* Hst, const bf16* Gst,
                                           int bh, int c, int S, int P, int PS, int nC,
                                           int flags, int tid) {
  using L = ChSmem<N>;
  bf16* Xs = reinterpret_cast<bf16*>(st + L::sX);
  bf16* Ys = reinterpret_cast<bf16*>(st + L::sY);
  bf16* Hs = reinterpret_cast<bf16*>(st + L::sH);
  bf16* Gs = reinterpret_cast<bf16*>(st + L::sG);
  float* Ds = reinterpret_cast<float*>(st + L::sDt);
  const int t0 = c * Q, nt = min(Q, S - t0);
  const size_t row0 = (static_cast<size_t>(bh) * S + t0) * P;
  for (int i = tid; i < Q * PP / 8; i += kThreads) {
    const int t = i / (PP / 8), p = (i % (PP / 8)) * 8;
    const int ok = t < nt ? max(0, min(8, P - p)) : 0;
    const size_t off = row0 + static_cast<size_t>(t) * P + p;
    copy8(Xs + t * LDP + p, x + off, x, ok, flags & kVecX);
    copy8(Ys + t * LDP + p, dy + off, dy, ok, flags & kVecX);
  }
  const size_t plane = static_cast<size_t>(N) * PS;
  const bool has_h = c > 0, has_g = c < nC - 1;
  const bf16* hp = has_h ? Hst + (static_cast<size_t>(bh) * (nC - 1) + (c - 1)) * plane : Hst;
  const bf16* gp = has_g ? Gst + (static_cast<size_t>(bh) * (nC - 1) + c) * plane : Gst;
  for (int i = tid; i < N * PP / 8; i += kThreads) {
    const int n = i / (PP / 8), p = (i % (PP / 8)) * 8;
    const bool in = p < PS;
    const size_t off = static_cast<size_t>(n) * PS + p;
    cp_async16(smem_addr(Hs + n * LDP + p), has_h && in ? hp + off : Hst, has_h && in ? 16 : 0);
    cp_async16(smem_addr(Gs + n * LDP + p), has_g && in ? gp + off : Gst, has_g && in ? 16 : 0);
  }
  const float* db = dt + static_cast<size_t>(bh) * S;
  for (int t = tid; t < Q; t += kThreads)
    cp_async4(smem_addr(Ds + t), db + (t < nt ? t0 + t : 0), t < nt ? 4 : 0);
}

// One (chunk c, B/C row r, group of HPB heads): dx, ddt of its heads, its
// heads' dB and dC summed in order into part (2, R, G, S, N) float32, and
// each head's share of dA into dAp (BH, nC). Warp w = 4 qt + mi owns rows
// 16 mi.. of each product and the qt-th quarter of its columns.
template <int N>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_chunk_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const bf16* __restrict__ Bm,
                     const bf16* __restrict__ Cm, const bf16* __restrict__ dy,
                     const bf16* __restrict__ Hst, const bf16* __restrict__ Gst,
                     bf16* __restrict__ dx, float* __restrict__ ddt, float* __restrict__ dAp,
                     float* __restrict__ part, int S, int P, int PS, int H, int HPB, int nC,
                     int flags) {
  using L = ChSmem<N>;
  constexpr int LDN = L::LDN;
  constexpr int NW = N / WQ < 16 ? 16 : N / WQ;   // dB/dC columns of a warp
  constexpr int NT = NW / 8;                    // their n8 blocks
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* Cs = reinterpret_cast<bf16*>(smem + L::kC);
  bf16* Bs = reinterpret_cast<bf16*>(smem + L::kB);
  bf16* Mx = reinterpret_cast<bf16*>(smem + L::kMx);
  bf16* Lc = reinterpret_cast<bf16*>(smem + L::kLc);
  bf16* DX = reinterpret_cast<bf16*>(smem + L::kDX);
  float* f_row = reinterpret_cast<float*>(smem + L::kF);   // [WQ][Q] by column group
  float* f_col = f_row + WQ * Q;   // [4][Q] by row block
  float* f_v = f_col + 4 * Q;      // [WQ][Q]
  float* f_vg = f_v + WQ * Q;      // [WQ][Q]
  float* f_rh = f_vg + WQ * Q;     // [WQ][Q]
  float* f_gh = f_rh + WQ * Q;     // [kWarps]

  const int c = blockIdx.x, R = gridDim.y / (H / HPB);
  const int r = blockIdx.y / (H / HPB), grp = blockIdx.y % (H / HPB);
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int mi = w & 3, qt = w >> 2;   // warp tile: m16 rows 16 mi.., column group qt
  const int t0 = c * Q, nt = min(Q, S - t0);

  // C and B of this chunk, with the first head.
  {
    const size_t bc0 = (static_cast<size_t>(r) * S + t0) * N;
    for (int i = tid; i < Q * N / 8; i += kThreads) {
      const int t = i / (N / 8), n = (i % (N / 8)) * 8, ok = t < nt ? 8 : 0;
      const size_t off = bc0 + static_cast<size_t>(t) * N + n;
      copy8(Cs + t * LDN + n, Cm + off, Cm, ok, flags & kVecBC);
      copy8(Bs + t * LDN + n, Bm + off, Bm, ok, flags & kVecBC);
    }
  }
  const int bh0 = r * H + grp * HPB;
  stage_head<N>(smem + L::kRing, x, dy, dt, Hst, Gst, bh0, c, S, P, PS, nC, flags, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // C B^T of this warp's tile: rows 16 mi + g (+8), columns JW qt + 8 jt +
  // 2 tq (+1).
  float cb[JT][4];
#pragma unroll
  for (int jt = 0; jt < JT; ++jt)
#pragma unroll
    for (int e = 0; e < 4; ++e) cb[jt][e] = 0.0f;
#pragma unroll
  for (int kn = 0; kn < N / 16; ++kn) {
    uint32_t a[4];
    frag_a(a, Cs, LDN, 16 * mi, 16 * kn, lane);
#pragma unroll
    for (int jp = 0; jp < JT / 2; ++jp) {
      uint32_t b[4];
      frag_bt(b, Bs, LDN, 16 * kn, JW * qt + 16 * jp, lane);
      mma_16816(cb[2 * jp], a, b[0], b[1]);
      mma_16816(cb[2 * jp + 1], a, b[2], b[3]);
    }
  }

  // dC and dB of this warp's tile (rows 16 mi + g (+8), columns n0 + 8 n +
  // 2 tq (+1)), summed over the group's heads.
  float dc[NT][4], db[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dc[n][e] = db[n][e] = 0.0f;
  const int n0 = NW * qt;
  const bool nact = n0 < N;   // at small N some column groups have no columns
  const int i0 = 16 * mi + g, i1 = i0 + 8;
  const int j0 = JW * qt + 2 * tq;   // this thread's first column of Q and of P

  for (int hi = 0; hi < HPB; ++hi) {
    const int bh = bh0 + hi;
    uint8_t* stg = smem + L::kRing + (hi & 1) * L::kStage;
    if (hi > 0) {
      cp_async_wait<0>();
      __syncthreads();   // head hi is in; every reader of the other stage is done
    }
    if (hi + 1 < HPB) {
      stage_head<N>(smem + L::kRing + ((hi + 1) & 1) * L::kStage, x, dy, dt, Hst, Gst, bh + 1,
                    c, S, P, PS, nC, flags, tid);
      cp_async_commit();
    }
    const bf16* Xs = reinterpret_cast<const bf16*>(stg + L::sX);
    const bf16* Ys = reinterpret_cast<const bf16*>(stg + L::sY);
    const bf16* Hs = reinterpret_cast<const bf16*>(stg + L::sH);
    const bf16* Gs = reinterpret_cast<const bf16*>(stg + L::sG);
    const float* Ds = reinterpret_cast<const float*>(stg + L::sDt);
    const float a_h = A[bh];

    // This head's cumulative log-decay, scanned by every warp (lane l:
    // steps 2l, 2l + 1); seg_at(k) gives step k's to the whole warp.
    float s0, s1;
    const float total = chunk_scan(Ds[2 * lane], Ds[2 * lane + 1], a_h, lane, s0, s1);
    auto seg_at = [&](int k) {
      const float lo = __shfl_sync(0xffffffffu, s0, k >> 1);
      const float hi = __shfl_sync(0xffffffffu, s1, k >> 1);
      return k & 1 ? hi : lo;
    };
    // Rows i0, i1: seg, exp(seg), exp(total - seg).
    const float sg[2] = {seg_at(i0), seg_at(i1)};
    const float ei[2] = {__expf(sg[0]), __expf(sg[1])};
    const float exi[2] = {__expf(total - sg[0]), __expf(total - sg[1])};

    // dY X^T on this warp's tile; Mx, Lc and the sums of R.
    {
      float yx[JT][4];
#pragma unroll
      for (int jt = 0; jt < JT; ++jt)
#pragma unroll
        for (int e = 0; e < 4; ++e) yx[jt][e] = 0.0f;
#pragma unroll
      for (int kp = 0; kp < PP / 16; ++kp) {
        uint32_t a[4];
        frag_a(a, Ys, LDP, 16 * mi, 16 * kp, lane);
#pragma unroll
        for (int jp = 0; jp < JT / 2; ++jp) {
          uint32_t b[4];
          frag_bt(b, Xs, LDP, 16 * kp, JW * qt + 16 * jp, lane);
          mma_16816(yx[2 * jp], a, b[0], b[1]);
          mma_16816(yx[2 * jp + 1], a, b[2], b[3]);
        }
      }
      float rows[2] = {0.0f, 0.0f}, cols[JT][2];
#pragma unroll
      for (int jt = 0; jt < JT; ++jt) {
        cols[jt][0] = cols[jt][1] = 0.0f;
        float mx[4], lc[4];
        const float sgj[2] = {seg_at(j0 + 8 * jt), seg_at(j0 + 8 * jt + 1)};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e < 2 ? i0 : i1, j = j0 + 8 * jt + (e & 1);
          const float Lij = j <= i ? __expf(sg[e >> 1] - sgj[e & 1]) : 0.0f;
          mx[e] = yx[jt][e] * Lij * Ds[j];
          lc[e] = cb[jt][e] * Lij;
          const float Rij = mx[e] * cb[jt][e];
          rows[e >> 1] += Rij;
          cols[jt][e & 1] += Rij;
        }
        const int j = j0 + 8 * jt;
        *reinterpret_cast<uint32_t*>(Mx + i0 * LDQ + j) = pack_bf16(mx[0], mx[1]);
        *reinterpret_cast<uint32_t*>(Mx + i1 * LDQ + j) = pack_bf16(mx[2], mx[3]);
        *reinterpret_cast<uint32_t*>(Lc + i0 * LDQ + j) = pack_bf16(lc[0], lc[1]);
        *reinterpret_cast<uint32_t*>(Lc + i1 * LDQ + j) = pack_bf16(lc[2], lc[3]);
      }
      // Row sums over the quad (this group's JW columns), column sums over
      // the 8 row pairs of the warp (its 16 rows).
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        rows[h] += __shfl_xor_sync(0xffffffffu, rows[h], 1);
        rows[h] += __shfl_xor_sync(0xffffffffu, rows[h], 2);
      }
      if (tq == 0) {
        f_row[qt * Q + i0] = rows[0];
        f_row[qt * Q + i1] = rows[1];
      }
#pragma unroll
      for (int jt = 0; jt < JT; ++jt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float s = cols[jt][h];
          s += __shfl_xor_sync(0xffffffffu, s, 4);
          s += __shfl_xor_sync(0xffffffffu, s, 8);
          s += __shfl_xor_sync(0xffffffffu, s, 16);
          cols[jt][h] = s;
        }
      if (g == 0) {
#pragma unroll
        for (int jt = 0; jt < JT; ++jt) {
          f_col[mi * Q + j0 + 8 * jt] = cols[jt][0];
          f_col[mi * Q + j0 + 8 * jt + 1] = cols[jt][1];
        }
      }
    }
    __syncthreads();   // Mx and Lc are written

    // U = Lc^T dY + diag(ex) B G on this warp's tile (rows j = 16 mi + g
    // (+8), columns p = j0 + 8 pt (+1)); dx, v and v's G part.
    {
      float u1[JT][4], u2[JT][4];
#pragma unroll
      for (int pt = 0; pt < JT; ++pt)
#pragma unroll
        for (int e = 0; e < 4; ++e) u1[pt][e] = u2[pt][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk < mi) continue;   // Lc_ij = 0 for i < j
        uint32_t a[4];
        frag_at(a, Lc, LDQ, 16 * mi, 16 * kk, lane);
#pragma unroll
        for (int pp = 0; pp < JT / 2; ++pp) {
          uint32_t b[4];
          frag_b(b, Ys, LDP, 16 * kk, JW * qt + 16 * pp, lane);
          mma_16816(u1[2 * pp], a, b[0], b[1]);
          mma_16816(u1[2 * pp + 1], a, b[2], b[3]);
        }
      }
#pragma unroll
      for (int kn = 0; kn < N / 16; ++kn) {
        uint32_t a[4];
        frag_a(a, Bs, LDN, 16 * mi, 16 * kn, lane);
#pragma unroll
        for (int pp = 0; pp < JT / 2; ++pp) {
          uint32_t b[4];
          frag_b(b, Gs, LDP, 16 * kn, JW * qt + 16 * pp, lane);
          mma_16816(u2[2 * pp], a, b[0], b[1]);
          mma_16816(u2[2 * pp + 1], a, b[2], b[3]);
        }
      }
      const float* exj = exi;
      const float dtj[2] = {Ds[i0], Ds[i1]};
      float vs[2] = {0.0f, 0.0f}, vg[2] = {0.0f, 0.0f};
#pragma unroll
      for (int pt = 0; pt < JT; ++pt) {
        const int p = j0 + 8 * pt;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = h ? i1 : i0;
          const float2 xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(Xs + j * LDP + p));
          const float ua = u1[pt][2 * h] + exj[h] * u2[pt][2 * h];
          const float ub = u1[pt][2 * h + 1] + exj[h] * u2[pt][2 * h + 1];
          vs[h] += xv.x * ua + xv.y * ub;
          vg[h] += xv.x * u2[pt][2 * h] + xv.y * u2[pt][2 * h + 1];
          *reinterpret_cast<uint32_t*>(DX + j * LDP + p) = pack_bf16(dtj[h] * ua, dtj[h] * ub);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        vs[h] += __shfl_xor_sync(0xffffffffu, vs[h], 1);
        vs[h] += __shfl_xor_sync(0xffffffffu, vs[h], 2);
        vg[h] += __shfl_xor_sync(0xffffffffu, vg[h], 1);
        vg[h] += __shfl_xor_sync(0xffffffffu, vg[h], 2);
      }
      if (tq == 0) {
        f_v[qt * Q + i0] = vs[0];
        f_v[qt * Q + i1] = vs[1];
        f_vg[qt * Q + i0] = exj[0] * vg[0];
        f_vg[qt * Q + i1] = exj[1] * vg[1];
      }
    }

    // dC = Mx B + diag(e) dY H^T and dB = Mx^T C + diag(w) X G^T on this
    // warp's tile; the H part of r = C . dC; <G, H>.
    float rh[2] = {0.0f, 0.0f};
    if (nact) {
      float p1[NT][4], p2[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) p1[n][e] = p2[n][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk > mi) continue;   // Mx_ij = 0 for j > i
        uint32_t a[4];
        frag_a(a, Mx, LDQ, 16 * mi, 16 * kk, lane);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t b[4];
          frag_b(b, Bs, LDN, 16 * kk, n0 + 16 * np, lane);
          mma_16816(p1[2 * np], a, b[0], b[1]);
          mma_16816(p1[2 * np + 1], a, b[2], b[3]);
        }
      }
#pragma unroll
      for (int kp = 0; kp < PP / 16; ++kp) {
        uint32_t a[4];
        frag_a(a, Ys, LDP, 16 * mi, 16 * kp, lane);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t b[4];
          frag_bt(b, Hs, LDP, 16 * kp, n0 + 16 * np, lane);
          mma_16816(p2[2 * np], a, b[0], b[1]);
          mma_16816(p2[2 * np + 1], a, b[2], b[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, col = n0 + 8 * n + 2 * tq + (e & 1);
          const float cv = __bfloat162float(Cs[(h ? i1 : i0) * LDN + col]);
          rh[h] += cv * ei[h] * p2[n][e];
          dc[n][e] += p1[n][e] + ei[h] * p2[n][e];
        }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) p1[n][e] = p2[n][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk < mi) continue;   // Mx_ij = 0 for i < j
        uint32_t a[4];
        frag_at(a, Mx, LDQ, 16 * mi, 16 * kk, lane);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t b[4];
          frag_b(b, Cs, LDN, 16 * kk, n0 + 16 * np, lane);
          mma_16816(p1[2 * np], a, b[0], b[1]);
          mma_16816(p1[2 * np + 1], a, b[2], b[3]);
        }
      }
#pragma unroll
      for (int kp = 0; kp < PP / 16; ++kp) {
        uint32_t a[4];
        frag_a(a, Xs, LDP, 16 * mi, 16 * kp, lane);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t b[4];
          frag_bt(b, Gs, LDP, 16 * kp, n0 + 16 * np, lane);
          mma_16816(p2[2 * np], a, b[0], b[1]);
          mma_16816(p2[2 * np + 1], a, b[2], b[3]);
        }
      }
      const float wj[2] = {Ds[i0] * exi[0], Ds[i1] * exi[1]};
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) db[n][e] += p1[n][e] + wj[e >> 1] * p2[n][e];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rh[h] += __shfl_xor_sync(0xffffffffu, rh[h], 1);
      rh[h] += __shfl_xor_sync(0xffffffffu, rh[h], 2);
    }
    if (tq == 0) {
      f_rh[qt * Q + i0] = rh[0];
      f_rh[qt * Q + i1] = rh[1];
    }
    // <G_{c+1}, H_c>: warp w over rows n = w, w + kWarps, ...
    {
      float gh = 0.0f;
      for (int n = w; n < N; n += kWarps) {
        const float2 hv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(Hs + n * LDP + 2 * lane));
        const float2 gv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(Gs + n * LDP + 2 * lane));
        gh += hv.x * gv.x + hv.y * gv.y;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) gh += __shfl_xor_sync(0xffffffffu, gh, o);
      if (lane == 0) f_gh[w] = gh;
    }
    __syncthreads();   // the sums and dx are written

    // dx to device memory, whole rows in 16-byte pieces where they allow.
    {
      bf16* dxb = dx + (static_cast<size_t>(bh) * S + t0) * P;
      for (int i = tid; i < Q * (PP / 8); i += kThreads) {
        const int t = i / (PP / 8), p = (i % (PP / 8)) * 8;
        if (t >= nt || p >= P) continue;
        bf16* d = dxb + static_cast<size_t>(t) * P + p;
        if (flags & kVecDX) {
          *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(DX + t * LDP + p);
        } else {
          for (int e = 0; e < 8 && p + e < P; ++e) d[e] = DX[t * LDP + p + e];
        }
      }
    }

    // Q_t for ddt and the chunk's share of dA (warp 0; lane l: steps 2l,
    // 2l + 1), every sum in a fixed order.
    if (w == 0) {
      float av[2], bv[2], vv[2], dtv[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = 2 * lane + h;
        float rowsum = 0.0f, colsum = 0.0f, rin = 0.0f, vgs = 0.0f;
        vv[h] = 0.0f;
#pragma unroll
        for (int q = 0; q < WQ; ++q) {
          rowsum += f_row[q * Q + k];
          rin += f_rh[q * Q + k];
          vgs += f_vg[q * Q + k];
          vv[h] += f_v[q * Q + k];
        }
#pragma unroll
        for (int m = 0; m < 4; ++m) colsum += f_col[m * Q + k];
        dtv[h] = Ds[k];
        av[h] = (rowsum - colsum) + rin;
        bv[h] = dtv[h] * vgs;
      }
      float gh = 0.0f;
#pragma unroll
      for (int i = 0; i < kWarps; ++i) gh += f_gh[i];
      gh *= __expf(total);
      // Suffix sums of a (inclusive) and prefix sums of b (exclusive).
      float sa = av[0] + av[1], pb = bv[0] + bv[1];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_down_sync(0xffffffffu, sa, o);
        if (lane + o < 32) sa += u;
        const float z = __shfl_up_sync(0xffffffffu, pb, o);
        if (lane >= o) pb += z;
      }
      pb -= bv[0] + bv[1];
      const float q0 = sa + pb + gh, q1 = (sa - av[0]) + (pb + bv[0]) + gh;
      float* ddtb = ddt + static_cast<size_t>(bh) * S + t0;
      if (2 * lane < nt) ddtb[2 * lane] = vv[0] + a_h * q0;
      if (2 * lane + 1 < nt) ddtb[2 * lane + 1] = vv[1] + a_h * q1;
      float da = dtv[0] * q0 + dtv[1] * q1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) da += __shfl_xor_sync(0xffffffffu, da, o);
      if (lane == 0) dAp[static_cast<size_t>(bh) * nC + c] = da;
    }
  }

  // The group's dB and dC: part[0 or 1][r][grp][t0 + i][n].
  if (nact) {
    const size_t SN = static_cast<size_t>(S) * N;
    const size_t G = H / HPB;
    float* pb_ = part + (static_cast<size_t>(r) * G + grp) * SN + static_cast<size_t>(t0) * N;
    float* pc_ = pb_ + static_cast<size_t>(R) * G * SN;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = h ? i1 : i0, col = n0 + 8 * n + 2 * tq;
        if (i >= nt) continue;
        *reinterpret_cast<float2*>(pb_ + static_cast<size_t>(i) * N + col) =
            make_float2(db[n][2 * h], db[n][2 * h + 1]);
        *reinterpret_cast<float2*>(pc_ + static_cast<size_t>(i) * N + col) =
            make_float2(dc[n][2 * h], dc[n][2 * h + 1]);
      }
  }
}

// ---------------------------------------------------------------- sums

// dB, dC (R, S, N) bfloat16 = the sum over the G groups of part, in order
// (block row y: dB of B/C row y, or dC of row y - R), four elements a
// thread at a time; dA[bh] = the sum over the chunks of dAp[bh], in order
// (block row 0).
__global__ void __launch_bounds__(kSumThreads)
ssd_bwd_sum_kernel(const float* __restrict__ part, const float* __restrict__ dAp,
                   bf16* __restrict__ dB, bf16* __restrict__ dC, float* __restrict__ dA,
                   int row, int R, int G, int BH, int nC) {
  const int y = blockIdx.y, first = blockIdx.x * kSumThreads + threadIdx.x;
  const int stride = gridDim.x * kSumThreads;
  const float* src = part + static_cast<size_t>(y) * G * row;
  bf16* out = (y < R ? dB : dC) + static_cast<size_t>(y % R) * row;
  for (int e = 4 * first; e < row; e += 4 * stride) {
    float4 acc = *reinterpret_cast<const float4*>(src + e);
    for (int k = 1; k < G; ++k) {
      const float4 p = *reinterpret_cast<const float4*>(src + static_cast<size_t>(k) * row + e);
      acc.x += p.x;
      acc.y += p.y;
      acc.z += p.z;
      acc.w += p.w;
    }
    uint2 o;
    o.x = pack_bf16(acc.x, acc.y);
    o.y = pack_bf16(acc.z, acc.w);
    *reinterpret_cast<uint2*>(out + e) = o;
  }
  if (y == 0) {
    for (int i = first; i < BH; i += stride) {
      float sum = 0.0f;
      for (int k = 0; k < nC; ++k) sum += dAp[static_cast<size_t>(i) * nC + k];
      dA[i] = sum;
    }
  }
}

bool aligned(const void* p, uintptr_t n) { return (reinterpret_cast<uintptr_t>(p) % n) == 0; }

// The states kernel over HS heads a block (two when H is even).
template <int N, int HS>
int launch_states(const bf16* x, const float* dt, const float* A, const bf16* Bm,
                  const bf16* Cm, const bf16* dy, bf16* Hst, bf16* Gst, int BH, int S, int P,
                  int PS, int H, int nC, int flags, cudaStream_t s) {
  constexpr int bytes = StSmem<N, HS>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(ssd_bwd_states_kernel<N, HS>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_bwd_states_kernel<N, HS><<<BH / HS, 256 * HS, bytes, s>>>(x, dt, A, Bm, Cm, dy, Hst, Gst,
                                                                S, P, PS, H, nC, flags);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int launch(const bf16* x, const float* dt, const float* A, const bf16* Bm, const bf16* Cm,
           const bf16* dy, bf16* dx, float* ddt, float* dA, bf16* dBm, bf16* dCm, bf16* Hst,
           bf16* Gst, float* dAp, float* part, int BH, int S, int P, int H, int HPB,
           cudaStream_t s) {
  const int nC = (S + Q - 1) / Q, R = BH / H, G = H / HPB;
  const int PS = (P + 7) / 8 * 8;
  const int flags = (aligned(Bm, 16) && aligned(Cm, 16) ? kVecBC : 0)
                    | (P % 8 == 0 && aligned(x, 16) && aligned(dy, 16) ? kVecX : 0)
                    | (P % 8 == 0 && aligned(dx, 16) ? kVecDX : 0);
  cudaError_t e;
  if (nC > 1) {
    e = static_cast<cudaError_t>(
        H % 2 == 0 ? launch_states<N, 2>(x, dt, A, Bm, Cm, dy, Hst, Gst, BH, S, P, PS, H, nC,
                                         flags, s)
                   : launch_states<N, 1>(x, dt, A, Bm, Cm, dy, Hst, Gst, BH, S, P, PS, H, nC,
                                         flags, s));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  constexpr int cb = ChSmem<N>::kBytes;
  e = cudaFuncSetAttribute(ssd_bwd_chunk_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           cb);
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_bwd_chunk_kernel<N><<<dim3(nC, R * G), kThreads, cb, s>>>(
      x, dt, A, Bm, Cm, dy, Hst, Gst, dx, ddt, dAp, part, S, P, PS, H, HPB, nC, flags);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int row = S * N, want = (row / 4 + kSumThreads - 1) / kSumThreads;
  ssd_bwd_sum_kernel<<<dim3(want < 512 ? want : 512, 2 * R), kSumThreads, 0, s>>>(
      part, dAp, dBm, dCm, dA, row, R, G, BH, nC);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xh, dy (BH, S, P) and Bm, Cm (BH / H, S, N) bfloat16; dt (BH, S), A (BH,)
// float32. Writes dx (BH, S, P), dBm and dCm (BH / H, S, N) bfloat16, ddt
// (BH, S) and dA (BH,) float32, through the scratch Hst and Gst (BH, nC -
// 1, N, PS) bfloat16 (nC = ceil(S / 64), PS = P rounded up to 8; 16-byte
// aligned; unread when nC is 1), dAp (BH, nC) float32 and part (2, BH / H,
// H / HPB, S, N) float32. N is 16, 32, 64 or 128, 1 <= P <= 64, and HPB
// (heads a block walks) divides H. Launches three kernels on `stream` and
// returns cudaGetLastError() (cudaErrorInvalidValue for what they do not
// take).
extern "C" int ssd_scan_bwd_tc_launch(const void* xh, const float* dt, const float* A,
                                      const void* Bm, const void* Cm, const void* dy,
                                      void* dx, float* ddt, float* dA, void* dBm, void* dCm,
                                      void* Hst, void* Gst, float* dAp, float* part, int BH,
                                      int S, int P, int N, int H, int HPB, void* stream) {
  if (H < 1 || BH % H != 0 || HPB < 1 || H % HPB != 0 || P < 1 || P > 64 ||
      (S + Q - 1) / Q > 65535 || BH > 65535 || 2 * (BH / H) > 65535 ||
      static_cast<long long>(S) * N > (1LL << 30) ||
      !aligned(Hst, 16) || !aligned(Gst, 16) || !aligned(part, 16) || !aligned(dBm, 8) ||
      !aligned(dCm, 8))
    return static_cast<int>(cudaErrorInvalidValue);
  if (BH <= 0 || S <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SSD_BWD_TC(NN)                                                                      \
  launch<NN>(static_cast<const bf16*>(xh), dt, A, static_cast<const bf16*>(Bm),             \
             static_cast<const bf16*>(Cm), static_cast<const bf16*>(dy), static_cast<bf16*>(dx), \
             ddt, dA, static_cast<bf16*>(dBm), static_cast<bf16*>(dCm),                     \
             static_cast<bf16*>(Hst), static_cast<bf16*>(Gst), dAp, part, BH, S, P, H, HPB, s)
  switch (N) {
    case 16: return SSD_BWD_TC(16);
    case 32: return SSD_BWD_TC(32);
    case 64: return SSD_BWD_TC(64);
    case 128: return SSD_BWD_TC(128);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SSD_BWD_TC
}
