// ssd_scan, bfloat16 route: the Mamba2 SSD scan in its chunked form on
// Hopper's tensor cores (mma.sync). The float32 route stays on the
// recurrence in ssd_scan.cu.
//
// Replaces src/repro/kernels/ssd_scan.py::ssd_scan (pallas_call at :72) for
// bfloat16 xh (BH, S, P) and Bm, Cm (R, S, N), R = BH / H (row bh reads B/C
// row bh / H); dt (BH, S) and A (BH,) float32; y in bfloat16.
//
// The chunked form the Pallas kernel computes, per chunk of Q steps with
// seg = cumsum(dt * A) inside the chunk and total = seg[Q - 1]:
//   y     = (C B^T o L) (x dt) + diag(exp(seg)) C state,
//   L_ij  = exp(seg_i - seg_j) for i >= j, else 0 (masked before exp: above
//           the diagonal the exponent is positive and overflows),
//   state = exp(total) state + B^T ((x dt) o exp(total - seg)).
// The value does not depend on the chunk, so the kernel takes its own,
// Q = 64, whatever chunk the caller names (S need not be a multiple of it:
// the last chunk is padded with dt = 0 and x = B = C = 0). C B^T depends
// only on the batch row and the chunk, not on the head, so a first kernel
// computes it once per (B/C row, chunk) into float32 scratch
// (R * ceil(S / Q) * Q * Q floats, 2 MB at mamba2-370m's 4 x 2048) and the
// H heads of that row read it from L2.
//
// Rounding: the products take bfloat16 operands and sum in float32. x, B
// and C enter as they are; (C B^T o L) diag(dt), (x dt) o exp(total - seg)
// and the state as an operand of C state are rounded to bfloat16. The
// state itself is carried in float32 registers, and exp(seg) scales the
// float32 product C state.
//
// Bound, at mamba2-370m's prefill (BH 128, S 2048, P 64, N 128, bf16): the
// function moves 72 MB (x and y 33.5 MB each, B and C per batch row, dt):
// 21.6 us at 3.35 TB/s. The chunked form at Q 64, C B^T once per batch
// row, does 9.7 GFLOP: 9.8 us on the tensor cores. So bytes bound it.
//
// Grid. One pass per (bh, 64 columns of P) walks the chunks in order with
// the (N, P) state in registers, as the Pallas grid does: 128 blocks at
// mamba2's shape, one per SM. A multi-pass split (chunk states, state
// passing, outputs) would run chunks in parallel but write and read
// BH * (S / Q) * N * P float32 states: 134 MB at Q 64 (33.5 MB at Q 256),
// more than x and y together, against a one-pass cost of 32 chunk steps of
// a few microseconds. The one pass is kept, and its chunk steps are made
// short: a block has 8 warps, and the next chunk's C, B, x, C B^T and dt
// are copied into the other half of a two-stage ring (cp.async) while this
// chunk is computed, so no step waits on device memory. Operands load from
// the row-major tiles with ldmatrix (transposed where a product needs it),
// so nothing is transposed in shared memory. Per chunk: warp 0 scans dt A;
// every warp writes its columns of the previous state as bf16; then warp w
// computes output rows 16 (w % 4).. and columns 32 (w / 4).. (C state,
// scaled, plus the causal part of (C B^T o L dt) x, skipping key blocks
// above its rows) and state columns 8w..8w+7. Two block barriers a chunk.
#include <cstdint>

#include "tc.cuh"

namespace {

constexpr int Q = 64;          // steps per chunk
constexpr int PT = 64;         // columns of P per block
constexpr int kThreads = 256;  // 8 warps
constexpr int kCbThreads = 128;
constexpr int LDP = PT + 8;    // padded rows (conflict-free ldmatrix / fragments)
constexpr int LDF = Q + 8;

// Flags of the launch: which copies may move 16 bytes at a time.
constexpr int kVecBC = 1, kVecX = 2, kVecDt = 4, kPairY = 8;

using bf16 = __nv_bfloat16;
using namespace popt;

template <int N>
struct Smem {
  static constexpr int LDN = N + 8;
  // One stage of the ring: what a chunk step reads.
  static constexpr int kC = 0;                    // C [Q][LDN]
  static constexpr int kB = kC + Q * LDN * 2;     // B [Q][LDN]
  static constexpr int kX = kB + Q * LDN * 2;     // x [Q][LDP]
  static constexpr int kCB = kX + Q * LDP * 2;    // C B^T [Q][LDF] float
  static constexpr int kDt = kCB + Q * LDF * 4;   // dt [Q] float
  static constexpr int kStage = kDt + Q * 4;
  // Written each step.
  static constexpr int kXP = 2 * kStage;          // (x dt) exp(total - seg) [Q][LDP]
  static constexpr int kST = kXP + Q * LDP * 2;   // state [N][LDP]
  static constexpr int kF = kST + N * LDP * 2;    // seg, exp(seg), dt exp(total - seg)
  static constexpr int kBytes = kF + 3 * Q * 4;
};

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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

// C B^T for one (B/C row, chunk): cb[i][j] float32, rows i of warp w for
// key blocks j < 16w + 16 (the rest is above the diagonal and never read).
template <int N>
__global__ void __launch_bounds__(kCbThreads)
ssd_cb_kernel(const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
              float* __restrict__ cb, int S, int nC, int flags) {
  constexpr int LDN = N + 8;
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* Cs = reinterpret_cast<bf16*>(smem);
  bf16* Bs = Cs + Q * LDN;
  const int c = blockIdx.x, r = blockIdx.y, t0 = c * Q, nt = min(Q, S - t0);
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const size_t bc0 = (static_cast<size_t>(r) * S + t0) * N;
  for (int i = tid; i < Q * N / 8; i += kCbThreads) {
    const int tt = i / (N / 8), n = (i % (N / 8)) * 8, ok = tt < nt ? 8 : 0;
    const size_t off = bc0 + static_cast<size_t>(tt) * N + n;
    copy8(Cs + tt * LDN + n, Cm + off, Cm, ok, flags & kVecBC);
    copy8(Bs + tt * LDN + n, Bm + off, Bm, ok, flags & kVecBC);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  float acc[8][4];
#pragma unroll
  for (int jt = 0; jt < 8; ++jt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[jt][e] = 0.0f;
  const bf16* ca = Cs + (16 * w + g) * LDN + 2 * t;
#pragma unroll
  for (int kn = 0; kn < N / 16; ++kn) {
    const uint32_t a[4] = {ld32(ca + 16 * kn), ld32(ca + 8 * LDN + 16 * kn),
                           ld32(ca + 16 * kn + 8), ld32(ca + 8 * LDN + 16 * kn + 8)};
#pragma unroll
    for (int jt = 0; jt < 8; ++jt) {
      if (jt > 2 * w + 1) continue;
      const bf16* bb = Bs + (8 * jt + g) * LDN + 16 * kn + 2 * t;
      mma_16816(acc[jt], a, ld32(bb), ld32(bb + 8));
    }
  }
  float* out = cb + (static_cast<size_t>(r) * nC + c) * Q * Q;
#pragma unroll
  for (int jt = 0; jt < 8; ++jt) {
    if (jt > 2 * w + 1) continue;
    const int i = 16 * w + g, j = 8 * jt + 2 * t;
    *reinterpret_cast<float2*>(out + i * Q + j) = make_float2(acc[jt][0], acc[jt][1]);
    *reinterpret_cast<float2*>(out + (i + 8) * Q + j) = make_float2(acc[jt][2], acc[jt][3]);
  }
}

// Start the copies of chunk c into ring stage `st` (cp.async where the
// flags allow, plain loads otherwise).
template <int N>
__device__ __forceinline__ void stage_chunk(uint8_t* st, const bf16* x, const float* dtb,
                                            const bf16* Bm, const bf16* Cm, const float* cb,
                                            int c, int S, int P, int p0, int r, int nC,
                                            int flags, int tid) {
  using L = Smem<N>;
  constexpr int LDN = L::LDN;
  bf16* Cs = reinterpret_cast<bf16*>(st + L::kC);
  bf16* Bs = reinterpret_cast<bf16*>(st + L::kB);
  bf16* Xs = reinterpret_cast<bf16*>(st + L::kX);
  float* CBs = reinterpret_cast<float*>(st + L::kCB);
  float* Ds = reinterpret_cast<float*>(st + L::kDt);
  const int t0 = c * Q, nt = min(Q, S - t0);
  const size_t bc0 = (static_cast<size_t>(r) * S + t0) * N;
  for (int i = tid; i < Q * N / 8; i += kThreads) {
    const int t = i / (N / 8), n = (i % (N / 8)) * 8, ok = t < nt ? 8 : 0;
    const size_t off = bc0 + static_cast<size_t>(t) * N + n;
    copy8(Cs + t * LDN + n, Cm + off, Cm, ok, flags & kVecBC);
    copy8(Bs + t * LDN + n, Bm + off, Bm, ok, flags & kVecBC);
  }
  for (int i = tid; i < Q * PT / 8; i += kThreads) {
    const int t = i / (PT / 8), p = (i % (PT / 8)) * 8;
    const int ok = t < nt ? max(0, min(8, P - p0 - p)) : 0;
    copy8(Xs + t * LDP + p, x + static_cast<size_t>(t0 + t) * P + p0 + p, x, ok,
          flags & kVecX);
  }
  const float* cbc = cb + (static_cast<size_t>(r) * nC + c) * Q * Q;
  for (int i = tid; i < Q * Q / 4; i += kThreads) {
    const int row = i / (Q / 4), col = (i % (Q / 4)) * 4;
    cp_async16(smem_addr(CBs + row * LDF + col), cbc + row * Q + col, 16);
  }
  if (flags & kVecDt) {
    for (int i = tid; i < Q / 4; i += kThreads) {
      const int n = max(0, min(4, nt - 4 * i));
      cp_async16(smem_addr(Ds + 4 * i), n > 0 ? dtb + t0 + 4 * i : dtb, 4 * n);
    }
  } else {
    for (int t = tid; t < Q; t += kThreads) Ds[t] = t < nt ? dtb[t0 + t] : 0.0f;
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads, 1)
ssd_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ A, const bf16* __restrict__ Bm,
              const bf16* __restrict__ Cm, const float* __restrict__ cb,
              bf16* __restrict__ y, int S, int P, int H, int nC, int flags) {
  using L = Smem<N>;
  constexpr int LDN = L::LDN;
  constexpr int MT = N / 16;      // m16 tiles of the state's N rows
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* XP = reinterpret_cast<bf16*>(smem + L::kXP);
  bf16* ST = reinterpret_cast<bf16*>(smem + L::kST);
  float* s_seg = reinterpret_cast<float*>(smem + L::kF);
  float* s_eseg = s_seg + Q;
  float* s_w = s_eseg + Q;

  const int bh = blockIdx.y, p0 = blockIdx.x * PT, r = bh / H;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int rw = w & 3, ph = w >> 2;       // output rows 16 rw.., columns 32 ph..
  const int i0 = 16 * rw + g;              // this thread's rows i0 and i0 + 8
  const int lr = (lane & 7) + 8 * ((lane >> 3) & 1), lc = 8 * (lane >> 4);  // ldmatrix
  const float a_h = A[bh];
  const float* dtb = dt + static_cast<size_t>(bh) * S;
  const bf16* xb = x + static_cast<size_t>(bh) * S * P;
  bf16* yb = y + static_cast<size_t>(bh) * S * P;

  // State rows n = 16 mt + g (+8), columns p = 8w + 2tq (+1).
  float st[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) st[mt][e] = 0.0f;

  stage_chunk<N>(smem, xb, dtb, Bm, Cm, cb, 0, S, P, p0, r, nC, flags, tid);
  cp_async_commit();

  for (int c = 0; c < nC; ++c) {
    const int t0 = c * Q, nt = min(Q, S - t0);
    uint8_t* stg = smem + (c & 1) * L::kStage;
    const bf16* Cs = reinterpret_cast<const bf16*>(stg + L::kC);
    const bf16* Bs = reinterpret_cast<const bf16*>(stg + L::kB);
    const bf16* Xs = reinterpret_cast<const bf16*>(stg + L::kX);
    const float* CBs = reinterpret_cast<const float*>(stg + L::kCB);
    const float* Ds = reinterpret_cast<const float*>(stg + L::kDt);
    cp_async_wait<0>();
    __syncthreads();   // chunk c is in; every reader of the other stage is done
    if (c + 1 < nC) {
      stage_chunk<N>(smem + ((c + 1) & 1) * L::kStage, xb, dtb, Bm, Cm, cb, c + 1, S, P,
                     p0, r, nC, flags, tid);
      cp_async_commit();
    }
    // The cumulative log-decay: lane l holds steps 2l and 2l + 1.
    if (w == 0) {
      const float d0 = Ds[2 * lane], d1 = Ds[2 * lane + 1];
      const float a0 = d0 * a_h, a1 = d1 * a_h;
      float v = a0 + a1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
      }
      const float s0 = v - a1, s1 = v;
      const float total = __shfl_sync(0xffffffffu, v, 31);
      s_seg[2 * lane] = s0;
      s_seg[2 * lane + 1] = s1;
      s_eseg[2 * lane] = __expf(s0);
      s_eseg[2 * lane + 1] = __expf(s1);
      s_w[2 * lane] = d0 * __expf(total - s0);
      s_w[2 * lane + 1] = d1 * __expf(total - s1);
    }
    // The state before this chunk, as bf16 ST[n][p].
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      bf16* sp = ST + (16 * mt + g) * LDP + 8 * w + 2 * tq;
      *reinterpret_cast<uint32_t*>(sp) = pack_bf16(st[mt][0], st[mt][1]);
      *reinterpret_cast<uint32_t*>(sp + 8 * LDP) = pack_bf16(st[mt][2], st[mt][3]);
    }
    __syncthreads();

    // This warp's columns of (x dt) exp(total - seg): XP[t][8w..8w+7].
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = lane + 32 * h;
      const uint4 v = *reinterpret_cast<const uint4*>(Xs + t * LDP + 8 * w);
      const bf16* e = reinterpret_cast<const bf16*>(&v);
      const float wt = s_w[t];
      uint4 o;
      uint32_t* op = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        op[k] = pack_bf16(__bfloat162float(e[2 * k]) * wt, __bfloat162float(e[2 * k + 1]) * wt);
      *reinterpret_cast<uint4*>(XP + t * LDP + 8 * w) = o;
    }

    // y = exp(seg) o (C state) ...
    float yacc[4][4];
#pragma unroll
    for (int pt = 0; pt < 4; ++pt)
#pragma unroll
      for (int e = 0; e < 4; ++e) yacc[pt][e] = 0.0f;
#pragma unroll
    for (int kn = 0; kn < N / 16; ++kn) {
      uint32_t a[4];
      ldsm_x4(a, Cs + (16 * rw + lr) * LDN + 16 * kn + lc);
#pragma unroll
      for (int pp = 0; pp < 2; ++pp) {
        uint32_t b[4];
        ldsm_x4_t(b, ST + (16 * kn + lr) * LDP + 32 * ph + 16 * pp + lc);
        mma_16816(yacc[2 * pp], a, b[0], b[1]);
        mma_16816(yacc[2 * pp + 1], a, b[2], b[3]);
      }
    }
    const float sg0 = s_seg[i0], sg1 = s_seg[i0 + 8];
    const float e0 = s_eseg[i0], e1 = s_eseg[i0 + 8];
#pragma unroll
    for (int pt = 0; pt < 4; ++pt) {
      yacc[pt][0] *= e0; yacc[pt][1] *= e0;
      yacc[pt][2] *= e1; yacc[pt][3] *= e1;
    }
    // ... plus (C B^T o L diag(dt)) x over key slices at or below the rows.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk > rw) continue;
      float m[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = 16 * kk + 8 * h + 2 * tq;
        const float2 u = *reinterpret_cast<const float2*>(CBs + i0 * LDF + j);
        const float2 v = *reinterpret_cast<const float2*>(CBs + (i0 + 8) * LDF + j);
        const float cbv[4] = {u.x, u.y, v.x, v.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + (e >> 1) * 8, jj = j + (e & 1);
          m[h][e] = jj <= i ? cbv[e] * __expf((e < 2 ? sg0 : sg1) - s_seg[jj]) * Ds[jj]
                            : 0.0f;
        }
      }
      const uint32_t a[4] = {pack_bf16(m[0][0], m[0][1]), pack_bf16(m[0][2], m[0][3]),
                             pack_bf16(m[1][0], m[1][1]), pack_bf16(m[1][2], m[1][3])};
#pragma unroll
      for (int pp = 0; pp < 2; ++pp) {
        uint32_t b[4];
        ldsm_x4_t(b, Xs + (16 * kk + lr) * LDP + 32 * ph + 16 * pp + lc);
        mma_16816(yacc[2 * pp], a, b[0], b[1]);
        mma_16816(yacc[2 * pp + 1], a, b[2], b[3]);
      }
    }
#pragma unroll
    for (int pt = 0; pt < 4; ++pt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = i0 + 8 * h, p = p0 + 32 * ph + 8 * pt + 2 * tq;
        if (i >= nt) continue;
        bf16* yp = yb + static_cast<size_t>(t0 + i) * P + p;
        if ((flags & kPairY) && p + 1 < P) {
          *reinterpret_cast<uint32_t*>(yp) = pack_bf16(yacc[pt][2 * h], yacc[pt][2 * h + 1]);
        } else {
          if (p < P) yp[0] = __float2bfloat16_rn(yacc[pt][2 * h]);
          if (p + 1 < P) yp[1] = __float2bfloat16_rn(yacc[pt][2 * h + 1]);
        }
      }

    // state = exp(total) state + B^T XP, this warp's columns 8w..8w+7.
    __syncwarp();      // this warp's XP columns are written
    const float et = __expf(s_seg[Q - 1]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[mt][e] *= et;
#pragma unroll
    for (int k2 = 0; k2 < 2; ++k2) {
      uint32_t b[4];     // key slices 2 k2 (b[0], b[1]) and 2 k2 + 1 (b[2], b[3])
      ldsm_x4_t(b, XP + (32 * k2 + lane) * LDP + 8 * w);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ts = 16 * (2 * k2 + h);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t a[4];
          ldsm_x4_t(a, Bs + (ts + (lane & 7) + 8 * (lane >> 4)) * LDN + 16 * mt +
                           8 * ((lane >> 3) & 1));
          mma_16816(st[mt], a, b[2 * h], b[2 * h + 1]);
        }
      }
    }
  }
}

bool aligned(const void* p, uintptr_t n) { return (reinterpret_cast<uintptr_t>(p) % n) == 0; }

template <int N>
int launch(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
           float* cb, void* y, int BH, int S, int P, int H, cudaStream_t s) {
  const int nC = (S + Q - 1) / Q, R = BH / H;
  const int flags = (aligned(Bm, 16) && aligned(Cm, 16) ? kVecBC : 0)
                    | (P % 8 == 0 && aligned(x, 16) ? kVecX : 0)
                    | (S % 4 == 0 && aligned(dt, 16) ? kVecDt : 0)
                    | (P % 2 == 0 && aligned(y, 4) ? kPairY : 0);
  const int cb_bytes = 2 * Q * (N + 8) * 2;
  ssd_cb_kernel<N><<<dim3(nC, R), kCbThreads, cb_bytes, s>>>(
      static_cast<const bf16*>(Bm), static_cast<const bf16*>(Cm), cb, S, nC, flags);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  constexpr int bytes = Smem<N>::kBytes;
  e = cudaFuncSetAttribute(ssd_tc_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_tc_kernel<N><<<dim3((P + PT - 1) / PT, BH), kThreads, bytes, s>>>(
      static_cast<const bf16*>(x), dt, A, static_cast<const bf16*>(Bm),
      static_cast<const bf16*>(Cm), cb, static_cast<bf16*>(y), S, P, H, nC, flags);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xh (BH, S, P), Bm and Cm (BH / H, S, N) bfloat16; dt (BH, S) and A (BH,)
// float32; y (BH, S, P) bfloat16; cb float32 scratch of
// (BH / H) * ceil(S / 64) * 64 * 64 floats (16-byte aligned). N is 16, 32,
// 64 or 128. Launches on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for what the kernels do not take).
extern "C" int ssd_scan_tc_launch(const void* xh, const float* dt, const float* A,
                                  const void* Bm, const void* Cm, void* y, float* cb, int BH,
                                  int S, int P, int N, int H, void* stream) {
  if (H < 1 || BH % H != 0 || BH > 65535 || P < 1 || (S + Q - 1) / Q > 65535 ||
      !aligned(cb, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (BH <= 0 || S <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 16: return launch<16>(xh, dt, A, Bm, Cm, cb, y, BH, S, P, H, s);
    case 32: return launch<32>(xh, dt, A, Bm, Cm, cb, y, BH, S, P, H, s);
    case 64: return launch<64>(xh, dt, A, Bm, Cm, cb, y, BH, S, P, H, s);
    case 128: return launch<128>(xh, dt, A, Bm, Cm, cb, y, BH, S, P, H, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
