// The identity-skip bottleneck body of bottleneck.cuh in bfloat16 on the
// tensor cores: the same function, rounding points and epilogues (t1 and t2
// round to bf16, t3 stays in f32, t1 is ZERO outside the image), run as
// three products of mma.sync.m16n8k16 bf16 with f32 accumulation
// (csrc/mma.cuh). float32 keeps the FMA body of bottleneck.cuh.
//
// Serves every bf16 caller of the body: bottleneck.cu's grid kernel
// (kPlain #1 and #5, kPool #2, kUpAdd + kPlain #3), bottom.cu's walk
// (#7, with kPlainPool on the way down) and, with MOB = true, mobile.cu's
// separable bottleneck (#8-#10). Every output element sums its
// products in one fixed order, chunk by chunk as the stage sequence below
// runs, whatever the tile's place or size, so #7's walk gives the same
// bits as the walk composed of single-bottleneck launches.
//
// The mobile body (MOB) differs in phase 2 alone: the 3x3 depthwise step
// over the t1 halo on the CUDA cores (tile_depthwise: mobile.cu's tap
// order, each product and sum rounded as written, the sum rounded to
// bf16) into region A, then a GEMM, M = TH*TW, K = Cm, N = Cm (pw2), whose
// bn2 epilogue writes t2 over t1 (dead since the depthwise step). Its
// weights (W1' and W3' with the 1x1 depthwise scales folded in, pw2) are
// 160 KB at C=256 and ride the same ring; the taps d2 stay float32 and
// are read from L2. Its modes are kPlain (kMobPlain), kPlainPool
// (kMobPool: x + t3 with one rounding, as kMobPlain) and kUpAdd
// (kMobUpAdd).
//
// The conv-skip bottleneck (kConvSkip, bottleneck.cu's convskip_tc_kernel,
// #6) differs in its input and its skip: x has Cin channels (the halo
// rows are Cin + 8 wide, phase 1 is K = Cin), and the skip is a fourth
// product, M = TH*TW, K = Cin, N = C, whose A rows are the halo's
// interior. Its Ws slices ride the ring right after phase 1's, while the
// x halo is still whole (phase 2 writes t2 over it). The skip's epilogue
// writes round(relu(acc + bs)) to out; phase 3's epilogue reads it back
// in place of the residual x (the same lane, the same element: both
// products split M and N alike) and writes round(skip + round(t3)). So
// the skip costs no shared memory and no second accumulator set, and its
// bf16 round trip through L2 is exact, since the skip is rounded to bf16
// anyway.
//
// Bound on the H100: at 64 px (B=128, C=256, Cm=128) one bottleneck is
// 223 GFLOP against 268 MB of HBM traffic, so the tensor-core math bounds
// it (0.226 ms at 989 TFLOP/s).
//
// Design, one TH x TW output tile (TH <= 8, TW <= 16) per call, 8 warps:
//   * Phase 1 is a GEMM, M = the (TH+2)(TW+2) halo pixels (padded to a
//     multiple of 16), K = C, N = Cm: A is the x halo in shared memory
//     (rows of C + 8 bf16: a 16-byte shift per row, so the 8 rows of an
//     ldmatrix tile fall in 8 distinct bank groups), loaded by 16-byte
//     cp.async with zero fill outside the image. Its epilogue writes t1
//     (rows of Cm + 8) on the halo, zero outside the image.
//   * Phase 2 is an implicit GEMM, M = TH*TW, K = 9*Cm, N = Cm: the
//     ldmatrix row addresses do the nine shifts over the t1 halo, as in
//     unit3_tc_kernel (bottleneck_train.cu). t2 (rows of Cm + 8) takes the
//     place of the x halo, which phase 1 no longer needs.
//   * Phase 3 is a GEMM, M = TH*TW, K = Cm, N = C, whose epilogue applies
//     the mode straight from the accumulator fragments in f32 (the residual
//     x and u_lo read from device memory, L2-hot after the halo load).
//   * Weights: one bottleneck's are 416 KB at C=256, more than shared
//     memory holds, so their (CK x NT) slices stream from L2 through ONE
//     cp.async ring of NST stages that runs across the three phases: the
//     W1 chunks, the nine W2 tap slices per chunk, the W3 chunks. The next
//     phase's first slices are in flight while a phase computes, and one
//     barrier per stage orders the ring, the epilogues and the next
//     phase's reads.
//   * Warps split each product 2 x 4 (or 4 x 2 for NT = 16) over m16 and
//     n8 tiles: at most MW m16 x 4 n8 tiles, 16 * MW accumulators a lane
//     (MW = 4 for tiles up to 8 x 8, two blocks an SM; 6 for 8 x 16).
//   * The plan (the tile, CK, NT, NST and the shared-memory bytes) comes
//     from ops/cuda/bottleneck_kernel.py bneck_tc_plan, which the CPU tests
//     check; bneck_tc_plan_ok says what this body takes. At C=256 an 8 x 8
//     tile takes 52,800 bytes of x halo, 27,200 of t1 and two 17,408-byte
//     stages: 114,816 bytes, two blocks an SM. The plan was picked by
//     measurement (scripts/torch_port_bneck_tc_ab.py): against it, chunks
//     of 32 (four stages) and one block an SM with four stages ran 1.4x and
//     1.6x longer, an 8 x 16 tile (half the weight reads a pixel, one block
//     an SM) 1.1x.
//   * What holds it (PERF.md): each tile streams all of one bottleneck's
//     weights from L2 for its 64 pixels, 3.4 GB a call at 64 px, B=128,
//     with one barrier per 17 KB stage.
#pragma once

#include "bottleneck.cuh"
#include "mma.cuh"

namespace spe {

using bf16 = __nv_bfloat16;

constexpr int kBtNw = 4;     // n8 tiles of one warp, at most
constexpr int kBtMaxMw = 6;  // m16 tiles of one warp, at most
constexpr int kBtMaxTh = 8;  // tile rows, at most
constexpr int kBtMaxTw = 16; // tile columns, at most

// Bytes of shared memory one TH x TW tile takes: region A (the x halo in
// phase 1, then t2 and, when pooling, the out tile), t1 on the halo, and the
// ring (ops/cuda/bottleneck_kernel.py _bneck_tc_smem). Cin: the channels
// of x where they differ from C (the conv skip), else 0.
__host__ __device__ inline size_t bneck_tc_smem(int TH, int TW, int C, int Cm,
                                                bool pooling, int CK, int NT,
                                                int NST, int Cin = 0) {
  const size_t HW2 = (size_t)(TH + 2) * (TW + 2), P = (size_t)TH * TW;
  size_t regA = HW2 * ((Cin ? Cin : C) + 8);
  const size_t regA2 = P * (Cm + 8) + (pooling ? P * (C + 8) : 0);
  if (regA2 > regA) regA = regA2;
  return (regA + HW2 * (Cm + 8) + (size_t)NST * CK * (NT + 8)) * 2;
}

// n8 tiles along N of the warp grid: 4 warps, or 2 when NT = 16.
__host__ __device__ inline int bneck_tc_wn(int NT) { return NT == 16 ? 2 : 4; }

// m16 tiles of one warp, at most, in phase 1 (the halo, the widest M) of a
// TH x TW tile.
__host__ __device__ inline int bneck_tc_mw(int TH, int TW, int NT) {
  const int WM = 8 / bneck_tc_wn(NT), MT1 = ((TH + 2) * (TW + 2) + 15) / 16;
  return (MT1 + WM - 1) / WM;
}

// What the body takes: C % 32 == 0 (Cm = C/2 a multiple of 16), CK a
// multiple of 16 up to 64 and NT = 16 or a multiple of 32 up to 128, both
// dividing Cm; tiles of at most kBtMaxTh x kBtMaxTw, even where they pool,
// whose halo gives a warp at most kBtMaxMw m16 tiles; NST 2..4; smem enough
// for a TH x TW tile. The conv skip (Cin > 0) takes Cin a multiple of 16
// that CK divides.
__host__ inline bool bneck_tc_plan_ok(int C, int Cm, int TH, int TW, int CK,
                                      int NT, int NST, size_t smem,
                                      bool pooling, int Cin = 0) {
  if (C % 32 || Cm * 2 != C || CK % 16 || CK < 16 || CK > 64 || Cm % CK ||
      Cm % NT || NT > 128 || (NT != 16 && NT % 32) || TH < 1 || TW < 1 ||
      TH > kBtMaxTh || TW > kBtMaxTw || (pooling && (TH % 2 || TW % 2)) ||
      NST < 2 || NST > 4 || bneck_tc_mw(TH, TW, NT) > kBtMaxMw ||
      Cin < 0 || Cin % CK)
    return false;
  return smem >= bneck_tc_smem(TH, TW, C, Cm, pooling, CK, NT, NST, Cin);
}

// This warp's share of one product with MT m16 tiles and NT columns: m16
// tiles [m0, m0 + mcount), n8 tiles [n8 0, nw) from column nbase.
struct WarpPart {
  int m0, mcount, nbase, nw;
};

__device__ __forceinline__ WarpPart warp_part(int MT, int NT) {
  const int warp = threadIdx.x >> 5, WN = bneck_tc_wn(NT), WM = 8 / WN;
  const int wm = warp / WN, wn = warp % WN, nw = NT / 8 / WN;
  const int mw = (MT + WM - 1) / WM;
  const int m0 = wm * mw;
  const int mc = MT - m0 < mw ? MT - m0 : mw;
  return WarpPart{m0, mc > 0 ? mc : 0, wn * nw * 8, nw};
}

// acc[mt][j] += A (the lane's ldmatrix row addresses a[mt], bytes, at this
// stage's first column) x the ring slot at b (bytes, the lane's k row and
// column already added), over CK / 16 k16 steps. SRB: bytes of a ring row.
template <int MW>
__device__ __forceinline__ void tc_stage(float (&acc)[MW][kBtNw][4],
                                         const uint32_t (&a)[MW],
                                         const WarpPart wp, uint32_t b,
                                         int CK, int SRB) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    if (ks * 16 >= CK) break;
    uint32_t bf[kBtNw][2];
#pragma unroll
    for (int j = 0; j < kBtNw; j += 2) {
      if (j >= wp.nw) break;
      const uint32_t addr = b + ks * 16 * SRB + j * 16;
      if (j + 1 < wp.nw) {
        uint32_t q[4];
        mma::ldmatrix_x4_t(q, addr);
        bf[j][0] = q[0];
        bf[j][1] = q[1];
        bf[j + 1][0] = q[2];
        bf[j + 1][1] = q[3];
      } else {
        uint32_t q[2];
        mma::ldmatrix_x2_t(q, addr);
        bf[j][0] = q[0];
        bf[j][1] = q[1];
      }
    }
#pragma unroll
    for (int mt = 0; mt < MW; ++mt) {
      if (mt >= wp.mcount) break;
      uint32_t af[4];
      mma::ldmatrix_x4(af, a[mt] + ks * 32);
#pragma unroll
      for (int j = 0; j < kBtNw; ++j) {
        if (j >= wp.nw) break;
        mma::mma_bf16(acc[mt][j], af, bf[j][0], bf[j][1]);
      }
    }
  }
}

// bn(relu(v + b)) with every operation rounded as written (no contraction
// left to the compiler), so each caller's instantiation gives the same bits.
__device__ __forceinline__ float bn_relu(float v, float b, float a, float c) {
  return __fmaf_rn(fmaxf(__fadd_rn(v, b), 0.f), a, c);
}

__device__ __forceinline__ float bf_lo16(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf_hi16(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// The mobile body's 3x3 depthwise step: a (rows of Cm + 8, one per output
// pixel of the TH x TW tile) from the t1 halo (rows of Cm + 8, zero outside
// the image) and the float32 taps d2 (9, Cm), 8 channels a thread: per
// channel the taps in row-major order, each product and sum rounded on its
// own (no contraction), the sum rounded to bf16, as mobile.cu's FMA kernel
// and the plain version compute it.
__device__ __forceinline__ void tile_depthwise(const bf16* t1s, bf16* as,
                                               const float* __restrict__ d2,
                                               int TH, int TW, int Cm) {
  const int LW = TW + 2, S1 = Cm + 8, c8 = Cm / 8;
  for (int v = threadIdx.x; v < TH * TW * c8; v += kThreads) {
    const int p = v / c8, c = (v % c8) * 8, py = p / TW, px = p % TW;
    float acc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = 0.f;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const uint4 r = *reinterpret_cast<const uint4*>(
          t1s + (size_t)((py + tap / 3) * LW + px + tap % 3) * S1 + c);
      const float4 d0 = __ldg(reinterpret_cast<const float4*>(d2 + tap * Cm + c));
      const float4 d1 = __ldg(reinterpret_cast<const float4*>(d2 + tap * Cm + c + 4));
      const uint32_t w[4] = {r.x, r.y, r.z, r.w};
      const float d[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        acc[2 * k] = __fadd_rn(acc[2 * k], __fmul_rn(bf_lo16(w[k]), d[2 * k]));
        acc[2 * k + 1] =
            __fadd_rn(acc[2 * k + 1], __fmul_rn(bf_hi16(w[k]), d[2 * k + 1]));
      }
    }
    *reinterpret_cast<uint4*>(as + (size_t)p * S1 + c) =
        make_uint4(mma::pack_bf16(acc[0], acc[1]), mma::pack_bf16(acc[2], acc[3]),
                   mma::pack_bf16(acc[4], acc[5]), mma::pack_bf16(acc[6], acc[7]));
  }
}

// One identity-skip bottleneck on the TH x TW tile of image b whose top-left
// pixel is (ty0, tx0), in bf16 on the tensor cores; a warp takes at most MW
// m16 tiles (bneck_tc_mw). MOB runs the mobile body's phase 2 (the
// depthwise step with the taps d2, then pw2) in place of the 3x3 product.
// kConvSkip takes x with Cin channels and the skip's weight ws (Cin, C);
// vec then ends with bs (C). Ends without a barrier: a caller that reuses
// smem for another tile syncs first.
template <int MODE, int MW, bool MOB = false>
__device__ __forceinline__ void bneck_tile_tc(
    unsigned char* smem, const bf16* x, const bf16* __restrict__ w1,
    const bf16* __restrict__ w2, const bf16* __restrict__ w3,
    const float* __restrict__ vec, bf16* out, bf16* pooled, const bf16* ulo,
    int b, int ty0, int tx0, int H, int W, int C, int Cm, int TH, int TW,
    int CK, int NT, int NST, const float* __restrict__ d2 = nullptr,
    const bf16* __restrict__ ws = nullptr, int Cin = 0) {
  constexpr bool CS = MODE == kConvSkip;
  const int CX = CS ? Cin : C;  // channels of x
  const int LW = TW + 2, HW2 = (TH + 2) * LW, P = TH * TW;
  const int SX = CX + 8, S1 = Cm + 8, SR = NT + 8;
  const size_t regA0 = (size_t)HW2 * SX,
               regA1 = (size_t)P * S1 + (pools<MODE>() ? (size_t)P * SX : 0);
  const size_t regA = regA0 > regA1 ? regA0 : regA1;
  bf16* xs = reinterpret_cast<bf16*>(smem);  // phase 1: the x halo
  bf16* t1s = xs + regA;
  // Phases 2-3: t2 (MOB: the depthwise sums a, and t2 over t1).
  bf16* t2s = MOB ? t1s : xs;
  bf16* outs = xs + (size_t)P * S1;           // pooling: the out tile
  bf16* ring = t1s + (size_t)HW2 * S1;
  const int tid = threadIdx.x, lane = tid & 31;
  const bf16* xb = x + (size_t)b * H * W * CX;

  // Phase 0: the x halo, zeros outside the image, as one commit group.
  {
    const int c8 = CX / 8;
    for (int v = tid; v < HW2 * c8; v += kThreads) {
      const int q = v / c8, c = (v % c8) * 8;
      const int iy = ty0 - 1 + q / LW, ix = tx0 - 1 + q % LW;
      const bool in = iy >= 0 && iy < H && ix >= 0 && ix < W;
      const bf16* src = xb + ((size_t)(in ? iy : 0) * W + (in ? ix : 0)) * CX + c;
      mma::cp_async16_zfill(mma::smem_u32(xs + (size_t)q * SX + c), src, in);
    }
    mma::cp_async_commit();
  }

  // The stage sequence: phase 1 runs Cm/NT column groups of CX/CK stages
  // (W1 rows kc*CK.., columns nc*NT..), the conv skip's phase 4 C/NT
  // groups of Cin/CK stages of Ws, phase 2 Cm/NT groups of 9 taps x Cm/CK
  // stages (MOB: of Cm/CK stages of pw2), phase 3 C/NT groups of Cm/CK
  // stages.
  const int K1 = CX / CK, K2 = Cm / CK, T2 = MOB ? 1 : 9;
  const int S1n = (Cm / NT) * K1, S2n = (Cm / NT) * T2 * K2;
  const int S2b = S1n + (CS ? (C / NT) * K1 : 0);  // phase 2's first stage
  const int S = S2b + S2n + (C / NT) * K2;
  const int per_row = NT / 8;
  auto issue = [&](int s) {
    if (s < S) {
      const bf16* src;
      int ld;
      if (s < S1n) {
        src = w1 + (size_t)(s % K1) * CK * Cm + (s / K1) * NT;
        ld = Cm;
      } else if (s < S2b) {
        const int s4 = s - S1n;
        src = ws + (size_t)(s4 % K1) * CK * C + (s4 / K1) * NT;
        ld = C;
      } else if (s < S2b + S2n) {
        const int s2 = s - S2b, j = s2 % (T2 * K2);
        src = w2 + ((size_t)(j / K2) * Cm + (j % K2) * CK) * Cm +
              (s2 / (T2 * K2)) * NT;
        ld = Cm;
      } else {
        const int s3 = s - S2b - S2n;
        src = w3 + (size_t)(s3 % K2) * CK * C + (s3 / K2) * NT;
        ld = C;
      }
      bf16* dst = ring + (size_t)(s % NST) * CK * SR;
      for (int v = tid; v < CK * per_row; v += kThreads) {
        const int r = v / per_row, c = (v % per_row) * 8;
        mma::cp_async16(mma::smem_u32(dst + r * SR + c), src + (size_t)r * ld + c);
      }
    }
    mma::cp_async_commit();
  };
  for (int s = 0; s < NST - 1; ++s) issue(s);

  // Each warp's part of the products and its lanes' ldmatrix rows.
  const int MT1 = (HW2 + 15) / 16, MT = (P + 15) / 16;
  const WarpPart wp1 = warp_part(MT1, NT), wp = warp_part(MT, NT);
  const int lrow = lane & 15, lcol = (lane >> 4) * 8;
  uint32_t a1[MW], a2[MW], a3[MW], a4[MW];  // a4: the skip's (CS)
#pragma unroll
  for (int mt = 0; mt < MW; ++mt) {
    const int q = min((wp1.m0 + mt) * 16 + lrow, HW2 - 1);
    a1[mt] = mma::smem_u32(xs + (size_t)q * SX + lcol);
    const int p = min((wp.m0 + mt) * 16 + lrow, P - 1);
    a2[mt] = MOB ? mma::smem_u32(xs + (size_t)p * S1 + lcol)
                 : mma::smem_u32(t1s + (size_t)((p / TW) * LW + p % TW) * S1 + lcol);
    a3[mt] = mma::smem_u32(t2s + (size_t)p * S1 + lcol);
    if (CS)  // the halo's interior pixel p
      a4[mt] = mma::smem_u32(
          xs + (size_t)((p / TW + 1) * LW + p % TW + 1) * SX + lcol);
  }
  const int SRB = SR * 2;
  const uint32_t ring0 = mma::smem_u32(ring);
  const int lr = lane >> 2, lc = 2 * (lane & 3);  // fragment row, column

  float acc[MW][kBtNw][4];
  for (int s = 0; s < S; ++s) {
    mma::cp_async_wait_n(NST - 2);  // stage s (and the halo) has landed
    // Stage s is visible; every warp is done with stage s - 1, whose ring
    // slot stage s + NST - 1 takes, and with the last epilogue's writes.
    __syncthreads();
    issue(s + NST - 1);
    if (MOB && s == S2b) {
      // t1 is whole: the depthwise sums take the x halo's place. acc is
      // zeroed here (phase 2 starts a column group), so that its registers
      // are free during the depthwise step.
      tile_depthwise(t1s, xs, d2, TH, TW, Cm);
#pragma unroll
      for (int mt = 0; mt < MW; ++mt)
#pragma unroll
        for (int jj = 0; jj < kBtNw; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][jj][e] = 0.f;
      __syncthreads();
    }

    int phase, nc, j, jn, off;  // off: bytes added to the A rows
    if (s < S1n) {
      phase = 1, nc = s / K1, j = s % K1, jn = K1, off = j * CK * 2;
    } else if (CS && s < S2b) {
      const int s4 = s - S1n;
      phase = 4, nc = s4 / K1, j = s4 % K1, jn = K1, off = j * CK * 2;
    } else if (MOB && s < S2b + S2n) {
      const int s2 = s - S2b;
      phase = 2, nc = s2 / K2, j = s2 % K2, jn = K2, off = j * CK * 2;
    } else if (s < S2b + S2n) {
      const int s2 = s - S2b, tap = (s2 % (9 * K2)) / K2;
      phase = 2, nc = s2 / (9 * K2), j = s2 % (9 * K2), jn = 9 * K2;
      off = (((tap / 3) * LW + tap % 3) * S1 + (j % K2) * CK) * 2;
    } else {
      const int s3 = s - S2b - S2n;
      phase = 3, nc = s3 / K2, j = s3 % K2, jn = K2, off = j * CK * 2;
    }
    const WarpPart w = phase == 1 ? wp1 : wp;  // a copy: no local memory
    if (j == 0) {
#pragma unroll
      for (int mt = 0; mt < MW; ++mt)
#pragma unroll
        for (int jj = 0; jj < kBtNw; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][jj][e] = 0.f;
    }
    if (w.mcount > 0) {
      uint32_t a[MW];
#pragma unroll
      for (int mt = 0; mt < MW; ++mt)
        a[mt] = (phase == 1 ? a1[mt] : phase == 2 ? a2[mt]
                 : CS && phase == 4 ? a4[mt] : a3[mt]) + off;
      const uint32_t bb = ring0 + (s % NST) * CK * SRB + lrow * SRB +
                          (w.nbase + lcol) * 2;
      tc_stage(acc, a, w, bb, CK, SRB);
    }
    if (j != jn - 1 || w.mcount == 0) continue;

    // The epilogue of column group nc: row (mt, h) of this lane is
    // (m0 + mt) * 16 + h * 8 + lane / 4, its columns n and n + 1.
#pragma unroll
    for (int mt = 0; mt < MW; ++mt) {
      if (mt >= w.mcount) break;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = (w.m0 + mt) * 16 + h * 8 + lr;
        if (phase == 1) {
          if (r >= HW2) continue;
          const int iy = ty0 - 1 + r / LW, ix = tx0 - 1 + r % LW;
          const bool in = iy >= 0 && iy < H && ix >= 0 && ix < W;
#pragma unroll
          for (int jj = 0; jj < kBtNw; ++jj) {
            if (jj >= w.nw) break;
            const int n = nc * NT + w.nbase + jj * 8 + lc;
            float t[2];
#pragma unroll
            for (int e = 0; e < 2; ++e)
              t[e] = in ? bn_relu(acc[mt][jj][2 * h + e], vec[n + e],
                                  vec[Cm + n + e], vec[2 * Cm + n + e])
                        : 0.f;
            *reinterpret_cast<uint32_t*>(t1s + (size_t)r * S1 + n) =
                mma::pack_bf16(t[0], t[1]);
          }
        } else if (phase == 2) {
          if (r >= P) continue;
#pragma unroll
          for (int jj = 0; jj < kBtNw; ++jj) {
            if (jj >= w.nw) break;
            const int n = nc * NT + w.nbase + jj * 8 + lc;
            float t[2];
#pragma unroll
            for (int e = 0; e < 2; ++e)
              t[e] = bn_relu(acc[mt][jj][2 * h + e], vec[3 * Cm + n + e],
                             vec[4 * Cm + n + e], vec[5 * Cm + n + e]);
            *reinterpret_cast<uint32_t*>(t2s + (size_t)r * S1 + n) =
                mma::pack_bf16(t[0], t[1]);
          }
        } else {
          if (r >= P) continue;
          const int gy = ty0 + r / TW, gx = tx0 + r % TW;
          if (gy >= H || gx >= W) continue;
          const size_t o = (((size_t)b * H + gy) * W + gx) * C;
          const float* v3 = vec + 6 * Cm;
          if (CS && phase == 4) {
            // The skip, rounded to bf16, parked in out until phase 3.
#pragma unroll
            for (int jj = 0; jj < kBtNw; ++jj) {
              if (jj >= w.nw) break;
              const int n = nc * NT + w.nbase + jj * 8 + lc;
              float sk[2];
#pragma unroll
              for (int e = 0; e < 2; ++e)
                sk[e] = fmaxf(__fadd_rn(acc[mt][jj][2 * h + e],
                                        v3[3 * C + n + e]), 0.f);
              *reinterpret_cast<uint32_t*>(out + o + n) =
                  mma::pack_bf16(sk[0], sk[1]);
            }
            continue;
          }
          // The residual: x, or the conv skip's value that this lane
          // parked in out in phase 4.
          const bf16* res = CS ? out : x;
#pragma unroll
          for (int jj = 0; jj < kBtNw; ++jj) {
            if (jj >= w.nw) break;
            const int n = nc * NT + w.nbase + jj * 8 + lc;
            const uint32_t xw = *reinterpret_cast<const uint32_t*>(res + o + n);
            float t3[2], v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e)
              t3[e] = bn_relu(acc[mt][jj][2 * h + e], v3[n + e],
                              v3[C + n + e], v3[2 * C + n + e]);
            const float xv[2] = {bf_lo16(xw), bf_hi16(xw)};
            if (MODE == kUpAdd) {
              const size_t ou =
                  (((size_t)b * (H / 2) + gy / 2) * (W / 2) + gx / 2) * C + n;
              const uint32_t uw = *reinterpret_cast<const uint32_t*>(ulo + ou);
              const float uv[2] = {bf_lo16(uw), bf_hi16(uw)};
#pragma unroll
              for (int e = 0; e < 2; ++e)
                v[e] = __fadd_rn(round_st<bf16>(__fadd_rn(xv[e], t3[e])), uv[e]);
            } else {
#pragma unroll
              for (int e = 0; e < 2; ++e)
                v[e] = __fadd_rn(xv[e], MODE == kPool || CS
                                            ? round_st<bf16>(t3[e])
                                            : t3[e]);
            }
            const uint32_t pk = mma::pack_bf16(v[0], v[1]);
            *reinterpret_cast<uint32_t*>(out + o + n) = pk;
            if (pools<MODE>())
              *reinterpret_cast<uint32_t*>(outs + (size_t)r * SX + n) = pk;
          }
        }
      }
    }
  }
  if (pools<MODE>()) {
    // Each tile pools its own 2x2 windows (TH and TW are even), 8 channels
    // a thread, from the out tile (rows of C + 8).
    __syncthreads();
    const int PW = TW / 2, Ho = H / 2, Wo = W / 2, c8 = C / 8;
    for (int v = tid; v < (TH / 2) * PW * c8; v += kThreads) {
      const int c = (v % c8) * 8, q = v / c8, py = q / PW, px = q % PW;
      const int gy = ty0 / 2 + py, gx = tx0 / 2 + px;
      if (gy >= Ho || gx >= Wo) continue;
      const bf16* t = outs + (size_t)(2 * py * TW + 2 * px) * SX + c;
      const uint4 r00 = *reinterpret_cast<const uint4*>(t);
      const uint4 r01 = *reinterpret_cast<const uint4*>(t + SX);
      const uint4 r10 = *reinterpret_cast<const uint4*>(t + (size_t)TW * SX);
      const uint4 r11 = *reinterpret_cast<const uint4*>(t + (size_t)(TW + 1) * SX);
      const uint32_t* w00 = reinterpret_cast<const uint32_t*>(&r00);
      const uint32_t* w01 = reinterpret_cast<const uint32_t*>(&r01);
      const uint32_t* w10 = reinterpret_cast<const uint32_t*>(&r10);
      const uint32_t* w11 = reinterpret_cast<const uint32_t*>(&r11);
      uint32_t m[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float lo = fmaxf(fmaxf(bf_lo16(w00[k]), bf_lo16(w01[k])),
                               fmaxf(bf_lo16(w10[k]), bf_lo16(w11[k])));
        const float hi = fmaxf(fmaxf(bf_hi16(w00[k]), bf_hi16(w01[k])),
                               fmaxf(bf_hi16(w10[k]), bf_hi16(w11[k])));
        m[k] = mma::pack_bf16(lo, hi);  // exact: a max of bf16 values
      }
      *reinterpret_cast<uint4*>(pooled + (((size_t)b * Ho + gy) * Wo + gx) * C + c) =
          make_uint4(m[0], m[1], m[2], m[3]);
    }
  }
}

}  // namespace spe
