// Fused hourglass head and inter-stack glue for inference:
//
//   head = round(bn(relu(u . Wh + bh)))       1x1, C -> C
//   pred = sigmoid(head . Wp + bp)            1x1, C -> K, float32 out
//   mid stacks only:
//   h2 = round(head . W2 + b2)                1x1, C -> C
//   hm = round(round(pred) . W3 + b3)         1x1, K -> C
//   y' = round(round(h2 + hm) + y)
//
// Replaces single_person_pose_estimation_tpu/ops/pallas/head_kernel.py:
// fused_head (its _head_mid_kernel and _head_last_kernel).
//
// Bound on the H100: per 64x64 map and image the mid head is 1.1 GFLOP
// (three C x C products and two thin K products) against ~6.3 MB of HBM
// traffic at bf16 (u, y in; y' out; pred out in f32), ~170 FLOP/byte,
// under the ~295 where bf16 tensor cores would stop being the limit, so
// HBM bounds the ideal kernel. In bfloat16 the products run on the tensor
// cores (head_tc_kernel); in float32 as FMA on the CUDA cores
// (head_kernel), bound by the FMA rate.
//
// Design: only 1x1 products, so a block takes a run of flat pixel rows with
// no halo and writes pred and y' once. The padded pred columns are written
// as zero and W3's padded rows are zero, so sigmoid(0) = 0.5 cannot leak
// into y'.
//
// head_kernel (float32): R rows a block (ops/cuda/head_kernel.py
// head_fma_plan: 64, fewer above C ~ 440, where u, head and pred of 64 rows
// would not fit a block's shared memory), u, head and the rounded pred in
// shared memory, K rounded up to 4.
//
// head_tc_kernel (bfloat16), mma.sync.m16n8k16 with float32 accumulation
// (csrc/mma.cuh) and the ring of csrc/bottleneck_tc.cuh, 8 warps split 2 x 4
// over m16 and n8 tiles:
//   * the u tile (R rows of C + 8 bf16, cp.async, zero past the last row);
//   * phase 1, head = u . Wh in C/NT column groups, into its own tile (rows
//     of C + 8); phase P, head . Wp over K padded to kHdNp = 32 columns
//     (wpp), whose epilogue stages the float32 pred rows (68 bytes at K=17:
//     unaligned for vector stores) and the rounded pred (rows of 40) where u
//     was; phase 3 (mid stacks), for each column group h2 = head . W2 and,
//     in their own accumulators, hm = round(pred) . W3 (w3p, kHdNp rows),
//     the epilogue reading y from device memory and writing y';
//   * Wh, Wp, W2 and W3 stream from L2 in (CK x NT) slices through ONE
//     cp.async ring of NST stages that runs across the phases, with one
//     barrier per stage; the pred rows go out at the end, coalesced;
//   * the plan (R, CK, NT, NST, the shared-memory bytes) comes from
//     ops/cuda/head_kernel.py head_tc_plan, which the CPU tests check;
//     head_tc_plan_ok says what this kernel takes. At C=256: 64 rows,
//     chunks of 64 in and 128 out, two stages, 102,400 bytes, two blocks an
//     SM, picked by measurement (scripts/torch_port_bneck_tc_ab.py): chunks
//     of 32, 32 rows and one block an SM with four stages ran 1.3x, 1.6x
//     and 1.6x longer;
//   * what holds it (PERF.md): its serial stages, 22 a mid-stack block (12
//     at the last stack) with one block barrier each, as in the bottleneck
//     body; the last-stack head takes 0.55x the mid head's time.
#include "bottleneck_tc.cuh"

namespace spe {

template <typename T, bool MID>
__global__ void __launch_bounds__(kThreads)
head_kernel(const T* __restrict__ u, const T* __restrict__ y,
            const T* __restrict__ wh, const T* __restrict__ wpT,
            const T* __restrict__ w2, const T* __restrict__ w3p,
            const float* __restrict__ vec, float* __restrict__ pred,
            T* __restrict__ ynext, int M, int C, int K, int KP, int R) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using V4 = typename Store<T>::V4;
  T* us = reinterpret_cast<T*>(smem_raw);
  T* hs = us + R * C;
  T* ps = hs + R * C;
  const float* bh = vec;
  const float* ah = vec + C;
  const float* ch = vec + 2 * C;
  const float* b2 = vec + 3 * C;
  const float* b3 = vec + 4 * C;
  const float* bp = vec + 5 * C;
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * R;
  const int C4 = C / 4;

  for (int v = tid; v < R * C4; v += kThreads) {
    const int p = v / C4, c = (v % C4) * 4;
    V4 val{};
    if (r0 + p < M) val = *reinterpret_cast<const V4*>(u + (size_t)(r0 + p) * C + c);
    *reinterpret_cast<V4*>(us + p * C + c) = val;
  }
  __syncthreads();

  const int G = C / kNC, PG = kThreads / G;
  const int cg = tid % G, pg = tid / G, n0 = cg * kNC;

  // head = round(bn(relu(u . Wh + bh)))
  if (pg < PG) {
    for (int base = 0; base < R; base += PG * kNP) {
      float acc[kNP][kNC];
      zero_acc(acc);
      const T* arow[kNP];
#pragma unroll
      for (int i = 0; i < kNP; ++i) {
        const int p = base + pg + PG * i;
        arow[i] = us + (p < R ? p : 0) * C;
      }
      mac_rows<T>(acc, arow, wh, C, n0, C);
#pragma unroll
      for (int i = 0; i < kNP; ++i) {
        const int p = base + pg + PG * i;
        if (p >= R) continue;
#pragma unroll
        for (int j = 0; j < kNC; ++j) {
          const int n = n0 + j;
          hs[p * C + n] =
              Store<T>::from_f(fmaxf(acc[i][j] + bh[n], 0.f) * ah[n] + ch[n]);
        }
      }
    }
  }
  __syncthreads();

  // pred = sigmoid(head . Wp + bp) in float32; its rounded copy feeds hm.
  for (int v = tid; v < R * KP; v += kThreads) {
    const int p = v / KP, k = v % KP;
    float pr = 0.f;
    if (k < K) {
      float z = 0.f;
      for (int c = 0; c < C; c += 4) {
        float a[4], w[4];
        Store<T>::load4(hs + p * C + c, a);
        Store<T>::load4(wpT + (size_t)k * C + c, w);
#pragma unroll
        for (int q = 0; q < 4; ++q) z = fmaf(a[q], w[q], z);
      }
      pr = 1.f / (1.f + expf(-(z + bp[k])));
      if (r0 + p < M) pred[(size_t)(r0 + p) * K + k] = pr;
    }
    ps[p * KP + k] = Store<T>::from_f(pr);
  }

  if (!MID) return;
  __syncthreads();

  // y' = round(round(h2 + hm) + y)
  if (pg < PG) {
    for (int base = 0; base < R; base += PG * kNP) {
      float ah2[kNP][kNC], ahm[kNP][kNC];
      zero_acc(ah2);
      zero_acc(ahm);
      const T* hrow[kNP];
      const T* prow[kNP];
#pragma unroll
      for (int i = 0; i < kNP; ++i) {
        const int p = base + pg + PG * i;
        const int pp = p < R ? p : 0;
        hrow[i] = hs + pp * C;
        prow[i] = ps + pp * KP;
      }
      mac_rows<T>(ah2, hrow, w2, C, n0, C);
      mac_rows<T>(ahm, prow, w3p, C, n0, KP);
#pragma unroll
      for (int i = 0; i < kNP; ++i) {
        const int p = base + pg + PG * i;
        if (p >= R || r0 + p >= M) continue;
        const size_t o = (size_t)(r0 + p) * C;
#pragma unroll
        for (int j = 0; j < kNC; ++j) {
          const int n = n0 + j;
          const float h2 = round_st<T>(ah2[i][j] + b2[n]);
          const float hm = round_st<T>(ahm[i][j] + b3[n]);
          const float s = round_st<T>(h2 + hm);
          ynext[o + n] = Store<T>::from_f(s + Store<T>::to_f(y[o + n]));
        }
      }
    }
  }
}

template <typename T, bool MID>
cudaError_t launch_head(const void* u, const void* y, const void* wh,
                        const void* wpT, const void* w2, const void* w3p,
                        const void* vec, void* pred, void* ynext, int M, int C,
                        int K, int R, cudaStream_t stream) {
  if (R < 1 || R > 64) return cudaErrorInvalidValue;
  const int KP = (K + 3) / 4 * 4;
  const size_t smem = ((size_t)2 * R * C + (size_t)R * KP) * sizeof(T);
  auto kernel = head_kernel<T, MID>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (M + R - 1) / R;
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(y),
      static_cast<const T*>(wh), static_cast<const T*>(wpT),
      static_cast<const T*>(w2), static_cast<const T*>(w3p),
      static_cast<const float*>(vec), static_cast<float*>(pred),
      static_cast<T*>(ynext), M, C, K, KP, R);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores.
// ---------------------------------------------------------------------------

constexpr int kHdNp = 32;   // pred columns (K padded), and W3's rows
constexpr int kHdMw = 2;    // m16 tiles of one warp, at most (R <= 64)

// Bytes of the pred stage: R rows of K floats, rounded up to 16 bytes.
__host__ __device__ inline size_t head_tc_pred_bytes(int R, int K) {
  return ((size_t)R * K * 4 + 15) / 16 * 16;
}

// Bytes of shared memory of one block of R rows (ops/cuda/head_kernel.py
// _head_tc_smem): the u tile, which the pred stage and the rounded pred
// (rows of kHdNp + 8) replace after phase 1; the head tile; the ring.
__host__ __device__ inline size_t head_tc_smem(int R, int C, int K, int CK,
                                               int NT, int NST) {
  size_t regU = (size_t)R * (C + 8) * 2;
  const size_t regP = head_tc_pred_bytes(R, K) + (size_t)R * (kHdNp + 8) * 2;
  if (regP > regU) regU = regP;
  return regU + (size_t)R * (C + 8) * 2 + (size_t)NST * CK * (NT + 8) * 2;
}

// What head_tc_kernel takes: C a multiple of 32, 1 <= K <= kHdNp; R = 16,
// 32 or 64 rows; CK a multiple of 16 from 32 (W3's kHdNp rows fill one
// ring slot) to 64 and NT a multiple of 32 up to 128, both dividing C; NST
// 2..4; smem enough for the block.
__host__ inline bool head_tc_plan_ok(int C, int K, int R, int CK, int NT,
                                     int NST, size_t smem) {
  if (C % 32 || C < 32 || K < 1 || K > kHdNp || R % 16 || R < 16 || R > 64 ||
      CK % 16 || CK < kHdNp || CK > 64 || C % CK || NT % 32 || NT > 128 ||
      C % NT || NST < 2 || NST > 4)
    return false;
  return smem >= head_tc_smem(R, C, K, CK, NT, NST);
}

template <bool MID>
__global__ void __launch_bounds__(kThreads, 2)
head_tc_kernel(const bf16* __restrict__ u, const bf16* __restrict__ y,
               const bf16* __restrict__ wh, const bf16* __restrict__ wpp,
               const bf16* __restrict__ w2, const bf16* __restrict__ w3p,
               const float* __restrict__ vec, float* __restrict__ pred,
               bf16* __restrict__ ynext, int M, int C, int K, int R, int CK,
               int NT, int NST) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int SU = C + 8, SP = kHdNp + 8, SR = NT + 8;
  size_t regU = (size_t)R * SU * 2;
  const size_t pbytes = head_tc_pred_bytes(R, K);
  if (pbytes + (size_t)R * SP * 2 > regU) regU = pbytes + (size_t)R * SP * 2;
  bf16* us = reinterpret_cast<bf16*>(smem_raw);          // phase 1: u
  float* pst = reinterpret_cast<float*>(smem_raw);       // then: pred rows
  bf16* pb = reinterpret_cast<bf16*>(smem_raw + pbytes); // and round(pred)
  bf16* hs = reinterpret_cast<bf16*>(smem_raw + regU);   // head
  bf16* ring = hs + (size_t)R * SU;
  const float* bh = vec;
  const float* ah = vec + C;
  const float* chv = vec + 2 * C;
  const float* b2 = vec + 3 * C;
  const float* b3 = vec + 4 * C;
  const float* bp = vec + 5 * C;
  const int tid = threadIdx.x, lane = tid & 31;
  const int r0 = blockIdx.x * R;

  // Phase 0: the u rows, zeros past the last row, as one commit group.
  {
    const int c8 = C / 8;
    for (int v = tid; v < R * c8; v += kThreads) {
      const int q = v / c8, c = (v % c8) * 8;
      const bool in = r0 + q < M;
      mma::cp_async16_zfill(mma::smem_u32(us + (size_t)q * SU + c),
                            u + (size_t)(in ? r0 + q : 0) * C + c, in);
    }
    mma::cp_async_commit();
  }

  // The stage sequence: phase 1 runs C/NT column groups of C/CK stages of
  // Wh, phase P C/CK stages of wpp (kHdNp columns), phase 3 (mid stacks)
  // C/NT column groups of C/CK stages of W2 and one of W3 (kHdNp rows).
  const int K1 = C / CK, NG = C / NT;
  const int S1n = NG * K1, SPn = K1;
  const int S = S1n + SPn + (MID ? NG * (K1 + 1) : 0);
  auto issue = [&](int s) {
    if (s < S) {
      const bf16* src;
      int ld, rows = CK, cols = NT;
      if (s < S1n) {
        src = wh + (size_t)(s % K1) * CK * C + (s / K1) * NT;
        ld = C;
      } else if (s < S1n + SPn) {
        src = wpp + (size_t)(s - S1n) * CK * kHdNp;
        ld = kHdNp, cols = kHdNp;
      } else {
        const int s3 = s - S1n - SPn, nc = s3 / (K1 + 1), j = s3 % (K1 + 1);
        ld = C;
        if (j < K1) {
          src = w2 + (size_t)j * CK * C + nc * NT;
        } else {
          src = w3p + nc * NT;
          rows = kHdNp;
        }
      }
      bf16* dst = ring + (size_t)(s % NST) * CK * SR;
      const int per_row = cols / 8;
      for (int v = tid; v < rows * per_row; v += kThreads) {
        const int r = v / per_row, c = (v % per_row) * 8;
        mma::cp_async16(mma::smem_u32(dst + r * SR + c), src + (size_t)r * ld + c);
      }
    }
    mma::cp_async_commit();
  };
  for (int s = 0; s < NST - 1; ++s) issue(s);

  // Each warp's part of the products (the same m16 tiles in every phase)
  // and its lanes' ldmatrix rows.
  const int MT = R / 16;
  const WarpPart wpn = warp_part(MT, NT), wpk = warp_part(MT, kHdNp);
  const int lrow = lane & 15, lcol = (lane >> 4) * 8;
  uint32_t au[kHdMw], ahd[kHdMw], apd[kHdMw];
#pragma unroll
  for (int mt = 0; mt < kHdMw; ++mt) {
    const int p = min((wpn.m0 + mt) * 16 + lrow, R - 1);
    au[mt] = mma::smem_u32(us + (size_t)p * SU + lcol);
    ahd[mt] = mma::smem_u32(hs + (size_t)p * SU + lcol);
    apd[mt] = mma::smem_u32(pb + (size_t)p * SP + lcol);
  }
  const int SRB = SR * 2;
  const uint32_t ring0 = mma::smem_u32(ring);
  const int lr = lane >> 2, lc = 2 * (lane & 3);  // fragment row, column

  float acc[kHdMw][kBtNw][4], acc2[kHdMw][kBtNw][4];
  for (int s = 0; s < S; ++s) {
    mma::cp_async_wait_n(NST - 2);  // stage s (and the u rows) has landed
    // Stage s is visible; every warp is done with stage s - 1, whose ring
    // slot stage s + NST - 1 takes, and with the last epilogue's writes.
    __syncthreads();
    issue(s + NST - 1);

    int phase, nc, j, jn;
    if (s < S1n) {
      phase = 1, nc = s / K1, j = s % K1, jn = K1;
    } else if (s < S1n + SPn) {
      phase = 2, nc = 0, j = s - S1n, jn = K1;
    } else {
      const int s3 = s - S1n - SPn;
      phase = 3, nc = s3 / (K1 + 1), j = s3 % (K1 + 1), jn = K1 + 1;
    }
    const WarpPart w = phase == 2 ? wpk : wpn;  // a copy: no local memory
    if (w.mcount == 0) continue;
    const bool thin = phase == 3 && j == K1;  // the W3 stage, into acc2
    if (j == 0 || thin) {
#pragma unroll
      for (int mt = 0; mt < kHdMw; ++mt)
#pragma unroll
        for (int jj = 0; jj < kBtNw; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (thin)
              acc2[mt][jj][e] = 0.f;
            else
              acc[mt][jj][e] = 0.f;
          }
    }
    uint32_t a[kHdMw];
#pragma unroll
    for (int mt = 0; mt < kHdMw; ++mt)
      a[mt] = thin ? apd[mt] : (phase == 1 ? au[mt] : ahd[mt]) + j * CK * 2;
    const uint32_t bb = ring0 + (s % NST) * CK * SRB + lrow * SRB +
                        (w.nbase + lcol) * 2;
    if (thin)
      tc_stage(acc2, a, w, bb, kHdNp, SRB);
    else
      tc_stage(acc, a, w, bb, CK, SRB);
    if (j != jn - 1) continue;

    // The epilogue of column group nc: row (mt, h) of this lane is
    // (m0 + mt) * 16 + h * 8 + lane / 4, its columns n and n + 1.
#pragma unroll
    for (int mt = 0; mt < kHdMw; ++mt) {
      if (mt >= w.mcount) break;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = (w.m0 + mt) * 16 + h * 8 + lr;
#pragma unroll
        for (int jj = 0; jj < kBtNw; ++jj) {
          if (jj >= w.nw) break;
          const int n = nc * NT + w.nbase + jj * 8 + lc;
          if (phase == 1) {
            float t[2];
#pragma unroll
            for (int e = 0; e < 2; ++e)
              t[e] = bn_relu(acc[mt][jj][2 * h + e], bh[n + e], ah[n + e],
                             chv[n + e]);
            *reinterpret_cast<uint32_t*>(hs + (size_t)r * SU + n) =
                mma::pack_bf16(t[0], t[1]);
          } else if (phase == 2) {
            float pr[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              pr[e] = 0.f;
              if (n + e < K) {
                const float z = __fadd_rn(acc[mt][jj][2 * h + e], bp[n + e]);
                pr[e] = 1.f / (1.f + expf(-z));
                pst[r * K + n + e] = pr[e];
              }
            }
            *reinterpret_cast<uint32_t*>(pb + (size_t)r * SP + n) =
                mma::pack_bf16(pr[0], pr[1]);
          } else {
            if (r0 + r >= M) continue;
            const size_t o = (size_t)(r0 + r) * C + n;
            const uint32_t yw = *reinterpret_cast<const uint32_t*>(y + o);
            const float yv[2] = {bf_lo16(yw), bf_hi16(yw)};
            float v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float h2 =
                  round_st<bf16>(__fadd_rn(acc[mt][jj][2 * h + e], b2[n + e]));
              const float hm =
                  round_st<bf16>(__fadd_rn(acc2[mt][jj][2 * h + e], b3[n + e]));
              v[e] = __fadd_rn(round_st<bf16>(__fadd_rn(h2, hm)), yv[e]);
            }
            *reinterpret_cast<uint32_t*>(ynext + o) = mma::pack_bf16(v[0], v[1]);
          }
        }
      }
    }
  }

  // The staged pred rows of this block are one contiguous run of pred:
  // 16-byte stores from a 16-byte aligned start (r0 * K is a multiple of 16).
  __syncthreads();
  const int rows = M - r0 < R ? M - r0 : R;
  const int nv = rows * K, n4 = nv / 4;
  float* dst = pred + (size_t)r0 * K;
  for (int v = tid; v < n4; v += kThreads)
    reinterpret_cast<float4*>(dst)[v] = reinterpret_cast<const float4*>(pst)[v];
  for (int v = n4 * 4 + tid; v < nv; v += kThreads) dst[v] = pst[v];
}

template <bool MID>
cudaError_t launch_head_tc(const void* u, const void* y, const void* wh,
                           const void* wpp, const void* w2, const void* w3p,
                           const void* vec, void* pred, void* ynext, int M,
                           int C, int K, int R, int CK, int NT, int NST,
                           size_t smem, cudaStream_t stream) {
  if (!head_tc_plan_ok(C, K, R, CK, NT, NST, smem))
    return cudaErrorInvalidValue;
  auto kernel = head_tc_kernel<MID>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (M + R - 1) / R;
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const bf16*>(u), static_cast<const bf16*>(y),
      static_cast<const bf16*>(wh), static_cast<const bf16*>(wpp),
      static_cast<const bf16*>(w2), static_cast<const bf16*>(w3p),
      static_cast<const float*>(vec), static_cast<float*>(pred),
      static_cast<bf16*>(ynext), M, C, K, R, CK, NT, NST);
  return cudaGetLastError();
}

}  // namespace spe

// mid: 1 for a stack with next-stack glue (y, w2, w3p, ynext used), 0 for
// the last stack. M = B*H*W pixel rows, R rows a block (head_fma_plan).
// float32 storage (bfloat16 runs spe_head_tc: bf16 = 1 is refused).
// Returns cudaGetLastError().
extern "C" int spe_head(int mid, int bf16, const void* u, const void* y,
                        const void* wh, const void* wpT, const void* w2,
                        const void* w3p, const void* vec, void* pred,
                        void* ynext, int M, int C, int K, int R,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return (int)cudaErrorInvalidValue;
  if (mid)
    return (int)spe::launch_head<float, true>(u, y, wh, wpT, w2, w3p, vec, pred, ynext, M, C, K, R, s);
  return (int)spe::launch_head<float, false>(u, y, wh, wpT, w2, w3p, vec, pred, ynext, M, C, K, R, s);
}

// The same in bfloat16 on the tensor cores, with the plan of head_tc_plan:
// rows, ck, nt, nst, smem bytes. wpp is Wp (C, 32) and w3p W3 (32, C), both
// zero-padded.
extern "C" int spe_head_tc(int mid, const void* u, const void* y,
                           const void* wh, const void* wpp, const void* w2,
                           const void* w3p, const void* vec, void* pred,
                           void* ynext, int M, int C, int K, int rows, int ck,
                           int nt, int nst, int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mid)
    return (int)spe::launch_head_tc<true>(u, y, wh, wpp, w2, w3p, vec, pred, ynext, M, C, K, rows, ck, nt, nst, smem, s);
  return (int)spe::launch_head_tc<false>(u, y, wh, wpp, w2, w3p, vec, pred, ynext, M, C, K, rows, ck, nt, nst, smem, s);
}
