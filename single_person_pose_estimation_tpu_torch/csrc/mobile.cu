// Fused identity-skip MOBILE (separable-conv) hourglass bottleneck for
// inference, three epilogues:
//
//   t1  = bn1(relu(x . W1' + b1))             W1' = dw1[:, None] * pw1, C -> Cm
//   a   = round(sum over 9 taps of t1 shifted * d2[tap])   3x3 depthwise, f32
//   t2  = bn2(relu(a . pw2 + b2))             Cm -> Cm
//   t3  = bn3(relu(t2 . W3' + b3))            W3' = dw3[:, None] * pw3, Cm -> C
//   kMobPlain: out = x + t3                   (f32 add, one rounding)
//   kMobPool:  out as kMobPlain, pooled = maxpool2x2(out)
//   kMobUpAdd: d = round(x + t3), out = round(d + up2x(u_lo))
//
// Replaces the TPU kernels single_person_pose_estimation_tpu/ops/pallas/
// mobile_kernel.py:fused_bottleneck_mobile (kMobPlain),
// :fused_bottleneck_mobile_pool (kMobPool) and, as the first of two
// launches, :fused_uplevel_mobile (kMobUpAdd with the short weights; the
// second launch is kMobPlain with the merged weights on the sum), as
// bottleneck.cu serves the standard up-level. The 1x1 depthwise scales are
// folded into W1' and W3' once, at prepare time (ops/cuda/mobile_kernel.py
// MobileParams.pack); the 3x3 taps d2 stay float32 and the depthwise sum is
// rounded to the storage type before pw2, as the TPU kernel does.
//
// Bound on the H100: at the 64 px level (C=256, Cm=128) one bottleneck is
// ~166 kFLOP per pixel against 1 KB of HBM traffic per pixel (x in, out
// back, bf16), ~160 FLOP/byte: below the bf16 tensor-core ridge (~295), so
// HBM bounds the ideal kernel. In bfloat16 the three pointwise products run
// on the tensor cores, in the shared body of bottleneck_tc.cuh with its
// mobile phase 2 (mobile_tc_kernel, the plan of ops/cuda/mobile_kernel.py
// mobile_tc_plan); the body is held by its serial stages and barriers,
// not by HBM (PERF.md). In float32 they run as FMA on the CUDA cores
// (mobile_kernel), bound by the FMA rate and by shared-memory reads.
//
// Design of the float32 kernel: bottleneck.cu's. One block takes one TS x
// TS output tile (TS from ops/cuda/bottleneck_kernel.py fma_tile_plan: 8,
// or 4 above C=384, where an 8 x 8 tile's halo would not fit a block's
// shared memory; the whole map when smaller) of one image. It loads x over
// a one-pixel halo, recomputes t1 on the halo (ZERO outside the image: the
// reference pads t1, not x), and keeps t1, the depthwise sum and t2 in
// shared memory. The depthwise step is 9 per-channel multiply-adds with
// separately rounded float32 operations, in the TPU kernel's tap order.
// Nothing is allocated here; the wrapper allocates the outputs.
#include "bottleneck_tc.cuh"

namespace spe {

enum MobileMode { kMobPlain = 0, kMobPool = 1, kMobUpAdd = 2 };

// One bottleneck's operands: W1' (C, Cm), d2 (9, Cm) float32, pw2 (Cm, Cm),
// W3' (Cm, C); vec float32 [b1, a1, c1, b2, a2, c2] (Cm each) then
// [b3, a3, c3] (C each).
template <typename T>
struct MobileW {
  const T* w1;
  const float* d2;
  const T* w2;
  const T* w3;
  const float* vec;
};

// out[q][n] = sum_k A[q][k] * w[k][n] for q in [0, npix), n in [0, N):
// epi(q, n, sum) receives each sum. row(q) points at A's row q (K values in
// shared memory). Threads take kNC consecutive channels and kNP pixels.
template <typename T, typename Row, typename Epi>
__device__ __forceinline__ void pointwise(int npix, int N, int K,
                                          const T* __restrict__ w, Row row,
                                          Epi epi) {
  const int G = N / kNC, PG = kThreads / G;
  const int tid = threadIdx.x, cg = tid % G, pg = tid / G, n0 = cg * kNC;
  if (pg >= PG) return;
  for (int base = 0; base < npix; base += PG * kNP) {
    float acc[kNP][kNC];
    zero_acc(acc);
    const T* arow[kNP];
#pragma unroll
    for (int i = 0; i < kNP; ++i) {
      const int q = base + pg + PG * i;
      arow[i] = row(q < npix ? q : 0);
    }
    mac_rows<T>(acc, arow, w, N, n0, K);
#pragma unroll
    for (int i = 0; i < kNP; ++i) {
      const int q = base + pg + PG * i;
      if (q >= npix) continue;
#pragma unroll
      for (int j = 0; j < kNC; ++j) epi(q, n0 + j, acc[i][j]);
    }
  }
}

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
mobile_kernel(const T* __restrict__ x, const T* __restrict__ ulo,
              MobileW<T> P, T* __restrict__ out, T* __restrict__ pooled,
              int H, int W, int C, int Cm, int TH, int TW, int tiles_x) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int IW = TW + 2, NI = (TH + 2) * IW, NO = TH * TW;
  // A: x on the halo, then the depthwise sums, then (kMobPool) the out
  // tile. Tt: t1 on the halo, then t2.
  T* A = reinterpret_cast<T*>(smem_raw);
  T* Tt = A + (size_t)NI * C;

  const int b = blockIdx.y;
  const int ty0 = (blockIdx.x / tiles_x) * TH;
  const int tx0 = (blockIdx.x % tiles_x) * TW;
  const float* b1 = P.vec;
  const float* a1 = b1 + Cm;
  const float* c1 = a1 + Cm;
  const float* b2 = c1 + Cm;
  const float* a2 = b2 + Cm;
  const float* c2 = a2 + Cm;
  const float* b3 = c2 + Cm;
  const float* a3 = b3 + C;
  const float* c3 = a3 + C;

  // x over the halo into shared memory, zeros outside the image.
  load_region<T>(A, x + (size_t)b * H * W * C, ty0 - 1, tx0 - 1, TH + 2,
                 IW, H, W, C);
  __syncthreads();

  // t1 on the halo, zero outside the image.
  pointwise<T>(NI, Cm, C, P.w1, [&](int q) { return A + (size_t)q * C; },
               [&](int q, int n, float acc) {
                 const int iy = ty0 - 1 + q / IW, ix = tx0 - 1 + q % IW;
                 const bool inside = iy >= 0 && iy < H && ix >= 0 && ix < W;
                 const float t = fmaxf(acc + b1[n], 0.f) * a1[n] + c1[n];
                 Tt[(size_t)q * Cm + n] = Store<T>::from_f(inside ? t : 0.f);
               });
  __syncthreads();

  // 3x3 depthwise: per channel, taps in row-major order, each product and
  // sum rounded on its own (no FMA contraction), then rounded to T. The
  // sums overwrite x in A (dead since the t1 product).
  for (int v = threadIdx.x; v < NO * Cm; v += kThreads) {
    const int n = v % Cm, p = v / Cm, py = p / TW, px = p % TW;
    float acc = 0.f;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int q = (py + tap / 3) * IW + px + tap % 3;
      acc = __fadd_rn(acc, __fmul_rn(Store<T>::to_f(Tt[(size_t)q * Cm + n]),
                                     P.d2[tap * Cm + n]));
    }
    A[(size_t)p * Cm + n] = Store<T>::from_f(acc);
  }
  __syncthreads();

  // t2 overwrites t1 (dead since the depthwise step).
  pointwise<T>(NO, Cm, Cm, P.w2, [&](int p) { return A + (size_t)p * Cm; },
               [&](int p, int n, float acc) {
                 const float t = fmaxf(acc + b2[n], 0.f) * a2[n] + c2[n];
                 Tt[(size_t)p * Cm + n] = Store<T>::from_f(t);
               });
  __syncthreads();

  // t3 and the epilogue; kMobPool keeps the out tile in A (the depthwise
  // sums there are dead since the t2 product).
  pointwise<T>(
      NO, C, Cm, P.w3, [&](int p) { return Tt + (size_t)p * Cm; },
      [&](int p, int n, float acc) {
        const float t3 = fmaxf(acc + b3[n], 0.f) * a3[n] + c3[n];
        const int gy = ty0 + p / TW, gx = tx0 + p % TW;
        if (gy >= H || gx >= W) return;
        const size_t o = (((size_t)b * H + gy) * W + gx) * C + n;
        const float xv = Store<T>::to_f(x[o]);
        if (MODE == kMobUpAdd) {
          const float d = round_st<T>(xv + t3);
          const size_t u =
              (((size_t)b * (H / 2) + gy / 2) * (W / 2) + gx / 2) * C + n;
          out[o] = Store<T>::from_f(d + Store<T>::to_f(ulo[u]));
        } else {
          const T r = Store<T>::from_f(xv + t3);
          out[o] = r;
          if (MODE == kMobPool) A[(size_t)p * C + n] = r;
        }
      });

  if (MODE == kMobPool) {
    // Each block pools its own 2x2 windows: TH and TW are even.
    __syncthreads();
    pool_tile<T>(A, pooled, b, ty0, tx0, TH, TW, H, W, C);
  }
}

template <typename T, int MODE>
cudaError_t launch_mobile(const void* x, const void* ulo, MobileW<T> P,
                          void* out, void* pooled, int B, int H, int W, int C,
                          int Cm, int ts, cudaStream_t stream) {
  if (ts < 2 || ts > 8 || ts % 2) return cudaErrorInvalidValue;
  const int TH = H < ts ? H : ts, TW = W < ts ? W : ts;
  const int tiles_y = (H + TH - 1) / TH, tiles_x = (W + TW - 1) / TW;
  // A holds x on the halo (the larger of it, the depthwise sums and the
  // out tile); Tt holds t1 on the halo.
  const size_t NI = (size_t)(TH + 2) * (TW + 2);
  const size_t smem = NI * (C + Cm) * sizeof(T);
  auto kernel = mobile_kernel<T, MODE>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(tiles_y * tiles_x, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(ulo), P,
      static_cast<T*>(out), static_cast<T*>(pooled), H, W, C, Cm, TH, TW,
      tiles_x);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_mobile(int mode, const void* x, const void* ulo,
                            MobileW<T> P, void* out, void* pooled, int B,
                            int H, int W, int C, int Cm, int ts,
                            cudaStream_t s) {
  switch (mode) {
    case kMobPlain:
      return launch_mobile<T, kMobPlain>(x, ulo, P, out, pooled, B, H, W, C, Cm, ts, s);
    case kMobPool:
      return launch_mobile<T, kMobPool>(x, ulo, P, out, pooled, B, H, W, C, Cm, ts, s);
    case kMobUpAdd:
      return launch_mobile<T, kMobUpAdd>(x, ulo, P, out, pooled, B, H, W, C, Cm, ts, s);
  }
  return cudaErrorInvalidValue;
}

// The bf16 mobile bottleneck on the tensor cores: one tile (the plan's TSH
// x TSW, clipped to the map) per block, the body of bottleneck_tc.cuh with
// MOB = true. MODE is the body's epilogue: kPlain (kMobPlain), kPlainPool
// (kMobPool) or kUpAdd (kMobUpAdd).
template <int MODE, int MW>
__global__ void __launch_bounds__(kThreads, MW <= 4 ? 2 : 1)
mobile_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                 const float* __restrict__ d2, const bf16* __restrict__ w2,
                 const bf16* __restrict__ w3, const float* __restrict__ vec,
                 bf16* __restrict__ out, bf16* __restrict__ pooled,
                 const bf16* __restrict__ ulo, int H, int W, int C, int Cm,
                 int TH, int TW, int tiles_x, int CK, int NT, int NST) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bneck_tile_tc<MODE, MW, true>(smem_raw, x, w1, w2, w3, vec, out, pooled,
                                ulo, blockIdx.y, (blockIdx.x / tiles_x) * TH,
                                (blockIdx.x % tiles_x) * TW, H, W, C, Cm, TH,
                                TW, CK, NT, NST, d2);
}

template <int MODE, int MW>
cudaError_t launch_mobile_tc_mw(const void* x, const void* ulo,
                                MobileW<bf16> P, void* out, void* pooled,
                                int B, int H, int W, int C, int Cm, int TH,
                                int TW, int CK, int NT, int NST, size_t smem,
                                cudaStream_t stream) {
  const int tiles_y = (H + TH - 1) / TH, tiles_x = (W + TW - 1) / TW;
  auto kernel = mobile_tc_kernel<MODE, MW>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(tiles_y * tiles_x, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), P.w1, P.d2, P.w2, P.w3, P.vec,
      static_cast<bf16*>(out), static_cast<bf16*>(pooled),
      static_cast<const bf16*>(ulo), H, W, C, Cm, TH, TW, tiles_x, CK, NT,
      NST);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_mobile_tc(const void* x, const void* ulo, MobileW<bf16> P,
                             void* out, void* pooled, int B, int H, int W,
                             int C, int Cm, int TSH, int TSW, int CK, int NT,
                             int NST, size_t smem, cudaStream_t stream) {
  const int TH = H < TSH ? H : TSH, TW = W < TSW ? W : TSW;
  if (!bneck_tc_plan_ok(C, Cm, TH, TW, CK, NT, NST, smem, pools<MODE>()))
    return cudaErrorInvalidValue;
  if (bneck_tc_mw(TH, TW, NT) <= 4)
    return launch_mobile_tc_mw<MODE, 4>(x, ulo, P, out, pooled, B, H, W, C,
                                        Cm, TH, TW, CK, NT, NST, smem, stream);
  return launch_mobile_tc_mw<MODE, kBtMaxMw>(x, ulo, P, out, pooled, B, H, W,
                                             C, Cm, TH, TW, CK, NT, NST, smem,
                                             stream);
}

template <typename T>
MobileW<T> weights(const void* w1, const void* d2, const void* w2,
                   const void* w3, const void* vec) {
  return MobileW<T>{static_cast<const T*>(w1), static_cast<const float*>(d2),
                    static_cast<const T*>(w2), static_cast<const T*>(w3),
                    static_cast<const float*>(vec)};
}

}  // namespace spe

// mode: 0 plain, 1 pool, 2 up-add; float32 storage (bfloat16 runs
// spe_mobile_tc: bf16 = 1 is refused), ts x ts tiles (fma_tile_plan). The
// operands come as (W1', d2, pw2, W3', vec); ulo is read by the up-add
// only. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int spe_mobile(int mode, int bf16, const void* x, const void* ulo,
                          const void* w1, const void* d2, const void* w2,
                          const void* w3, const void* vec, void* out,
                          void* pooled, int B, int H, int W, int C, int Cm,
                          int ts, void* stream) {
  if (bf16) return (int)cudaErrorInvalidValue;
  return (int)spe::dispatch_mobile<float>(
      mode, x, ulo, spe::weights<float>(w1, d2, w2, w3, vec), out, pooled, B,
      H, W, C, Cm, ts, static_cast<cudaStream_t>(stream));
}

// The same in bfloat16 on the tensor cores, with the plan of
// mobile_tc_plan: tile tsh x tsw, input chunk ck, output chunk nt, ring
// stages nst, smem bytes.
extern "C" int spe_mobile_tc(int mode, const void* x, const void* ulo,
                             const void* w1, const void* d2, const void* w2,
                             const void* w3, const void* vec, void* out,
                             void* pooled, int B, int H, int W, int C, int Cm,
                             int tsh, int tsw, int ck, int nt, int nst,
                             int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const spe::MobileW<spe::bf16> P =
      spe::weights<spe::bf16>(w1, d2, w2, w3, vec);
  switch (mode) {
    case spe::kMobPlain:
      return (int)spe::launch_mobile_tc<spe::kPlain>(x, ulo, P, out, pooled, B, H, W, C, Cm, tsh, tsw, ck, nt, nst, smem, s);
    case spe::kMobPool:
      return (int)spe::launch_mobile_tc<spe::kPlainPool>(x, ulo, P, out, pooled, B, H, W, C, Cm, tsh, tsw, ck, nt, nst, smem, s);
    case spe::kMobUpAdd:
      return (int)spe::launch_mobile_tc<spe::kUpAdd>(x, ulo, P, out, pooled, B, H, W, C, Cm, tsh, tsw, ck, nt, nst, smem, s);
  }
  return (int)cudaErrorInvalidValue;
}
