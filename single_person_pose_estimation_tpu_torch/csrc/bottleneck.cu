// Fused hourglass bottlenecks for inference: the identity-skip bottleneck
// with three epilogues (bottleneck.cuh says what each computes), and the
// conv-skip bottleneck of the front module:
//
//   kPlain:   out = x + t3                  (f32 add, one rounding)
//   kPool:    out = x + round(t3), pooled = maxpool2x2(out)
//   kUpAdd:   d = round(x + t3), out = round(d + up2x(u_lo))
//   convskip: skip = round(relu(x . Ws + bs)), x (Cin) -> C
//             out = round(skip + round(t3)) (an add in the STORAGE dtype of
//             two rounded operands, not kPlain's f32 add of x + t3; at f32
//             the two agree, so only a bf16 check can tell them apart)
//
// Replaces the TPU kernels single_person_pose_estimation_tpu/ops/pallas/
// bottleneck_kernel.py:fused_bottleneck (kPlain), :fused_bottleneck_pool
// (kPool), :fused_bottleneck_rows (kPlain; see below), :fused_bottleneck_
// convskip (convskip_tc_kernel; float32: convskip_kernel) and, as the first
// of two launches, uplevel_kernel.py:fused_uplevel (kUpAdd; the second
// launch is kPlain on the sum).
//
// Bound on the H100: at the 64 px level (C=256, Cm=128) a bottleneck is
// 1.74 GFLOP per image against 4 MB of HBM traffic (x in, out back, bf16),
// ~430 FLOP/byte, so the tensor math bounds it, not HBM. The conv skip at
// 64 px (128 -> 256, Cm=128) is 1.88 GFLOP per image against 3 MB, ~620
// FLOP/byte: also the math. In bfloat16 both run that math on the tensor
// cores (bneck_tc_kernel and convskip_tc_kernel, the body of
// bottleneck_tc.cuh); in float32 they run as FMA on the CUDA cores
// (bottleneck_kernel, convskip_kernel), bound by the FMA rate and by
// shared-memory reads of t1/t2.
//
// Design: the TPU kernel holds a whole 64x64x256 map per image in VMEM; an
// SM block holds at most 227 KB, so each block takes one TH x TW output tile
// of one image: on the FMA body a TS x TS tile (the whole map when
// smaller), TS from ops/cuda/bottleneck_kernel.py fma_tile_plan, 8 up to
// C=384 in float32 and smaller above, where an 8 x 8 tile's halo would not
// fit (4 x 4 takes 216 bytes a channel in float32, up to C=1024); on the
// tensor-core body the tile of bneck_tc_plan (convskip_tc_plan for the
// conv skip). It loads x over a one-pixel halo, recomputes t1 on the
// (TH+2)x(TW+2) halo (t1 is forced to ZERO outside the image: the
// reference pads t1, not x), keeps t1 and t2 in shared memory and writes
// only the outputs. Weights stream from L2 (the
// FMA body: coalesced reads; the tensor-core body: a cp.async ring).
// Nothing is allocated here; the wrapper allocates outputs.
//
// fused_bottleneck_rows: the TPU kernel cuts a map taller than 64 rows into
// hb-row strips, each with its two halo rows passed in and t1 zeroed on
// halo rows at the image border, because a whole 128x128x256 map does not
// fit Mosaic's VMEM budget. Its function is kPlain's on a map of any size:
// kPlain already tiles every map in small tiles with a one-pixel halo and t1
// zero outside the image, so the port launches kPlain. The strips do not
// carry over: an hb=64 strip at W=128 with its f32 temporaries is megabytes,
// against 227 KB of shared memory per block. Like kPlain at 64 px, #5 at
// 128 px is bound by its operations (C=256: 2 x 128 x 128 x 213K FLOP per
// image). Every offset into a map is computed in size_t: at B=128, 128 px,
// C=256 a map holds 2^29 values, and B=512 would overflow an int.
//
// The float32 convskip_kernel keeps the Cin-wide x halo apart from t2
// (region A of the identity kernel is overwritten by t2 after phase 1),
// because its phase 3 runs the skip product and the t3 product side by
// side and needs the x of every output pixel: at 4x4 tiles, Cin=128,
// Cm=128 that is (36*128 + 36*128 + 16*128) values, 45 KB. The bf16
// convskip_tc_kernel runs the skip product right after phase 1 instead,
// while the halo is whole, and parks the rounded skip in out
// (bottleneck_tc.cuh says how).
#include "bottleneck_tc.cuh"

namespace spe {

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
bottleneck_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                  const T* __restrict__ w2, const T* __restrict__ w3,
                  const float* __restrict__ vec, T* __restrict__ out,
                  T* __restrict__ pooled, const T* __restrict__ ulo,
                  int H, int W, int C, int Cm, int TH, int TW, int tiles_x) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bneck_tile<T, MODE>(reinterpret_cast<T*>(smem_raw), x, w1, w2, w3, vec,
                      out, pooled, ulo, blockIdx.y,
                      (blockIdx.x / tiles_x) * TH, (blockIdx.x % tiles_x) * TW,
                      H, W, C, Cm, TH, TW);
}

// An FMA tile side: 2, 4 or 8 (even, so that pooling tiles are).
inline bool fma_tile_ok(int ts) { return ts >= 2 && ts <= 8 && ts % 2 == 0; }

template <typename T, int MODE>
cudaError_t launch_bottleneck(const void* x, const void* w1, const void* w2,
                              const void* w3, const void* vec, void* out,
                              void* pooled, const void* ulo, int B, int H,
                              int W, int C, int Cm, int ts,
                              cudaStream_t stream) {
  if (!fma_tile_ok(ts)) return cudaErrorInvalidValue;
  const int TH = H < ts ? H : ts, TW = W < ts ? W : ts;
  const int tiles_y = (H + TH - 1) / TH, tiles_x = (W + TW - 1) / TW;
  const size_t smem =
      tile_smem_elems(TH, TW, C, Cm, pools<MODE>()) * sizeof(T);
  auto kernel = bottleneck_kernel<T, MODE>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(tiles_y * tiles_x, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const T*>(w2), static_cast<const T*>(w3),
      static_cast<const float*>(vec), static_cast<T*>(out),
      static_cast<T*>(pooled), static_cast<const T*>(ulo), H, W, C, Cm, TH, TW,
      tiles_x);
  return cudaGetLastError();
}

// The bf16 body on the tensor cores: one tile (the plan's TSH x TSW,
// clipped to the map) per block, the plan from ops/cuda/bottleneck_kernel.py
// bneck_tc_plan. MW = 4 (tiles up to 8 x 8) runs two blocks an SM within
// 128 registers a thread; MW = 6 (up to 8 x 16) one.
template <int MODE, int MW>
__global__ void __launch_bounds__(kThreads, MW <= 4 ? 2 : 1)
bneck_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                const bf16* __restrict__ w2, const bf16* __restrict__ w3,
                const float* __restrict__ vec, bf16* __restrict__ out,
                bf16* __restrict__ pooled, const bf16* __restrict__ ulo, int H,
                int W, int C, int Cm, int TH, int TW, int tiles_x, int CK,
                int NT, int NST) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bneck_tile_tc<MODE, MW>(smem_raw, x, w1, w2, w3, vec, out, pooled, ulo,
                          blockIdx.y, (blockIdx.x / tiles_x) * TH,
                          (blockIdx.x % tiles_x) * TW, H, W, C, Cm, TH, TW, CK,
                          NT, NST);
}

template <int MODE, int MW>
cudaError_t launch_bneck_tc_mw(const void* x, const void* w1, const void* w2,
                               const void* w3, const void* vec, void* out,
                               void* pooled, const void* ulo, int B, int H,
                               int W, int C, int Cm, int TH, int TW, int CK,
                               int NT, int NST, size_t smem,
                               cudaStream_t stream) {
  const int tiles_y = (H + TH - 1) / TH, tiles_x = (W + TW - 1) / TW;
  auto kernel = bneck_tc_kernel<MODE, MW>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(tiles_y * tiles_x, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
      static_cast<const bf16*>(w2), static_cast<const bf16*>(w3),
      static_cast<const float*>(vec), static_cast<bf16*>(out),
      static_cast<bf16*>(pooled), static_cast<const bf16*>(ulo), H, W, C, Cm,
      TH, TW, tiles_x, CK, NT, NST);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_bneck_tc(const void* x, const void* w1, const void* w2,
                            const void* w3, const void* vec, void* out,
                            void* pooled, const void* ulo, int B, int H, int W,
                            int C, int Cm, int TSH, int TSW, int CK, int NT,
                            int NST, size_t smem, cudaStream_t stream) {
  const int TH = H < TSH ? H : TSH, TW = W < TSW ? W : TSW;
  if (!bneck_tc_plan_ok(C, Cm, TH, TW, CK, NT, NST, smem, pools<MODE>()))
    return cudaErrorInvalidValue;
  if (bneck_tc_mw(TH, TW, NT) <= 4)
    return launch_bneck_tc_mw<MODE, 4>(x, w1, w2, w3, vec, out, pooled, ulo, B,
                                       H, W, C, Cm, TH, TW, CK, NT, NST, smem,
                                       stream);
  return launch_bneck_tc_mw<MODE, kBtMaxMw>(x, w1, w2, w3, vec, out, pooled,
                                            ulo, B, H, W, C, Cm, TH, TW, CK,
                                            NT, NST, smem, stream);
}

template <typename T>
cudaError_t dispatch_mode(int mode, const void* x, const void* w1,
                          const void* w2, const void* w3, const void* vec,
                          void* out, void* pooled, const void* ulo, int B,
                          int H, int W, int C, int Cm, int ts,
                          cudaStream_t s) {
  switch (mode) {
    case kPlain:
      return launch_bottleneck<T, kPlain>(x, w1, w2, w3, vec, out, pooled, ulo, B, H, W, C, Cm, ts, s);
    case kPool:
      return launch_bottleneck<T, kPool>(x, w1, w2, w3, vec, out, pooled, ulo, B, H, W, C, Cm, ts, s);
    case kUpAdd:
      return launch_bottleneck<T, kUpAdd>(x, w1, w2, w3, vec, out, pooled, ulo, B, H, W, C, Cm, ts, s);
  }
  return cudaErrorInvalidValue;
}

// Conv-skip bottleneck in float32 (T = float), x (B, H, W, Cin) -> out (B,
// H, W, C). vec holds [b1 a1 c1 b2 a2 c2] (Cm each), [b3 a3 c3] (C each),
// then bs (C).
template <typename T>
__global__ void __launch_bounds__(kThreads)
convskip_kernel(const T* __restrict__ x, const T* __restrict__ ws,
                const T* __restrict__ w1, const T* __restrict__ w2,
                const T* __restrict__ w3, const float* __restrict__ vec,
                T* __restrict__ out, int H, int W, int Cin, int C, int Cm,
                int TH, int TW, int tiles_x) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int HW2 = (TH + 2) * (TW + 2);
  const int P = TH * TW;
  T* xs = smem;                  // the Cin-wide x halo, kept to the end
  T* t1s = xs + HW2 * Cin;
  T* t2s = t1s + HW2 * Cm;

  const int b = blockIdx.y;
  const int ty0 = (blockIdx.x / tiles_x) * TH;
  const int tx0 = (blockIdx.x % tiles_x) * TW;
  load_region<T>(xs, x + (size_t)b * H * W * Cin, ty0 - 1, tx0 - 1, TH + 2,
                 TW + 2, H, W, Cin);
  __syncthreads();
  tile_t1<T>(xs, t1s, w1, vec, ty0, tx0, TH, TW, H, W, Cin, Cm);
  __syncthreads();
  tile_t2<T>(t1s, t2s, w2, vec, TH, TW, Cm);
  __syncthreads();

  // Phase 3: t3 from t2, the skip from the x centre (N = C).
  const float* b3 = vec + 6 * Cm;
  const float* a3 = b3 + C;
  const float* c3 = b3 + 2 * C;
  const float* bs = b3 + 3 * C;
  const int G = C / kNC, PG = kThreads / G;
  const int tid = threadIdx.x, cg = tid % G, pg = tid / G, n0 = cg * kNC;
  if (pg >= PG) return;
  for (int base = 0; base < P; base += PG * kNP) {
    float acc[kNP][kNC], sacc[kNP][kNC];
    zero_acc(acc);
    zero_acc(sacc);
    const T* trow[kNP];
    const T* xrow[kNP];
#pragma unroll
    for (int i = 0; i < kNP; ++i) {
      const int p = base + pg + PG * i;
      const int pp = p < P ? p : 0;
      trow[i] = t2s + pp * Cm;
      xrow[i] = xs + ((pp / TW + 1) * (TW + 2) + pp % TW + 1) * Cin;
    }
    mac_rows<T>(acc, trow, w3, C, n0, Cm);
    mac_rows<T>(sacc, xrow, ws, C, n0, Cin);
#pragma unroll
    for (int i = 0; i < kNP; ++i) {
      const int p = base + pg + PG * i;
      if (p >= P) continue;
      const int gy = ty0 + p / TW, gx = tx0 + p % TW;
      if (gy >= H || gx >= W) continue;
      const size_t o = (((size_t)b * H + gy) * W + gx) * C;
#pragma unroll
      for (int j = 0; j < kNC; ++j) {
        const int n = n0 + j;
        const float t3 = fmaxf(acc[i][j] + b3[n], 0.f) * a3[n] + c3[n];
        const float skip = fmaxf(sacc[i][j] + bs[n], 0.f);
        out[o + n] = Store<T>::from_f(round_st<T>(skip) + round_st<T>(t3));
      }
    }
  }
}

template <typename T>
cudaError_t launch_convskip(const void* x, const void* ws, const void* w1,
                            const void* w2, const void* w3, const void* vec,
                            void* out, int B, int H, int W, int Cin, int C,
                            int Cm, int ts, cudaStream_t stream) {
  if (!fma_tile_ok(ts)) return cudaErrorInvalidValue;
  const int TH = H < ts ? H : ts, TW = W < ts ? W : ts;
  const int tiles_y = (H + TH - 1) / TH, tiles_x = (W + TW - 1) / TW;
  const size_t HW2 = (size_t)(TH + 2) * (TW + 2), P = (size_t)TH * TW;
  const size_t smem = (HW2 * Cin + HW2 * Cm + P * Cm) * sizeof(T);
  auto kernel = convskip_kernel<T>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(tiles_y * tiles_x, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(ws),
      static_cast<const T*>(w1), static_cast<const T*>(w2),
      static_cast<const T*>(w3), static_cast<const float*>(vec),
      static_cast<T*>(out), H, W, Cin, C, Cm, TH, TW, tiles_x);
  return cudaGetLastError();
}

// The conv-skip bottleneck in bf16 on the tensor cores: one tile of the
// plan of ops/cuda/bottleneck_kernel.py convskip_tc_plan per block. out
// carries no __restrict__: the body writes the rounded skip there and
// reads it back.
template <int MW>
__global__ void __launch_bounds__(kThreads, MW <= 4 ? 2 : 1)
convskip_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ ws,
                   const bf16* __restrict__ w1, const bf16* __restrict__ w2,
                   const bf16* __restrict__ w3, const float* __restrict__ vec,
                   bf16* out, int H, int W, int Cin, int C, int Cm, int TH,
                   int TW, int tiles_x, int CK, int NT, int NST) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bneck_tile_tc<kConvSkip, MW>(smem_raw, x, w1, w2, w3, vec, out, nullptr,
                               nullptr, blockIdx.y,
                               (blockIdx.x / tiles_x) * TH,
                               (blockIdx.x % tiles_x) * TW, H, W, C, Cm, TH,
                               TW, CK, NT, NST, nullptr, ws, Cin);
}

template <int MW>
cudaError_t launch_convskip_tc_mw(const void* x, const void* ws,
                                  const void* w1, const void* w2,
                                  const void* w3, const void* vec, void* out,
                                  int B, int H, int W, int Cin, int C, int Cm,
                                  int TH, int TW, int CK, int NT, int NST,
                                  size_t smem, cudaStream_t stream) {
  const int tiles_y = (H + TH - 1) / TH, tiles_x = (W + TW - 1) / TW;
  auto kernel = convskip_tc_kernel<MW>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(tiles_y * tiles_x, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(ws),
      static_cast<const bf16*>(w1), static_cast<const bf16*>(w2),
      static_cast<const bf16*>(w3), static_cast<const float*>(vec),
      static_cast<bf16*>(out), H, W, Cin, C, Cm, TH, TW, tiles_x, CK, NT, NST);
  return cudaGetLastError();
}

cudaError_t launch_convskip_tc(const void* x, const void* ws, const void* w1,
                               const void* w2, const void* w3,
                               const void* vec, void* out, int B, int H,
                               int W, int Cin, int C, int Cm, int TSH,
                               int TSW, int CK, int NT, int NST, size_t smem,
                               cudaStream_t stream) {
  const int TH = H < TSH ? H : TSH, TW = W < TSW ? W : TSW;
  if (Cin < 16 ||
      !bneck_tc_plan_ok(C, Cm, TH, TW, CK, NT, NST, smem, false, Cin))
    return cudaErrorInvalidValue;
  if (bneck_tc_mw(TH, TW, NT) <= 4)
    return launch_convskip_tc_mw<4>(x, ws, w1, w2, w3, vec, out, B, H, W,
                                    Cin, C, Cm, TH, TW, CK, NT, NST, smem,
                                    stream);
  return launch_convskip_tc_mw<kBtMaxMw>(x, ws, w1, w2, w3, vec, out, B, H,
                                         W, Cin, C, Cm, TH, TW, CK, NT, NST,
                                         smem, stream);
}

}  // namespace spe

// mode: 0 plain, 1 pool, 2 up-add; float32 storage (bfloat16 runs
// spe_bottleneck_tc: bf16 = 1 is refused), ts x ts tiles (fma_tile_plan).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int spe_bottleneck(int mode, int bf16, const void* x,
                              const void* w1, const void* w2, const void* w3,
                              const void* vec, void* out, void* pooled,
                              const void* ulo, int B, int H, int W, int C,
                              int Cm, int ts, void* stream) {
  if (bf16) return (int)cudaErrorInvalidValue;
  return (int)spe::dispatch_mode<float>(mode, x, w1, w2, w3, vec, out, pooled,
                                        ulo, B, H, W, C, Cm, ts,
                                        static_cast<cudaStream_t>(stream));
}

// The same in bfloat16 on the tensor cores, with the plan of
// bneck_tc_plan: tile tsh x tsw, input chunk ck, output chunk nt, ring
// stages nst, smem bytes.
extern "C" int spe_bottleneck_tc(int mode, const void* x, const void* w1,
                                 const void* w2, const void* w3,
                                 const void* vec, void* out, void* pooled,
                                 const void* ulo, int B, int H, int W, int C,
                                 int Cm, int tsh, int tsw, int ck, int nt,
                                 int nst, int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case spe::kPlain:
      return (int)spe::launch_bneck_tc<spe::kPlain>(x, w1, w2, w3, vec, out, pooled, ulo, B, H, W, C, Cm, tsh, tsw, ck, nt, nst, smem, s);
    case spe::kPool:
      return (int)spe::launch_bneck_tc<spe::kPool>(x, w1, w2, w3, vec, out, pooled, ulo, B, H, W, C, Cm, tsh, tsw, ck, nt, nst, smem, s);
    case spe::kUpAdd:
      return (int)spe::launch_bneck_tc<spe::kUpAdd>(x, w1, w2, w3, vec, out, pooled, ulo, B, H, W, C, Cm, tsh, tsw, ck, nt, nst, smem, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The conv-skip bottleneck: x (B, H, W, Cin), ws (Cin, C), w1 (Cin, Cm),
// w2 (3, 3, Cm, Cm), w3 (Cm, C), vec 6*Cm + 4*C floats, out (B, H, W, C),
// ts x ts tiles (fma_tile_plan); float32 storage (bfloat16 runs
// spe_convskip_tc: bf16 = 1 is refused).
extern "C" int spe_convskip(int bf16, const void* x, const void* ws,
                            const void* w1, const void* w2, const void* w3,
                            const void* vec, void* out, int B, int H, int W,
                            int Cin, int C, int Cm, int ts, void* stream) {
  if (bf16) return (int)cudaErrorInvalidValue;
  return (int)spe::launch_convskip<float>(x, ws, w1, w2, w3, vec, out, B, H, W,
                                          Cin, C, Cm, ts,
                                          static_cast<cudaStream_t>(stream));
}

// The same in bfloat16 on the tensor cores, with the plan of
// convskip_tc_plan: tile tsh x tsw, input chunk ck, output chunk nt, ring
// stages nst, smem bytes.
extern "C" int spe_convskip_tc(const void* x, const void* ws, const void* w1,
                               const void* w2, const void* w3,
                               const void* vec, void* out, int B, int H,
                               int W, int Cin, int C, int Cm, int tsh,
                               int tsw, int ck, int nt, int nst, int smem,
                               void* stream) {
  return (int)spe::launch_convskip_tc(x, ws, w1, w2, w3, vec, out, B, H, W,
                                      Cin, C, Cm, tsh, tsw, ck, nt, nst, smem,
                                      static_cast<cudaStream_t>(stream));
}

extern "C" const char* spe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
