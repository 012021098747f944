// Train-mode bottleneck units, forward and backward, for the fused train
// step (model_backend="fused"). Replaces the six TPU kernels of
// single_person_pose_estimation_tpu/experimental/bottleneck_train_kernel.py:
//
//   conv1x1_relu_stats (:72)   a = round(relu(z . W + b)),  sums [Σa, Σa²]
//   conv3x3_relu_stats (:144)  the same with a 3x3 SAME conv
//       where z = round(x * scale + shift) (or z = x for the first unit),
//       zero outside the image (the reference pads z, not x);
//   bn_bwd_reduce (:219)       sums [Σdz, Σdz·a]
//   unit1x1_bwd (:286), unit3x3_bwd (:373), unit1_bwd (:433)
//       dy  = round(a > 0 ? K1·dz + K2·a + K3 : 0)
//       din = conv^T(dy, W) rounded;  next sums [Σdin, Σdin·cin] of the RAW
//       cin; unit1: dx = round(g + din);
//       dW[tap] = Σ shift_tap(z)^T · dy,  db = Σ dy   (z = cin re-normalized)
//
// Four kernel bodies serve the six functions:
//   unit_kernel<KS, PRO, EPI>  a tiled conv whose prologue makes its input
//       (z from x, or dy from dz and a) on the tile and its one-pixel halo in
//       shared memory, and whose epilogue is relu + bias + stats (forward)
//       or round + next sums or skip add (din: the conv of dy with the
//       flipped, transposed weights);
//   reduce_kernel              the two per-channel sums of bn_bwd_reduce;
//   dw_kernel<KS, AFF>         split-K weight gradient: a block owns a 64x64
//       tile of one tap's dW over one slice of the rows, and recomputes dy
//       and the shifted z of that slice on the fly;
//   finalize_kernel            sums the per-block partials of the three
//       above in a fixed order.
//
// Bound on the H100 (B=64, 64 px, C=256, Cm=128, bf16): the 1x1 units and
// the reductions are bound by HBM bytes (~0.06-0.16 ms), the 3x3 units by
// tensor-core operations (~0.08-0.16 ms). This first version runs the
// products as FMA on the CUDA cores in float32, so it is bound by the FMA
// rate, far above those bounds.
//
// Design: the TPU kernels carry their sums and dW/db across a sequential
// batch grid in VMEM. Blocks on Hopper run in parallel in no order, so each
// block writes float32 partials to a workspace that the wrapper allocates,
// and finalize_kernel adds them in a fixed order: a rerun gives the same
// bits (no float atomics). The row kernels run at most kMaxParts blocks,
// each looping over tiles in a fixed order, so the partials stay few. The
// elementwise prologues round every float32 multiply and add (__fmul_rn,
// __fadd_rn) in the plain versions' order, so z and dy equal theirs bit
// for bit; only the order of the sums differs. Nothing is allocated here.
#include "common.cuh"

namespace spe {
namespace train {

constexpr int kMaxParts = 1024;  // ops/cuda/bottleneck_train_kernel.py MAX_PARTS
constexpr int kDwRows = 32;      // rows of one dw_kernel step
constexpr int kDwTile = 64;      // dW tile side

enum Pro { kProNone = 0, kProAffine = 1, kProDy = 2 };
enum Epi { kEpiReluStats = 0, kEpiDin = 1, kEpiDinSums = 2, kEpiDinSkip = 3 };

// The prologue's value of channel c at the in-image NHWC offset idx:
// x itself, round(x*v0 + v1), or dy = round(a > 0 ? v0*x + v1*a + v2 : 0)
// with x = dz.
template <typename T, int PRO>
__device__ __forceinline__ float prologue(const T* __restrict__ x,
                                          const T* __restrict__ a,
                                          const float* __restrict__ v0,
                                          const float* __restrict__ v1,
                                          const float* __restrict__ v2,
                                          size_t idx, int c) {
  const float xv = Store<T>::to_f(x[idx]);
  if (PRO == kProNone) return xv;
  if (PRO == kProAffine)
    return round_st<T>(__fadd_rn(__fmul_rn(xv, v0[c]), v1[c]));
  const float av = Store<T>::to_f(a[idx]);
  const float da = __fadd_rn(
      __fadd_rn(__fmul_rn(v0[c], xv), __fmul_rn(v1[c], av)), v2[c]);
  return round_st<T>(av > 0.f ? da : 0.f);
}

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// One block walks tiles t = blockIdx.x, + gridDim.x, ... of TH x TW output
// pixels. K prologue channels in, N out. part: gridDim.x rows of [s1, s2]
// (2N floats) when the epilogue sums.
template <typename T, int KS, int PRO, int EPI>
__global__ void __launch_bounds__(kThreads)
unit_kernel(const T* __restrict__ x, const T* __restrict__ a,
            const float* __restrict__ pv, const T* __restrict__ w,
            const float* __restrict__ bias, const T* __restrict__ aux,
            T* __restrict__ out, float* __restrict__ part, int H, int W,
            int K, int N, int TH, int TW, int tiles_x, int tiles_img,
            int ntiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int R = KS / 2;
  const int LH = TH + 2 * R, LW = TW + 2 * R, P = TH * TW;
  T* zs = reinterpret_cast<T*>(smem_raw);
  float* red = reinterpret_cast<float*>(
      smem_raw + align16((size_t)LH * LW * K * sizeof(T)));
  constexpr bool kSums = EPI == kEpiReluStats || EPI == kEpiDinSums;
  const int tid = threadIdx.x;
  const int G = N / kNC, PG = kThreads / G;
  const int cg = tid % G, pg = tid / G, n0 = cg * kNC;
  const float* v0 = pv;
  const float* v1 = pv + K;
  const float* v2 = pv + 2 * K;
  float s1[kNC], s2[kNC];
#pragma unroll
  for (int j = 0; j < kNC; ++j) s1[j] = s2[j] = 0.f;

  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int b = t / tiles_img, tt = t % tiles_img;
    const int ty0 = (tt / tiles_x) * TH, tx0 = (tt % tiles_x) * TW;
    __syncthreads();  // the previous tile's readers are done with zs
    for (int v = tid; v < LH * LW * K; v += kThreads) {
      const int q = v / K, c = v % K;
      const int iy = ty0 - R + q / LW, ix = tx0 - R + q % LW;
      float val = 0.f;
      if (iy >= 0 && iy < H && ix >= 0 && ix < W)
        val = prologue<T, PRO>(x, a, v0, v1, v2,
                               (((size_t)b * H + iy) * W + ix) * K + c, c);
      zs[v] = Store<T>::from_f(val);
    }
    __syncthreads();
    if (pg >= PG) continue;
    for (int base = 0; base < P; base += PG * kNP) {
      float acc[kNP][kNC];
      zero_acc(acc);
      for (int tap = 0; tap < KS * KS; ++tap) {
        const int dy = tap / KS, dx = tap % KS;
        const T* arow[kNP];
#pragma unroll
        for (int i = 0; i < kNP; ++i) {
          const int p = base + pg + PG * i;
          const int pp = p < P ? p : 0;
          arow[i] = zs + ((pp / TW + dy) * LW + pp % TW + dx) * K;
        }
        mac_rows<T>(acc, arow, w + (size_t)tap * K * N, N, n0, K);
      }
#pragma unroll
      for (int i = 0; i < kNP; ++i) {
        const int p = base + pg + PG * i;
        if (p >= P) continue;
        const int gy = ty0 + p / TW, gx = tx0 + p % TW;
        if (gy >= H || gx >= W) continue;
        const size_t o = (((size_t)b * H + gy) * W + gx) * N;
#pragma unroll
        for (int j = 0; j < kNC; ++j) {
          const int n = n0 + j;
          if (EPI == kEpiReluStats) {
            const float av = round_st<T>(fmaxf(__fadd_rn(acc[i][j], bias[n]), 0.f));
            out[o + n] = Store<T>::from_f(av);
            s1[j] += av;
            s2[j] = fmaf(av, av, s2[j]);
          } else {
            const float d = round_st<T>(acc[i][j]);
            if (EPI == kEpiDinSkip) {
              out[o + n] = Store<T>::from_f(__fadd_rn(Store<T>::to_f(aux[o + n]), d));
            } else {
              out[o + n] = Store<T>::from_f(d);
              if (EPI == kEpiDinSums) {
                s1[j] += d;
                s2[j] = fmaf(d, Store<T>::to_f(aux[o + n]), s2[j]);
              }
            }
          }
        }
      }
    }
  }
  if (!kSums) return;
  __syncthreads();
  if (pg < PG) {
#pragma unroll
    for (int j = 0; j < kNC; ++j) {
      red[(pg * 2) * N + n0 + j] = s1[j];
      red[(pg * 2 + 1) * N + n0 + j] = s2[j];
    }
  }
  __syncthreads();
  for (int v = tid; v < 2 * N; v += kThreads) {
    const int r = v / N, c = v % N;
    float s = 0.f;
    for (int g = 0; g < PG; ++g) s += red[(g * 2 + r) * N + c];
    part[(size_t)blockIdx.x * 2 * N + v] = s;
  }
}

// [Σdz, Σdz·a] of R rows of C channels: part has gridDim.x rows of 2C.
template <typename T>
__global__ void __launch_bounds__(kThreads)
reduce_kernel(const T* __restrict__ dz, const T* __restrict__ a,
              float* __restrict__ part, int R, int C) {
  __shared__ float red[2 * kThreads * kNC];  // PG * 2C <= 2 * 256 * 4
  const int tid = threadIdx.x;
  const int G = C / kNC, PG = kThreads / G;
  const int cg = tid % G, pg = tid / G, n0 = cg * kNC;
  float s1[kNC] = {0.f, 0.f, 0.f, 0.f}, s2[kNC] = {0.f, 0.f, 0.f, 0.f};
  if (pg < PG) {
    for (size_t r = (size_t)blockIdx.x * PG + pg; r < (size_t)R;
         r += (size_t)gridDim.x * PG) {
      float d[kNC], av[kNC];
      Store<T>::load4(dz + r * C + n0, d);
      Store<T>::load4(a + r * C + n0, av);
#pragma unroll
      for (int j = 0; j < kNC; ++j) {
        s1[j] += d[j];
        s2[j] = fmaf(d[j], av[j], s2[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kNC; ++j) {
      red[(pg * 2) * C + n0 + j] = s1[j];
      red[(pg * 2 + 1) * C + n0 + j] = s2[j];
    }
  }
  __syncthreads();
  for (int v = tid; v < 2 * C; v += kThreads) {
    const int r = v / C, c = v % C;
    float s = 0.f;
    for (int g = 0; g < PG; ++g) s += red[(g * 2 + r) * C + c];
    part[(size_t)blockIdx.x * 2 * C + v] = s;
  }
}

// Split-K weight gradient. blockIdx.x picks (tap, Ci tile, Co tile),
// blockIdx.y the slice of rows [y * rows, (y + 1) * rows). part row y
// (L = KS*KS*Ci*Co + Co floats): dW (tap, Ci, Co), then db (Co).
template <typename T, int KS, bool AFF>
__global__ void __launch_bounds__(kThreads)
dw_kernel(const T* __restrict__ dz, const T* __restrict__ a,
          const float* __restrict__ kv, const T* __restrict__ cin,
          const float* __restrict__ aff, float* __restrict__ part, int B,
          int H, int W, int Ci, int Co, int rows, int L) {
  __shared__ __align__(16) float zs[kDwRows][kDwTile];
  __shared__ __align__(16) float ds[kDwRows][kDwTile];
  const int tid = threadIdx.x;
  const int tiles_i = (Ci + kDwTile - 1) / kDwTile;
  const int tiles_o = (Co + kDwTile - 1) / kDwTile;
  const int tap = blockIdx.x / (tiles_i * tiles_o);
  const int rem = blockIdx.x % (tiles_i * tiles_o);
  const int i0 = (rem / tiles_o) * kDwTile, o0 = (rem % tiles_o) * kDwTile;
  const int sy = tap / KS - KS / 2, sx = tap % KS - KS / 2;
  const int tr = tid / 16, tc = tid % 16;
  const size_t R = (size_t)B * H * W;
  const size_t r_begin = (size_t)blockIdx.y * rows;
  const size_t r_end = r_begin + rows < R ? r_begin + rows : R;
  float acc[4][4], db[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    db[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  for (size_t r0 = r_begin; r0 < r_end; r0 += kDwRows) {
    __syncthreads();
    for (int v = tid; v < kDwRows * kDwTile; v += kThreads) {
      const int p = v / kDwTile, c = v % kDwTile;
      const size_t r = r0 + p;
      float zv = 0.f, dv = 0.f;
      if (r < r_end) {
        if (o0 + c < Co)
          dv = prologue<T, kProDy>(dz, a, kv, kv + Co, kv + 2 * Co,
                                   r * Co + o0 + c, o0 + c);
        const int yx = (int)(r % ((size_t)H * W));
        const int y = yx / W + sy, x = yx % W + sx;
        if (i0 + c < Ci && y >= 0 && y < H && x >= 0 && x < W) {
          const size_t idx = (r - yx + (size_t)y * W + x) * Ci + i0 + c;
          zv = AFF ? prologue<T, kProAffine>(cin, cin, aff, aff + Ci, aff,
                                             idx, i0 + c)
                   : Store<T>::to_f(cin[idx]);
        }
      }
      zs[p][c] = zv;
      ds[p][c] = dv;
    }
    __syncthreads();
#pragma unroll 4
    for (int p = 0; p < kDwRows; ++p) {
      const float4 z4 = *reinterpret_cast<const float4*>(&zs[p][tr * 4]);
      const float4 d4 = *reinterpret_cast<const float4*>(&ds[p][tc * 4]);
      const float z[4] = {z4.x, z4.y, z4.z, z4.w};
      const float d[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(z[i], d[j], acc[i][j]);
#pragma unroll
      for (int j = 0; j < 4; ++j) db[j] += d[j];
    }
  }
  float* dst = part + (size_t)blockIdx.y * L;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ci = i0 + tr * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = o0 + tc * 4 + j;
      if (ci < Ci && co < Co) dst[((size_t)tap * Ci + ci) * Co + co] = acc[i][j];
    }
  }
  if (tap == 0 && i0 == 0 && tr == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = o0 + tc * 4 + j;
      if (co < Co) dst[(size_t)KS * KS * Ci * Co + co] = db[j];
    }
  }
}

// out[l] = sum over p of ws[p][l], p in a fixed order: 8 groups of
// consecutive partials, then the 8 group sums in order.
__global__ void __launch_bounds__(kThreads)
finalize_kernel(const float* __restrict__ ws, float* __restrict__ out,
                int nparts, int L) {
  __shared__ float red[8][32];
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  const int per = (nparts + 7) / 8;
  const int p0 = g * per, p1 = p0 + per < nparts ? p0 + per : nparts;
  float s = 0.f;
  if (col < L)
    for (int p = p0; p < p1; ++p) s += ws[(size_t)p * L + col];
  red[g][lane] = s;
  __syncthreads();
  if (g == 0 && col < L) {
    float tot = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) tot += red[k][lane];
    out[col] = tot;
  }
}

inline cudaError_t launch_finalize(const float* ws, float* out, int nparts,
                                   int L, cudaStream_t s) {
  finalize_kernel<<<(L + 31) / 32, kThreads, 0, s>>>(ws, out, nparts, L);
  return cudaGetLastError();
}

// Blocks of a row kernel: as many as the card holds at once, at most
// kMaxParts and at most `work`. The same card gives the same count, so a
// rerun sums in the same order.
template <typename Kern>
cudaError_t row_grid(Kern kernel, size_t smem, int work, int* grid) {
  int dev = 0, sms = 0, occ = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  int g = (occ > 0 ? occ : 1) * sms;
  if (g > kMaxParts) g = kMaxParts;
  if (g > work) g = work;
  *grid = g > 0 ? g : 1;
  return cudaSuccess;
}

template <typename T, int KS, int PRO, int EPI>
cudaError_t launch_unit(const void* x, const void* a, const void* pv,
                        const void* w, const void* bias, const void* aux,
                        void* out, void* ws, void* sums, int B, int H, int W,
                        int K, int N, cudaStream_t s) {
  const int TH = H < 8 ? H : 8, TW = W < 8 ? W : 8;
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_img = ((H + TH - 1) / TH) * tiles_x;
  const int ntiles = B * tiles_img;
  const int LH = TH + KS - 1, LW = TW + KS - 1;
  const int PG = kThreads / (N / kNC);
  const size_t smem = align16((size_t)LH * LW * K * sizeof(T)) +
                      (size_t)PG * 2 * N * sizeof(float);
  auto kernel = unit_kernel<T, KS, PRO, EPI>;
  cudaError_t err = allow_smem(kernel, smem);
  int grid = 0;
  if (err == cudaSuccess) err = row_grid(kernel, smem, ntiles, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(a),
      static_cast<const float*>(pv), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<const T*>(aux),
      static_cast<T*>(out), static_cast<float*>(ws), H, W, K, N, TH, TW,
      tiles_x, tiles_img, ntiles);
  err = cudaGetLastError();
  if (err != cudaSuccess || !(EPI == kEpiReluStats || EPI == kEpiDinSums))
    return err;
  return launch_finalize(static_cast<const float*>(ws),
                         static_cast<float*>(sums), grid, 2 * N, s);
}

template <typename T>
cudaError_t dispatch_unit(int ks, int pro, int epi, const void* x,
                          const void* a, const void* pv, const void* w,
                          const void* bias, const void* aux, void* out,
                          void* ws, void* sums, int B, int H, int W, int K,
                          int N, cudaStream_t s) {
#define SPE_UNIT(KS_, PRO_, EPI_)                                              \
  if (ks == KS_ && pro == PRO_ && epi == EPI_)                                 \
    return launch_unit<T, KS_, PRO_, EPI_>(x, a, pv, w, bias, aux, out, ws,    \
                                           sums, B, H, W, K, N, s);
  SPE_UNIT(1, kProNone, kEpiReluStats)
  SPE_UNIT(1, kProAffine, kEpiReluStats)
  SPE_UNIT(3, kProAffine, kEpiReluStats)
  SPE_UNIT(1, kProDy, kEpiDin)
  SPE_UNIT(1, kProDy, kEpiDinSums)
  SPE_UNIT(1, kProDy, kEpiDinSkip)
  SPE_UNIT(3, kProDy, kEpiDinSums)
#undef SPE_UNIT
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_reduce(const void* dz, const void* a, void* ws, void* sums,
                          int R, int C, cudaStream_t s) {
  const int PG = kThreads / (C / kNC);
  int grid = 0;
  cudaError_t err = row_grid(reduce_kernel<T>, 0, (R + PG - 1) / PG, &grid);
  if (err != cudaSuccess) return err;
  reduce_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(dz), static_cast<const T*>(a),
      static_cast<float*>(ws), R, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_finalize(static_cast<const float*>(ws),
                         static_cast<float*>(sums), grid, 2 * C, s);
}

template <typename T, int KS, bool AFF>
cudaError_t launch_dw(const void* dz, const void* a, const void* k,
                      const void* cin, const void* aff, void* ws, void* out,
                      int B, int H, int W, int Ci, int Co, int slices,
                      int rows, cudaStream_t s) {
  const int L = KS * KS * Ci * Co + Co;
  const int tiles = KS * KS * ((Ci + kDwTile - 1) / kDwTile) *
                    ((Co + kDwTile - 1) / kDwTile);
  dw_kernel<T, KS, AFF><<<dim3(tiles, slices), kThreads, 0, s>>>(
      static_cast<const T*>(dz), static_cast<const T*>(a),
      static_cast<const float*>(k), static_cast<const T*>(cin),
      static_cast<const float*>(aff), static_cast<float*>(ws), B, H, W, Ci,
      Co, rows, L);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_finalize(static_cast<const float*>(ws),
                         static_cast<float*>(out), slices, L, s);
}

template <typename T>
cudaError_t dispatch_dw(int ks, int aff, const void* dz, const void* a,
                        const void* k, const void* cin, const void* affv,
                        void* ws, void* out, int B, int H, int W, int Ci,
                        int Co, int slices, int rows, cudaStream_t s) {
  if (ks == 1 && aff)
    return launch_dw<T, 1, true>(dz, a, k, cin, affv, ws, out, B, H, W, Ci, Co, slices, rows, s);
  if (ks == 1)
    return launch_dw<T, 1, false>(dz, a, k, cin, affv, ws, out, B, H, W, Ci, Co, slices, rows, s);
  if (ks == 3 && aff)
    return launch_dw<T, 3, true>(dz, a, k, cin, affv, ws, out, B, H, W, Ci, Co, slices, rows, s);
  return cudaErrorInvalidValue;
}

}  // namespace train
}  // namespace spe

// A unit kernel (ks 1 or 3; pro 0 none, 1 affine, 2 dy; epi 0 relu+stats,
// 1 din, 2 din+next sums, 3 din+skip), then, when the epilogue sums, the
// finalize kernel into sums (2, N). ws holds kMaxParts rows of 2N floats.
extern "C" int spe_train_unit(int bf16, int ks, int pro, int epi,
                              const void* x, const void* a, const void* pv,
                              const void* w, const void* bias, const void* aux,
                              void* out, void* ws, void* sums, int B, int H,
                              int W, int K, int N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)spe::train::dispatch_unit<__nv_bfloat16>(
        ks, pro, epi, x, a, pv, w, bias, aux, out, ws, sums, B, H, W, K, N, s);
  return (int)spe::train::dispatch_unit<float>(
      ks, pro, epi, x, a, pv, w, bias, aux, out, ws, sums, B, H, W, K, N, s);
}

// bn_bwd_reduce: the reduce kernel, then the finalize kernel into sums
// (2, C). ws holds kMaxParts rows of 2C floats.
extern "C" int spe_train_reduce(int bf16, const void* dz, const void* a,
                                void* ws, void* sums, int R, int C,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)spe::train::launch_reduce<__nv_bfloat16>(dz, a, ws, sums, R, C, s);
  return (int)spe::train::launch_reduce<float>(dz, a, ws, sums, R, C, s);
}

// dW and db of a unit: the dw kernel over `slices` slices of `rows` rows,
// then the finalize kernel into out (ks*ks*Ci*Co + Co floats). ws holds
// `slices` rows of that length.
extern "C" int spe_train_dw(int bf16, int ks, int aff, const void* dz,
                            const void* a, const void* k, const void* cin,
                            const void* affv, void* ws, void* out, int B,
                            int H, int W, int Ci, int Co, int slices,
                            int rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)spe::train::dispatch_dw<__nv_bfloat16>(
        ks, aff, dz, a, k, cin, affv, ws, out, B, H, W, Ci, Co, slices, rows, s);
  return (int)spe::train::dispatch_dw<float>(
      ks, aff, dz, a, k, cin, affv, ws, out, B, H, W, Ci, Co, slices, rows, s);
}
