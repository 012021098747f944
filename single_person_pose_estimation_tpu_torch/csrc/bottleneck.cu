// Fused identity-skip hourglass bottleneck for inference, three epilogues:
//
//   t1  = bn1(relu(x . W1 + b1))            1x1, C -> Cm
//   t2  = bn2(relu(conv3x3(t1, W2) + b2))   3x3, Cm -> Cm, zero padding
//   t3  = bn3(relu(t2 . W3 + b3))           1x1, Cm -> C
//   kPlain:  out = x + t3                   (f32 add, one rounding)
//   kPool:   out = x + round(t3), pooled = maxpool2x2(out)
//   kUpAdd:  d = round(x + t3), out = round(d + up2x(u_lo))
//
// Replaces the TPU kernels single_person_pose_estimation_tpu/ops/pallas/
// bottleneck_kernel.py:fused_bottleneck (kPlain), :fused_bottleneck_pool
// (kPool) and, as the first of two launches, uplevel_kernel.py:fused_uplevel
// (kUpAdd; the second launch is kPlain on the sum).
//
// Bound on the H100: at the 64 px level (C=256, Cm=128) a bottleneck is
// 1.74 GFLOP per image against 4 MB of HBM traffic (x in, out back, bf16),
// ~430 FLOP/byte, so the tensor math bounds it, not HBM. This first version
// runs that math as FMA on the CUDA cores in f32 (no tensor cores yet), so
// it is bound by the FMA rate and by shared-memory reads of t1/t2.
//
// Design: the TPU kernel holds a whole 64x64x256 map per image in VMEM; an
// SM block holds at most 227 KB, so each block takes one TH x TW output tile
// (8x8, or the whole map when smaller) of one image. It loads x over a
// one-pixel halo, recomputes t1 on the (TH+2)x(TW+2) halo (t1 is forced to
// ZERO outside the image: the reference pads t1, not x), keeps t1 and t2 in
// shared memory and writes only the outputs. Weights stream from L2 with
// coalesced reads. Nothing is allocated here; the wrapper allocates outputs.
#include "common.cuh"

namespace spe {

enum Mode { kPlain = 0, kPool = 1, kUpAdd = 2 };

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
bottleneck_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                  const T* __restrict__ w2, const T* __restrict__ w3,
                  const float* __restrict__ vec, T* __restrict__ out,
                  T* __restrict__ pooled, const T* __restrict__ ulo,
                  int H, int W, int C, int Cm, int TH, int TW, int tiles_x) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int HW2 = (TH + 2) * (TW + 2);  // halo pixels
  const int P = TH * TW;                 // output pixels
  // Region A holds the x halo in phase 1, then t2 and (kPool) the out tile.
  const int regA = max(HW2 * C, P * Cm + (MODE == kPool ? P * C : 0));
  T* xs = smem;
  T* t2s = smem;
  T* outs = smem + P * Cm;
  T* t1s = smem + regA;

  const int b = blockIdx.y;
  const int ty0 = (blockIdx.x / tiles_x) * TH;
  const int tx0 = (blockIdx.x % tiles_x) * TW;
  const T* xb = x + (size_t)b * H * W * C;
  const float* b1 = vec;
  const float* a1 = vec + Cm;
  const float* c1 = vec + 2 * Cm;
  const float* b2 = vec + 3 * Cm;
  const float* a2 = vec + 4 * Cm;
  const float* c2 = vec + 5 * Cm;
  const float* b3 = vec + 6 * Cm;
  const float* a3 = b3 + C;
  const float* c3 = b3 + 2 * C;
  const int tid = threadIdx.x;

  // Phase 0: the x halo into shared memory, zeros outside the image.
  load_region<T>(xs, xb, ty0 - 1, tx0 - 1, TH + 2, TW + 2, H, W, C);
  __syncthreads();

  // Phase 1: t1 on every halo pixel (N = Cm).
  {
    const int G = Cm / kNC, PG = kThreads / G;
    const int cg = tid % G, pg = tid / G, n0 = cg * kNC;
    if (pg < PG) {
      for (int base = 0; base < HW2; base += PG * kNP) {
        float acc[kNP][kNC];
        zero_acc(acc);
        const T* arow[kNP];
#pragma unroll
        for (int i = 0; i < kNP; ++i) {
          const int q = base + pg + PG * i;
          arow[i] = xs + (q < HW2 ? q : 0) * C;
        }
        mac_rows<T>(acc, arow, w1, Cm, n0, C);
#pragma unroll
        for (int i = 0; i < kNP; ++i) {
          const int q = base + pg + PG * i;
          if (q >= HW2) continue;
          const int iy = ty0 - 1 + q / (TW + 2), ix = tx0 - 1 + q % (TW + 2);
          const bool inside = iy >= 0 && iy < H && ix >= 0 && ix < W;
#pragma unroll
          for (int j = 0; j < kNC; ++j) {
            const int n = n0 + j;
            const float t = fmaxf(acc[i][j] + b1[n], 0.f) * a1[n] + c1[n];
            t1s[q * Cm + n] = Store<T>::from_f(inside ? t : 0.f);
          }
        }
      }
    }
  }
  __syncthreads();

  // Phase 2: t2 = 3x3 conv of t1 as 9 shifted products (N = Cm).
  {
    const int G = Cm / kNC, PG = kThreads / G;
    const int cg = tid % G, pg = tid / G, n0 = cg * kNC;
    if (pg < PG) {
      for (int base = 0; base < P; base += PG * kNP) {
        float acc[kNP][kNC];
        zero_acc(acc);
        for (int tap = 0; tap < 9; ++tap) {
          const int dy = tap / 3, dx = tap % 3;
          const T* arow[kNP];
#pragma unroll
          for (int i = 0; i < kNP; ++i) {
            const int p = base + pg + PG * i;
            const int pp = p < P ? p : 0;
            arow[i] = t1s + ((pp / TW + dy) * (TW + 2) + pp % TW + dx) * Cm;
          }
          mac_rows<T>(acc, arow, w2 + (size_t)tap * Cm * Cm, Cm, n0, Cm);
        }
#pragma unroll
        for (int i = 0; i < kNP; ++i) {
          const int p = base + pg + PG * i;
          if (p >= P) continue;
#pragma unroll
          for (int j = 0; j < kNC; ++j) {
            const int n = n0 + j;
            const float t = fmaxf(acc[i][j] + b2[n], 0.f) * a2[n] + c2[n];
            t2s[p * Cm + n] = Store<T>::from_f(t);
          }
        }
      }
    }
  }
  __syncthreads();

  // Phase 3: t3 and the epilogue (N = C).
  {
    const int G = C / kNC, PG = kThreads / G;
    const int cg = tid % G, pg = tid / G, n0 = cg * kNC;
    if (pg < PG) {
      for (int base = 0; base < P; base += PG * kNP) {
        float acc[kNP][kNC];
        zero_acc(acc);
        const T* arow[kNP];
#pragma unroll
        for (int i = 0; i < kNP; ++i) {
          const int p = base + pg + PG * i;
          arow[i] = t2s + (p < P ? p : 0) * Cm;
        }
        mac_rows<T>(acc, arow, w3, C, n0, Cm);
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
            const float xv = Store<T>::to_f(x[o + n]);
            if (MODE == kPlain) {
              out[o + n] = Store<T>::from_f(xv + t3);
            } else if (MODE == kPool) {
              const T r = Store<T>::from_f(xv + round_st<T>(t3));
              out[o + n] = r;
              outs[p * C + n] = r;
            } else {
              const float d = round_st<T>(xv + t3);
              const size_t ou =
                  (((size_t)b * (H / 2) + gy / 2) * (W / 2) + gx / 2) * C + n;
              out[o + n] = Store<T>::from_f(d + Store<T>::to_f(ulo[ou]));
            }
          }
        }
      }
    }
  }

  if (MODE == kPool) {
    // Each block pools its own 2x2 windows: TH and TW are even.
    __syncthreads();
    pool_tile<T>(outs, pooled, b, ty0, tx0, TH, TW, H, W, C);
  }
}

template <typename T, int MODE>
cudaError_t launch_bottleneck(const void* x, const void* w1, const void* w2,
                              const void* w3, const void* vec, void* out,
                              void* pooled, const void* ulo, int B, int H,
                              int W, int C, int Cm, cudaStream_t stream) {
  const int TH = H < 8 ? H : 8, TW = W < 8 ? W : 8;
  const int tiles_y = (H + TH - 1) / TH, tiles_x = (W + TW - 1) / TW;
  const size_t HW2 = (size_t)(TH + 2) * (TW + 2), P = (size_t)TH * TW;
  size_t regA = HW2 * C;
  const size_t regA2 = P * Cm + (MODE == kPool ? P * C : 0);
  if (regA2 > regA) regA = regA2;
  const size_t smem = (regA + HW2 * Cm) * sizeof(T);
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

template <typename T>
cudaError_t dispatch_mode(int mode, const void* x, const void* w1,
                          const void* w2, const void* w3, const void* vec,
                          void* out, void* pooled, const void* ulo, int B,
                          int H, int W, int C, int Cm, cudaStream_t s) {
  switch (mode) {
    case kPlain:
      return launch_bottleneck<T, kPlain>(x, w1, w2, w3, vec, out, pooled, ulo, B, H, W, C, Cm, s);
    case kPool:
      return launch_bottleneck<T, kPool>(x, w1, w2, w3, vec, out, pooled, ulo, B, H, W, C, Cm, s);
    case kUpAdd:
      return launch_bottleneck<T, kUpAdd>(x, w1, w2, w3, vec, out, pooled, ulo, B, H, W, C, Cm, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace spe

// mode: 0 plain, 1 pool, 2 up-add. bf16: 1 for bfloat16 storage, 0 for f32.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int spe_bottleneck(int mode, int bf16, const void* x,
                              const void* w1, const void* w2, const void* w3,
                              const void* vec, void* out, void* pooled,
                              const void* ulo, int B, int H, int W, int C,
                              int Cm, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)spe::dispatch_mode<__nv_bfloat16>(mode, x, w1, w2, w3, vec, out,
                                                  pooled, ulo, B, H, W, C, Cm, s);
  return (int)spe::dispatch_mode<float>(mode, x, w1, w2, w3, vec, out, pooled,
                                        ulo, B, H, W, C, Cm, s);
}

extern "C" const char* spe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
