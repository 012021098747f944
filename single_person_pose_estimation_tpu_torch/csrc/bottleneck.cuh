// The bottleneck body shared by csrc/bottleneck.cu (one tile per block) and
// csrc/bottom.cu (one image per block, walking its tiles): the three phases
// of one TH x TW output tile and their epilogues.
//
//   t1  = bn1(relu(x . W1 + b1))            1x1, K -> Cm (K = C, or Cin)
//   t2  = bn2(relu(conv3x3(t1, W2) + b2))   3x3, Cm -> Cm, zero padding
//   t3  = bn3(relu(t2 . W3 + b3))           1x1, Cm -> C
//   kPlain:     out = x + t3                (f32 add, one rounding)
//   kPool:      out = x + round(t3), pooled = maxpool2x2(out)
//   kUpAdd:     d = round(x + t3), out = round(d + up2x(u_lo))
//   kPlainPool: out = x + t3 as kPlain, pooled = maxpool2x2(out)
//   kConvSkip:  skip = round(relu(x . Ws + bs)), x (Cin) -> C,
//               out = round(skip + round(t3))  (bf16 body only)
//
// The pointers of maps (x, out, pooled, u_lo) carry no __restrict__: in
// bottom.cu one block writes a map and reads it back in a later stage, so
// no load of a map may go through the read-only (non-coherent) cache.
#pragma once

#include "common.cuh"

namespace spe {

enum Mode { kPlain = 0, kPool = 1, kUpAdd = 2, kPlainPool = 3, kConvSkip = 4 };

template <int MODE>
__host__ __device__ constexpr bool pools() {
  return MODE == kPool || MODE == kPlainPool;
}

// Elements of shared memory one tile of `mode` needs: region A (the x halo
// in phase 1, then t2 and, when pooling, the out tile) and t1 on the halo.
__host__ __device__ inline size_t tile_smem_elems(int TH, int TW, int C,
                                                  int Cm, bool pooling) {
  const size_t HW2 = (size_t)(TH + 2) * (TW + 2), P = (size_t)TH * TW;
  size_t regA = HW2 * C;
  const size_t regA2 = P * Cm + (pooling ? P * C : 0);
  if (regA2 > regA) regA = regA2;
  return regA + HW2 * Cm;
}

// Phase 1: t1 on every pixel of the (TH+2) x (TW+2) halo held in xs (rows
// of K), into t1s (rows of Cm). t1 is ZERO outside the image: the
// reference pads t1, not x, and a zero x gives t1 = relu(b1)*a1 + c1.
template <typename T>
__device__ __forceinline__ void tile_t1(const T* xs, T* t1s,
                                        const T* __restrict__ w1,
                                        const float* __restrict__ vec, int ty0,
                                        int tx0, int TH, int TW, int H, int W,
                                        int K, int Cm) {
  const float* b1 = vec;
  const float* a1 = vec + Cm;
  const float* c1 = vec + 2 * Cm;
  const int HW2 = (TH + 2) * (TW + 2);
  const int G = Cm / kNC, PG = kThreads / G;
  const int tid = threadIdx.x, cg = tid % G, pg = tid / G, n0 = cg * kNC;
  if (pg >= PG) return;
  for (int base = 0; base < HW2; base += PG * kNP) {
    float acc[kNP][kNC];
    zero_acc(acc);
    const T* arow[kNP];
#pragma unroll
    for (int i = 0; i < kNP; ++i) {
      const int q = base + pg + PG * i;
      arow[i] = xs + (q < HW2 ? q : 0) * K;
    }
    mac_rows<T>(acc, arow, w1, Cm, n0, K);
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

// Phase 2: t2 = 3x3 conv of t1 as 9 shifted products, into t2s (rows of
// Cm, one per output pixel).
template <typename T>
__device__ __forceinline__ void tile_t2(const T* t1s, T* t2s,
                                        const T* __restrict__ w2,
                                        const float* __restrict__ vec, int TH,
                                        int TW, int Cm) {
  const float* b2 = vec + 3 * Cm;
  const float* a2 = vec + 4 * Cm;
  const float* c2 = vec + 5 * Cm;
  const int P = TH * TW;
  const int G = Cm / kNC, PG = kThreads / G;
  const int tid = threadIdx.x, cg = tid % G, pg = tid / G, n0 = cg * kNC;
  if (pg >= PG) return;
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

// Phase 3: t3 and the identity-skip epilogue of MODE (N = C). x, out and
// u_lo are whole NHWC tensors; b selects the image. outs (shared) receives
// the out tile when the mode pools.
template <typename T, int MODE>
__device__ __forceinline__ void tile_t3(const T* t2s, T* outs,
                                        const T* __restrict__ w3,
                                        const float* __restrict__ vec,
                                        const T* x, T* out, const T* ulo,
                                        int b, int ty0, int tx0, int TH,
                                        int TW, int H, int W, int C, int Cm) {
  const float* b3 = vec + 6 * Cm;
  const float* a3 = b3 + C;
  const float* c3 = b3 + 2 * C;
  const int P = TH * TW;
  const int G = C / kNC, PG = kThreads / G;
  const int tid = threadIdx.x, cg = tid % G, pg = tid / G, n0 = cg * kNC;
  if (pg >= PG) return;
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
        } else if (MODE == kPool || MODE == kPlainPool) {
          const T r = Store<T>::from_f(
              MODE == kPool ? xv + round_st<T>(t3) : xv + t3);
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

// One identity-skip bottleneck on the TH x TW tile of image b whose
// top-left pixel is (ty0, tx0). Ends without a barrier: a caller that
// reuses smem for another tile syncs first.
template <typename T, int MODE>
__device__ __forceinline__ void bneck_tile(
    T* smem, const T* x, const T* __restrict__ w1, const T* __restrict__ w2,
    const T* __restrict__ w3, const float* __restrict__ vec, T* out,
    T* pooled, const T* ulo, int b, int ty0, int tx0, int H, int W, int C,
    int Cm, int TH, int TW) {
  const int HW2 = (TH + 2) * (TW + 2);
  const int P = TH * TW;
  // Region A holds the x halo in phase 1, then t2 and (pooling) the out tile.
  const int regA = max(HW2 * C, P * Cm + (pools<MODE>() ? P * C : 0));
  T* xs = smem;
  T* t2s = smem;
  T* outs = smem + P * Cm;
  T* t1s = smem + regA;
  const T* xb = x + (size_t)b * H * W * C;

  // Phase 0: the x halo into shared memory, zeros outside the image.
  load_region<T>(xs, xb, ty0 - 1, tx0 - 1, TH + 2, TW + 2, H, W, C);
  __syncthreads();
  tile_t1<T>(xs, t1s, w1, vec, ty0, tx0, TH, TW, H, W, C, Cm);
  __syncthreads();
  tile_t2<T>(t1s, t2s, w2, vec, TH, TW, Cm);
  __syncthreads();
  tile_t3<T, MODE>(t2s, outs, w3, vec, x, out, ulo, b, ty0, tx0, TH, TW, H,
                   W, C, Cm);
  if (pools<MODE>()) {
    // Each tile pools its own 2x2 windows: TH and TW are even.
    __syncthreads();
    pool_tile<T>(outs, pooled, b, ty0, tx0, TH, TW, H, W, C);
  }
}

}  // namespace spe
