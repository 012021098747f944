// Shared helpers for the hand-written inference kernels.
//
// Every kernel is templated on the storage type T (float or __nv_bfloat16)
// and accumulates in float. Channel counts are multiples of 4 at every
// call site (the wrappers require C % 16 == 0), so rows of T are read four
// values at a time: 16 bytes for float, 8 bytes for bf16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace spe {

constexpr int kThreads = 256;  // threads per block in every kernel
constexpr int kNP = 8;         // output pixels per thread per chunk
constexpr int kNC = 4;         // consecutive output channels per thread

template <typename T> struct Store;

template <> struct Store<float> {
  using V4 = float4;
  static __device__ __forceinline__ float to_f(float v) { return v; }
  static __device__ __forceinline__ float from_f(float v) { return v; }
  static __device__ __forceinline__ void load4(const float* p, float o[4]) {
    float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
};

template <> struct Store<__nv_bfloat16> {
  using V4 = uint2;
  static __device__ __forceinline__ float to_f(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 from_f(float v) {
    return __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                               float o[4]) {
    uint2 r = *reinterpret_cast<const uint2*>(p);
    float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.x));
    float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.y));
    o[0] = lo.x; o[1] = lo.y; o[2] = hi.x; o[3] = hi.y;
  }
};

// Round a float to the storage type and back: the kernels' rounding points.
template <typename T>
__device__ __forceinline__ float round_st(float v) {
  return Store<T>::to_f(Store<T>::from_f(v));
}

// acc[i][j] += sum_k A[arow[i]][k] * B[k][n0 + j], k in [0, K), K % 4 == 0.
// A rows live in shared memory; B is a (K, ldb) row-major weight in device
// memory. Threads of a warp share the A rows (broadcast reads) and take
// neighbouring channel groups, so each B row is read coalesced.
template <typename T>
__device__ __forceinline__ void mac_rows(float (&acc)[kNP][kNC],
                                         const T* const (&arow)[kNP],
                                         const T* __restrict__ B, int ldb,
                                         int n0, int K) {
  for (int k = 0; k < K; k += 4) {
    float b[4][kNC];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) Store<T>::load4(B + (size_t)(k + kk) * ldb + n0, b[kk]);
#pragma unroll
    for (int i = 0; i < kNP; ++i) {
      float a[4];
      Store<T>::load4(arow[i] + k, a);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < kNC; ++j) acc[i][j] = fmaf(a[kk], b[kk][j], acc[i][j]);
    }
  }
}

__device__ __forceinline__ void zero_acc(float (&acc)[kNP][kNC]) {
#pragma unroll
  for (int i = 0; i < kNP; ++i)
#pragma unroll
    for (int j = 0; j < kNC; ++j) acc[i][j] = 0.f;
}

// Rows of C values of the LH x LW region whose top-left pixel is (y0, x0)
// in an H x W image (xb, NHWC) into dst, zeros outside the image. xb is
// not __restrict__: bottom.cu reads maps that its block wrote earlier in
// the same launch, which the read-only (non-coherent) cache may not serve.
template <typename T>
__device__ __forceinline__ void load_region(T* dst, const T* xb,
                                            int y0, int x0, int LH, int LW,
                                            int H, int W, int C) {
  using V4 = typename Store<T>::V4;
  const int C4 = C / 4;
  for (int v = threadIdx.x; v < LH * LW * C4; v += kThreads) {
    const int q = v / C4, c = (v % C4) * 4;
    const int iy = y0 + q / LW, ix = x0 + q % LW;
    V4 val{};
    if (iy >= 0 && iy < H && ix >= 0 && ix < W)
      val = *reinterpret_cast<const V4*>(xb + ((size_t)iy * W + ix) * C + c);
    *reinterpret_cast<V4*>(dst + (size_t)q * C + c) = val;
  }
}

// The 2x2/s2 max pool of a TH x TW output tile held in shared memory (rows
// of C) whose top-left pixel is (ty0, tx0), into image b of pooled
// (H/2 x W/2). TH, TW, ty0 and tx0 are even.
template <typename T>
__device__ __forceinline__ void pool_tile(const T* tile, T* __restrict__ pooled,
                                          int b, int ty0, int tx0, int TH,
                                          int TW, int H, int W, int C) {
  const int PW = TW / 2, Ho = H / 2, Wo = W / 2;
  for (int v = threadIdx.x; v < (TH / 2) * PW * C; v += kThreads) {
    const int n = v % C, q = v / C;
    const int py = q / PW, px = q % PW;
    const int gy = ty0 / 2 + py, gx = tx0 / 2 + px;
    if (gy >= Ho || gx >= Wo) continue;
    const int p00 = 2 * py * TW + 2 * px;
    const float m = fmaxf(
        fmaxf(Store<T>::to_f(tile[(size_t)p00 * C + n]),
              Store<T>::to_f(tile[(size_t)(p00 + 1) * C + n])),
        fmaxf(Store<T>::to_f(tile[(size_t)(p00 + TW) * C + n]),
              Store<T>::to_f(tile[(size_t)(p00 + TW + 1) * C + n])));
    pooled[(((size_t)b * Ho + gy) * Wo + gx) * C + n] = Store<T>::from_f(m);
  }
}

// Shared memory above 48 KB must be opted into per kernel.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace spe
