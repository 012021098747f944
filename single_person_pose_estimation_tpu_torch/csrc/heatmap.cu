// Gaussian heatmap targets for training:
//
//   xi = trunc(kx[b,k]), yi = trunc(ky[b,k])
//   out[b,y,x,k] = exp(-((x-xi)^2 + (y-yi)^2) / (2 sigma^2))
//                  if 0 < xi < W, 0 < yi < H, kv[b,k] > 0,
//                     |x-xi| <= radius and |y-yi| <= radius
//                  else 0                        (float32, NHWC)
//
// Replaces single_person_pose_estimation_tpu/experimental/heatmap_kernel.py:
// render_heatmaps_batch_pallas (its _render_kernel), which computes the
// same function as ops/heatmap.py:render_heatmaps_batch bit for bit.
//
// Bound on the H100: the output is all there is. At B=64 and 64x64x17 it
// is 17.8 MB of float32 written once, against 13 KB of keypoints read and
// a few operations per element, so HBM write bandwidth bounds it (~5 us at
// 3.35 TB/s).
//
// Design: the TPU kernel builds one (H, W, K) tile per example in VMEM from
// iotas. Here one thread computes one output element, in the NHWC order of
// the output, so a warp writes 128 consecutive bytes; the few keypoints of
// an image stay in L1. The exponent is computed without contraction and
// with expf (not __expf; the build uses no fast-math), so the result stays
// within an ulp or two of the plain PyTorch version's.
#include <cuda_runtime.h>

namespace spe {

constexpr int kHeatmapThreads = 256;

__global__ void __launch_bounds__(kHeatmapThreads)
heatmap_kernel(const float* __restrict__ kx, const float* __restrict__ ky,
               const int* __restrict__ kv, float* __restrict__ out, int n,
               int H, int W, int K, int radius, float two_s2) {
  const int i = blockIdx.x * kHeatmapThreads + threadIdx.x;
  if (i >= n) return;
  const int k = i % K;
  int r = i / K;
  const int x = r % W;
  r /= W;
  const int y = r % H;
  const int b = r / H;
  const int j = b * K + k;
  const int xi = (int)truncf(kx[j]);
  const int yi = (int)truncf(ky[j]);
  float val = 0.f;
  if (xi > 0 && xi < W && yi > 0 && yi < H && kv[j] > 0) {
    const int dx = x - xi, dy = y - yi;
    if (abs(dx) <= radius && abs(dy) <= radius) {
      const float fx = (float)dx, fy = (float)dy;
      const float d2 = __fadd_rn(__fmul_rn(fx, fx), __fmul_rn(fy, fy));
      val = expf(__fdiv_rn(-d2, two_s2));
    }
  }
  out[i] = val;
}

}  // namespace spe

extern "C" int spe_heatmap(const void* kx, const void* ky, const void* kv,
                           void* out, int B, int H, int W, int K, int radius,
                           float two_s2, void* stream) {
  const int n = B * H * W * K;
  if (n == 0) return 0;
  const int blocks = (n + spe::kHeatmapThreads - 1) / spe::kHeatmapThreads;
  spe::heatmap_kernel<<<blocks, spe::kHeatmapThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(kx), static_cast<const float*>(ky),
      static_cast<const int*>(kv), static_cast<float*>(out), n, H, W, K,
      radius, two_s2);
  return (int)cudaGetLastError();
}
