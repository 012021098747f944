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
// iotas. Here a block builds `chunk` consecutive floats of one image's
// NHWC map in shared memory (whole rows where they fit, so at the train
// step's 64x64x17 four rows of 1,088 floats) and stores them once, with
// 16-byte stores where a row is a whole number of them (W * K % 4 == 0;
// else 4-byte ones). The launch comes from heatmap_geometry in
// ops/cuda/heatmap_kernel.py. The block zeros its chunk, then writes the
// value of every (keypoint, row, x) of a window that falls in it, one
// thread an item (at the train step ~476 items against 4,352 floats), and
// streams the chunk out. Only the items need a division; the stores need
// none.
//
// Each value is computed as the plain version computes it: d2 = dx*dx +
// dy*dy and -d2 / (2 sigma^2) each rounded on its own (no contraction),
// then expf (not __expf; the build uses no fast-math), so the result stays
// within an ulp or two of the plain PyTorch version's.
#include <cuda_runtime.h>

namespace spe {

constexpr int kHeatmapThreads = 256;  // HEATMAP_THREADS in the wrapper

template <int VEC>
__global__ void __launch_bounds__(kHeatmapThreads)
heatmap_kernel(const float* __restrict__ kx, const float* __restrict__ ky,
               const int* __restrict__ kv, float* __restrict__ out, int H,
               int W, int K, int radius, float two_s2, int chunk,
               int chunks) {
  extern __shared__ float4 s_heat[];  // the block's `chunk` floats
  float* s_img = reinterpret_cast<float*>(s_heat);
  const int b = blockIdx.x / chunks;
  const int rowlen = W * K;
  const int n = H * rowlen;  // floats an image
  const int c0 = (blockIdx.x - b * chunks) * chunk;
  const int len = min(chunk, n - c0);
  const int ylo = c0 / rowlen;
  const int ny = (c0 + len - 1) / rowlen - ylo + 1;  // rows the chunk meets

  for (int e = VEC * threadIdx.x; e < len; e += VEC * blockDim.x) {
    if constexpr (VEC == 4)
      *reinterpret_cast<float4*>(s_img + e) = make_float4(0.f, 0.f, 0.f, 0.f);
    else
      s_img[e] = 0.f;
  }
  __syncthreads();
  // Item i is keypoint k = i % K, row ylo + (i / K) % ny, column
  // max(xi - radius, 0) + i / (K ny).
  // At most 2 W K items (ny <= 2 where a row fills a chunk), under 2^32.
  const unsigned span = min(2 * radius + 1, W);
  const unsigned items = radius < 0 ? 0u : (unsigned)K * ny * span;
  for (unsigned i = threadIdx.x; i < items; i += blockDim.x) {
    const int k = i % K, rest = i / K;
    const long long j = (long long)b * K + k;
    const int xi = (int)truncf(kx[j]);
    const int yi = (int)truncf(ky[j]);
    if (!(xi > 0 && xi < W && yi > 0 && yi < H && kv[j] > 0)) continue;
    const int y = ylo + rest % ny;
    const int x = max(xi - radius, 0) + rest / ny;
    const int dx = x - xi, dy = y - yi;
    if (abs(dy) > radius || dx > radius || x >= W) continue;
    const int e = (y * W + x) * K + k - c0;
    if (e < 0 || e >= len) continue;
    const float fx = (float)dx, fy = (float)dy;
    const float d2 = __fadd_rn(__fmul_rn(fx, fx), __fmul_rn(fy, fy));
    s_img[e] = expf(__fdiv_rn(-d2, two_s2));
  }
  __syncthreads();
  float* dst = out + (long long)b * n + c0;
  for (int e = VEC * threadIdx.x; e < len; e += VEC * blockDim.x) {
    if constexpr (VEC == 4)
      *reinterpret_cast<float4*>(dst + e) =
          *reinterpret_cast<const float4*>(s_img + e);
    else
      dst[e] = s_img[e];
  }
}

}  // namespace spe

// chunk, chunks (= ceil(H * W * K / chunk)) and vec come from
// heatmap_geometry, which also clamps radius to [-1, max(H, W)].
extern "C" int spe_heatmap(const void* kx, const void* ky, const void* kv,
                           void* out, int B, int H, int W, int K, int radius,
                           float two_s2, int chunk, int chunks, int vec,
                           void* stream) {
  if ((long long)B * H * W * K == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const int blocks = B * chunks;
  const size_t smem = sizeof(float) * (size_t)chunk;
  const auto x = static_cast<const float*>(kx);
  const auto y = static_cast<const float*>(ky);
  const auto v = static_cast<const int*>(kv);
  const auto o = static_cast<float*>(out);
  if (vec)
    spe::heatmap_kernel<4><<<blocks, spe::kHeatmapThreads, smem, s>>>(
        x, y, v, o, H, W, K, radius, two_s2, chunk, chunks);
  else
    spe::heatmap_kernel<1><<<blocks, spe::kHeatmapThreads, smem, s>>>(
        x, y, v, o, H, W, K, radius, two_s2, chunk, chunks);
  return (int)cudaGetLastError();
}
