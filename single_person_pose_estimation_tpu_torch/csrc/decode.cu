// Batched v2 heatmap decode: (B, H, W, K) float32 NHWC -> (B, K, 3) float32
// of (x, y, conf), per image and keypoint:
//
//   idx  = first maximum of the H*W map in row-major order; conf its value
//   x    = idx % W,  y = idx / H        (the reference divides by height)
//   x1   = max(x-1, 0), x2 = min(x+2, W), and the same for y
//   legacy:    the 9 slots j are read with the patch's own width
//              pw = x2-x1 (the reference's border mis-index): row j/pw,
//              col j%pw, clamped into the map; slot pw+1 reads 0; slots
//              j >= ph*pw are -inf; p = first maximum over the slots;
//              offset ((p%3)/4, (p/3)/4), never negative
//   corrected: the 8 true neighbours inside the map (centre and
//              off-map slots -inf); offset (dx/4, dy/4) of the first
//              maximum, so +-0.25
//   out  = (x + off_x, y + off_y, conf) if conf > threshold else 0
//
// Replaces single_person_pose_estimation_tpu/experimental/decode_kernel.py:
// decode_batch_pallas (its _decode_kernel), which computes the same
// function as ops/decode.py:decode_batch. Every step is a compare, integer
// arithmetic or a division by 4, so the kernel and the plain PyTorch
// version (ops/decode.py in the port) agree exactly.
//
// Bound on the H100: the heatmaps are all there is. At B=128 and 64x64x17
// they are 35.65 MB of float32 read once, against 26 KB written and one
// compare per element, so HBM read bandwidth bounds it (~10.6 us at
// 3.35 TB/s). Straight from the head kernel the maps sit in the 50 MB L2,
// where the kernel can beat that bound.
//
// Design: the TPU kernel takes one grid step per image over an (H*W, K)
// layout and nine masked reductions for the patch. Here one block takes
// one image with a thread count that is a multiple of K (17 x 32 = 544
// for COCO): K is innermost in NHWC, so every element a thread reads
// belongs to the one keypoint tid % K, and a warp reads consecutive
// addresses. Each thread keeps a running (max, first index) over its
// pixels, in increasing order, so a strict > keeps the first maximum.
// A shared-memory pass per keypoint combines the partial results, breaking
// ties by the lower index; then K threads read their 9 patch slots (L1/L2
// hits) and write (x, y, conf).
#include <cuda_runtime.h>
#include <math_constants.h>

namespace spe {

constexpr int kDecodeThreads = 544;

__global__ void __launch_bounds__(kDecodeThreads)
decode_kernel(const float* __restrict__ hm, float* __restrict__ out, int H,
              int W, int K, float threshold, int legacy) {
  __shared__ float s_val[kDecodeThreads];
  __shared__ int s_idx[kDecodeThreads];
  const int tid = threadIdx.x;
  const int groups = kDecodeThreads / K;  // pixels read side by side
  const int HW = H * W;
  const float* map = hm + (size_t)blockIdx.x * HW * K;

  float best = -CUDART_INF_F;
  int best_idx = 0x7fffffff;              // "no pixel": loses every tie
  if (tid < groups * K) {
    const int k = tid % K;
    int p = tid / K;
    if (p < HW) {
      best = map[p * K + k];
      best_idx = p;
    }
#pragma unroll 8
    for (p += groups; p < HW; p += groups) {
      const float v = map[p * K + k];
      if (v > best) {
        best = v;
        best_idx = p;
      }
    }
  }
  s_val[tid] = best;
  s_idx[tid] = best_idx;
  __syncthreads();
  if (tid >= K) return;

  const int k = tid;
  float conf = s_val[k];
  int idx = s_idx[k];
  for (int g = 1; g < groups; ++g) {
    const float v = s_val[g * K + k];
    const int i = s_idx[g * K + k];
    if (v > conf || (v == conf && i < idx)) {
      conf = v;
      idx = i;
    }
  }
  const int x = idx % W;
  const int y = idx / H;
  const int x1 = max(x - 1, 0), y1 = max(y - 1, 0);
  const int pw = min(x + 2, W) - x1, ph = min(y + 2, H) - y1;

  float pbest = 0.f;
  int pidx = 0;
  for (int j = 0; j < 9; ++j) {
    int row, col;
    bool valid;
    if (legacy) {
      row = j / pw;
      col = j % pw;
      valid = j < ph * pw;
    } else {
      row = y - y1 + j / 3 - 1;
      col = x - x1 + j % 3 - 1;
      const int ny = y1 + row, nx = x1 + col;
      valid = ny >= 0 && ny < H && nx >= 0 && nx < W && j != 4;
    }
    const int ry = min(max(y1 + row, 0), H - 1);
    const int rx = min(max(x1 + col, 0), W - 1);
    float v = map[(ry * W + rx) * K + k];
    if (legacy && j == pw + 1) v = 0.f;
    if (!valid) v = -CUDART_INF_F;
    if (j == 0 || v > pbest) {
      pbest = v;
      pidx = j;
    }
  }
  float off_x, off_y;
  if (legacy) {
    off_x = (float)(pidx % 3) / 4.0f;
    off_y = (float)(pidx / 3) / 4.0f;
  } else {
    off_x = (float)(pidx % 3 - 1) / 4.0f;
    off_y = (float)(pidx / 3 - 1) / 4.0f;
  }
  float* o = out + ((size_t)blockIdx.x * K + k) * 3;
  const bool keep = conf > threshold;
  o[0] = keep ? __fadd_rn((float)x, off_x) : 0.f;
  o[1] = keep ? __fadd_rn((float)y, off_y) : 0.f;
  o[2] = keep ? conf : 0.f;
}

}  // namespace spe

extern "C" int spe_decode(const void* hm, void* out, int B, int H, int W,
                          int K, float threshold, int legacy, void* stream) {
  if (B == 0) return 0;
  spe::decode_kernel<<<B, spe::kDecodeThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(hm), static_cast<float*>(out), H, W, K,
      threshold, legacy);
  return (int)cudaGetLastError();
}
