// One pass of the two-pass affine warp used by training augmentation: a
// two-tap linear resample along the last axis with zero fill.
//
//   pos = slope[b] * x' + line_coef[b] * l + line_const[b]
//   out[b,c,l,x'] = sum_k img[b,c,l,k] * max(0, 1 - |pos - k|),  0 <= k < K
//
// Only k = floor(pos) and floor(pos) + 1 can have a non-zero weight, and a
// k outside [0, K) contributes nothing, so each output reads two inputs.
//
// Replaces single_person_pose_estimation_tpu/ops/pallas/warp_kernel.py:
// resample_last_axis (its _resample_kernel); affine_warp_batch launches it
// twice. The TPU kernel builds the K x K' banded weight matrix in VMEM and
// runs one matmul per line on the MXU; that is the TPU's way to avoid a
// gather, and it is not carried over.
//
// Bound on the H100: each output element reads two floats of its own line
// and does a handful of operations, so HBM bandwidth bounds it: one read of
// the input and one write of the output, 2 x 50.3 MB per launch at B=64,
// 256x256x3 float32 (~30 us at 3.35 TB/s).
//
// Design: a thread takes kResampleVec = 4 consecutive outputs of one line
// and writes them as one 16-byte store when K % 4 == 0; tx threads (a power
// of two) cover a line, 256 / tx lines share a block, and the grid is (line
// blocks, segments of tx * 4 outputs), all from ops/cuda/warp_kernel.py
// resample_geometry. Indices are int32, one division per thread gives the
// line's image and row, and each thread reads its image's three parameters
// once. The two taps of each output are read from the line in device
// memory through the read-only cache: a warp's 128 outputs read one short
// stretch of their line, so its eight loads a lane fall on the same few
// cache lines and each input byte comes from HBM about once. The position
// and the weights are computed in the TPU kernel's order with explicitly
// rounded operations (__fmul_rn, __fadd_rn, __fsub_rn), which nvcc never
// contracts into FMAs, so the result is bit for bit that of the plain
// PyTorch version, which rounds after every operation.
#include <cuda_runtime.h>

namespace spe {

constexpr int kResampleThreads = 256;
constexpr int kResampleVec = 4;

__global__ void __launch_bounds__(kResampleThreads)
resample_kernel(const float* __restrict__ img,
                const float* __restrict__ params, float* __restrict__ out,
                int lines, int C, int L, int K, int tx) {
  const long long ln =
      (long long)blockIdx.x * (kResampleThreads / tx) + threadIdx.x / tx;
  const int x0 = (blockIdx.y * tx + threadIdx.x % tx) * kResampleVec;
  if (ln >= lines || x0 >= K) return;
  const int line = (int)ln;
  const int l = line % L, b = line / L / C;  // line = (b * C + c) * L + l
  const float a = __ldg(params + 3 * b), coef = __ldg(params + 3 * b + 1),
              cst = __ldg(params + 3 * b + 2);
  const float cl = __fmul_rn(coef, (float)l);
  const float* src = img + (size_t)line * K;
  float v[kResampleVec];
#pragma unroll
  for (int e = 0; e < kResampleVec; ++e) {
    const float pos =
        __fadd_rn(__fadd_rn(__fmul_rn(a, (float)(x0 + e)), cl), cst);
    const float f0 = floorf(pos);
    const float f1 = __fadd_rn(f0, 1.f);
    const float w0 = fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(pos, f0))));
    const float w1 = fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(pos, f1))));
    const float v0 = (f0 >= 0.f && f0 < (float)K) ? __ldg(src + (int)f0) : 0.f;
    const float v1 = (f1 >= 0.f && f1 < (float)K) ? __ldg(src + (int)f1) : 0.f;
    v[e] = __fadd_rn(__fmul_rn(v0, w0), __fmul_rn(v1, w1));
  }
  float* dst = out + (size_t)line * K + x0;
  if (K % kResampleVec == 0) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < kResampleVec; ++e)
      if (x0 + e < K) dst[e] = v[e];
  }
}

}  // namespace spe

// img, out (B, C, L, K) float32, params (B, 3) float32; the geometry of
// resample_geometry: tx threads a line, a grid of gx line blocks by gy
// segments. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int spe_resample(const void* img, const void* params, void* out,
                            int B, int C, int L, int K, int tx, int gx,
                            int gy, void* stream) {
  const long long lines = (long long)B * C * L;
  if (lines == 0 || K == 0) return 0;
  if (tx < 1 || tx > spe::kResampleThreads || (tx & (tx - 1)) ||
      lines > 0x7fffffffLL || gy > 65535 ||
      (long long)gx * (spe::kResampleThreads / tx) < lines ||
      (long long)gy * tx * spe::kResampleVec < K)
    return (int)cudaErrorInvalidValue;
  spe::resample_kernel<<<dim3(gx, gy), spe::kResampleThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const float*>(params),
      static_cast<float*>(out), (int)lines, C, L, K, tx);
  return (int)cudaGetLastError();
}
