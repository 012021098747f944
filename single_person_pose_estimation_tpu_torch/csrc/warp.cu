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
// Design: one thread per output element, in the output's memory order, so
// a warp writes 128 consecutive bytes and its reads fall in one or two
// neighbouring stretches of the same line (cached in L1/L2). The position
// and the weights are computed in the TPU kernel's order with explicitly
// rounded operations (__fmul_rn, __fadd_rn, __fsub_rn), which nvcc never
// contracts into FMAs, so the result is bit for bit that of the plain
// PyTorch version, which rounds after every operation.
#include <cuda_runtime.h>

namespace spe {

constexpr int kWarpThreads = 256;

__global__ void __launch_bounds__(kWarpThreads)
resample_kernel(const float* __restrict__ img,
                const float* __restrict__ params, float* __restrict__ out,
                long long n, int C, int L, int K) {
  const long long i = (long long)blockIdx.x * kWarpThreads + threadIdx.x;
  if (i >= n) return;
  const int x = (int)(i % K);
  const long long line = i / K;          // (b * C + c) * L + l
  const int l = (int)(line % L);
  const int b = (int)(line / L / C);
  const float a = params[3 * b], coef = params[3 * b + 1],
              cst = params[3 * b + 2];
  const float pos = __fadd_rn(__fadd_rn(__fmul_rn(a, (float)x),
                                        __fmul_rn(coef, (float)l)),
                              cst);
  const float f0 = floorf(pos);
  const float f1 = __fadd_rn(f0, 1.f);
  const float w0 = fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(pos, f0))));
  const float w1 = fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(pos, f1))));
  const float* src = img + line * K;
  const float v0 = (f0 >= 0.f && f0 < (float)K) ? src[(int)f0] : 0.f;
  const float v1 = (f1 >= 0.f && f1 < (float)K) ? src[(int)f1] : 0.f;
  out[i] = __fadd_rn(__fmul_rn(v0, w0), __fmul_rn(v1, w1));
}

}  // namespace spe

extern "C" int spe_resample(const void* img, const void* params, void* out,
                            int B, int C, int L, int K, void* stream) {
  const long long n = (long long)B * C * L * K;
  if (n == 0) return 0;
  const long long blocks = (n + spe::kWarpThreads - 1) / spe::kWarpThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  spe::resample_kernel<<<(unsigned)blocks, spe::kWarpThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const float*>(params),
      static_cast<float*>(out), n, C, L, K);
  return (int)cudaGetLastError();
}
