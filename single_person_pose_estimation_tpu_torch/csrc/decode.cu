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
// layout and nine masked reductions for the patch. Here a thread-block
// cluster of `cluster` blocks takes one image, so a small batch (a served
// bucket of 1 or 16) still spreads over many SMs; the launch comes from
// decode_geometry in ops/cuda/decode_kernel.py. The image's H*W*K floats
// are cut into rows of R = lcm(VEC, K) floats (VEC = 4, or 1 where the
// image does not start on 16 bytes), R / K pixels each: for COCO's 17
// keypoints 68 floats, four pixels. A block has `groups` groups of
// `lanes` = R / VEC threads; lane c of group g reads floats VEC*c .. of
// rows g', g' + G, g' + 2G, ... (g' its group's place among the G groups
// of the cluster), so a warp reads consecutive addresses and each of the
// lane's VEC slots always meets the same keypoint, (VEC*c + j) % K. The
// lane copies its rows into shared memory with cp.async, 16 bytes at a
// time and kDecodeStages copies in flight, which hides the memory's
// latency without holding registers, and keeps a running (max, first
// index) per slot: rows come in increasing order, so a strict > keeps the
// first maximum. Then one thread a slot combines the block's groups, and
// the cluster's first block combines each keypoint's slots of every block
// (the others' through distributed shared memory). Every combination takes
// the larger value and, on a tie, the lower index, which is exact in any
// order, so every launch geometry gives the same bits. Last, the K threads
// of the first block read their 9 patch slots (L2 hits) and write (x, y,
// conf).
#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace cg = cooperative_groups;

namespace spe {

constexpr int kDecodeStages = 8;         // copies a lane has in flight
constexpr int kDecodeMaxThreads = 544;   // K_MAX: one row's lanes at most

// The larger value; on a tie the lower index.
__device__ __forceinline__ void decode_take(float& bv, int& bi, float v,
                                            int i) {
  if (v > bv || (v == bv && i < bi)) {
    bv = v;
    bi = i;
  }
}

// VEC floats from global to shared memory, asynchronously (cp.async).
template <int VEC>
__device__ __forceinline__ void decode_copy(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  if constexpr (VEC == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
}

__device__ __forceinline__ void decode_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int VEC>
__global__ void __launch_bounds__(kDecodeMaxThreads)
decode_kernel(const float* __restrict__ hm, float* __restrict__ out, int H,
              int W, int K, float threshold, int legacy, int lanes,
              int groups) {
  // [kDecodeStages][threads][VEC] copies in flight, then [groups][R]
  // values and [groups][R] first indices
  extern __shared__ float4 s_dec[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int img = blockIdx.x / cs;
  const int R = VEC * lanes;  // floats a row, lcm(VEC, K)
  const int ppr = R / K;      // pixels a row
  const int T = blockDim.x;   // lanes * groups
  float* s_stage = reinterpret_cast<float*>(s_dec);
  float* s_val = s_stage + kDecodeStages * T * VEC;
  int* s_idx = reinterpret_cast<int*>(s_val + T * VEC);
  const int g = threadIdx.x / lanes, c = threadIdx.x - g * lanes;
  const unsigned n = (unsigned)H * W * K;
  const float* map = hm + (size_t)img * n;
  const unsigned nrows = (n + R - 1) / R;
  const unsigned G = (unsigned)cs * groups;
  const unsigned col = VEC * c;

  // This lane reads rows r0, r0 + G, ...: `count` of them, the last row
  // only as far as the map goes.
  const unsigned r0 = (unsigned)rank * groups + g;
  unsigned count = 0;
  if (r0 < nrows) {
    count = (nrows - 1 - r0) / G + 1;
    if ((r0 + (count - 1) * G) * R + col >= n) --count;
  }
  float* stage = s_stage + threadIdx.x * VEC;  // this lane's slot of stage 0
  const float* src = map + r0 * R + col;
  const size_t stride = (size_t)G * R;
#pragma unroll
  for (int s = 0; s < kDecodeStages; ++s) {
    if (s < count) decode_copy<VEC>(stage + s * T * VEC, src + s * stride);
    decode_commit();
  }

  float best[VEC];
  int bidx[VEC], pj[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    best[j] = -CUDART_INF_F;
    bidx[j] = INT_MAX;  // "no pixel": loses every tie
    pj[j] = (int)(col + j) / K;
  }
  for (unsigned i = 0; i < count; ++i) {
    // Copy i has landed once at most kDecodeStages - 1 newer ones wait.
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kDecodeStages - 1)
                 : "memory");
    float* slot = stage + (i % kDecodeStages) * T * VEC;
    float v[VEC];
    if constexpr (VEC == 4) {
      const float4 q = *reinterpret_cast<const float4*>(slot);
      v[0] = q.x;
      v[1] = q.y;
      v[2] = q.z;
      v[3] = q.w;
    } else {
      v[0] = slot[0];
    }
    const int pix = (int)(r0 + i * G) * ppr;
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      if (i == 0 || v[j] > best[j]) {  // rows in order: the first maximum
        best[j] = v[j];
        bidx[j] = pix + pj[j];
      }
    if (i + kDecodeStages < count)
      decode_copy<VEC>(slot, src + (i + kDecodeStages) * stride);
    decode_commit();
  }

#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    s_val[g * R + col + j] = best[j];
    s_idx[g * R + col + j] = bidx[j];
  }
  __syncthreads();
  // The block's R slots, each combined over the block's groups by one
  // thread, into group 0's row.
  for (int e = threadIdx.x; e < R; e += T) {
    float bv = s_val[e];
    int bi = s_idx[e];
    for (int q = 1; q < groups; ++q)
      decode_take(bv, bi, s_val[q * R + e], s_idx[q * R + e]);
    s_val[e] = bv;
    s_idx[e] = bi;
  }
  if (cs == 1) {
    __syncthreads();
  } else {
    cluster.sync();
    if (rank != 0) {
      cluster.sync();  // keep this block's shared memory until it is read
      return;
    }
  }

  // The first block: each keypoint's R / K slots of every block of the
  // cluster (the others' through distributed shared memory), then its
  // patch.
  for (int k = threadIdx.x; k < K; k += T) {
    float conf = s_val[k];
    int idx = s_idx[k];
    for (int m = 1; m < ppr; ++m)
      decode_take(conf, idx, s_val[k + m * K], s_idx[k + m * K]);
    for (int q = 1; q < cs; ++q) {
      const float* rv = cluster.map_shared_rank(s_val, q);
      const int* ri = cluster.map_shared_rank(s_idx, q);
      for (int m = 0; m < ppr; ++m)
        decode_take(conf, idx, rv[k + m * K], ri[k + m * K]);
    }
    const int x = idx % W;
    const int y = idx / H;
    const int x1 = max(x - 1, 0), y1 = max(y - 1, 0);
    const int pw = min(x + 2, W) - x1, ph = min(y + 2, H) - y1;

    float pv[9];
    int prow = 0, pcol = 0;  // legacy: slot j at (j / pw, j % pw)
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      int ry, rx;
      bool valid;
      if (legacy) {
        valid = j < ph * pw;
        ry = min(y1 + prow, H - 1);
        rx = min(x1 + pcol, W - 1);
        if (++pcol == pw) {
          pcol = 0;
          ++prow;
        }
      } else {
        const int ny = y + j / 3 - 1, nx = x + j % 3 - 1;
        valid = ny >= 0 && ny < H && nx >= 0 && nx < W && j != 4;
        ry = min(max(ny, 0), H - 1);
        rx = min(max(nx, 0), W - 1);
      }
      float v = map[(ry * W + rx) * K + k];
      if (legacy && j == pw + 1) v = 0.f;
      pv[j] = valid ? v : -CUDART_INF_F;
    }
    float pbest = pv[0];
    int pidx = 0;
#pragma unroll
    for (int j = 1; j < 9; ++j)
      if (pv[j] > pbest) {
        pbest = pv[j];
        pidx = j;
      }
    float off_x, off_y;
    if (legacy) {
      off_x = (float)(pidx % 3) / 4.0f;
      off_y = (float)(pidx / 3) / 4.0f;
    } else {
      off_x = (float)(pidx % 3 - 1) / 4.0f;
      off_y = (float)(pidx / 3 - 1) / 4.0f;
    }
    float* o = out + ((size_t)img * K + k) * 3;
    const bool keep = conf > threshold;
    o[0] = keep ? __fadd_rn((float)x, off_x) : 0.f;
    o[1] = keep ? __fadd_rn((float)y, off_y) : 0.f;
    o[2] = keep ? conf : 0.f;
  }
  if (cs > 1) cluster.sync();  // the others' shared memory was read above
}

}  // namespace spe

// vec, lanes, groups, cluster and smem come from decode_geometry: a grid
// of B * cluster blocks of lanes * groups threads, in clusters of
// `cluster` (a plain launch where it is 1: every block is then a cluster
// of its own).
extern "C" int spe_decode(const void* hm, void* out, int B, int H, int W,
                          int K, float threshold, int legacy, int vec,
                          int lanes, int groups, int cluster, int smem,
                          void* stream) {
  if (B == 0) return 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)B * (unsigned)cluster);
  cfg.blockDim = dim3((unsigned)(lanes * groups));
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  const auto* x = static_cast<const float*>(hm);
  auto* o = static_cast<float*>(out);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        vec ? spe::decode_kernel<4> : spe::decode_kernel<1>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const cudaError_t err =
      vec ? cudaLaunchKernelEx(&cfg, spe::decode_kernel<4>, x, o, H, W, K,
                               threshold, legacy, lanes, groups)
          : cudaLaunchKernelEx(&cfg, spe::decode_kernel<1>, x, o, H, W, K,
                               threshold, legacy, lanes, groups);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
