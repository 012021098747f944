// The innermost `depth` levels of one hourglass (a subtree) in ONE launch:
// 3*depth + 3 identity-skip bottlenecks, the 2x2 pools on the way down and
// the upsample-adds on the way up.
//
//   walk(x, 0, h) = b(b(b(x)))                      the bottom block
//   walk(x, d, h) = b(round(b(f) + up2x(walk(maxpool2x2(f), d-1, h/2))))
//                   with f = b(x)
//
// Each b is the bottleneck of bottleneck.cuh: out = round(x + t3), t3 in
// f32. b(f) + up2x(.) is an add in the storage dtype of two rounded values
// (kUpAdd), the pools are exact. Bottleneck i of the walk reads weight set
// i, stacked in the walk's order (ops/cuda/bottom_kernel.py bneck_order).
//
// Replaces the TPU kernel single_person_pose_estimation_tpu/ops/pallas/
// bottom_kernel.py:fused_subtree (and :fused_bottom, its depth 1).
//
// Bound on the H100: the same math as the separate bottleneck launches,
// ~426 KFLOP per pixel per bottleneck at C=256, against only the subtree's
// input and output in HBM, so the math bounds it (at depth 2, B=128: 9
// bottlenecks over 16, 8 and 4 px maps). Like the other kernels it runs
// that math as f32 FMA on the CUDA cores.
//
// Design: the TPU kernel keeps every intermediate of a block of images in
// VMEM. An H100 block has 227 KB of shared memory, less than one 16 px map
// at C=256 in f32, so here ONE BLOCK WALKS ONE IMAGE: for each bottleneck
// of the walk it loops over the 8x8 tiles of the level's map and runs the
// three phases of bottleneck.cuh on each, with the pool (kPlainPool) and
// the up-add (kUpAdd) as tile epilogues. The level maps live in a global
// workspace that the wrapper allocates, per image (about 1.6 MB at depth 3,
// bf16). A __syncthreads() after every tile orders one stage's global
// writes before the next stage's reads within the block; no block reads
// another block's data, so no grid-wide barrier is needed. At B=128 that is
// 128 blocks on 132 SMs, one block per SM; a thread-block cluster per image
// (distributed shared memory) is the way to more SMs per image.
#include "bottleneck.cuh"

namespace spe {

constexpr int kMaxDepth = 4;  // JAX's walk: levels f8, f4, f2, f1

// Elements of one image's workspace: for each level k < depth of side
// h = H >> k the level output f and the up-add sum s (h*h*C each) and the
// pooled map (h*h*C/4), which later holds the inner walk's output; two
// ping-pong maps at the bottom level.
__host__ __device__ inline size_t subtree_ws_elems(int H, int C, int depth) {
  size_t n = 0;
  for (int k = 0; k < depth; ++k) {
    const size_t hk = (size_t)(H >> k) * (H >> k) * C;
    n += 2 * hk + hk / 4;
  }
  const size_t hd = (size_t)(H >> depth) * (H >> depth) * C;
  return n + 2 * hd;
}

// One bottleneck over the whole h x h map of one image, tile by tile. The
// barrier after each tile frees shared memory for the next tile and makes
// this stage's global writes visible to the block's next stage.
template <typename T, int MODE>
__device__ void bneck_map(T* smem, const T* in, const T* __restrict__ w1,
                          const T* __restrict__ w2, const T* __restrict__ w3,
                          const float* __restrict__ vec, T* out, T* pooled,
                          const T* ulo, int h, int C, int Cm) {
  const int TS = h < 8 ? h : 8;
  const int tiles = (h + TS - 1) / TS;
  for (int t = 0; t < tiles * tiles; ++t) {
    bneck_tile<T, MODE>(smem, in, w1, w2, w3, vec, out, pooled, ulo, 0,
                        (t / tiles) * TS, (t % tiles) * TS, h, h, C, Cm, TS,
                        TS);
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
subtree_kernel(const T* __restrict__ x, const T* __restrict__ w1s,
               const T* __restrict__ w2s, const T* __restrict__ w3s,
               const float* __restrict__ vecs, T* out, T* ws, int H, int C,
               int Cm, int depth, size_t ws_image) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const size_t map = (size_t)H * H * C;
  const T* xin = x + blockIdx.x * map;
  T* xout = out + blockIdx.x * map;
  T* wsb = ws + blockIdx.x * ws_image;

  T* F[kMaxDepth];
  T* S[kMaxDepth];
  T* P[kMaxDepth];
  size_t off = 0;
  for (int k = 0; k < depth; ++k) {
    const size_t hk = (size_t)(H >> k) * (H >> k) * C;
    F[k] = wsb + off;
    S[k] = F[k] + hk;
    P[k] = S[k] + hk;
    off += 2 * hk + hk / 4;
  }
  T* T0 = wsb + off;
  T* T1 = T0 + (size_t)(H >> depth) * (H >> depth) * C;

  const size_t s1 = (size_t)C * Cm, s2 = (size_t)9 * Cm * Cm, sv = 6 * Cm + 3 * C;
  int i = 0;  // the walk's bottleneck index = its weight set
#define SPE_BNECK(MODE, IN, OUT, POOLED, ULO, h)                            \
  bneck_map<T, MODE>(smem, IN, w1s + i * s1, w2s + i * s2, w3s + i * s1,   \
                     vecs + i * sv, OUT, POOLED, ULO, h, C, Cm);           \
  ++i

  // Down: f_k = b(in_k), in_{k+1} = maxpool(f_k).
  const T* in = xin;
  for (int k = 0; k < depth; ++k) {
    SPE_BNECK(kPlainPool, in, F[k], P[k], nullptr, H >> k);
    in = P[k];
  }
  // Bottom: three bottlenecks; the result goes back into the pooled map it
  // started from (dead after the first), or to out when depth is 0.
  const int hd = H >> depth;
  T* r = depth ? P[depth - 1] : xout;
  SPE_BNECK(kPlain, in, T0, nullptr, nullptr, hd);
  SPE_BNECK(kPlain, T0, T1, nullptr, nullptr, hd);
  SPE_BNECK(kPlain, T1, r, nullptr, nullptr, hd);
  // Up: s_k = round(b(f_k) + up2x(inner)), level out = b(s_k); the inner
  // walk's output of level k is in P[k].
  for (int k = depth - 1; k >= 0; --k) {
    SPE_BNECK(kUpAdd, F[k], S[k], nullptr, P[k], H >> k);
    SPE_BNECK(kPlain, S[k], k ? P[k - 1] : xout, nullptr, nullptr, H >> k);
  }
#undef SPE_BNECK
}

template <typename T>
cudaError_t launch_subtree(const void* x, const void* w1s, const void* w2s,
                           const void* w3s, const void* vecs, void* out,
                           void* ws, int B, int H, int C, int Cm, int depth,
                           long long ws_image, cudaStream_t stream) {
  if (depth < 0 || depth > kMaxDepth || (H >> depth) < 1 ||
      (H % (1 << depth)) != 0 ||
      ws_image < (long long)subtree_ws_elems(H, C, depth))
    return cudaErrorInvalidValue;
  const int TS = H < 8 ? H : 8;
  const size_t smem = tile_smem_elems(TS, TS, C, Cm, true) * sizeof(T);
  auto kernel = subtree_kernel<T>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<B, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1s),
      static_cast<const T*>(w2s), static_cast<const T*>(w3s),
      static_cast<const float*>(vecs), static_cast<T*>(out),
      static_cast<T*>(ws), H, C, Cm, depth, (size_t)ws_image);
  return cudaGetLastError();
}

}  // namespace spe

// x and out (B, H, H, C); w1s (nb, C, Cm), w2s (nb, 3, 3, Cm, Cm), w3s
// (nb, Cm, C) in the storage dtype, vecs (nb, 6*Cm + 3*C) float32, nb =
// 3*depth + 3 in the walk's order; ws holds B * ws_image elements of the
// storage dtype, ws_image >= spe_subtree_ws_elems(H, C, depth).
extern "C" int spe_subtree(int bf16, const void* x, const void* w1s,
                           const void* w2s, const void* w3s, const void* vecs,
                           void* out, void* ws, int B, int H, int C, int Cm,
                           int depth, long long ws_image, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)spe::launch_subtree<__nv_bfloat16>(
        x, w1s, w2s, w3s, vecs, out, ws, B, H, C, Cm, depth, ws_image, s);
  return (int)spe::launch_subtree<float>(x, w1s, w2s, w3s, vecs, out, ws, B, H,
                                         C, Cm, depth, ws_image, s);
}

extern "C" long long spe_subtree_ws_elems(int H, int C, int depth) {
  return (long long)spe::subtree_ws_elems(H, C, depth);
}
