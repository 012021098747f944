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
// bottlenecks over 16, 8 and 4 px maps). In bfloat16 it runs that math on
// the tensor cores, with the body of bottleneck_tc.cuh and the tile plan of
// the separate launches (subtree_tc_kernel); in float32 as FMA on the CUDA
// cores (subtree_kernel).
//
// Design: the TPU kernel keeps every intermediate of a block of images in
// VMEM. An H100 block has 227 KB of shared memory, less than one 16 px map
// at C=256 in f32, so here ONE BLOCK WALKS ONE IMAGE: for each bottleneck
// of the walk it loops over the tiles of the level's map (the FMA body's
// fma_tile_plan side, or the tensor-core plan's TS x TS, clipped to the map) and runs the three phases
// of the body on each, with the pool (kPlainPool) and the up-add (kUpAdd)
// as tile epilogues. The level maps live in a global
// workspace that the wrapper allocates, per image (about 1.6 MB at depth 3,
// bf16). A __syncthreads() after every tile orders one stage's global
// writes before the next stage's reads within the block; no block reads
// another block's data, so no grid-wide barrier is needed. At B=128 that is
// 128 blocks on 132 SMs, one block per SM; a thread-block cluster per image
// (distributed shared memory) is the way to more SMs per image. The
// tensor-core body sums every output element in one fixed order wherever
// its tile lies, so in bf16 the walk gives the bits of the same walk
// composed of bottleneck.cu launches.
#include "bottleneck_tc.cuh"

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
                          const T* ulo, int h, int C, int Cm, int ts) {
  const int TS = h < ts ? h : ts;
  const int tiles = (h + TS - 1) / TS;
  for (int t = 0; t < tiles * tiles; ++t) {
    bneck_tile<T, MODE>(smem, in, w1, w2, w3, vec, out, pooled, ulo, 0,
                        (t / tiles) * TS, (t % tiles) * TS, h, h, C, Cm, TS,
                        TS);
    __syncthreads();
  }
}

// The walk of one image (blockIdx.x): `bneck(i, MODE, in, out, pooled,
// ulo, h)` runs bottleneck i of the walk over one h x h map.
template <typename T, typename Bneck>
__device__ void subtree_walk(const Bneck& bneck, const T* x, T* out, T* ws,
                             int H, int C, int depth, size_t ws_image) {
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

  int i = 0;  // the walk's bottleneck index = its weight set
  // Down: f_k = b(in_k), in_{k+1} = maxpool(f_k).
  const T* in = xin;
  for (int k = 0; k < depth; ++k) {
    bneck.template run<kPlainPool>(i++, in, F[k], P[k], nullptr, H >> k);
    in = P[k];
  }
  // Bottom: three bottlenecks; the result goes back into the pooled map it
  // started from (dead after the first), or to out when depth is 0.
  const int hd = H >> depth;
  T* r = depth ? P[depth - 1] : xout;
  bneck.template run<kPlain>(i++, in, T0, nullptr, nullptr, hd);
  bneck.template run<kPlain>(i++, T0, T1, nullptr, nullptr, hd);
  bneck.template run<kPlain>(i++, T1, r, nullptr, nullptr, hd);
  // Up: s_k = round(b(f_k) + up2x(inner)), level out = b(s_k); the inner
  // walk's output of level k is in P[k].
  for (int k = depth - 1; k >= 0; --k) {
    bneck.template run<kUpAdd>(i++, F[k], S[k], nullptr, P[k], H >> k);
    bneck.template run<kPlain>(i++, S[k], k ? P[k - 1] : xout, nullptr,
                               nullptr, H >> k);
  }
}

// Bottleneck i of the walk on the FMA body: ts x ts tiles (fma_tile_plan).
template <typename T>
struct FmaBneck {
  T* smem;
  const T *w1s, *w2s, *w3s;
  const float* vecs;
  int C, Cm, ts;
  template <int MODE>
  __device__ void run(int i, const T* in, T* out, T* pooled, const T* ulo,
                      int h) const {
    const size_t s1 = (size_t)C * Cm, s2 = (size_t)9 * Cm * Cm,
                 sv = 6 * Cm + 3 * C;
    bneck_map<T, MODE>(smem, in, w1s + i * s1, w2s + i * s2, w3s + i * s1,
                       vecs + i * sv, out, pooled, ulo, h, C, Cm, ts);
  }
};

// Bottleneck i of the walk on the tensor-core body: the tiles of the
// separate launches' plan, TSH x TSW clipped to the map.
struct TcBneck {
  unsigned char* smem;
  const bf16 *w1s, *w2s, *w3s;
  const float* vecs;
  int C, Cm, TSH, TSW, CK, NT, NST;
  template <int MODE>
  __device__ void run(int i, const bf16* in, bf16* out, bf16* pooled,
                      const bf16* ulo, int h) const {
    const size_t s1 = (size_t)C * Cm, s2 = (size_t)9 * Cm * Cm,
                 sv = 6 * Cm + 3 * C;
    const int th = h < TSH ? h : TSH, tw = h < TSW ? h : TSW;
    const int tiles_x = (h + tw - 1) / tw, tiles = ((h + th - 1) / th) * tiles_x;
    for (int t = 0; t < tiles; ++t) {
      bneck_tile_tc<MODE, kBtMaxMw>(
          smem, in, w1s + i * s1, w2s + i * s2, w3s + i * s1, vecs + i * sv,
          out, pooled, ulo, 0, (t / tiles_x) * th, (t % tiles_x) * tw, h, h,
          C, Cm, th, tw, CK, NT, NST);
      __syncthreads();
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
subtree_kernel(const T* __restrict__ x, const T* __restrict__ w1s,
               const T* __restrict__ w2s, const T* __restrict__ w3s,
               const float* __restrict__ vecs, T* out, T* ws, int H, int C,
               int Cm, int depth, size_t ws_image, int ts) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const FmaBneck<T> bneck{reinterpret_cast<T*>(smem_raw), w1s, w2s, w3s, vecs,
                          C, Cm, ts};
  subtree_walk<T>(bneck, x, out, ws, H, C, depth, ws_image);
}

__global__ void __launch_bounds__(kThreads)
subtree_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1s,
                  const bf16* __restrict__ w2s, const bf16* __restrict__ w3s,
                  const float* __restrict__ vecs, bf16* out, bf16* ws, int H,
                  int C, int Cm, int depth, size_t ws_image, int TSH, int TSW,
                  int CK, int NT, int NST) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const TcBneck bneck{smem_raw, w1s, w2s, w3s, vecs, C,
                      Cm,       TSH, TSW, CK,  NT,   NST};
  subtree_walk<bf16>(bneck, x, out, ws, H, C, depth, ws_image);
}

inline bool subtree_shape_ok(int H, int C, int depth, long long ws_image) {
  return depth >= 0 && depth <= kMaxDepth && (H >> depth) >= 1 &&
         (H % (1 << depth)) == 0 &&
         ws_image >= (long long)subtree_ws_elems(H, C, depth);
}

template <typename T>
cudaError_t launch_subtree(const void* x, const void* w1s, const void* w2s,
                           const void* w3s, const void* vecs, void* out,
                           void* ws, int B, int H, int C, int Cm, int depth,
                           long long ws_image, int ts, cudaStream_t stream) {
  if (!subtree_shape_ok(H, C, depth, ws_image) || ts < 2 || ts > 8 || ts % 2)
    return cudaErrorInvalidValue;
  const int TS = H < ts ? H : ts;
  const size_t smem = tile_smem_elems(TS, TS, C, Cm, true) * sizeof(T);
  auto kernel = subtree_kernel<T>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<B, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1s),
      static_cast<const T*>(w2s), static_cast<const T*>(w3s),
      static_cast<const float*>(vecs), static_cast<T*>(out),
      static_cast<T*>(ws), H, C, Cm, depth, (size_t)ws_image, ts);
  return cudaGetLastError();
}

inline cudaError_t launch_subtree_tc(const void* x, const void* w1s,
                                     const void* w2s, const void* w3s,
                                     const void* vecs, void* out, void* ws,
                                     int B, int H, int C, int Cm, int depth,
                                     long long ws_image, int TSH, int TSW,
                                     int CK, int NT, int NST, size_t smem,
                                     cudaStream_t stream) {
  if (!subtree_shape_ok(H, C, depth, ws_image) ||
      !bneck_tc_plan_ok(C, Cm, TSH, TSW, CK, NT, NST, smem, true))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(subtree_tc_kernel, smem);
  if (err != cudaSuccess) return err;
  subtree_tc_kernel<<<B, kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1s),
      static_cast<const bf16*>(w2s), static_cast<const bf16*>(w3s),
      static_cast<const float*>(vecs), static_cast<bf16*>(out),
      static_cast<bf16*>(ws), H, C, Cm, depth, (size_t)ws_image, TSH, TSW,
      CK, NT, NST);
  return cudaGetLastError();
}

}  // namespace spe

// x and out (B, H, H, C); w1s (nb, C, Cm), w2s (nb, 3, 3, Cm, Cm), w3s
// (nb, Cm, C) in the storage dtype, vecs (nb, 6*Cm + 3*C) float32, nb =
// 3*depth + 3 in the walk's order; ws holds B * ws_image elements of the
// storage dtype, ws_image >= spe_subtree_ws_elems(H, C, depth); ts x ts
// tiles of the FMA body (fma_tile_plan).
extern "C" int spe_subtree(int bf16, const void* x, const void* w1s,
                           const void* w2s, const void* w3s, const void* vecs,
                           void* out, void* ws, int B, int H, int C, int Cm,
                           int depth, long long ws_image, int ts,
                           void* stream) {
  if (bf16) return (int)cudaErrorInvalidValue;  // spe_subtree_tc
  return (int)spe::launch_subtree<float>(x, w1s, w2s, w3s, vecs, out, ws, B, H,
                                         C, Cm, depth, ws_image, ts,
                                         static_cast<cudaStream_t>(stream));
}

// The same in bfloat16 on the tensor cores, with the plan of
// bneck_tc_plan for the walk (tile tsh x tsw, ck, nt, nst, smem bytes).
extern "C" int spe_subtree_tc(const void* x, const void* w1s, const void* w2s,
                              const void* w3s, const void* vecs, void* out,
                              void* ws, int B, int H, int C, int Cm, int depth,
                              long long ws_image, int tsh, int tsw, int ck,
                              int nt, int nst, int smem, void* stream) {
  return (int)spe::launch_subtree_tc(x, w1s, w2s, w3s, vecs, out, ws, B, H, C,
                                     Cm, depth, ws_image, tsh, tsw, ck, nt,
                                     nst, smem,
                                     static_cast<cudaStream_t>(stream));
}

extern "C" long long spe_subtree_ws_elems(int H, int C, int depth) {
  return (long long)spe::subtree_ws_elems(H, C, depth);
}
