// Train-mode bottleneck units, forward and backward, for the fused train
// step (model_backend="fused"). Replaces the six TPU kernels of
// single_person_pose_estimation_tpu/experimental/bottleneck_train_kernel.py:
//
//   conv1x1_relu_stats (:72)   a = round(relu(z . W + b)),  sums [Σa, Σa²]
//   conv3x3_relu_stats (:144)  the same with a 3x3 SAME conv
//       where z = round(x * scale + shift) (or z = x for the first unit),
//       zero outside the image (the reference pads z, not x);
//   bn_bwd_reduce (:219)       sums [Σdz, Σdz·a]
//   unit1x1_bwd (:286), unit3x3_bwd (:373), unit1_bwd (:433)
//       dy  = round(a > 0 ? K1·dz + K2·a + K3 : 0)
//       din = conv^T(dy, W) rounded;  next sums [Σdin, Σdin·cin] of the RAW
//       cin; unit1: dx = round(g + din);
//       dW[tap] = Σ shift_tap(z)^T · dy,  db = Σ dy   (z = cin re-normalized)
//
// Eight kernel bodies serve the six functions:
//   unit_kernel<T, KS, PRO, EPI>  a tiled conv whose prologue makes its
//       input (z from x, or dy from dz and a) on the tile and its one-pixel
//       halo in shared memory, and whose epilogue is relu + bias + stats
//       (forward) or round + next sums or skip add (din: the conv of dy
//       with the flipped, transposed weights); FMA on the CUDA cores, for
//       every float32 unit (bfloat16 never reaches it);
//   unit3_tc_kernel<PRO, EPI>  the bfloat16 3x3 unit (#14b, and #14e's din)
//       on the tensor cores: an implicit GEMM, M = output pixels, N = Cout,
//       K = 9 * Cin (see its note below);
//   unit1_tc_kernel<PRO, EPI, WIDE>  the bfloat16 1x1 units on the tensor
//       cores, a GEMM with M = rows: the forward #14a (relu + bias +
//       stats, z = x or z = affine(x); N = Cout, K = Cin) and the backward
//       din (#14d, with or without the next sums, and #14f's dx = g + din;
//       N = the unit's input channels, K = the dy channels) (see its note
//       below);
//   reduce_kernel              the two per-channel sums of bn_bwd_reduce;
//   dw_kernel<T, KS, AFF>      split-K weight gradient: a block owns a 64x64
//       tile of one tap's dW over one slice of the rows, and recomputes dy
//       and the shifted z of that slice on the fly (FMA; float32 only);
//   dw3_tc_kernel              the bfloat16 3x3 weight gradient (#14e's dW
//       and db) on the tensor cores, split over rows; a block computes dy
//       and z once per tile for all 9 taps;
//   dw1_tc_kernel<AFF, WIDE>   the bfloat16 1x1 weight gradient (#14d's and
//       #14f's dW and db) on the tensor cores, split over rows; a block owns
//       a 128 x 128 channel tile and makes dy and z once per row tile;
//   finalize_kernel            sums the per-block partials of the others in
//       a fixed order.
//
// Bound on the H100 (B=64, 64 px, C=256, Cm=128, bf16): the 1x1 units and
// the reductions are bound by HBM bytes (~0.06-0.16 ms), the 3x3 units by
// tensor-core operations (~0.08-0.16 ms). The FMA bodies run the products
// in float32 on the CUDA cores, far above those bounds; they serve float32
// only. Every bf16 unit (the 3x3 units, the 1x1 forward and the 1x1
// backward) runs them as mma.sync.m16n8k16 bf16 with float32
// accumulation (csrc/mma.cuh): per k16 step a warp loads its A and B
// fragments with ldmatrix from padded shared-memory rows (no bank
// conflicts) and issues 16 products. What holds the 3x3 bodies above the
// bound is instruction issue and latency at 2 blocks (unit3) or 1 block
// (dw3) per SM: the prologues' float32 work, the barriers, and mma.sync's
// share of the tensor cores' rate (wgmma is the rest).
//
// Design: the TPU kernels carry their sums and dW/db across a sequential
// batch grid in VMEM. Blocks on Hopper run in parallel in no order, so each
// block writes float32 partials to a workspace that the wrapper allocates,
// and finalize_kernel adds them in a fixed order: a rerun gives the same
// bits (no float atomics). The row kernels run at most kMaxParts blocks,
// each looping over tiles in a fixed order, so the partials stay few. The
// elementwise prologues round every float32 multiply and add (__fmul_rn,
// __fadd_rn) in the plain versions' order, so z and dy equal theirs bit
// for bit; only the order of the sums differs. Nothing is allocated here.
//
// The tensor-core bodies take their plan as integers from
// ops/cuda/bottleneck_train_kernel.py (unit3_plan, dw3_plan, unit1_plan,
// dw1_plan), which the CPU tests check. Choices of the 3x3 bodies:
//   * Output tile: kTcM = 128 pixels, 8 x 16 on maps at least 16 wide
//     (halo 10 x 18: 1.41 halo pixels per output pixel, against 1.56 for
//     8 x 8), whole images from 8 px down (two of 8 x 8, eight of 4 x 4),
//     so every level of the fused step fills the tile; a warp's 16 ldmatrix
//     rows are 16 pixels of one tile row, or whole rows of small images.
//   * Halo: channel-contiguous, rows padded to CK + 8 bf16 (CK + 8 = 72: a
//     144-byte stride, so the 8 rows of an ldmatrix tile fall in 8
//     distinct 16-byte bank groups for any tap's shift); Cin in chunks of
//     CK = 64 (or 48/32/16, the widest that divides it), so any width that
//     is a multiple of 16 up to 1024 fits. Its raw values arrive by
//     cp.async with zero fill, all in flight at once, and the prologue
//     runs in place; per-block tables of the tile geometry replace the
//     integer divisions.
//   * Weights: one tap's (CK x NT) slice per stage, rows padded to NT + 8,
//     through a cp.async ring of up to TC_STAGES stages (as many as leave
//     room for two blocks per SM), one barrier per stage. NT = 128 (the
//     widest chunk of Cout that divides it), halved down to 32 on the small
//     maps so that a launch has at least TC_MIN_WORK work items.
//   * Grid: row_grid's persistent grid, capped at kMaxParts, a fixed order
//     of work items per block; the column sums of a work item go through a
//     fixed warp butterfly and a fixed order over warps into the block's
//     partial row.
//   * dW: warp w owns tap w (9 warps), the block a 32 x 64 (Ci x Co) tile
//     for all 9 taps: 9 x 32 x 64 accumulators are 64 registers a lane, and
//     dy and z are computed once per tile and channel tile (at C=128: dy 4
//     times over the 4 Ci tiles, z twice over the 2 Co tiles, against 18
//     times in dw_kernel), from a three-stage cp.async ring; the row
//     slices are as many as make about 264 blocks (twice the H100's 132
//     SMs) within DW_WORKSPACE.
//
// The 1x1 bodies (#14a forward, #14d, #14f backward) need no halo and no
// geometry: a tile is kTcM consecutive rows of the (R, K) matrix. Their
// arithmetic is small (~0.017 ms for #14a, ~0.035 ms for #14d/#14f at the
// shapes above), so HBM bytes (0.06 ms for #14a, 0.12 ms for #14d, 0.16 ms
// for #14f, each input read once) and instruction issue bound them; the
// design moves each byte once, in 16-byte copies, with enough in flight to
// cover the latency, and keeps the tensor cores fed:
//   * din and the forward (unit1_tc_kernel): one block per SM (row_grid,
//     persistent); the block's work items (a row tile and an output chunk
//     of NT channels) and their K chunks (CK = 64 or the widest that
//     divides K) form one sequence of stages through a cp.async ring of up
//     to 4 stages, so the next item's raw inputs are in flight while an
//     item's epilogue runs. A stage holds the raw dz and a (backward) or
//     the raw x (forward); each thread turns what it copied into dy or z
//     in place (prologue8, bit for bit; z = x needs nothing), and the
//     stage barrier makes it visible. The B operand, W^T for din or W
//     itself for the forward (K x N either way, rows padded to N + 8),
//     stays resident in shared memory for the whole loop where it fits
//     (64-70 KB at the fused shapes: read once per block instead of once
//     per tile); else its (CK x NT) slice rides in each stage. The
//     epilogue's aux tile (cin for the next sums, g for dx; the forward
//     has none) rides in the item's last stage into an item buffer, where
//     the epilogue also leaves its outputs for 16-byte stores (a first
//     build that read aux and stored din 4 bytes at a time from registers
//     spent most of its time there). NT is halved down to 16 on the small
//     maps so that a launch has about TC_MIN_WORK items. A ragged last
//     tile is zero-filled and its rows past R are neither stored nor
//     summed: the backward's zero rows give dy = 0, but the forward's give
//     relu(b) (relu(shift . W + b) under the affine), which is not 0.
//     Where N / NT > 1 (#14a's unit 3, 128 -> 256: two chunks of 128), the
//     chunks of one row tile are consecutive work items, so two blocks of
//     one wave read the same x tile (32 KB) within microseconds of each
//     other and the second read is served by the 50 MB L2; keeping the
//     tile in shared memory for both chunks would need both chunks'
//     accumulators (128 floats a lane) or a ring that holds a whole tile.
//     scripts/torch_port_unit1_phases.py measures what the L2 saves by
//     running the same kernel with the chunks of a tile half a launch
//     apart: 0.1904 against 0.1820 ms on an NVIDIA H100 80GB HBM3 at 700
//     W (B=64, 64 px), less than the extra 67 MB of HBM would cost alone,
//     since instruction issue and not HBM holds the kernel.
//   * dW (dw1_tc_kernel): one block per SM; a block owns a TI x TO =
//     128 x 128 (Ci x Co) tile, 8 warps of 32 x 64 (64 accumulators a
//     lane), over one slice of the row tiles of kDw1M = 64 rows, so dy is
//     made once per (row tile, Co tile) and z once per (row tile, Ci tile)
//     (dw_kernel made them 2-4 times). dz, a and cin arrive through a
//     cp.async ring of up to 4 stages; A = z^T loads with ldmatrix.trans
//     from the row-major z, B = dy with ldmatrix.trans. The slices are as
//     many as make about DW1_BLOCKS blocks within DW_WORKSPACE; with one
//     slice the kernel writes dW and db directly.
#include "common.cuh"
#include "mma.cuh"

namespace spe {
namespace train {

constexpr int kMaxParts = 1024;  // ops/cuda/bottleneck_train_kernel.py MAX_PARTS
constexpr int kDwRows = 32;      // rows of one dw_kernel step
constexpr int kDwTile = 64;      // dW tile side
constexpr int kTcM = 128;        // output pixels of a tensor-core tile (TC_M)
constexpr int kTcThreads = 256;  // unit3_tc_kernel: 8 warps, 4 along M x 2 along N
constexpr int kTcNt8 = 8;        // n8 tiles of one warp, at most
constexpr int kTcCk16 = 4;       // k16 steps of one input chunk, at most (TC_CK)
constexpr int kDwTcThreads = 288;  // dw3_tc_kernel: 9 warps, one per tap
constexpr int kDw1M = 64;        // rows of one dw1_tc_kernel stage (DW1_M)
constexpr int kDw1Tile = 128;    // widest Ci and Co tile of dw1_tc_kernel (DW1_TILE)
constexpr size_t kSmemLimit = 232448;  // one block's shared memory (SMEM_LIMIT)
static_assert(kTcThreads == kThreads, "row_grid sizes blocks of kThreads");

enum Pro { kProNone = 0, kProAffine = 1, kProDy = 2 };
enum Epi { kEpiReluStats = 0, kEpiDin = 1, kEpiDinSums = 2, kEpiDinSkip = 3 };

// The prologue's value of channel c at the in-image NHWC offset idx:
// x itself, round(x*v0 + v1), or dy = round(a > 0 ? v0*x + v1*a + v2 : 0)
// with x = dz.
template <typename T, int PRO>
__device__ __forceinline__ float prologue(const T* __restrict__ x,
                                          const T* __restrict__ a,
                                          const float* __restrict__ v0,
                                          const float* __restrict__ v1,
                                          const float* __restrict__ v2,
                                          size_t idx, int c) {
  const float xv = Store<T>::to_f(x[idx]);
  if (PRO == kProNone) return xv;
  if (PRO == kProAffine)
    return round_st<T>(__fadd_rn(__fmul_rn(xv, v0[c]), v1[c]));
  const float av = Store<T>::to_f(a[idx]);
  const float da = __fadd_rn(
      __fadd_rn(__fmul_rn(v0[c], xv), __fmul_rn(v1[c], av)), v2[c]);
  return round_st<T>(av > 0.f ? da : 0.f);
}

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// One block walks tiles t = blockIdx.x, + gridDim.x, ... of TH x TW output
// pixels. K prologue channels in, N out. part: gridDim.x rows of [s1, s2]
// (2N floats) when the epilogue sums.
template <typename T, int KS, int PRO, int EPI>
__global__ void __launch_bounds__(kThreads)
unit_kernel(const T* __restrict__ x, const T* __restrict__ a,
            const float* __restrict__ pv, const T* __restrict__ w,
            const float* __restrict__ bias, const T* __restrict__ aux,
            T* __restrict__ out, float* __restrict__ part, int H, int W,
            int K, int N, int TH, int TW, int tiles_x, int tiles_img,
            int ntiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int R = KS / 2;
  const int LH = TH + 2 * R, LW = TW + 2 * R, P = TH * TW;
  T* zs = reinterpret_cast<T*>(smem_raw);
  float* red = reinterpret_cast<float*>(
      smem_raw + align16((size_t)LH * LW * K * sizeof(T)));
  constexpr bool kSums = EPI == kEpiReluStats || EPI == kEpiDinSums;
  const int tid = threadIdx.x;
  const int G = N / kNC, PG = kThreads / G;
  const int cg = tid % G, pg = tid / G, n0 = cg * kNC;
  const float* v0 = pv;
  const float* v1 = pv + K;
  const float* v2 = pv + 2 * K;
  float s1[kNC], s2[kNC];
#pragma unroll
  for (int j = 0; j < kNC; ++j) s1[j] = s2[j] = 0.f;

  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int b = t / tiles_img, tt = t % tiles_img;
    const int ty0 = (tt / tiles_x) * TH, tx0 = (tt % tiles_x) * TW;
    __syncthreads();  // the previous tile's readers are done with zs
    for (int v = tid; v < LH * LW * K; v += kThreads) {
      const int q = v / K, c = v % K;
      const int iy = ty0 - R + q / LW, ix = tx0 - R + q % LW;
      float val = 0.f;
      if (iy >= 0 && iy < H && ix >= 0 && ix < W)
        val = prologue<T, PRO>(x, a, v0, v1, v2,
                               (((size_t)b * H + iy) * W + ix) * K + c, c);
      zs[v] = Store<T>::from_f(val);
    }
    __syncthreads();
    if (pg >= PG) continue;
    for (int base = 0; base < P; base += PG * kNP) {
      float acc[kNP][kNC];
      zero_acc(acc);
      for (int tap = 0; tap < KS * KS; ++tap) {
        const int dy = tap / KS, dx = tap % KS;
        const T* arow[kNP];
#pragma unroll
        for (int i = 0; i < kNP; ++i) {
          const int p = base + pg + PG * i;
          const int pp = p < P ? p : 0;
          arow[i] = zs + ((pp / TW + dy) * LW + pp % TW + dx) * K;
        }
        mac_rows<T>(acc, arow, w + (size_t)tap * K * N, N, n0, K);
      }
#pragma unroll
      for (int i = 0; i < kNP; ++i) {
        const int p = base + pg + PG * i;
        if (p >= P) continue;
        const int gy = ty0 + p / TW, gx = tx0 + p % TW;
        if (gy >= H || gx >= W) continue;
        const size_t o = (((size_t)b * H + gy) * W + gx) * N;
#pragma unroll
        for (int j = 0; j < kNC; ++j) {
          const int n = n0 + j;
          if (EPI == kEpiReluStats) {
            const float av = round_st<T>(fmaxf(__fadd_rn(acc[i][j], bias[n]), 0.f));
            out[o + n] = Store<T>::from_f(av);
            s1[j] += av;
            s2[j] = fmaf(av, av, s2[j]);
          } else {
            const float d = round_st<T>(acc[i][j]);
            if (EPI == kEpiDinSkip) {
              out[o + n] = Store<T>::from_f(__fadd_rn(Store<T>::to_f(aux[o + n]), d));
            } else {
              out[o + n] = Store<T>::from_f(d);
              if (EPI == kEpiDinSums) {
                s1[j] += d;
                s2[j] = fmaf(d, Store<T>::to_f(aux[o + n]), s2[j]);
              }
            }
          }
        }
      }
    }
  }
  if (!kSums) return;
  __syncthreads();
  if (pg < PG) {
#pragma unroll
    for (int j = 0; j < kNC; ++j) {
      red[(pg * 2) * N + n0 + j] = s1[j];
      red[(pg * 2 + 1) * N + n0 + j] = s2[j];
    }
  }
  __syncthreads();
  for (int v = tid; v < 2 * N; v += kThreads) {
    const int r = v / N, c = v % N;
    float s = 0.f;
    for (int g = 0; g < PG; ++g) s += red[(g * 2 + r) * N + c];
    part[(size_t)blockIdx.x * 2 * N + v] = s;
  }
}

// [Σdz, Σdz·a] of R rows of C channels: part has gridDim.x rows of 2C.
template <typename T>
__global__ void __launch_bounds__(kThreads)
reduce_kernel(const T* __restrict__ dz, const T* __restrict__ a,
              float* __restrict__ part, int R, int C) {
  __shared__ float red[2 * kThreads * kNC];  // PG * 2C <= 2 * 256 * 4
  const int tid = threadIdx.x;
  const int G = C / kNC, PG = kThreads / G;
  const int cg = tid % G, pg = tid / G, n0 = cg * kNC;
  float s1[kNC] = {0.f, 0.f, 0.f, 0.f}, s2[kNC] = {0.f, 0.f, 0.f, 0.f};
  if (pg < PG) {
    for (size_t r = (size_t)blockIdx.x * PG + pg; r < (size_t)R;
         r += (size_t)gridDim.x * PG) {
      float d[kNC], av[kNC];
      Store<T>::load4(dz + r * C + n0, d);
      Store<T>::load4(a + r * C + n0, av);
#pragma unroll
      for (int j = 0; j < kNC; ++j) {
        s1[j] += d[j];
        s2[j] = fmaf(d[j], av[j], s2[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kNC; ++j) {
      red[(pg * 2) * C + n0 + j] = s1[j];
      red[(pg * 2 + 1) * C + n0 + j] = s2[j];
    }
  }
  __syncthreads();
  for (int v = tid; v < 2 * C; v += kThreads) {
    const int r = v / C, c = v % C;
    float s = 0.f;
    for (int g = 0; g < PG; ++g) s += red[(g * 2 + r) * C + c];
    part[(size_t)blockIdx.x * 2 * C + v] = s;
  }
}

// Split-K weight gradient. blockIdx.x picks (tap, Ci tile, Co tile),
// blockIdx.y the slice of rows [y * rows, (y + 1) * rows). part row y
// (L = KS*KS*Ci*Co + Co floats): dW (tap, Ci, Co), then db (Co).
template <typename T, int KS, bool AFF>
__global__ void __launch_bounds__(kThreads)
dw_kernel(const T* __restrict__ dz, const T* __restrict__ a,
          const float* __restrict__ kv, const T* __restrict__ cin,
          const float* __restrict__ aff, float* __restrict__ part, int B,
          int H, int W, int Ci, int Co, int rows, int L) {
  __shared__ __align__(16) float zs[kDwRows][kDwTile];
  __shared__ __align__(16) float ds[kDwRows][kDwTile];
  const int tid = threadIdx.x;
  const int tiles_i = (Ci + kDwTile - 1) / kDwTile;
  const int tiles_o = (Co + kDwTile - 1) / kDwTile;
  const int tap = blockIdx.x / (tiles_i * tiles_o);
  const int rem = blockIdx.x % (tiles_i * tiles_o);
  const int i0 = (rem / tiles_o) * kDwTile, o0 = (rem % tiles_o) * kDwTile;
  const int sy = tap / KS - KS / 2, sx = tap % KS - KS / 2;
  const int tr = tid / 16, tc = tid % 16;
  const size_t R = (size_t)B * H * W;
  const size_t r_begin = (size_t)blockIdx.y * rows;
  const size_t r_end = r_begin + rows < R ? r_begin + rows : R;
  float acc[4][4], db[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    db[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  for (size_t r0 = r_begin; r0 < r_end; r0 += kDwRows) {
    __syncthreads();
    for (int v = tid; v < kDwRows * kDwTile; v += kThreads) {
      const int p = v / kDwTile, c = v % kDwTile;
      const size_t r = r0 + p;
      float zv = 0.f, dv = 0.f;
      if (r < r_end) {
        if (o0 + c < Co)
          dv = prologue<T, kProDy>(dz, a, kv, kv + Co, kv + 2 * Co,
                                   r * Co + o0 + c, o0 + c);
        const int yx = (int)(r % ((size_t)H * W));
        const int y = yx / W + sy, x = yx % W + sx;
        if (i0 + c < Ci && y >= 0 && y < H && x >= 0 && x < W) {
          const size_t idx = (r - yx + (size_t)y * W + x) * Ci + i0 + c;
          zv = AFF ? prologue<T, kProAffine>(cin, cin, aff, aff + Ci, aff,
                                             idx, i0 + c)
                   : Store<T>::to_f(cin[idx]);
        }
      }
      zs[p][c] = zv;
      ds[p][c] = dv;
    }
    __syncthreads();
#pragma unroll 4
    for (int p = 0; p < kDwRows; ++p) {
      const float4 z4 = *reinterpret_cast<const float4*>(&zs[p][tr * 4]);
      const float4 d4 = *reinterpret_cast<const float4*>(&ds[p][tc * 4]);
      const float z[4] = {z4.x, z4.y, z4.z, z4.w};
      const float d[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(z[i], d[j], acc[i][j]);
#pragma unroll
      for (int j = 0; j < 4; ++j) db[j] += d[j];
    }
  }
  float* dst = part + (size_t)blockIdx.y * L;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ci = i0 + tr * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = o0 + tc * 4 + j;
      if (ci < Ci && co < Co) dst[((size_t)tap * Ci + ci) * Co + co] = acc[i][j];
    }
  }
  if (tap == 0 && i0 == 0 && tr == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = o0 + tc * 4 + j;
      if (co < Co) dst[(size_t)KS * KS * Ci * Co + co] = db[j];
    }
  }
}

// out[l] = sum over p of ws[p][l], p in a fixed order: 8 groups of
// consecutive partials, then the 8 group sums in order.
__global__ void __launch_bounds__(kThreads)
finalize_kernel(const float* __restrict__ ws, float* __restrict__ out,
                int nparts, int L) {
  __shared__ float red[8][32];
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  const int per = (nparts + 7) / 8;
  const int p0 = g * per, p1 = p0 + per < nparts ? p0 + per : nparts;
  float s = 0.f;
  if (col < L)
    for (int p = p0; p < p1; ++p) s += ws[(size_t)p * L + col];
  red[g][lane] = s;
  __syncthreads();
  if (g == 0 && col < L) {
    float tot = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) tot += red[k][lane];
    out[col] = tot;
  }
}

inline cudaError_t launch_finalize(const float* ws, float* out, int nparts,
                                   int L, cudaStream_t s) {
  finalize_kernel<<<(L + 31) / 32, kThreads, 0, s>>>(ws, out, nparts, L);
  return cudaGetLastError();
}

// Blocks of a row kernel: as many as the card holds at once, at most
// kMaxParts and at most `work`. The same card gives the same count, so a
// rerun sums in the same order.
template <typename Kern>
cudaError_t row_grid(Kern kernel, size_t smem, int work, int* grid) {
  int dev = 0, sms = 0, occ = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  int g = (occ > 0 ? occ : 1) * sms;
  if (g > kMaxParts) g = kMaxParts;
  if (g > work) g = work;
  *grid = g > 0 ? g : 1;
  return cudaSuccess;
}

template <typename T, int KS, int PRO, int EPI>
cudaError_t launch_unit(const void* x, const void* a, const void* pv,
                        const void* w, const void* bias, const void* aux,
                        void* out, void* ws, void* sums, int B, int H, int W,
                        int K, int N, cudaStream_t s) {
  const int PG = kThreads / (N / kNC);
  auto smem_of = [&](int th, int tw) {
    return align16((size_t)(th + KS - 1) * (tw + KS - 1) * K * sizeof(T)) +
           (size_t)PG * 2 * N * sizeof(float);
  };
  // 8 x 8 tiles, halved where the input tile would not fit one block's
  // shared memory (float32 at up to 1024 channels).
  int TH = H < 8 ? H : 8, TW = W < 8 ? W : 8;
  while (smem_of(TH, TW) > kSmemLimit && (TH > 1 || TW > 1)) {
    if (TH >= TW) TH = (TH + 1) / 2;
    else TW = (TW + 1) / 2;
  }
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_img = ((H + TH - 1) / TH) * tiles_x;
  const int ntiles = B * tiles_img;
  const size_t smem = smem_of(TH, TW);
  auto kernel = unit_kernel<T, KS, PRO, EPI>;
  cudaError_t err = allow_smem(kernel, smem);
  int grid = 0;
  if (err == cudaSuccess) err = row_grid(kernel, smem, ntiles, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(a),
      static_cast<const float*>(pv), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<const T*>(aux),
      static_cast<T*>(out), static_cast<float*>(ws), H, W, K, N, TH, TW,
      tiles_x, tiles_img, ntiles);
  err = cudaGetLastError();
  if (err != cudaSuccess || !(EPI == kEpiReluStats || EPI == kEpiDinSums))
    return err;
  return launch_finalize(static_cast<const float*>(ws),
                         static_cast<float*>(sums), grid, 2 * N, s);
}

// float32 only: bf16 runs unit1_tc_kernel and unit3_tc_kernel.
inline cudaError_t dispatch_unit(int ks, int pro, int epi, const void* x,
                                 const void* a, const void* pv, const void* w,
                                 const void* bias, const void* aux, void* out,
                                 void* ws, void* sums, int B, int H, int W,
                                 int K, int N, cudaStream_t s) {
#define SPE_UNIT(KS_, PRO_, EPI_)                                              \
  if (ks == KS_ && pro == PRO_ && epi == EPI_)                                 \
    return launch_unit<float, KS_, PRO_, EPI_>(x, a, pv, w, bias, aux, out,    \
                                               ws, sums, B, H, W, K, N, s);
  SPE_UNIT(1, kProNone, kEpiReluStats)
  SPE_UNIT(1, kProAffine, kEpiReluStats)
  SPE_UNIT(1, kProDy, kEpiDin)
  SPE_UNIT(1, kProDy, kEpiDinSums)
  SPE_UNIT(1, kProDy, kEpiDinSkip)
  SPE_UNIT(3, kProAffine, kEpiReluStats)
  SPE_UNIT(3, kProDy, kEpiDinSums)
#undef SPE_UNIT
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_reduce(const void* dz, const void* a, void* ws, void* sums,
                          int R, int C, cudaStream_t s) {
  const int PG = kThreads / (C / kNC);
  int grid = 0;
  cudaError_t err = row_grid(reduce_kernel<T>, 0, (R + PG - 1) / PG, &grid);
  if (err != cudaSuccess) return err;
  reduce_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(dz), static_cast<const T*>(a),
      static_cast<float*>(ws), R, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_finalize(static_cast<const float*>(ws),
                         static_cast<float*>(sums), grid, 2 * C, s);
}

template <int KS, bool AFF>
cudaError_t launch_dw(const void* dz, const void* a, const void* k,
                      const void* cin, const void* aff, void* ws, void* out,
                      int B, int H, int W, int Ci, int Co, int slices,
                      int rows, cudaStream_t s) {
  const int L = KS * KS * Ci * Co + Co;
  const int tiles = KS * KS * ((Ci + kDwTile - 1) / kDwTile) *
                    ((Co + kDwTile - 1) / kDwTile);
  dw_kernel<float, KS, AFF><<<dim3(tiles, slices), kThreads, 0, s>>>(
      static_cast<const float*>(dz), static_cast<const float*>(a),
      static_cast<const float*>(k), static_cast<const float*>(cin),
      static_cast<const float*>(aff), static_cast<float*>(ws), B, H, W, Ci,
      Co, rows, L);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_finalize(static_cast<const float*>(ws),
                         static_cast<float*>(out), slices, L, s);
}

// float32 only: bf16 runs dw1_tc_kernel and dw3_tc_kernel.
inline cudaError_t dispatch_dw(int ks, int aff, const void* dz, const void* a,
                               const void* k, const void* cin,
                               const void* affv, void* ws, void* out, int B,
                               int H, int W, int Ci, int Co, int slices,
                               int rows, cudaStream_t s) {
  if (ks == 1 && aff)
    return launch_dw<1, true>(dz, a, k, cin, affv, ws, out, B, H, W, Ci, Co, slices, rows, s);
  if (ks == 1)
    return launch_dw<1, false>(dz, a, k, cin, affv, ws, out, B, H, W, Ci, Co, slices, rows, s);
  if (ks == 3 && aff)
    return launch_dw<3, true>(dz, a, k, cin, affv, ws, out, B, H, W, Ci, Co, slices, rows, s);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The 3x3 units in bfloat16 on the tensor cores.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

// A tile is ni images x th rows x tw columns of output pixels (at most
// kTcM), its halo ni x (th + 2) x (tw + 2) pixels; tiles run image group
// by image group, row of tiles by row of tiles.
struct TcTiles {
  int B, H, W, ni, th, tw, tiles_x, tiles_y, ntiles;
};

inline TcTiles make_tiles(int B, int H, int W, int ni, int th, int tw) {
  TcTiles g{B, H, W, ni, th, tw, (W + tw - 1) / tw, (H + th - 1) / th, 0};
  g.ntiles = ((B + ni - 1) / ni) * g.tiles_y * g.tiles_x;
  return g;
}

__device__ __forceinline__ void tile_origin(const TcTiles& g, int t, int& b0,
                                            int& y0, int& x0) {
  const int per_group = g.tiles_y * g.tiles_x, r = t % per_group;
  b0 = (t / per_group) * g.ni;
  y0 = (r / g.tiles_x) * g.th;
  x0 = (r % g.tiles_x) * g.tw;
}

// Output pixel m of a tile: image i, row r, column c within it.
__device__ __forceinline__ void tile_pixel(const TcTiles& g, int m, int& i,
                                           int& r, int& c) {
  c = m % g.tw;
  r = (m / g.tw) % g.th;
  i = m / (g.tw * g.th);
}

// The halo index of pixel (i, r, c) at tap (0, 0); tap (p, q) adds
// p * (tw + 2) + q.
__device__ __forceinline__ int halo_index(const TcTiles& g, int i, int r, int c) {
  return (i * (g.th + 2) + r) * (g.tw + 2) + c;
}

// Each block tabulates its tile geometry once: hpk[q] = packed (image,
// row, column) of halo pixel q (row and column from the halo's corner),
// mpk[m] = packed (image, row, column) of tile row m, -1 past P; 8 bits
// for the row and for the column (th <= kTcM, tw <= 16). A lookup then
// takes the place of three integer divisions per pixel.
__device__ __forceinline__ int pack_irc(int i, int r, int c) {
  return (i << 16) | (r << 8) | c;
}

__device__ __forceinline__ void build_tables(const TcTiles& g, int* hpk,
                                             int* mpk) {
  const int LH = g.th + 2, LW = g.tw + 2, P = g.ni * g.th * g.tw;
  for (int q = threadIdx.x; q < g.ni * LH * LW; q += blockDim.x)
    hpk[q] = pack_irc(q / (LH * LW), (q / LW) % LH, q % LW);
  for (int m = threadIdx.x; m < kTcM; m += blockDim.x) {
    int i, r, c;
    tile_pixel(g, m, i, r, c);
    mpk[m] = m < P ? pack_irc(i, r, c) : -1;
  }
}

// The NHWC pixel index of a tile row (packed, or -1) of the tile at (b0,
// y0, x0), or -1 outside the batch or the image.
__device__ __forceinline__ int row_pix(const TcTiles& g, int pk, int b0,
                                       int y0, int x0) {
  const int b = b0 + (pk >> 16), y = y0 + ((pk >> 8) & 255), x = x0 + (pk & 255);
  if (pk < 0 || b >= g.B || y >= g.H || x >= g.W) return -1;
  return (b * g.H + y) * g.W + x;
}

// The NHWC pixel index of a halo pixel (packed) of the tile at (b0, y0,
// x0), or -1 outside (the prologue's zero padding).
__device__ __forceinline__ int halo_pix(const TcTiles& g, int pk, int b0,
                                        int y0, int x0) {
  const int b = b0 + (pk >> 16), y = y0 + ((pk >> 8) & 255) - 1,
            x = x0 + (pk & 255) - 1;
  if (b >= g.B || y < 0 || y >= g.H || x < 0 || x >= g.W) return -1;
  return (b * g.H + y) * g.W + x;
}

__host__ __device__ inline size_t tables_bytes(int nhalo) {
  return align16((size_t)(nhalo + kTcM) * 4);
}

__device__ __forceinline__ float bf_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }
__device__ __forceinline__ float round_bf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// prologue<bf16, PRO> of 8 consecutive channels from their raw values (x,
// and a for kProDy, 8 packed bf16 each) and the constants v0[c], v1[c],
// v2[c] of c = c0..c0+7, as 8 packed bf16: the same float32 operations in
// the same order as prologue<T, PRO>, so the same bits.
template <int PRO>
__device__ __forceinline__ uint4 prologue8(uint4 xr, uint4 ar,
                                           const float* v0, const float* v1,
                                           const float* v2, int c0) {
  const uint32_t xw[4] = {xr.x, xr.y, xr.z, xr.w};
  const uint32_t aw[4] = {ar.x, ar.y, ar.z, ar.w};
  uint32_t ow[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float o[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + 2 * k + h;
      const float xv = h ? bf_hi(xw[k]) : bf_lo(xw[k]);
      if (PRO == kProAffine) {
        o[h] = __fadd_rn(__fmul_rn(xv, v0[c]), v1[c]);
      } else {
        const float av = h ? bf_hi(aw[k]) : bf_lo(aw[k]);
        const float da = __fadd_rn(
            __fadd_rn(__fmul_rn(v0[c], xv), __fmul_rn(v1[c], av)), v2[c]);
        o[h] = av > 0.f ? da : 0.f;
      }
    }
    ow[k] = mma::pack_bf16(o[0], o[1]);
  }
  return make_uint4(ow[0], ow[1], ow[2], ow[3]);
}

__device__ __forceinline__ uint4 lds16(const bf16* p) {
  return *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ void sts16(bf16* p, uint4 v) {
  *reinterpret_cast<uint4*>(p) = v;
}

// One block walks work items t = blockIdx.x, + gridDim.x, ...: item t is
// tile t / (N / NT) and the NT output channels of chunk t % (N / NT). Per
// input chunk of CK channels, the halo's raw values (x, and a for kProDy)
// arrive by cp.async, all in flight together, and each thread runs the
// prologue in place on the values it copied; the 9 taps' (CK x NT) weight
// slices stream through an NST-stage cp.async ring, NST - 1 stages ahead.
// Warp (wm, wn) owns rows wm*32..+31 of the tile's kTcM and columns
// wn*NT/2..+NT/2 of the chunk: 2 x NT/16 m16n8 accumulators.
template <int PRO, int EPI>
__global__ void __launch_bounds__(kTcThreads, 2)
unit3_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ a,
                const float* __restrict__ pv, const bf16* __restrict__ w,
                const float* __restrict__ bias, const bf16* __restrict__ aux,
                bf16* __restrict__ out, float* __restrict__ part, TcTiles g,
                int K, int N, int CK, int NT, int NST) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int LH = g.th + 2, LW = g.tw + 2, nhalo = g.ni * LH * LW;
  const int SH = CK + 8, SW = NT + 8;  // padded rows: ldmatrix is conflict-free
  const size_t halo_bytes = align16((size_t)nhalo * SH * 2);
  int* hpk = reinterpret_cast<int*>(smem_raw);
  int* mpk = hpk + nhalo;
  unsigned char* base = smem_raw + tables_bytes(nhalo);
  bf16* halo = reinterpret_cast<bf16*>(base);  // raw x, then z or dy
  bf16* araw = reinterpret_cast<bf16*>(base + halo_bytes);  // kProDy: a
  bf16* ring = reinterpret_cast<bf16*>(base + halo_bytes * (PRO == kProDy ? 2 : 1));
  float* colred = reinterpret_cast<float*>(ring + NST * CK * SW);  // [4][2][NT]
  float* red = colred + 8 * NT;                                    // [2][N]
  const int tid = threadIdx.x, lane = tid & 31, wm = (tid >> 5) & 3,
            wn = tid >> 7;
  const int P = g.ni * g.th * g.tw, nt8 = NT / 16, nch = N / NT;
  const int nstage = 9 * (K / CK), nwork = g.ntiles * nch, c8 = CK / 8;
  const float *v0 = pv, *v1 = pv + K, *v2 = pv + 2 * K;
  const bool busy = wm * 32 < P;  // a warp whose rows all lie past P idles

  for (int v = tid; v < 2 * N; v += kTcThreads) red[v] = 0.f;
  build_tables(g, hpk, mpk);
  __syncthreads();
  // This thread copies halo pixels q = hq0, + qstep, ... (channels hc0..
  // hc0+7 of the chunk) and weight rows kr0, + krstep, ... (columns
  // wc0..wc0+7); threads past the last whole step idle.
  const int qstep = kTcThreads / c8, hq0 = tid / c8, hc0 = (tid % c8) * 8;
  const int qlim = tid < qstep * c8 ? nhalo : 0;
  const int per_row = NT / 8, krstep = kTcThreads / per_row;
  const int kr0 = tid / per_row, wc0 = (tid % per_row) * 8;
  const int krlim = tid < krstep * per_row ? CK : 0;
  // The halo rows this lane's ldmatrix reads for its two m16 tiles.
  int arow[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int m = wm * 32 + mt * 16 + (lane & 15);
    int i, r, c;
    tile_pixel(g, m, i, r, c);
    arow[mt] = m < P ? halo_index(g, i, r, c) : 0;
  }
  const int krow = ((lane >> 3) & 1) * 8 + (lane & 7);  // B rows of ldmatrix

  for (int t = blockIdx.x; t < nwork; t += gridDim.x) {
    const int nc = t % nch;
    int b0, y0, x0;
    tile_origin(g, t / nch, b0, y0, x0);
    const bf16* wchunk = w + nc * NT;
    float acc[2][kTcNt8][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < kTcNt8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

    // Stage s: tap s % 9 of input chunk s / 9 into ring slot s % NST; one
    // commit group per stage, empty past the last.
    auto issue = [&](int s) {
      if (s < nstage) {
        const int kc = s / 9, tap = s % 9;
        bf16* dst = ring + (s % NST) * CK * SW + wc0;
        const bf16* src = wchunk + ((size_t)tap * K + kc * CK) * N + wc0;
        for (int kr = kr0; kr < krlim; kr += krstep)
          mma::cp_async16(mma::smem_u32(dst + kr * SW), src + (size_t)kr * N);
      }
      mma::cp_async_commit();
    };
    for (int s = 0; s < NST - 1; ++s) issue(s);
    for (int s = 0; s < nstage; ++s) {
      const int kc = s / 9, tap = s % 9;
      if (tap == 0) {
        // The halo of chunk kc, zeros outside the image.
        if (s > 0) __syncthreads();  // the previous chunk's readers are done
        const int c0 = kc * CK + hc0;
        for (int q = hq0; q < qlim; q += qstep) {
          const int pix = halo_pix(g, hpk[q], b0, y0, x0);
          const size_t idx = (size_t)(pix >= 0 ? pix : 0) * K + c0;
          mma::cp_async16_zfill(mma::smem_u32(halo + q * SH + hc0), x + idx, pix >= 0);
          if (PRO == kProDy)
            mma::cp_async16_zfill(mma::smem_u32(araw + q * SH + hc0), a + idx,
                                  pix >= 0);
        }
        mma::cp_async_commit();
        mma::cp_async_wait<0>();
        for (int q = hq0; q < qlim; q += qstep) {
          if (halo_pix(g, hpk[q], b0, y0, x0) < 0) continue;
          const uint4 ar = PRO == kProDy ? lds16(araw + q * SH + hc0)
                                         : make_uint4(0, 0, 0, 0);
          sts16(halo + q * SH + hc0,
                prologue8<PRO>(lds16(halo + q * SH + hc0), ar, v0, v1, v2, c0));
        }
      }
      mma::cp_async_wait_n(NST - 2);  // stage s has landed
      // Stage s and the halo are visible; every warp is done with stage
      // s - 1, whose ring slot stage s + NST - 1 takes.
      __syncthreads();
      issue(s + NST - 1);
      if (busy) {
        const bf16* wb = ring + (s % NST) * CK * SW;
        const int toff = (tap / 3) * LW + tap % 3;
#pragma unroll
        for (int ks = 0; ks < kTcCk16; ++ks) {
          if (ks >= CK / 16) break;
          uint32_t af[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            mma::ldmatrix_x4(af[mt], mma::smem_u32(
                halo + (arow[mt] + toff) * SH + ks * 16 + (lane >> 4) * 8));
          const bf16* brow = wb + (ks * 16 + krow) * SW + wn * (NT / 2);
#pragma unroll
          for (int j = 0; j < kTcNt8; j += 2) {
            if (j >= nt8) break;
            if (j + 1 < nt8) {
              uint32_t bq[4];
              mma::ldmatrix_x4_t(bq, mma::smem_u32(brow + j * 8 + (lane >> 4) * 8));
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) {
                mma::mma_bf16(acc[mt][j], af[mt], bq[0], bq[1]);
                mma::mma_bf16(acc[mt][j + 1], af[mt], bq[2], bq[3]);
              }
            } else {
              uint32_t bq[2];
              mma::ldmatrix_x2_t(bq, mma::smem_u32(brow + j * 8));
#pragma unroll
              for (int mt = 0; mt < 2; ++mt)
                mma::mma_bf16(acc[mt][j], af[mt], bq[0], bq[1]);
            }
          }
        }
      }
    }
    __syncthreads();  // the last stage's readers are done with the ring

    // Epilogue: this thread's rows (mt, h) are wm*32 + mt*16 + h*8 + lane/4.
    int pix[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = wm * 32 + mt * 16 + h * 8 + (lane >> 2);
        pix[mt][h] = row_pix(g, mpk[m], b0, y0, x0);
      }
#pragma unroll
    for (int j = 0; j < kTcNt8; ++j) {
      if (j >= nt8) break;
      const int cl = wn * (NT / 2) + j * 8 + 2 * (lane & 3);  // in the chunk
      const int n = nc * NT + cl;
      float s[4] = {0.f, 0.f, 0.f, 0.f};  // [Σu] of n, n+1, then [Σu·v]
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (pix[mt][h] < 0) continue;
          const size_t o = (size_t)pix[mt][h] * N + n;
          float u[2], v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float c = acc[mt][j][2 * h + e];
            u[e] = EPI == kEpiReluStats
                       ? round_bf(fmaxf(__fadd_rn(c, bias[n + e]), 0.f))
                       : round_bf(c);
          }
          *reinterpret_cast<uint32_t*>(out + o) = mma::pack_bf16(u[0], u[1]);
          if (EPI == kEpiReluStats) {
            v[0] = u[0];
            v[1] = u[1];
          } else {  // the next sums read the RAW cin
            const uint32_t cw = *reinterpret_cast<const uint32_t*>(aux + o);
            v[0] = bf_lo(cw);
            v[1] = bf_hi(cw);
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            s[e] += u[e];
            s[2 + e] = fmaf(u[e], v[e], s[2 + e]);
          }
        }
      // The 8 lanes of one column pair, in a fixed butterfly.
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[e] += __shfl_xor_sync(0xffffffffu, s[e], off);
      if (lane < 4) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          colred[(wm * 2) * NT + cl + e] = s[e];
          colred[(wm * 2 + 1) * NT + cl + e] = s[2 + e];
        }
      }
    }
    __syncthreads();
    for (int v = tid; v < 2 * NT; v += kTcThreads) {
      const int r = v / NT, c = v % NT;
      red[r * N + nc * NT + c] +=
          ((colred[r * NT + c] + colred[(2 + r) * NT + c]) +
           colred[(4 + r) * NT + c]) + colred[(6 + r) * NT + c];
    }
  }
  __syncthreads();
  for (int v = tid; v < 2 * N; v += kTcThreads)
    part[(size_t)blockIdx.x * 2 * N + v] = red[v];
}

// The 3x3 weight gradient, split over rows: blockIdx.x picks a TI x TO
// tile of (Ci, Co), blockIdx.y a slice of `per` tiles of output pixels.
// Per tile the raw dz and a (TO channels, kTcM rows) and the raw cin halo
// (TI channels) arrive by cp.async into one of three stages; each thread
// runs the prologues in place on the values it copied (dy, z: once per
// tile and channel tile). While the warps run tile t's products, tile t + 2
// is in flight and each thread's prologues of tile t + 1 are interleaved
// with its k steps, so the ALU work overlaps the tensor cores'. Warp w owns
// tap w and reads both operands with ldmatrix.trans (A = shifted z^T, B =
// dy). part row y (L floats): dW (tap, Ci, Co), then db (Co), summed by the
// blocks of Ci tile 0 from the dy they make.
__global__ void __launch_bounds__(kDwTcThreads)
dw3_tc_kernel(const bf16* __restrict__ dz, const bf16* __restrict__ a,
              const float* __restrict__ kv, const bf16* __restrict__ cin,
              const float* __restrict__ aff, float* __restrict__ part,
              TcTiles g, int Ci, int Co, int TI, int TO, int per, int L) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int LW = g.tw + 2, nhalo = g.ni * (g.th + 2) * LW;
  const int SZ = TI + 8, SD = TO + 8;
  // The geometry tables, then three stages of [dz -> dy, a, cin -> z].
  int* hpk = reinterpret_cast<int*>(smem_raw);
  int* mpk = hpk + nhalo;
  unsigned char* stages = smem_raw + tables_bytes(nhalo);
  const size_t stage_bytes = align16((size_t)(2 * kTcM * SD + nhalo * SZ) * 2);
  const int tid = threadIdx.x, lane = tid & 31, tap = tid >> 5;
  const int tiles_o = Co / TO;
  const int i0 = (blockIdx.x / tiles_o) * TI, o0 = (blockIdx.x % tiles_o) * TO;
  const int P = g.ni * g.th * g.tw, nks = (P + 15) / 16;
  const int mt16 = TI / 16, nt8 = TO / 8, d8 = TO / 8, z8 = TI / 8;
  // This thread's dy vectors are tile rows m0, + mstep, ... (channels
  // dcol..dcol+7), its z vectors halo pixels q0, + qstep, ... (channels
  // zcol..zcol+7): kDwTcThreads is a multiple of d8 and z8, so each
  // thread keeps its channels and their constants stay in registers.
  const int mstep = kDwTcThreads / d8, m0 = tid / d8, dcol = (tid % d8) * 8;
  const int qstep = kDwTcThreads / z8, q0 = tid / z8, zcol = (tid % z8) * 8;
  build_tables(g, hpk, mpk);
  float k1[8], k2[8], k3[8], sc[8], sh[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    k1[j] = kv[o0 + dcol + j];
    k2[j] = kv[Co + o0 + dcol + j];
    k3[j] = kv[2 * Co + o0 + dcol + j];
    sc[j] = aff[i0 + zcol + j];
    sh[j] = aff[Ci + i0 + zcol + j];
  }
  const bool db_sums = i0 == 0;
  float dbp[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  // The (shifted) halo row this lane's ldmatrix reads at each k step.
  int ah[kTcM / 16];
#pragma unroll
  for (int ks = 0; ks < kTcM / 16; ++ks) {
    const int m = ks * 16 + (lane >> 4) * 8 + (lane & 7);
    int i, r, c;
    tile_pixel(g, m, i, r, c);
    ah[ks] = (m < P ? halo_index(g, i, r, c) : 0) + (tap / 3) * LW + tap % 3;
  }
  const int krow = ((lane >> 3) & 1) * 8 + (lane & 7);
  float acc[2][kTcNt8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < kTcNt8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

  auto dy_of = [&](int slot) {
    return reinterpret_cast<bf16*>(stages + slot * stage_bytes);
  };
  // Tile t's raw values into stage `slot`, zeros past the tile and outside
  // the image; one commit group (empty past the slice).
  auto issue = [&](int t, int t_end, int slot) {
    if (t < t_end) {
      int b0, y0, x0;
      tile_origin(g, t, b0, y0, x0);
      bf16* ds = dy_of(slot);
      bf16* as = ds + kTcM * SD;
      bf16* zs = as + kTcM * SD;
      for (int m = m0; m < nks * 16; m += mstep) {
        const int pix = row_pix(g, mpk[m], b0, y0, x0);
        const size_t idx = (size_t)(pix >= 0 ? pix : 0) * Co + o0 + dcol;
        mma::cp_async16_zfill(mma::smem_u32(ds + m * SD + dcol), dz + idx, pix >= 0);
        mma::cp_async16_zfill(mma::smem_u32(as + m * SD + dcol), a + idx, pix >= 0);
      }
      for (int q = q0; q < nhalo; q += qstep) {
        const int pix = halo_pix(g, hpk[q], b0, y0, x0);
        const size_t idx = (size_t)(pix >= 0 ? pix : 0) * Ci + i0 + zcol;
        mma::cp_async16_zfill(mma::smem_u32(zs + q * SZ + zcol), cin + idx, pix >= 0);
      }
    }
    mma::cp_async_commit();
  };
  // Prologue unit k of the tile at (b0, y0, x0) in stage `slot`, in place:
  // this thread's dy vector k (rows past the tile hold zeros, so their dy
  // is 0) and its z vector k (z stays 0 outside the image), where they
  // exist; k < kTcM / 16 covers them all.
  auto prologue_unit = [&](int k, int slot, int b0, int y0, int x0) {
    bf16* ds = dy_of(slot);
    const int m = m0 + k * mstep, q = q0 + k * qstep;
    if (m < nks * 16) {
      bf16* p = ds + m * SD + dcol;
      const uint4 dyv = prologue8<kProDy>(lds16(p), lds16(p + kTcM * SD), k1,
                                          k2, k3, 0);
      sts16(p, dyv);
      if (db_sums) {
        const uint32_t dw[4] = {dyv.x, dyv.y, dyv.z, dyv.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dbp[2 * j] += bf_lo(dw[j]);
          dbp[2 * j + 1] += bf_hi(dw[j]);
        }
      }
    }
    if (q < nhalo && halo_pix(g, hpk[q], b0, y0, x0) >= 0) {
      bf16* p = ds + 2 * kTcM * SD + q * SZ + zcol;
      sts16(p, prologue8<kProAffine>(lds16(p), make_uint4(0, 0, 0, 0), sc, sh,
                                     nullptr, 0));
    }
  };

  const int t_begin = blockIdx.y * per;
  const int t_end = t_begin + per < g.ntiles ? t_begin + per : g.ntiles;
  __syncthreads();  // the tables
  issue(t_begin, t_end, 0);
  issue(t_begin + 1, t_end, 1);
  mma::cp_async_wait<1>();  // this thread's copies of the first tile
  if (t_begin < t_end) {
    int b0, y0, x0;
    tile_origin(g, t_begin, b0, y0, x0);
#pragma unroll
    for (int k = 0; k < kTcM / 16; ++k) prologue_unit(k, 0, b0, y0, x0);
  }
  for (int t = t_begin; t < t_end; ++t) {
    const int i = t - t_begin;
    // Tile t's prologues are visible, and tile t - 1's readers are done
    // with the stage that tile t + 2 takes.
    __syncthreads();
    issue(t + 2, t_end, (i + 2) % 3);
    mma::cp_async_wait<1>();  // this thread's copies of tile t + 1
    const bool next = t + 1 < t_end;
    int b0 = 0, y0 = 0, x0 = 0;
    if (next) tile_origin(g, t + 1, b0, y0, x0);
    const bf16* ds = dy_of(i % 3);
    const bf16* zs = ds + 2 * kTcM * SD;
#pragma unroll
    for (int ks = 0; ks < kTcM / 16; ++ks) {
      if (ks < nks) {
        uint32_t af[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          if (mt < mt16)
            mma::ldmatrix_x4_t(af[mt], mma::smem_u32(
                zs + ah[ks] * SZ + mt * 16 + ((lane >> 3) & 1) * 8));
        const bf16* brow = ds + (ks * 16 + krow) * SD;
#pragma unroll
        for (int j = 0; j < kTcNt8; j += 2) {
          if (j >= nt8) break;  // TO % 16 == 0: nt8 is even
          uint32_t bq[4];
          mma::ldmatrix_x4_t(bq, mma::smem_u32(brow + j * 8 + (lane >> 4) * 8));
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            if (mt < mt16) {
              mma::mma_bf16(acc[mt][j], af[mt], bq[0], bq[1]);
              mma::mma_bf16(acc[mt][j + 1], af[mt], bq[2], bq[3]);
            }
        }
      }
      if (next) prologue_unit(ks, (i + 1) % 3, b0, y0, x0);
    }
  }
  float* dst = part + (size_t)blockIdx.y * L;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < kTcNt8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (mt >= mt16 || j >= nt8) continue;
        const int ci = i0 + mt * 16 + h * 8 + (lane >> 2);
        const int co = o0 + j * 8 + 2 * (lane & 3);
        *reinterpret_cast<float2*>(dst + ((size_t)tap * Ci + ci) * Co + co) =
            make_float2(acc[mt][j][2 * h], acc[mt][j][2 * h + 1]);
      }
  if (!db_sums) return;
  // The kDwTcThreads / d8 partials of each channel, in thread order.
  __syncthreads();  // the last tile's readers are done with the stages
  float* red = reinterpret_cast<float*>(stages);
#pragma unroll
  for (int k = 0; k < 8; ++k) red[tid * 8 + k] = dbp[k];
  __syncthreads();
  for (int c = tid; c < TO; c += kDwTcThreads) {
    float sum = 0.f;
    for (int r = c / 8 * 8; r < kDwTcThreads * 8; r += d8 * 8) sum += red[r + c % 8];
    dst[(size_t)9 * Ci * Co + o0 + c] = sum;
  }
}

template <int PRO, int EPI>
cudaError_t launch_unit3_tc(const void* x, const void* a, const void* pv,
                            const void* w, const void* bias, const void* aux,
                            void* out, void* ws, void* sums, const TcTiles& g,
                            int K, int N, int CK, int NT, int NST, size_t smem,
                            cudaStream_t s) {
  auto kernel = unit3_tc_kernel<PRO, EPI>;
  cudaError_t err = allow_smem(kernel, smem);
  int grid = 0;
  if (err == cudaSuccess) err = row_grid(kernel, smem, g.ntiles * (N / NT), &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kTcThreads, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(a),
      static_cast<const float*>(pv), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<const bf16*>(aux),
      static_cast<bf16*>(out), static_cast<float*>(ws), g, K, N, CK, NT, NST);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_finalize(static_cast<const float*>(ws),
                         static_cast<float*>(sums), grid, 2 * N, s);
}

// ---------------------------------------------------------------------------
// The 1x1 units in bfloat16 on the tensor cores.
// ---------------------------------------------------------------------------

// One block walks work items t = blockIdx.x, + gridDim.x, ...: item t is
// the kTcM rows of row tile t / (N / NT) and the NT output channels of
// chunk t % (N / NT). The block's items and their K chunks of CK channels
// form one sequence of stages: stage s holds one chunk's raw inputs (kTcM
// rows of CK + 8 bf16 each: dz and a for kProDy, x otherwise) and, unless
// the B operand is resident (wres), the chunk's (CK x NT) slice of it, in
// ring slot s % NST; NST - 1 stages are in flight ahead of the one in use,
// across items. Each thread runs the prologue in place on what it copied
// (prologue8: dy from dz and a, or z = round(x * scale + shift); kProNone
// keeps z = x). Warp (wm, wn) owns rows wm*32..+31 of the tile and columns
// wn*NT/2..+NT/2 of the chunk.
//
// x is the prologue's raw input (dz for kProDy); pv holds its per-channel
// constants (K1, K2, K3 rows for kProDy, scale and shift for kProAffine);
// w is the (K, N) B operand (W^T for din, W for the forward); bias (N
// floats) serves the forward's epilogue only.
//
// The epilogue goes through an item buffer of kTcM x (NT + 8) bf16: the
// item's aux tile (the RAW cin for the next sums, or g for dx) arrives
// there by cp.async with the item's last stage, the epilogue replaces each
// value by the output's (din = round(acc), dx = round(g + din), or the
// forward's a = round(relu(acc + b)), which has no aux), and the block
// stores the buffer's rows below R in 16-byte vectors. NA item buffers
// take turns, enough that an item's aux is issued only after the epilogue
// of the item that used its buffer last (NA * K/CK >= NST; 1 without aux).
// The sums ([Σdin, Σdin·cin] for the next unit, [Σa, Σa²] for the forward)
// take rows below R only, through a fixed warp butterfly and a fixed order
// over warps into the block's partial row.
//
// WIDE: the widest plan, CK = 64 and NT = 128, with the chunk widths and
// so every loop bound over fragments known at compile time. The generic
// instantiation's runtime bounds break the fragment loops into short
// branches, which left its products well behind WIDE's at the fused
// shapes; it serves the other widths.
template <int PRO, int EPI, bool WIDE>
__global__ void __launch_bounds__(kTcThreads, 1)
unit1_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ a,
                const float* __restrict__ pv, const bf16* __restrict__ w,
                const float* __restrict__ bias, const bf16* __restrict__ aux,
                bf16* __restrict__ out, float* __restrict__ part, int R,
                int K, int N, int ck, int nt, int NST, int NA, int wres) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr bool kFwd = EPI == kEpiReluStats;
  constexpr bool kSums = kFwd || EPI == kEpiDinSums;
  constexpr bool kAux = EPI == kEpiDinSums || EPI == kEpiDinSkip;
  constexpr int kIn = PRO == kProDy ? 2 : 1;  // raw tiles of a stage
  const int CK = WIDE ? kTcCk16 * 16 : ck, NT = WIDE ? kTcNt8 * 16 : nt;
  const int SA = CK + 8, SW = wres ? N + 8 : NT + 8, SX = NT + 8;
  const size_t wbytes = wres ? align16((size_t)K * SW * 2) : 0;
  const size_t stage_bytes =
      align16((size_t)(kIn * kTcM * SA + (wres ? 0 : CK * SW)) * 2);
  const size_t item_bytes = align16((size_t)kTcM * SX * 2);
  bf16* wall = reinterpret_cast<bf16*>(smem_raw);  // resident W^T or W
  unsigned char* ring = smem_raw + wbytes;
  unsigned char* items = ring + NST * stage_bytes;
  float* colred = reinterpret_cast<float*>(items + NA * item_bytes);  // [4][2][NT]
  float* red = colred + 8 * NT;                                       // [2][N]
  const int tid = threadIdx.x, lane = tid & 31, wm = (tid >> 5) & 3,
            wn = tid >> 7;
  const int nch = N / NT, nkc = K / CK, nt8 = NT / 16, c8 = CK / 8;
  const int nwork = (R + kTcM - 1) / kTcM * nch;
  const int mine =
      (int)blockIdx.x < nwork ? (nwork - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int nstage = mine * nkc;

  if (kSums)
    for (int v = tid; v < 2 * N; v += kTcThreads) red[v] = 0.f;
  // This thread copies rows m0, + mstep, ... of a stage (channels hc0..
  // hc0+7 of the chunk), and rows r0, + rstep, ... of an NT-wide block
  // (columns wc0..wc0+7): weight rows below CK, item rows below kTcM;
  // threads past the last whole step idle.
  const int mstep = kTcThreads / c8, m0 = tid / c8, hc0 = (tid % c8) * 8;
  const int mlim = tid < mstep * c8 ? kTcM : 0;
  const int per_row = NT / 8, rstep = kTcThreads / per_row;
  const int r0 = tid / per_row, wc0 = (tid % per_row) * 8;
  const bool rbusy = tid < rstep * per_row;
  auto slot = [&](int s) {
    return reinterpret_cast<bf16*>(ring + (s % NST) * stage_bytes);
  };
  auto item_buf = [&](int i) {
    return reinterpret_cast<bf16*>(items + (i % NA) * item_bytes);
  };
  // Stage s into its ring slot, zeros past R, and with an item's last
  // stage its aux tile; one commit group per stage, empty past the last.
  auto issue = [&](int s) {
    if (s < nstage) {
      const int t = blockIdx.x + (s / nkc) * gridDim.x, kc = s % nkc;
      const int row0 = t / nch * kTcM, col0 = t % nch * NT + wc0;
      bf16* ds = slot(s);
      bf16* as = ds + kTcM * SA;  // kProDy: the raw a beside dz
      for (int m = m0; m < mlim; m += mstep) {
        const bool ok = row0 + m < R;
        const size_t idx = (size_t)(ok ? row0 + m : 0) * K + kc * CK + hc0;
        mma::cp_async16_zfill(mma::smem_u32(ds + m * SA + hc0), x + idx, ok);
        if (PRO == kProDy)
          mma::cp_async16_zfill(mma::smem_u32(as + m * SA + hc0), a + idx, ok);
      }
      if (!wres && rbusy) {
        bf16* wsl = ds + kIn * kTcM * SA;
        const bf16* src = w + (size_t)kc * CK * N + col0;
        for (int kr = r0; kr < CK; kr += rstep)
          mma::cp_async16(mma::smem_u32(wsl + kr * SW + wc0), src + (size_t)kr * N);
      }
      if (kAux && kc == nkc - 1 && rbusy) {
        bf16* xs = item_buf(s / nkc);
        for (int m = r0; m < kTcM; m += rstep) {
          const bool ok = row0 + m < R;
          const size_t idx = (size_t)(ok ? row0 + m : 0) * N + col0;
          mma::cp_async16_zfill(mma::smem_u32(xs + m * SX + wc0), aux + idx, ok);
        }
      }
    }
    mma::cp_async_commit();
  };
  if (wres) {  // one group ahead of the stages: stage 0's wait covers it
    const int n8 = N / 8;
    for (int v = tid; v < K * n8; v += kTcThreads) {
      const int k = v / n8, c = (v % n8) * 8;
      mma::cp_async16(mma::smem_u32(wall + k * SW + c), w + (size_t)k * N + c);
    }
    mma::cp_async_commit();
  }
  for (int s = 0; s < NST - 1; ++s) issue(s);

  const int krow = ((lane >> 3) & 1) * 8 + (lane & 7);  // B rows of ldmatrix
  float acc[2][kTcNt8][4];
  for (int s = 0; s < nstage; ++s) {
    const int t = blockIdx.x + (s / nkc) * gridDim.x, kc = s % nkc;
    const int nc = t % nch;
    if (kc == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < kTcNt8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
    }
    mma::cp_async_wait_n(NST - 2);  // this thread's copies of stage s
    bf16* ds = slot(s);
    if (PRO != kProNone && mlim) {
      float v0[8], v1[8], v2[8];
      const int c0 = kc * CK + hc0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v0[j] = pv[c0 + j];
        v1[j] = pv[K + c0 + j];
        v2[j] = PRO == kProDy ? pv[2 * K + c0 + j] : 0.f;
      }
      for (int m = m0; m < kTcM; m += mstep) {
        bf16* p = ds + m * SA + hc0;
        const uint4 ar = PRO == kProDy ? lds16(p + kTcM * SA) : make_uint4(0, 0, 0, 0);
        sts16(p, prologue8<PRO>(lds16(p), ar, v0, v1, v2, 0));
      }
    }
    // Stage s's dy or z (the B operand, the aux tile) are visible; every
    // warp is done with stage s - 1, whose ring slot stage s + NST - 1 takes.
    __syncthreads();
    issue(s + NST - 1);
    const bf16* wb = wres ? wall + (size_t)kc * CK * SW + nc * NT
                          : ds + kIn * kTcM * SA;
#pragma unroll
    for (int ks = 0; ks < kTcCk16; ++ks) {
      if (ks >= CK / 16) break;
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        mma::ldmatrix_x4(af[mt], mma::smem_u32(
            ds + (wm * 32 + mt * 16 + (lane & 15)) * SA + ks * 16 + (lane >> 4) * 8));
      const bf16* brow = wb + (ks * 16 + krow) * SW + wn * (NT / 2);
#pragma unroll
      for (int j = 0; j < kTcNt8; j += 2) {
        if (j >= nt8) break;
        if (j + 1 < nt8) {
          uint32_t bq[4];
          mma::ldmatrix_x4_t(bq, mma::smem_u32(brow + j * 8 + (lane >> 4) * 8));
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma::mma_bf16(acc[mt][j], af[mt], bq[0], bq[1]);
            mma::mma_bf16(acc[mt][j + 1], af[mt], bq[2], bq[3]);
          }
        } else {
          uint32_t bq[2];
          mma::ldmatrix_x2_t(bq, mma::smem_u32(brow + j * 8));
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            mma::mma_bf16(acc[mt][j], af[mt], bq[0], bq[1]);
        }
      }
    }
    if (kc != nkc - 1) continue;

    // Epilogue: this thread's tile rows (mt, h) are wm*32 + mt*16 + h*8 +
    // lane/4, its columns of n8 tile j cl, cl + 1.
    bf16* xs = item_buf(s / nkc);
    const int row0 = t / nch * kTcM;
#pragma unroll
    for (int j = 0; j < kTcNt8; ++j) {
      if (j >= nt8) break;
      const int cl = wn * (NT / 2) + j * 8 + 2 * (lane & 3);  // in the chunk
      // [Σu] of cl, cl+1, then [Σu·v]: u = din and v the RAW cin, or the
      // forward's u = v = a
      float sm[4] = {0.f, 0.f, 0.f, 0.f};
      const float b0 = kFwd ? bias[nc * NT + cl] : 0.f;
      const float b1 = kFwd ? bias[nc * NT + cl + 1] : 0.f;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = wm * 32 + mt * 16 + h * 8 + (lane >> 2);
          uint32_t* xp = reinterpret_cast<uint32_t*>(xs + m * SX + cl);
          const float e0 = acc[mt][j][2 * h], e1 = acc[mt][j][2 * h + 1];
          const float d0 = kFwd ? round_bf(fmaxf(__fadd_rn(e0, b0), 0.f))
                                : round_bf(e0);
          const float d1 = kFwd ? round_bf(fmaxf(__fadd_rn(e1, b1), 0.f))
                                : round_bf(e1);
          const uint32_t xv = kAux ? *xp : 0u;
          if (EPI == kEpiDinSkip) {
            *xp = mma::pack_bf16(__fadd_rn(bf_lo(xv), d0), __fadd_rn(bf_hi(xv), d1));
          } else {
            *xp = mma::pack_bf16(d0, d1);
          }
          // Rows past R are zero-filled: their dy is 0, but the forward's
          // a is relu(b) or relu(shift . W + b), so they are never summed.
          if (kSums && row0 + m < R) {
            sm[0] += d0;
            sm[1] += d1;
            sm[2] = fmaf(d0, kFwd ? d0 : bf_lo(xv), sm[2]);
            sm[3] = fmaf(d1, kFwd ? d1 : bf_hi(xv), sm[3]);
          }
        }
      if (kSums) {
        // The 8 lanes of one column pair, in a fixed butterfly.
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
#pragma unroll
          for (int e = 0; e < 4; ++e) sm[e] += __shfl_xor_sync(0xffffffffu, sm[e], off);
        if (lane < 4) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            colred[(wm * 2) * NT + cl + e] = sm[e];
            colred[(wm * 2 + 1) * NT + cl + e] = sm[2 + e];
          }
        }
      }
    }
    __syncthreads();  // the item buffer holds the outputs
    if (rbusy) {
      const size_t col0 = (size_t)nc * NT + wc0;
      for (int m = r0; m < kTcM && row0 + m < R; m += rstep)
        *reinterpret_cast<uint4*>(out + (size_t)(row0 + m) * N + col0) =
            lds16(xs + m * SX + wc0);
    }
    if (kSums)
      for (int v = tid; v < 2 * NT; v += kTcThreads) {
        const int r = v / NT, c = v % NT;
        red[r * N + nc * NT + c] +=
            ((colred[r * NT + c] + colred[(2 + r) * NT + c]) +
             colred[(4 + r) * NT + c]) + colred[(6 + r) * NT + c];
      }
  }
  if (!kSums) return;
  __syncthreads();
  for (int v = tid; v < 2 * N; v += kTcThreads)
    part[(size_t)blockIdx.x * 2 * N + v] = red[v];
}

// The 1x1 weight gradient dW = z^T dy, db = Σ dy, split over rows:
// blockIdx.x picks a TI x TO tile of (Ci, Co), blockIdx.y a slice of `per`
// row tiles of kDw1M rows. Per row tile the raw dz and a (TO channels) and
// the raw cin (TI channels) arrive by cp.async into one of NST ring slots,
// NST - 1 tiles ahead of the one in use; each thread runs the prologues in
// place on the values it copied (dy; z = round(cin * aff0 + aff1) when
// AFF, else z = cin). Warp (wm, wn) owns
// Ci rows wm*32..+31 and Co columns wn*TO/2..+TO/2 of the tile (warps or
// m16 tiles past TI idle) and reads A = z^T and B = dy with
// ldmatrix.trans. part row y (L floats): dW (Ci, Co), then db (Co), summed
// by the blocks of Ci tile 0 from the dy they make. WIDE: the widest
// plan, TI = TO = kDw1Tile, known at compile time (as in unit1_tc_kernel).
template <bool AFF, bool WIDE>
__global__ void __launch_bounds__(kTcThreads, 1)
dw1_tc_kernel(const bf16* __restrict__ dz, const bf16* __restrict__ a,
              const float* __restrict__ kv, const bf16* __restrict__ cin,
              const float* __restrict__ aff, float* __restrict__ part, int R,
              int Ci, int Co, int ti, int to, int per, int NST, int L) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int TI = WIDE ? kDw1Tile : ti, TO = WIDE ? kDw1Tile : to;
  const int SZ = TI + 8, SD = TO + 8;
  // Ring slot: [dz -> dy, a] (kDw1M x SD each), [cin -> z] (kDw1M x SZ).
  const size_t stage_bytes = align16((size_t)kDw1M * (2 * SD + SZ) * 2);
  const int tid = threadIdx.x, lane = tid & 31, wm = (tid >> 5) & 3,
            wn = tid >> 7;
  const int tiles_o = Co / TO;
  const int i0 = (blockIdx.x / tiles_o) * TI, o0 = (blockIdx.x % tiles_o) * TO;
  const int ntiles = (R + kDw1M - 1) / kDw1M;
  const int t_begin = blockIdx.y * per;
  const int nstage = min(per, ntiles - t_begin);
  const int nt8 = TO / 16, d8 = TO / 8, z8 = TI / 8;
  // This thread's dy vectors are rows m0, + mstep, ... (channels dcol..
  // dcol+7), its z vectors rows q0, + qstep, ... (channels zcol..zcol+7);
  // threads past the last whole step idle. Each thread keeps its channels,
  // so their constants stay in registers.
  const int mstep = kTcThreads / d8, m0 = tid / d8, dcol = (tid % d8) * 8;
  const int mlim = tid < mstep * d8 ? kDw1M : 0;
  const int qstep = kTcThreads / z8, q0 = tid / z8, zcol = (tid % z8) * 8;
  const int qlim = tid < qstep * z8 ? kDw1M : 0;
  float k1[8], k2[8], k3[8], sc[8], sh[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    k1[j] = kv[o0 + dcol + j];
    k2[j] = kv[Co + o0 + dcol + j];
    k3[j] = kv[2 * Co + o0 + dcol + j];
    sc[j] = AFF ? aff[i0 + zcol + j] : 0.f;
    sh[j] = AFF ? aff[Ci + i0 + zcol + j] : 0.f;
  }
  const bool db_sums = i0 == 0;
  float dbp[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  auto slot = [&](int s) {
    return reinterpret_cast<bf16*>(smem_raw + (s % NST) * stage_bytes);
  };
  // Row tile t_begin + s into its ring slot, zeros past R; one commit group
  // (empty past the slice).
  auto issue = [&](int s) {
    if (s < nstage) {
      const int row0 = (t_begin + s) * kDw1M;
      bf16* ds = slot(s);
      bf16* as = ds + kDw1M * SD;
      bf16* zs = as + kDw1M * SD;
      for (int m = m0; m < mlim; m += mstep) {
        const bool ok = row0 + m < R;
        const size_t idx = (size_t)(ok ? row0 + m : 0) * Co + o0 + dcol;
        mma::cp_async16_zfill(mma::smem_u32(ds + m * SD + dcol), dz + idx, ok);
        mma::cp_async16_zfill(mma::smem_u32(as + m * SD + dcol), a + idx, ok);
      }
      for (int q = q0; q < qlim; q += qstep) {
        const bool ok = row0 + q < R;
        const size_t idx = (size_t)(ok ? row0 + q : 0) * Ci + i0 + zcol;
        mma::cp_async16_zfill(mma::smem_u32(zs + q * SZ + zcol), cin + idx, ok);
      }
    }
    mma::cp_async_commit();
  };
  // The prologues of stage s, in place: this thread's dy vectors (rows
  // past R hold zeros, so their dy is 0) and, when AFF, its z vectors, at
  // most kDw1M / 16 of each (mstep, qstep >= 16); the raw vectors are all
  // loaded first.
  auto prologues = [&](int s) {
    constexpr int kV = kDw1M / 16;
    bf16* ds = slot(s);
    bf16* zs = ds + 2 * kDw1M * SD;
    uint4 xr[kV], ar[kV], zr[kV];
#pragma unroll
    for (int k = 0; k < kV; ++k) {
      const int m = m0 + k * mstep, q = q0 + k * qstep;
      if (m < mlim) {
        xr[k] = lds16(ds + m * SD + dcol);
        ar[k] = lds16(ds + (kDw1M + m) * SD + dcol);
      }
      if (AFF && q < qlim) zr[k] = lds16(zs + q * SZ + zcol);
    }
#pragma unroll
    for (int k = 0; k < kV; ++k) {
      const int m = m0 + k * mstep, q = q0 + k * qstep;
      if (m < mlim) {
        const uint4 dyv = prologue8<kProDy>(xr[k], ar[k], k1, k2, k3, 0);
        sts16(ds + m * SD + dcol, dyv);
        if (db_sums) {
          const uint32_t dw[4] = {dyv.x, dyv.y, dyv.z, dyv.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            dbp[2 * j] += bf_lo(dw[j]);
            dbp[2 * j + 1] += bf_hi(dw[j]);
          }
        }
      }
      if (AFF && q < qlim)
        sts16(zs + q * SZ + zcol, prologue8<kProAffine>(
                                      zr[k], make_uint4(0, 0, 0, 0), sc, sh,
                                      nullptr, 0));
    }
  };
  for (int s = 0; s < NST - 1; ++s) issue(s);

  // The row this lane's ldmatrix.trans reads within a k16 step, for A
  // (rows (lane/16)*8 + lane%8, Ci offset ((lane/8)%2)*8) and for B.
  const int arow = (lane >> 4) * 8 + (lane & 7), acol = ((lane >> 3) & 1) * 8;
  const int krow = ((lane >> 3) & 1) * 8 + (lane & 7);
  float acc[2][kTcNt8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < kTcNt8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
  const bool mt_on[2] = {wm * 32 < TI, wm * 32 + 16 < TI};
  for (int s = 0; s < nstage; ++s) {
    mma::cp_async_wait_n(NST - 2);  // this thread's copies of stage s
    prologues(s);
    // Stage s's dy and z are visible; every warp is done with stage s - 1,
    // whose ring slot stage s + NST - 1 takes.
    __syncthreads();
    issue(s + NST - 1);
    const bf16* ds = slot(s);
    const bf16* zs = ds + 2 * kDw1M * SD;
#pragma unroll
    for (int ks = 0; ks < kDw1M / 16; ++ks) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        if (mt_on[mt])
          mma::ldmatrix_x4_t(af[mt], mma::smem_u32(
              zs + (ks * 16 + arow) * SZ + wm * 32 + mt * 16 + acol));
      const bf16* brow = ds + (ks * 16 + krow) * SD + wn * (TO / 2);
#pragma unroll
      for (int j = 0; j < kTcNt8; j += 2) {
        if (j >= nt8) break;
        if (j + 1 < nt8) {
          uint32_t bq[4];
          mma::ldmatrix_x4_t(bq, mma::smem_u32(brow + j * 8 + (lane >> 4) * 8));
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            if (mt_on[mt]) {
              mma::mma_bf16(acc[mt][j], af[mt], bq[0], bq[1]);
              mma::mma_bf16(acc[mt][j + 1], af[mt], bq[2], bq[3]);
            }
        } else {
          uint32_t bq[2];
          mma::ldmatrix_x2_t(bq, mma::smem_u32(brow + j * 8));
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            if (mt_on[mt]) mma::mma_bf16(acc[mt][j], af[mt], bq[0], bq[1]);
        }
      }
    }
  }
  float* dst = part + (size_t)blockIdx.y * L;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < kTcNt8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!mt_on[mt] || j >= nt8) continue;
        const int ci = i0 + wm * 32 + mt * 16 + h * 8 + (lane >> 2);
        const int co = o0 + wn * (TO / 2) + j * 8 + 2 * (lane & 3);
        *reinterpret_cast<float2*>(dst + (size_t)ci * Co + co) =
            make_float2(acc[mt][j][2 * h], acc[mt][j][2 * h + 1]);
      }
  if (!db_sums) return;
  // The kTcThreads / d8 partials of each channel, in thread order.
  mma::cp_async_wait<0>();
  __syncthreads();  // the last stage's readers are done with the ring
  float* red = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int k = 0; k < 8; ++k) red[tid * 8 + k] = dbp[k];
  __syncthreads();
  for (int c = tid; c < TO; c += kTcThreads) {
    float sum = 0.f;
    for (int r = c / 8 * 8; r < kTcThreads * 8; r += d8 * 8) sum += red[r + c % 8];
    dst[(size_t)Ci * Co + o0 + c] = sum;
  }
}

// unit1_tc_kernel and, when its epilogue sums, the finalize kernel (also
// when the grid is one block).
template <int PRO, int EPI>
cudaError_t launch_unit1_tc(const void* x, const void* a, const void* pv,
                            const void* w, const void* bias, const void* aux,
                            void* out, void* ws, void* sums, int R, int K,
                            int N, int CK, int NT, int NST, int NA, int wres,
                            size_t smem, cudaStream_t s) {
  auto kernel = CK == kTcCk16 * 16 && NT == kTcNt8 * 16
                     ? unit1_tc_kernel<PRO, EPI, true>
                     : unit1_tc_kernel<PRO, EPI, false>;
  cudaError_t err = allow_smem(kernel, smem);
  int grid = 0;
  const int work = (R + kTcM - 1) / kTcM * (N / NT);
  if (err == cudaSuccess) err = row_grid(kernel, smem, work, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kTcThreads, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(a),
      static_cast<const float*>(pv), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<const bf16*>(aux),
      static_cast<bf16*>(out), static_cast<float*>(ws), R, K, N, CK, NT,
      NST, NA, wres);
  err = cudaGetLastError();
  if (err != cudaSuccess || !(EPI == kEpiDinSums || EPI == kEpiReluStats))
    return err;
  return launch_finalize(static_cast<const float*>(ws),
                         static_cast<float*>(sums), grid, 2 * N, s);
}

template <bool AFF>
cudaError_t launch_dw1_tc(const void* dz, const void* a, const void* kv,
                          const void* cin, const void* aff, void* ws,
                          void* out, int R, int Ci, int Co, int TI, int TO,
                          int slices, int per, int NST, size_t smem,
                          cudaStream_t s) {
  auto kernel = TI == kDw1Tile && TO == kDw1Tile ? dw1_tc_kernel<AFF, true>
                                                 : dw1_tc_kernel<AFF, false>;
  const int L = Ci * Co + Co;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  float* dst = static_cast<float*>(slices > 1 ? ws : out);
  kernel<<<dim3((Ci / TI) * (Co / TO), slices), kTcThreads, smem, s>>>(
      static_cast<const bf16*>(dz), static_cast<const bf16*>(a),
      static_cast<const float*>(kv), static_cast<const bf16*>(cin),
      static_cast<const float*>(aff), dst, R, Ci, Co, TI, TO, per, NST, L);
  err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return err;
  return launch_finalize(dst, static_cast<float*>(out), slices, L, s);
}

}  // namespace train
}  // namespace spe

// A float32 unit kernel (ks 1 or 3; pro 0 none, 1 affine, 2 dy; epi 0
// relu+stats, 1 din, 2 din+next sums, 3 din+skip), then, when the epilogue
// sums, the finalize kernel into sums (2, N). ws holds kMaxParts rows of
// 2N floats. bf16 is refused: it runs spe_train_unit1_fwd_tc,
// spe_train_unit1_tc and spe_train_unit3_tc.
extern "C" int spe_train_unit(int bf16, int ks, int pro, int epi,
                              const void* x, const void* a, const void* pv,
                              const void* w, const void* bias, const void* aux,
                              void* out, void* ws, void* sums, int B, int H,
                              int W, int K, int N, void* stream) {
  if (bf16) return (int)cudaErrorInvalidValue;
  return (int)spe::train::dispatch_unit(
      ks, pro, epi, x, a, pv, w, bias, aux, out, ws, sums, B, H, W, K, N,
      static_cast<cudaStream_t>(stream));
}

// bn_bwd_reduce: the reduce kernel, then the finalize kernel into sums
// (2, C). ws holds kMaxParts rows of 2C floats.
extern "C" int spe_train_reduce(int bf16, const void* dz, const void* a,
                                void* ws, void* sums, int R, int C,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)spe::train::launch_reduce<__nv_bfloat16>(dz, a, ws, sums, R, C, s);
  return (int)spe::train::launch_reduce<float>(dz, a, ws, sums, R, C, s);
}

// A 3x3 unit in bf16 on the tensor cores: pro 1 (z = affine(x), relu +
// stats: conv3x3_relu_stats) or 2 (dy, din + next sums: unit3x3_bwd's din),
// then the finalize kernel into sums (2, N). The tile (ni, th, tw), the
// input chunk ck, the output chunk nt, the weight ring's stages nst and
// the shared memory come from
// ops/cuda/bottleneck_train_kernel.py unit3_plan.
extern "C" int spe_train_unit3_tc(int pro, const void* x, const void* a,
                                  const void* pv, const void* w,
                                  const void* bias, const void* aux, void* out,
                                  void* ws, void* sums, int B, int H, int W,
                                  int K, int N, int ni, int th, int tw, int ck,
                                  int nt, int nst, int smem, void* stream) {
  using namespace spe::train;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TcTiles g = make_tiles(B, H, W, ni, th, tw);
  if (pro == kProAffine)
    return (int)launch_unit3_tc<kProAffine, kEpiReluStats>(
        x, a, pv, w, bias, aux, out, ws, sums, g, K, N, ck, nt, nst, smem, s);
  if (pro == kProDy)
    return (int)launch_unit3_tc<kProDy, kEpiDinSums>(
        x, a, pv, w, bias, aux, out, ws, sums, g, K, N, ck, nt, nst, smem, s);
  return (int)cudaErrorInvalidValue;
}

// The 3x3 weight gradient in bf16 on the tensor cores: dw3_tc_kernel over
// (Ci/ti) x (Co/to) channel tiles and `slices` slices of `per` pixel tiles.
// With one slice it writes out (9*Ci*Co + Co floats) directly and ws is
// unused; else its partials go to ws (slices rows) and the finalize kernel
// adds them into out. Plan: ops/cuda/bottleneck_train_kernel.py dw3_plan.
extern "C" int spe_train_dw3_tc(const void* dz, const void* a, const void* kv,
                                const void* cin, const void* aff, void* ws,
                                void* out, int B, int H, int W, int Ci, int Co,
                                int ni, int th, int tw, int ti, int to,
                                int slices, int per, int smem, void* stream) {
  using namespace spe::train;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TcTiles g = make_tiles(B, H, W, ni, th, tw);
  const int L = 9 * Ci * Co + Co;
  cudaError_t err = spe::allow_smem(dw3_tc_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  float* dst = static_cast<float*>(slices > 1 ? ws : out);
  dw3_tc_kernel<<<dim3((Ci / ti) * (Co / to), slices), kDwTcThreads, smem, s>>>(
      static_cast<const bf16*>(dz), static_cast<const bf16*>(a),
      static_cast<const float*>(kv), static_cast<const bf16*>(cin),
      static_cast<const float*>(aff), dst, g, Ci, Co, ti, to, per, L);
  err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return (int)err;
  return (int)launch_finalize(dst, static_cast<float*>(out), slices, L, s);
}

// A 1x1 backward unit's din in bf16 on the tensor cores: epi 1 (din:
// unit1x1_bwd without reduce_next), 2 (din + next sums, then the finalize
// kernel into sums (2, N); ws holds kMaxParts rows of 2N floats) or 3
// (dx = g + din: unit1_bwd). w is W^T, (K, N). The input chunk ck, the
// output chunk nt, the ring's stages nst, the item buffers na, whether
// W^T stays resident (wres) and the shared memory come from
// ops/cuda/bottleneck_train_kernel.py unit1_plan.
extern "C" int spe_train_unit1_tc(int epi, const void* dz, const void* a,
                                  const void* kv, const void* w,
                                  const void* aux, void* out, void* ws,
                                  void* sums, int R, int K, int N, int ck,
                                  int nt, int nst, int na, int wres, int smem,
                                  void* stream) {
  using namespace spe::train;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SPE_UNIT1(EPI_)                                                      \
  if (epi == EPI_)                                                           \
    return (int)launch_unit1_tc<kProDy, EPI_>(dz, a, kv, w, nullptr, aux,    \
                                              out, ws, sums, R, K, N, ck, nt, \
                                              nst, na, wres, smem, s);
  SPE_UNIT1(kEpiDin)
  SPE_UNIT1(kEpiDinSums)
  SPE_UNIT1(kEpiDinSkip)
#undef SPE_UNIT1
  return (int)cudaErrorInvalidValue;
}

// conv1x1_relu_stats (#14a) in bf16 on the tensor cores: unit1_tc_kernel's
// forward, pro 0 (z = x: the bottleneck's unit 1) or 1 (z = round(x *
// scale + shift), pv = [scale (K), shift (K)]: unit 3), a = round(relu(z .
// W + b)) into out (R, N) and [Σa, Σa²] over the R rows through the
// finalize kernel into sums (2, N); ws holds kMaxParts rows of 2N floats.
// w is W, (K, N); bias N floats. The input chunk ck, the output chunk nt,
// the ring's stages nst, whether W stays resident (wres) and the shared
// memory come from ops/cuda/bottleneck_train_kernel.py unit1_plan with
// EPI_RELU_STATS, which gives one item buffer.
extern "C" int spe_train_unit1_fwd_tc(int pro, const void* x, const void* pv,
                                      const void* w, const void* bias,
                                      void* out, void* ws, void* sums, int R,
                                      int K, int N, int ck, int nt, int nst,
                                      int wres, int smem, void* stream) {
  using namespace spe::train;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pro == kProNone)
    return (int)launch_unit1_tc<kProNone, kEpiReluStats>(
        x, nullptr, nullptr, w, bias, nullptr, out, ws, sums, R, K, N, ck, nt,
        nst, 1, wres, smem, s);
  if (pro == kProAffine)
    return (int)launch_unit1_tc<kProAffine, kEpiReluStats>(
        x, nullptr, pv, w, bias, nullptr, out, ws, sums, R, K, N, ck, nt, nst,
        1, wres, smem, s);
  return (int)cudaErrorInvalidValue;
}

// The 1x1 weight gradient in bf16 on the tensor cores: dw1_tc_kernel over
// (Ci/ti) x (Co/to) channel tiles and `slices` slices of `per` row tiles,
// with z = affine(cin) when aff, else z = cin. With one slice it writes
// out (Ci*Co + Co floats) directly and ws is unused; else its partials go
// to ws (slices rows) and the finalize kernel adds them into out. Plan:
// ops/cuda/bottleneck_train_kernel.py dw1_plan.
extern "C" int spe_train_dw1_tc(int aff, const void* dz, const void* a,
                                const void* kv, const void* cin,
                                const void* affv, void* ws, void* out, int R,
                                int Ci, int Co, int ti, int to, int slices,
                                int per, int nst, int smem, void* stream) {
  using namespace spe::train;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (aff)
    return (int)launch_dw1_tc<true>(dz, a, kv, cin, affv, ws, out, R, Ci, Co,
                                    ti, to, slices, per, nst, smem, s);
  return (int)launch_dw1_tc<false>(dz, a, kv, cin, affv, ws, out, R, Ci, Co,
                                   ti, to, slices, per, nst, smem, s);
}

// dW and db of a float32 unit: the dw kernel over `slices` slices of `rows`
// rows, then the finalize kernel into out (ks*ks*Ci*Co + Co floats). ws holds
// `slices` rows of that length.
extern "C" int spe_train_dw(int bf16, int ks, int aff, const void* dz,
                            const void* a, const void* k, const void* cin,
                            const void* affv, void* ws, void* out, int B,
                            int H, int W, int Ci, int Co, int slices,
                            int rows, void* stream) {
  if (bf16) return (int)cudaErrorInvalidValue;  // spe_train_dw1_tc, _dw3_tc
  return (int)spe::train::dispatch_dw(ks, aff, dz, a, k, cin, affv, ws, out,
                                      B, H, W, Ci, Co, slices, rows,
                                      static_cast<cudaStream_t>(stream));
}
