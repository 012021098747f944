"""Train-mode bottleneck units, forward and backward, as hand-written CUDA
kernels (`model_backend="fused"`).

Replaces the six TPU kernels of
`single_person_pose_estimation_tpu/experimental/bottleneck_train_kernel.py`,
each wrapper with the JAX function's name and contract:

  conv1x1_relu_stats  a = relu((x*scale + shift) @ W + b), the affine
                      optional, plus (2, Cout) f32 [sum a, sum a^2]
  conv3x3_relu_stats  the same with a 3x3 SAME conv (zero padding of the
                      normalized input)
  bn_bwd_reduce       (2, C) f32 [sum dz, sum dz*a]
  unit1x1_bwd         dy = mask(K1*dz + K2*a + K3); din = dy @ W^T;
                      dW = cin'^T dy (cin' = cin re-normalized by `aff`);
                      db = sum dy; next sums [sum din, sum din*cin]
  unit3x3_bwd         the same for the 3x3 unit
  unit1_bwd           unit 1 and the skip: dx = g + dy @ W1^T, dW, db

The kernels are `csrc/bottleneck_train.cu`; its source note says what
bounds them on the H100 and how they are laid out. In bfloat16 the two 3x3
units (`unit3_tc_kernel`, `dw3_tc_kernel`), the 1x1 forward
(conv1x1_relu_stats: `unit1_tc_kernel`'s forward instantiation) and the
two 1x1 backward units (`unit1_tc_kernel`, `dw1_tc_kernel`) run their
products on the tensor cores (`mma.sync` bf16 with float32 accumulation),
with the tile and chunk plan computed here (`unit3_plan`, `dw3_plan`,
`unit1_plan`, `dw1_plan`) and passed in as integers; bf16 never reaches
an FMA unit body. bn_bwd_reduce, a reduction with no product, and every
float32 body are FMA on the CUDA cores. A bf16 shape that the plan cannot
take raises. The TPU kernels carry their sums and dW/db across a
sequential grid; here every block writes float32 partials to a workspace
that the wrapper allocates with `torch.empty`, and a second launch adds
them in a fixed order, so two runs give the same bits. Launches per call
(each counted on the wrapper's `launches`): conv1x1_relu_stats,
conv3x3_relu_stats, bn_bwd_reduce 2 (the finalize runs even when the grid
is one block); unit1x1_bwd 4 (3 without
reduce_next); unit3x3_bwd 4; unit1_bwd 3; in bf16 a weight gradient that
its plan gives one slice writes dW and db itself, one launch fewer (the
fused step at batch 64 never does). Workspace at B=64, 64 px, C=256,
Cm=128: the row kernels' partials are at most 1,024 x 2C floats (2 MB);
the weight gradients are split over row slices so that their partials
stay under 32 MiB (the 3x3 unit: 33 slices of 9*128*128 + 128 floats in
bf16, 19.5 MB; 56 slices, 33 MB, in float32; the 1x1 units in bf16: 66
slices of 128*256 + 256 or + 128 floats, 8.7 MB).

Rounding follows the TPU kernels: the prologue z = round(x*scale + shift)
in float32; bias added in float32, then ReLU, then one rounding; the
stats sum the rounded a; dy is rounded to the compute dtype before both
products and db; din is rounded before the next sums, which read the RAW
cin; dx = round(g + round(din)).

Layout is NHWC as in the JAX package; weights (Cin, Cout) and (3, 3, Cin,
Cout). Each wrapper runs the plain PyTorch version (`*_plain`) for a
tensor on the CPU and the kernel for a CUDA tensor; there is no fallback
from one to the other.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from single_person_pose_estimation_tpu_torch.ops.cuda import build
from single_person_pose_estimation_tpu_torch.ops.cuda.bottleneck_kernel import (
    _DTYPES,
    SMEM_LIMIT,
    _require_cuda,
    _widest,
)

MAX_PARTS = 1024          # csrc/bottleneck_train.cu kMaxParts
DW_WORKSPACE = 8 << 20    # floats of a weight gradient's partials (32 MiB)
DW_MIN_ROWS = 2048        # rows of one weight-gradient slice, at least
PRO_NONE, PRO_AFFINE, PRO_DY = 0, 1, 2
EPI_RELU_STATS, EPI_DIN, EPI_DIN_SUMS, EPI_DIN_SKIP = 0, 1, 2, 3
# The bf16 3x3 units on the tensor cores (csrc/bottleneck_train.cu
# unit3_tc_kernel, dw3_tc_kernel).
TC_M = 128                # kTcM: output pixels of one tile
TC_NT = 128               # widest output-channel chunk of a work item
TC_CK = 64                # widest input-channel chunk of the halo
TC_HALO = 320             # halo pixels of one tile, at most
TC_STAGES = 4             # weight slices in flight in unit3_tc_kernel, at most
TC_MIN_WORK = 132         # work items a tensor-core unit aims at, at least (132 SMs)
DW3_BLOCKS = 264          # blocks the 3x3 weight gradient aims at (2 x 132 SMs)
# The bf16 1x1 units on the tensor cores (unit1_tc_kernel: the forward and
# the backward din; dw1_tc_kernel): one block per SM each.
DW1_M = 64                # kDw1M: rows of one weight-gradient stage
DW1_TILE = 128            # widest Ci and Co tile of a weight-gradient block
DW1_BLOCKS = 132          # blocks the 1x1 weight gradient aims at (132 SMs)


# ---------------------------------------------------------------------------
# Plain PyTorch versions: the same arithmetic and rounding points.
# ---------------------------------------------------------------------------

def _affine(x, scale, shift):
    return (x.float() * scale + shift).to(x.dtype)


def _dy(dz, a, k):
    """(a > 0) ? K1*dz + K2*a + K3 : 0, rounded to a's dtype."""
    a32 = a.float()
    da = k[0] * dz.float() + k[1] * a32 + k[2]
    return torch.where(a32 > 0, da, 0.0).to(a.dtype)


def _sums(u, v=None):
    """(2, C) float32 [sum u, sum u*v] (v = u: the sum of squares)."""
    u32 = u.float().reshape(-1, u.shape[-1])
    v32 = u32 if v is None else v.float().reshape(-1, v.shape[-1])
    return torch.stack([u32.sum(0), (u32 * v32).sum(0)])


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def conv1x1_relu_stats_plain(x, w, b, scale=None, shift=None):
    z = x if scale is None else _affine(x, scale, shift)
    a = torch.relu(z.float() @ w.to(x.dtype).float() + b).to(x.dtype)
    return a, _sums(a)


def conv3x3_relu_stats_plain(x, w, b, scale, shift):
    z = _affine(x, scale, shift)
    y = F.conv2d(_nchw(z.float()), w.to(x.dtype).float().permute(3, 2, 0, 1),
                 padding=1)
    a = torch.relu(_nhwc(y) + b).to(x.dtype)
    return a, _sums(a)


def bn_bwd_reduce_plain(dz, a):
    return _sums(dz, a)


def _mm_t(u, v):
    """u^T v over the flattened rows, float32: (Cu, Cv)."""
    return u.float().reshape(-1, u.shape[-1]).T @ \
        v.float().reshape(-1, v.shape[-1])


def unit1x1_bwd_plain(dz, a, cin, w, k, aff=None, affine_cin=True,
                      reduce_next=True):
    dt = a.dtype
    dy = _dy(dz, a, k)
    z = _affine(cin, aff[0], aff[1]) if affine_cin else cin
    dw = _mm_t(z, dy)
    din = (dy.float() @ w.to(dt).float().T).to(dt)
    db = dy.float().reshape(-1, dy.shape[-1]).sum(0)[None]
    sums = _sums(din, cin) if reduce_next else torch.zeros(
        2, cin.shape[-1], dtype=torch.float32, device=cin.device)
    return din, dw, db, sums


def unit3x3_bwd_plain(dz, a, cin, w, k, aff):
    dt = a.dtype
    B, H, W, C = dz.shape
    dy = _dy(dz, a, k)
    z = F.pad(_affine(cin, aff[0], aff[1]), (0, 0, 1, 1, 1, 1))
    dw = torch.stack([torch.stack([_mm_t(z[:, p:p + H, q:q + W], dy)
                                   for q in range(3)]) for p in range(3)])
    # din = sum over taps of shift(dy) @ W[2-p, 2-q]^T: a SAME conv of dy
    # with the flipped, transposed kernel.
    wt = w.to(dt).float().flip(0, 1).permute(2, 3, 0, 1)
    din = _nhwc(F.conv2d(_nchw(dy.float()), wt, padding=1)).to(dt)
    db = dy.float().reshape(-1, C).sum(0)[None]
    return din, dw, db, _sums(din, cin)


def unit1_bwd_plain(dz, a, x, g, w, k):
    dt = a.dtype
    dy = _dy(dz, a, k)
    din = (dy.float() @ w.to(dt).float().T).to(dt)
    dx = (g.float() + din.float()).to(dt)
    db = dy.float().reshape(-1, dy.shape[-1]).sum(0)[None]
    return dx, _mm_t(x, dy), db


# ---------------------------------------------------------------------------
# Kernel launch.
# ---------------------------------------------------------------------------

def _check(*acts, channels=()):
    """Contiguous NHWC activations of one float dtype and one (B, H, W), on
    one device (their channel counts may differ); for the kernels, channel counts that are multiples of 16,
    at most 1024 (the plain versions take any)."""
    x = acts[0]
    for t in acts:
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"expected contiguous NHWC tensors, got shape "
                             f"{tuple(t.shape)} contiguous="
                             f"{t.is_contiguous()}")
        if t.dtype != x.dtype or t.device != x.device \
                or t.shape[:3] != x.shape[:3]:
            raise TypeError(f"operands disagree: {tuple(t.shape)} {t.dtype} "
                            f"{t.device} vs {tuple(x.shape)} {x.dtype} "
                            f"{x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"storage dtype must be float32 or bfloat16, got "
                        f"{x.dtype}")
    for c in (*channels, *(t.shape[-1] for t in acts)):
        if x.device.type != "cpu" and (c % 16 or c > 1024):
            raise ValueError(f"channels must be a multiple of 16 (<= 1024), "
                             f"got {c}")


def _same_shape(*ts):
    if any(t.shape != ts[0].shape for t in ts):
        raise ValueError(f"expected one shape, got "
                         f"{[tuple(t.shape) for t in ts]}")


def _vec(v, n, device):
    """A float32 per-channel operand, contiguous, on the device."""
    v = torch.as_tensor(v).to(device=device, dtype=torch.float32)
    if v.numel() != n:
        raise ValueError(f"expected {n} values, got {tuple(v.shape)}")
    return v.reshape(-1).contiguous()


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _launch_unit(ks, pro, epi, x, a, pv, w, bias, aux, n):
    """One unit kernel (and its finalize when the epilogue sums); returns
    (out (B, H, W, n), sums (2, n) or None)."""
    _require_cuda(x)
    B, H, W, K = x.shape
    out = torch.empty((B, H, W, n), dtype=x.dtype, device=x.device)
    sums_needed = epi in (EPI_RELU_STATS, EPI_DIN_SUMS)
    ws = torch.empty((MAX_PARTS, 2 * n), dtype=torch.float32,
                     device=x.device) if sums_needed else None
    sums = torch.empty((2, n), dtype=torch.float32,
                       device=x.device) if sums_needed else None
    ptr = lambda t: t.data_ptr() if t is not None else None
    err = build.lib().spe_train_unit(
        int(x.dtype == torch.bfloat16), ks, pro, epi, x.data_ptr(), ptr(a),
        ptr(pv), w.data_ptr(), ptr(bias), ptr(aux), out.data_ptr(), ptr(ws),
        ptr(sums), B, H, W, K, n, _stream(x))
    build.check(err, "train unit kernel")
    return out, sums


def dw_slices(rows: int, length: int):
    """(slices, rows per slice) of a weight gradient over `rows` rows whose
    partials are `length` floats each: enough slices to fill the card,
    few enough that the partials stay within DW_WORKSPACE floats."""
    cap = max(1, DW_WORKSPACE // length)
    slices = max(1, min(-(-rows // DW_MIN_ROWS), cap))
    per = -(-rows // slices)
    per = -(-per // 32) * 32
    return -(-rows // per), per


def _tc_channels(*cs):
    for c in cs:
        if c % 16 or not 0 < c <= 1024:
            raise ValueError(f"the tensor-core units take channels that "
                             f"are multiples of 16 (<= 1024), got {c}")


def _tc_rows(B, H, W):
    """B*H*W, which the tensor-core kernels index in int32."""
    if B * H * W + TC_M >= 2 ** 31:
        raise ValueError(f"{B} x {H} x {W} pixels are too many for the "
                         f"tensor-core units")
    return B * H * W


def tc_tiles(B, H, W):
    """The output tile of the tensor-core 3x3 units: (ni, th, tw, tiles_x,
    tiles_y, ntiles). A tile is ni images x th rows x tw columns, at most
    TC_M pixels: 8 x 16 on maps at least 16 wide (a 10 x 18 halo, 1.41
    halo pixels per output pixel), whole images of 8 px in twos and of 4 px
    in eights; on maps under 4 px wide, fewer pixels, so that the halo
    holds at most TC_HALO pixels. Tiles run image group by image group,
    then by rows of tiles (csrc/bottleneck_train.cu make_tiles,
    tile_origin)."""
    _tc_rows(B, H, W)
    tw = min(W, 16)
    th = min(H, max(1, TC_M // tw))
    ni = min(B, max(1, TC_M // (th * tw)))
    while _halo_pixels(ni, th, tw) > TC_HALO:  # maps under 4 px wide
        ni, th = (-(-ni // 2), th) if ni > 1 else (ni, -(-th // 2))
    tiles_x, tiles_y = -(-W // tw), -(-H // th)
    return ni, th, tw, tiles_x, tiles_y, -(-B // ni) * tiles_y * tiles_x


def _halo_pixels(ni, th, tw):
    return ni * (th + 2) * (tw + 2)


def _align16(n):
    return -(-n // 16) * 16


def unit3_plan(B, H, W, K, N, dy=False):
    """The plan of unit3_tc_kernel for a (B, H, W, K) input and N outputs
    (dy: the din form, whose prologue reads dz and a): its tile, the input
    chunk ck (the halo holds ck channels at a time), the output chunk nt (a
    work item is one tile's nt outputs; halved down to 32 while the items
    number fewer than TC_MIN_WORK, as on the 16 to 4 px maps), the stages
    nst of the weight ring, the work items and the bytes of shared memory:
    the geometry tables (halo + TC_M int32), the halo (rows padded to ck + 8 bf16; twice for dy, whose raw a waits
    beside dz), nst weight slices (ck x (nt + 8) bf16), the per-warp column
    sums (4 x 2 x nt f32) and the block's sums (2 x N f32). nst is the
    most, up to TC_STAGES, with which two blocks fit on one SM."""
    _tc_channels(K, N)
    ni, th, tw, tiles_x, tiles_y, ntiles = tc_tiles(B, H, W)
    ck, nt = _widest(K, TC_CK), _widest(N, TC_NT)
    while ntiles * (N // nt) < TC_MIN_WORK and nt % 32 == 0 and nt > 32:
        nt //= 2
    halo = _halo_pixels(ni, th, tw)
    fixed = (_align16((halo + TC_M) * 4)
             + (2 if dy else 1) * _align16(halo * (ck + 8) * 2)
             + 8 * nt * 4 + 2 * N * 4)
    fits = [n for n in range(TC_STAGES, 1, -1)
            if fixed + n * ck * (nt + 8) * 2 <= SMEM_LIMIT // 2 - 1024]
    nst = fits[0] if fits else 2
    smem = fixed + nst * ck * (nt + 8) * 2
    if smem > SMEM_LIMIT:
        raise ValueError(f"a 3x3 unit at {(B, H, W, K)} -> {N} needs {smem} "
                         f"bytes of shared memory, over {SMEM_LIMIT}")
    return dict(ni=ni, th=th, tw=tw, tiles_x=tiles_x, tiles_y=tiles_y,
                ntiles=ntiles, ck=ck, nt=nt, nst=nst,
                work=ntiles * (N // nt), smem=smem)


def dw3_plan(B, H, W, Ci, Co):
    """The plan of dw3_tc_kernel: the tile (as unit3_plan's), the channel
    tile ti x to of one block (its 9 taps' accumulators, 9 * ti * to
    floats, fill the registers of 9 warps at 32 x 64), the slices of `per`
    tiles that split the rows (enough blocks to fill the card twice, few
    enough that their partials stay within DW_WORKSPACE floats; one slice
    writes dW and db directly, with no workspace), and the bytes of shared
    memory: the geometry tables (halo + TC_M int32) and three stages of the raw dz and a (TC_M x (to + 8) bf16 each,
    dz turned into dy in place) and the raw cin halo (ti + 8 bf16 a pixel,
    turned into z)."""
    _tc_channels(Ci, Co)
    ni, th, tw, tiles_x, tiles_y, ntiles = tc_tiles(B, H, W)
    ti, to = _widest(Ci, 32), _widest(Co, 64)
    ctiles = (Ci // ti) * (Co // to)
    length = 9 * Ci * Co + Co
    slices = max(1, min(DW_WORKSPACE // length, ntiles,
                        -(-DW3_BLOCKS // ctiles)))
    per = -(-ntiles // slices)
    slices = -(-ntiles // per)
    halo = _halo_pixels(ni, th, tw)
    stage = _align16((2 * TC_M * (to + 8) + halo * (ti + 8)) * 2)
    smem = _align16((halo + TC_M) * 4) + 3 * stage
    if smem > SMEM_LIMIT:
        raise ValueError(f"a 3x3 weight gradient at {(B, H, W, Ci)} -> {Co} "
                         f"needs {smem} bytes of shared memory, over "
                         f"{SMEM_LIMIT}")
    return dict(ni=ni, th=th, tw=tw, tiles_x=tiles_x, tiles_y=tiles_y,
                ntiles=ntiles, ti=ti, to=to, ctiles=ctiles, length=length,
                slices=slices, per=per,
                workspace=0 if slices == 1 else slices * length, smem=smem)


def _most_stages(fixed, stage, extra=lambda n: 0):
    """The most ring stages n, from TC_STAGES down to 2, that fit one
    block's shared memory beside `fixed` + extra(n) bytes (2 if none
    does)."""
    return next((n for n in range(TC_STAGES, 2, -1)
                 if fixed + extra(n) + n * stage <= SMEM_LIMIT), 2)


def unit1_plan(B, H, W, K, N, epi):
    """The plan of unit1_tc_kernel, a bf16 1x1 unit as a GEMM over (B, H, W)
    rows of K input channels and N outputs: the backward din (epi EPI_DIN,
    EPI_DIN_SUMS or EPI_DIN_SKIP; K dy channels, B = W^T) or the forward
    conv1x1_relu_stats (EPI_RELU_STATS; K = Cin, N = Cout, B = W). It gives
    the row tiles of TC_M rows (the last may be ragged), the input chunk ck
    (a stage holds ck input channels of a tile), the output chunk nt (a
    work item is one tile's nt outputs; halved down to 16 while the items
    number fewer than TC_MIN_WORK, as on the 16 to 4 px maps), whether the
    B operand (K x N, rows padded to N + 8 bf16) stays resident in shared
    memory (wres, where it fits), the ring's stages nst (the most, up to
    TC_STAGES, that fit one block on the SM), the item buffers na (TC_M x
    (nt + 8) bf16 each: the epilogue's aux tile and outputs; na * K/ck >=
    nst where an aux tile arrives by cp.async, so that it never lands in a
    buffer still in use; 1 for EPI_DIN and the forward, which have no aux),
    the work items and the bytes of shared memory: B when resident, nst
    stages of the raw inputs (TC_M x (ck + 8) bf16 each: dz and a, dz
    turned into dy in place, for the backward; x, turned into z, for the
    forward) and, unless B is resident, the chunk's slice of it (ck x (nt
    + 8) bf16), the item buffers, and where the epilogue sums
    (EPI_DIN_SUMS, EPI_RELU_STATS) the per-warp column sums (4 x 2 x nt
    f32) and the block's sums (2 x N f32). The widest plan, ck = TC_CK and
    nt = TC_NT, runs the kernel's WIDE instantiation, whose loop bounds are
    known at compile time."""
    _tc_channels(K, N)
    rows = _tc_rows(B, H, W)
    ntiles = -(-rows // TC_M)
    ck, nt = _widest(K, TC_CK), _widest(N, TC_NT)
    while ntiles * (N // nt) < TC_MIN_WORK and nt % 32 == 0:
        nt //= 2
    sums = (8 * nt + 2 * N) * 4 if epi in (EPI_DIN_SUMS, EPI_RELU_STATS) \
        else 0
    item = _align16(TC_M * (nt + 8) * 2)
    na = (lambda n: 1) if epi in (EPI_DIN, EPI_RELU_STATS) else \
        (lambda n: -(-n // (K // ck)))
    raw = (1 if epi == EPI_RELU_STATS else 2) * TC_M * (ck + 8) * 2
    for wres in (True, False):
        fixed = (_align16(K * (N + 8) * 2) if wres else 0) + sums
        stage = _align16(raw + (0 if wres else ck * (nt + 8) * 2))
        nst = _most_stages(fixed, stage, lambda n: na(n) * item)
        smem = fixed + na(nst) * item + nst * stage
        if smem <= SMEM_LIMIT:
            break
    else:
        raise ValueError(f"a 1x1 unit at {(B, H, W, K)} -> {N} needs {smem} "
                         f"bytes of shared memory, over {SMEM_LIMIT}")
    return dict(rows=rows, ntiles=ntiles, ck=ck, nt=nt, wres=wres, nst=nst,
                na=na(nst), work=ntiles * (N // nt), smem=smem)


def dw1_plan(B, H, W, Ci, Co):
    """The plan of dw1_tc_kernel, the weight gradient of a bf16 1x1 unit:
    the row tiles of DW1_M rows, the channel tile ti x to of one block (the
    widest that divide Ci and Co, up to DW1_TILE; 8 warps of 32 x to/2
    hold 128 x 128 float32 accumulators, 64 a lane), the slices of `per`
    row tiles that split the rows (enough blocks to fill the card once,
    few enough that their partials stay within DW_WORKSPACE floats; one
    slice writes dW and db directly, with no workspace), the ring's stages
    nst (the most, up to TC_STAGES, that fit) and the bytes of shared
    memory: nst stages of the raw dz and a (DW1_M x (to + 8) bf16 each, dz
    turned into dy in place) and the raw cin (DW1_M x (ti + 8) bf16, turned
    into z). ti = to = DW1_TILE runs the kernel's WIDE instantiation."""
    _tc_channels(Ci, Co)
    ntiles = -(-_tc_rows(B, H, W) // DW1_M)
    ti, to = _widest(Ci, DW1_TILE), _widest(Co, DW1_TILE)
    ctiles = (Ci // ti) * (Co // to)
    length = Ci * Co + Co
    slices = max(1, min(DW_WORKSPACE // length, ntiles,
                        -(-DW1_BLOCKS // ctiles)))
    per = -(-ntiles // slices)
    slices = -(-ntiles // per)
    stage = _align16(DW1_M * (2 * (to + 8) + ti + 8) * 2)
    nst = _most_stages(0, stage)
    return dict(ntiles=ntiles, ti=ti, to=to, ctiles=ctiles, length=length,
                slices=slices, per=per,
                workspace=0 if slices == 1 else slices * length, nst=nst,
                smem=nst * stage)


def _aligned16(*ts):
    """The tensor-core kernels copy their inputs 16 bytes at a time."""
    for t in ts:
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"the tensor-core units need 16-byte "
                             f"aligned operands; got {tuple(t.shape)} at "
                             f"{t.data_ptr():#x}")


def _launch_unit3_tc(pro, x, a, pv, w, bias, aux, n):
    """unit3_tc_kernel and its finalize: (out (B, H, W, n), sums (2, n))."""
    B, H, W, K = x.shape
    p = unit3_plan(B, H, W, K, n, dy=pro == PRO_DY)
    _require_cuda(x)
    _aligned16(x, a, w)
    out = torch.empty((B, H, W, n), dtype=x.dtype, device=x.device)
    ws = torch.empty((MAX_PARTS, 2 * n), dtype=torch.float32, device=x.device)
    sums = torch.empty((2, n), dtype=torch.float32, device=x.device)
    ptr = lambda t: t.data_ptr() if t is not None else None
    err = build.lib().spe_train_unit3_tc(
        pro, x.data_ptr(), ptr(a), pv.data_ptr(), w.data_ptr(), ptr(bias),
        ptr(aux), out.data_ptr(), ws.data_ptr(), sums.data_ptr(), B, H, W, K,
        n, p["ni"], p["th"], p["tw"], p["ck"], p["nt"], p["nst"], p["smem"],
        _stream(x))
    build.check(err, "tensor-core 3x3 unit kernel")
    return out, sums


def _launch_dw3_tc(dz, a, k, cin, aff):
    """dW (3, 3, Ci, Co) and db (1, Co), float32, of the bf16 3x3 unit on
    the tensor cores, and the launches it took (1 with one slice, else 2)."""
    B, H, W, Co = dz.shape
    Ci = cin.shape[-1]
    p = dw3_plan(B, H, W, Ci, Co)
    _aligned16(dz, a, cin)
    out = torch.empty(p["length"], dtype=torch.float32, device=dz.device)
    ws = torch.empty(p["workspace"], dtype=torch.float32, device=dz.device)
    err = build.lib().spe_train_dw3_tc(
        dz.data_ptr(), a.data_ptr(), k.data_ptr(), cin.data_ptr(),
        aff.data_ptr(), ws.data_ptr() if p["workspace"] else None,
        out.data_ptr(), B, H, W, Ci, Co, p["ni"], p["th"], p["tw"], p["ti"],
        p["to"], p["slices"], p["per"], p["smem"], _stream(dz))
    build.check(err, "tensor-core 3x3 dW kernel")
    return (out[:-Co].view(3, 3, Ci, Co), out[-Co:].view(1, Co),
            1 + (p["slices"] > 1))


def _launch_unit1_tc(epi, dz, a, kv, wt, aux, n):
    """unit1_tc_kernel (and its finalize for EPI_DIN_SUMS): (out (B, H, W,
    n), sums (2, n) or None, the launches it took). wt is W^T, (K, n)."""
    B, H, W, K = dz.shape
    p = unit1_plan(B, H, W, K, n, epi)
    _require_cuda(dz)
    _aligned16(dz, a, wt, aux)
    out = torch.empty((B, H, W, n), dtype=dz.dtype, device=dz.device)
    sums_needed = epi == EPI_DIN_SUMS
    ws = torch.empty((MAX_PARTS, 2 * n), dtype=torch.float32,
                     device=dz.device) if sums_needed else None
    sums = torch.empty((2, n), dtype=torch.float32,
                       device=dz.device) if sums_needed else None
    ptr = lambda t: t.data_ptr() if t is not None else None
    err = build.lib().spe_train_unit1_tc(
        epi, dz.data_ptr(), a.data_ptr(), kv.data_ptr(), wt.data_ptr(),
        ptr(aux), out.data_ptr(), ptr(ws), ptr(sums), p["rows"], K, n,
        p["ck"], p["nt"], p["nst"], p["na"], int(p["wres"]), p["smem"],
        _stream(dz))
    build.check(err, "tensor-core 1x1 unit kernel")
    return out, sums, 1 + sums_needed


def _launch_unit1_fwd_tc(pro, x, pv, w, bias, n):
    """unit1_tc_kernel's forward (conv1x1_relu_stats in bf16) and its
    finalize: (a (B, H, W, n), sums (2, n)). w is W, (K, n)."""
    B, H, W, K = x.shape
    p = unit1_plan(B, H, W, K, n, EPI_RELU_STATS)
    _require_cuda(x)
    _aligned16(x, w)
    out = torch.empty((B, H, W, n), dtype=x.dtype, device=x.device)
    ws = torch.empty((MAX_PARTS, 2 * n), dtype=torch.float32, device=x.device)
    sums = torch.empty((2, n), dtype=torch.float32, device=x.device)
    err = build.lib().spe_train_unit1_fwd_tc(
        pro, x.data_ptr(), pv.data_ptr() if pv is not None else None,
        w.data_ptr(), bias.data_ptr(), out.data_ptr(), ws.data_ptr(),
        sums.data_ptr(), p["rows"], K, n, p["ck"], p["nt"], p["nst"],
        int(p["wres"]), p["smem"], _stream(x))
    build.check(err, "tensor-core 1x1 forward kernel")
    return out, sums


def _launch_dw1_tc(dz, a, kv, cin, aff):
    """dW (Ci, Co) and db (1, Co), float32, of a bf16 1x1 unit on the
    tensor cores (z = cin re-normalized by aff, or cin when aff is None),
    and the launches it took (1 with one slice, else 2)."""
    B, H, W, Co = dz.shape
    Ci = cin.shape[-1]
    p = dw1_plan(B, H, W, Ci, Co)
    _aligned16(dz, a, cin)
    out = torch.empty(p["length"], dtype=torch.float32, device=dz.device)
    ws = torch.empty(p["workspace"], dtype=torch.float32, device=dz.device)
    err = build.lib().spe_train_dw1_tc(
        int(aff is not None), dz.data_ptr(), a.data_ptr(), kv.data_ptr(),
        cin.data_ptr(), aff.data_ptr() if aff is not None else None,
        ws.data_ptr() if p["workspace"] else None, out.data_ptr(),
        B * H * W, Ci, Co, p["ti"], p["to"], p["slices"], p["per"], p["nst"],
        p["smem"], _stream(dz))
    build.check(err, "tensor-core 1x1 dW kernel")
    return (out[:-Co].view(Ci, Co), out[-Co:].view(1, Co),
            1 + (p["slices"] > 1))


def _launch_dw(ks, dz, a, k, cin, aff):
    """dW (ks, ks, Ci, Co) and db (1, Co), float32, of one float32 unit."""
    B, H, W, Co = dz.shape
    Ci = cin.shape[-1]
    length = ks * ks * Ci * Co + Co
    slices, per = dw_slices(B * H * W, length)
    ws = torch.empty((slices, length), dtype=torch.float32, device=dz.device)
    out = torch.empty(length, dtype=torch.float32, device=dz.device)
    err = build.lib().spe_train_dw(
        int(dz.dtype == torch.bfloat16), ks, int(aff is not None),
        dz.data_ptr(), a.data_ptr(), k.data_ptr(), cin.data_ptr(),
        aff.data_ptr() if aff is not None else None, ws.data_ptr(),
        out.data_ptr(), B, H, W, Ci, Co, slices, per, _stream(dz))
    build.check(err, "train dW kernel")
    return (out[:-Co].view(ks, ks, Ci, Co), out[-Co:].view(1, Co))


def _weight(w, shape, dt):
    if tuple(w.shape) != shape:
        raise ValueError(f"weight must be {shape}, got {tuple(w.shape)}")
    return w.to(dt)


def conv1x1_relu_stats(x, w, b, scale=None, shift=None):
    """x (B, H, W, Cin), w (Cin, Cout) -> (a (B, H, W, Cout), sums (2, Cout)
    float32). scale/shift: the previous BN folded per input channel (None
    for the bottleneck's first unit). bf16 runs on the tensor cores
    (unit1_tc_kernel's forward), float32 on the FMA body. 2 launches."""
    Cin, Cout = w.shape
    _check(x, channels=(Cout,))
    if x.shape[-1] != Cin:
        raise ValueError(f"x {tuple(x.shape)} does not fit w {tuple(w.shape)}")
    if x.device.type == "cpu":
        return conv1x1_relu_stats_plain(x, w, b, scale, shift)
    pv = None if scale is None else torch.cat(
        [_vec(scale, Cin, x.device), _vec(shift, Cin, x.device)])
    pro = PRO_NONE if pv is None else PRO_AFFINE
    w = w.to(x.dtype).contiguous()
    bias = _vec(b, Cout, x.device)
    if x.dtype == torch.bfloat16:
        a, sums = _launch_unit1_fwd_tc(pro, x, pv, w, bias, Cout)
    else:
        a, sums = _launch_unit(1, pro, EPI_RELU_STATS, x, None, pv, w, bias,
                               None, Cout)
    conv1x1_relu_stats.launches += 2
    return a, sums


def conv3x3_relu_stats(x, w, b, scale, shift):
    """x (B, H, W, Cin), w (3, 3, Cin, Cout) -> (a, sums (2, Cout) float32).
    bf16 runs on the tensor cores (unit3_tc_kernel), float32 on the FMA
    body. 2 launches."""
    Cin, Cout = w.shape[2:]
    _check(x, channels=(Cout,))
    if x.device.type == "cpu":
        return conv3x3_relu_stats_plain(x, w, b, scale, shift)
    w = _weight(w, (3, 3, x.shape[-1], Cout), x.dtype).contiguous()
    pv = torch.cat([_vec(scale, Cin, x.device), _vec(shift, Cin, x.device)])
    bias = _vec(b, Cout, x.device)
    if x.dtype == torch.bfloat16:
        a, sums = _launch_unit3_tc(PRO_AFFINE, x, None, pv, w, bias, None,
                                   Cout)
    else:
        a, sums = _launch_unit(3, PRO_AFFINE, EPI_RELU_STATS, x, None, pv, w,
                               bias, None, Cout)
    conv3x3_relu_stats.launches += 2
    return a, sums


def bn_bwd_reduce(dz, a):
    """(2, C) float32 [sum dz, sum dz*a] over batch and space. 2 launches."""
    _check(dz, a)
    _same_shape(dz, a)
    if dz.device.type == "cpu":
        return bn_bwd_reduce_plain(dz, a)
    _require_cuda(dz)
    B, H, W, C = dz.shape
    ws = torch.empty((MAX_PARTS, 2 * C), dtype=torch.float32,
                     device=dz.device)
    sums = torch.empty((2, C), dtype=torch.float32, device=dz.device)
    err = build.lib().spe_train_reduce(
        int(dz.dtype == torch.bfloat16), dz.data_ptr(), a.data_ptr(),
        ws.data_ptr(), sums.data_ptr(), B * H * W, C, _stream(dz))
    build.check(err, "train reduce kernel")
    bn_bwd_reduce.launches += 2
    return sums


def unit1x1_bwd(dz, a, cin, w, k, aff=None, affine_cin=True,
                reduce_next=True):
    """Backward of a 1x1 unit: (dz_prev (B, H, W, Cm), dw (Cm, C), db (1,
    C), sums_prev (2, Cm)), the last three float32. dz, a (B, H, W, C);
    cin (B, H, W, Cm) the conv input's saved form, re-normalized by aff
    (2, Cm) when affine_cin; w (Cm, C); k (3, C) the K1/K2/K3 rows.
    sums_prev is zero unless reduce_next. bf16 runs on the tensor cores
    (unit1_tc_kernel, dw1_tc_kernel), float32 on the FMA bodies. 4
    launches (3 without reduce_next; one fewer in bf16 when dw1_plan takes
    one slice, which the fused step at batch 64 never does)."""
    _check(dz, a, cin)
    _same_shape(dz, a)
    if dz.device.type == "cpu":
        return unit1x1_bwd_plain(dz, a, cin, w, k, aff, affine_cin,
                                 reduce_next)
    C, Cm = dz.shape[-1], cin.shape[-1]
    w = _weight(w, (Cm, C), dz.dtype)
    kv = _vec(k, 3 * C, dz.device)
    affv = _vec(aff, 2 * Cm, dz.device) if affine_cin else None
    epi = EPI_DIN_SUMS if reduce_next else EPI_DIN
    aux = cin if reduce_next else None
    if dz.dtype == torch.bfloat16:
        din, sums, n_din = _launch_unit1_tc(epi, dz, a, kv, w.T.contiguous(),
                                            aux, Cm)
        dw, db, n_dw = _launch_dw1_tc(dz, a, kv, cin, affv)
        unit1x1_bwd.launches += n_din + n_dw
    else:
        din, sums = _launch_unit(1, PRO_DY, epi, dz, a, kv, w.T.contiguous(),
                                 None, aux, Cm)
        dw, db = _launch_dw(1, dz, a, kv, cin, affv)
        dw = dw[0, 0]
        unit1x1_bwd.launches += 4 if reduce_next else 3
    if sums is None:
        sums = torch.zeros((2, Cm), dtype=torch.float32, device=dz.device)
    return din, dw, db, sums


def unit3x3_bwd(dz, a, cin, w, k, aff):
    """Backward of the 3x3 unit: (dz_prev, dw (3, 3, C, C), db (1, C),
    sums_prev (2, C)). dz, a, cin (B, H, W, C); w (3, 3, C, C); k (3, C);
    aff (2, C) the previous unit's BN affine. bf16 runs on the tensor cores
    (unit3_tc_kernel, dw3_tc_kernel), float32 on the FMA bodies. 4
    launches (3 in bf16 when dw3_plan takes one slice, which the fused
    step at batch 64 never does)."""
    _check(dz, a, cin)
    _same_shape(dz, a, cin)
    if dz.device.type == "cpu":
        return unit3x3_bwd_plain(dz, a, cin, w, k, aff)
    C = dz.shape[-1]
    w = _weight(w, (3, 3, C, C), dz.dtype)
    kv = _vec(k, 3 * C, dz.device)
    affv = _vec(aff, 2 * C, dz.device)
    # din is the SAME conv of dy with the kernel flipped in space and
    # transposed in channels: Wk[p, q, o, i] = W[2-p, 2-q, i, o].
    wk = w.flip(0, 1).transpose(2, 3).contiguous()
    if dz.dtype == torch.bfloat16:
        din, sums = _launch_unit3_tc(PRO_DY, dz, a, kv, wk, None, cin, C)
        dw, db, n_dw = _launch_dw3_tc(dz, a, kv, cin, affv)
        unit3x3_bwd.launches += 2 + n_dw
        return din, dw, db, sums
    din, sums = _launch_unit(3, PRO_DY, EPI_DIN_SUMS, dz, a, kv, wk, None,
                             cin, C)
    dw, db = _launch_dw(3, dz, a, kv, cin, affv)
    unit3x3_bwd.launches += 4
    return din, dw, db, sums


def unit1_bwd(dz, a, x, g, w, k):
    """Backward of unit 1 and the skip: (dx (B, H, W, C), dw (C, Cm), db
    (1, Cm)). dz, a (B, H, W, Cm); x, g (B, H, W, C); w (C, Cm). bf16 runs
    on the tensor cores (unit1_tc_kernel, dw1_tc_kernel), float32 on the
    FMA bodies. 3 launches (2 in bf16 when dw1_plan takes one slice, which
    the fused step at batch 64 never does)."""
    _check(dz, a, x, g)
    _same_shape(dz, a)
    _same_shape(x, g)
    if dz.device.type == "cpu":
        return unit1_bwd_plain(dz, a, x, g, w, k)
    Cm, C = dz.shape[-1], x.shape[-1]
    w = _weight(w, (C, Cm), dz.dtype)
    kv = _vec(k, 3 * Cm, dz.device)
    if dz.dtype == torch.bfloat16:
        dx, _, n_dx = _launch_unit1_tc(EPI_DIN_SKIP, dz, a, kv,
                                       w.T.contiguous(), g, C)
        dw, db, n_dw = _launch_dw1_tc(dz, a, kv, x, None)
        unit1_bwd.launches += n_dx + n_dw
        return dx, dw, db
    dx, _ = _launch_unit(1, PRO_DY, EPI_DIN_SKIP, dz, a, kv,
                         w.T.contiguous(), None, g, C)
    dw, db = _launch_dw(1, dz, a, kv, x, None)
    unit1_bwd.launches += 3
    return dx, dw[0, 0], db


for _fn in (conv1x1_relu_stats, conv3x3_relu_stats, bn_bwd_reduce,
            unit1x1_bwd, unit3x3_bwd, unit1_bwd):
    _fn.launches = 0
del _fn
