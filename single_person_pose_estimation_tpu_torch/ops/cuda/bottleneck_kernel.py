"""Fused hourglass bottlenecks (inference), as hand-written CUDA kernels.

    t1  = bn1(relu(x @ W1 + b1))            1x1, C -> Cm
    t2  = bn2(relu(conv3x3(t1, W2) + b2))   3x3, Cm -> Cm
    t3  = bn3(relu(t2 @ W3 + b3))           1x1, Cm -> C
    out = x + t3

Replaces `single_person_pose_estimation_tpu/ops/pallas/bottleneck_kernel.py`
`fused_bottleneck`, `fused_bottleneck_pool` (which also returns the 2x2/s2
maxpool of `out`), `fused_bottleneck_rows` (the same function as
`fused_bottleneck`, on maps too tall for one TPU block) and
`fused_bottleneck_convskip` (a 1x1 conv + ReLU skip from Cin to C channels
in place of the identity). The kernels are in `csrc/bottleneck.cu`; its
source note says what bounds them on the H100 and how they are tiled. In
bfloat16 every one of them (#1, #2, #3's two launches, #5, #6) runs the
tensor-core body of `csrc/bottleneck_tc.cuh`, with the plan of
`bneck_tc_plan` (#6: `convskip_tc_plan`); in float32 the FMA bodies of
`csrc/bottleneck.cu` with the tile of `fma_tile_plan`.

Layout is NHWC, as in the JAX package. Weights are (C, Cm), (3, 3, Cm, Cm)
and (Cm, C) in the storage dtype (float32 or bfloat16); biases and the
folded BN affines (`bn_affine`) are float32; sums are taken in float32.

Each wrapper runs the plain PyTorch version for a tensor on the CPU and the
kernel for a CUDA tensor; there is no fallback from one to the other. The
wrapper's `launches` attribute counts kernel launches.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from single_person_pose_estimation_tpu_torch.ops.cuda import build

_DTYPES = (torch.float32, torch.bfloat16)
# csrc/bottleneck.cuh Mode; MODE_PLAIN_POOL is the subtree walk's (#7).
MODE_PLAIN, MODE_POOL, MODE_UPADD, MODE_PLAIN_POOL = 0, 1, 2, 3
SMEM_LIMIT = 232448       # shared memory of one block on the H100
# The bf16 body on the tensor cores (csrc/bottleneck_tc.cuh).
BNECK_TC_TILES = ((8, 8), (4, 8), (4, 4), (2, 2))  # tried widest first
BNECK_TC_CK = 64          # widest input-channel chunk of a ring stage
BNECK_TC_NT = 128         # widest output-channel chunk of a ring stage
BNECK_TC_STAGES = 4       # ring stages, at most
# The FMA bodies (float32): square tiles, tried widest first.
FMA_TILES = (8, 4, 2)


def bn_affine(scale, bias, mean, var, eps: float = 1e-3):
    """Fold inference BatchNorm into (a, c): bn(v) = a*v + c."""
    a = scale / torch.sqrt(var + eps)
    return a, bias - mean * a


@dataclass
class BottleneckParams:
    """One bottleneck's weights, laid out once for the kernels.

    w1 (C, Cm), w2 (3, 3, Cm, Cm), w3 (Cm, C) in the storage dtype; vec is
    float32 [b1, a1, c1, b2, a2, c2] (Cm each) then [b3, a3, c3] (C each).
    """

    w1: torch.Tensor
    w2: torch.Tensor
    w3: torch.Tensor
    vec: torch.Tensor

    @classmethod
    def pack(cls, w1, b1, w2, b2, w3, b3, a1, c1, a2, c2, a3, c3, *,
             dtype, device=None):
        f32 = dict(dtype=torch.float32, device=device)
        vec = torch.cat([torch.as_tensor(v).reshape(-1).to(**f32)
                         for v in (b1, a1, c1, b2, a2, c2, b3, a3, c3)])
        st = dict(dtype=dtype, device=device)
        return cls(torch.as_tensor(w1).to(**st).contiguous(),
                   torch.as_tensor(w2).to(**st).contiguous(),
                   torch.as_tensor(w3).to(**st).contiguous(),
                   vec.contiguous())

    def stages(self):
        """(b1, a1, c1, b2, a2, c2) over Cm and (b3, a3, c3) over C."""
        cm, c = self.w3.shape
        return (self.vec[:6 * cm].view(6, cm).unbind(0)
                + self.vec[6 * cm:6 * cm + 3 * c].view(3, c).unbind(0))


@dataclass
class ConvSkipParams(BottleneckParams):
    """A conv-skip bottleneck's weights: `BottleneckParams` with w1 (Cin,
    Cm) and w3 (Cm, C), plus the skip's ws (Cin, C) in the storage dtype
    and its bias bs appended to vec (C floats)."""

    ws: torch.Tensor = None

    @classmethod
    def pack(cls, ws, bs, w1, b1, w2, b2, w3, b3, a1, c1, a2, c2, a3, c3, *,
             dtype, device=None):
        p = BottleneckParams.pack(w1, b1, w2, b2, w3, b3, a1, c1, a2, c2,
                                  a3, c3, dtype=dtype, device=device)
        bs = torch.as_tensor(bs).reshape(-1).to(dtype=torch.float32,
                                                device=device)
        return cls(p.w1, p.w2, p.w3, torch.cat([p.vec, bs]).contiguous(),
                   torch.as_tensor(ws).to(dtype=dtype,
                                          device=device).contiguous())

    @property
    def bs(self):
        cm, c = self.w3.shape
        return self.vec[6 * cm + 3 * c:]


# ---------------------------------------------------------------------------
# Plain PyTorch versions: the same arithmetic and rounding points.
# ---------------------------------------------------------------------------

def _bneck_t3(x, p: BottleneckParams):
    """Returns (x as float32, t3 as float32) of one bottleneck."""
    dt = x.dtype
    b1, a1, c1, b2, a2, c2, b3, a3, c3 = p.stages()
    xf = x.float()
    t1 = (torch.relu(xf @ p.w1.float() + b1) * a1 + c1).to(dt)
    z2 = F.conv2d(t1.float().permute(0, 3, 1, 2),
                  p.w2.float().permute(3, 2, 0, 1), padding=1)
    t2 = (torch.relu(z2.permute(0, 2, 3, 1) + b2) * a2 + c2).to(dt)
    t3 = torch.relu(t2.float() @ p.w3.float() + b3) * a3 + c3
    return xf, t3


def maxpool2x2(x):
    """2x2/s2 max pool of an NHWC map."""
    B, H, W, C = x.shape
    return x.reshape(B, H // 2, 2, W // 2, 2, C).amax(dim=(2, 4))


def upsample2x(x):
    """Nearest 2x upsample of an NHWC map."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def fused_bottleneck_plain(x, p: BottleneckParams):
    xf, t3 = _bneck_t3(x, p)
    return (xf + t3).to(x.dtype)


def fused_bottleneck_pool_plain(x, p: BottleneckParams):
    xf, t3 = _bneck_t3(x, p)
    out = (xf + t3.to(x.dtype).float()).to(x.dtype)
    return out, maxpool2x2(out)


def fused_bottleneck_rows_plain(x, p: BottleneckParams, hb: int = 32):
    """#5's function: `fused_bottleneck_plain` after the strip check."""
    _rows_check(x, hb)
    return fused_bottleneck_plain(x, p)


def fused_bottleneck_convskip_plain(x, p: ConvSkipParams):
    """skip = round(relu(x @ Ws + bs)); out = skip + round(t3), added in
    the storage dtype (the TPU kernel's rounding points)."""
    dt = x.dtype
    skip = torch.relu(x.float() @ p.ws.float() + p.bs).to(dt)
    _, t3 = _bneck_t3(x, p)
    return (skip.float() + t3.to(dt).float()).to(dt)


def bottleneck_upadd_plain(x, u_lo, p: BottleneckParams):
    """round(round(x + t3) + up2x(u_lo)): the first half of an up-level."""
    xf, t3 = _bneck_t3(x, p)
    d = (xf + t3).to(x.dtype)
    return (d.float() + upsample2x(u_lo).float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Kernel launch.
# ---------------------------------------------------------------------------

def _check_x(x):
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"expected a contiguous NHWC tensor, got shape "
                         f"{tuple(x.shape)} contiguous={x.is_contiguous()}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"storage dtype must be float32 or bfloat16, got "
                        f"{x.dtype}")


def _check_weights(x, p, names):
    for name in names:
        w = getattr(p, name)
        if w.dtype != x.dtype or w.device != x.device:
            raise TypeError(f"{name} is {w.dtype} on {w.device}; x is "
                            f"{x.dtype} on {x.device}")
    if p.vec.dtype != torch.float32 or p.vec.device != x.device:
        raise TypeError("vec must be float32 on x's device")


def _check(x, p: BottleneckParams):
    _check_x(x)
    # The kernel spreads Cm/4 and C/4 channel groups over its 256 threads;
    # more groups than threads would leave t1/t2 unwritten.
    C, Cm = p.w1.shape
    if x.shape[-1] != C or C % 16 or Cm != C // 2 or C > 1024:
        raise ValueError(f"channels must be a multiple of 16 (<= 1024) "
                         f"with Cm = C/2: x {tuple(x.shape)}, w1 "
                         f"{tuple(p.w1.shape)}")
    _check_weights(x, p, ("w1", "w2", "w3"))


def _check_convskip(x, p: ConvSkipParams):
    _check_x(x)
    # Cin, C and Cm as the kernel's thread groups cover them (see _check).
    cin, cm = p.w1.shape
    c = p.w3.shape[1]
    if (x.shape[-1] != cin or p.ws.shape != (cin, c) or p.w3.shape[0] != cm
            or cin % 16 or c % 16 or cm != c // 2 or max(cin, c) > 1024):
        raise ValueError(f"expected x (..., Cin), ws (Cin, C), w1 (Cin, "
                         f"C/2), w3 (C/2, C) with Cin and C multiples of 16 "
                         f"(<= 1024): x {tuple(x.shape)}, ws "
                         f"{tuple(p.ws.shape)}, w1 {tuple(p.w1.shape)}, w3 "
                         f"{tuple(p.w3.shape)}")
    _check_weights(x, p, ("ws", "w1", "w2", "w3"))
    if p.vec.numel() != 6 * cm + 4 * c:
        raise ValueError(f"vec must hold {6 * cm + 4 * c} values (with bs), "
                         f"got {p.vec.numel()}")


def _bneck_tc_smem(th, tw, C, Cm, pooling, ck, nt, nst, cin=None):
    """Bytes of shared memory of one th x tw tile (csrc/bottleneck_tc.cuh
    bneck_tc_smem): region A, the x halo (rows of C + 8 bf16, or of cin + 8
    for the conv skip), which t2 (rows of Cm + 8) and, when pooling, the
    out tile (rows of C + 8) replace after phase 1 (the conv skip: after
    its skip product); t1 on the halo (rows of Cm + 8); nst ring stages of
    ck x (nt + 8)."""
    hw2, p = (th + 2) * (tw + 2), th * tw
    reg_a = max(hw2 * ((cin or C) + 8),
                p * (Cm + 8) + (p * (C + 8) if pooling else 0))
    return (reg_a + hw2 * (Cm + 8) + nst * ck * (nt + 8)) * 2


def _bneck_tc_mw(th, tw, nt):
    """m16 tiles of one warp, at most, in phase 1 of a th x tw tile
    (csrc/bottleneck_tc.cuh bneck_tc_mw): 4 fits two blocks an SM, 6 one."""
    m16_tiles = -(-(th + 2) * (tw + 2) // 16)
    warps_m = 8 // (2 if nt == 16 else 4)
    return -(-m16_tiles // warps_m)


def bneck_tc_plan(B, H, W, C, Cm, mode, blocks=2, tile=None, ck=None):
    """The plan of the bf16 bottleneck body on the tensor cores
    (csrc/bottleneck_tc.cuh), which the wrappers pass to the kernel as
    integers. For a (B, H, W, C) input of `mode` it gives:

    tsh x tsw, the tile: the first of BNECK_TC_TILES (or `tile`) whose
    tile fits one block with two ring stages, pooling or not, and leaves a
    warp at most 6 m16 tiles; it depends on the channels alone, so a map's
    tiles (tsh x tsw clipped to it: th x tw) are the same in a grid launch
    and in the subtree walk, and pooling tiles are even (the tile is, and
    a map under it is even where it pools);
    ck, the input chunk of a stage: the widest multiple of 16 up to
    BNECK_TC_CK (or `ck`) that divides Cm; nt, the output chunk: the widest
    multiple of 32 up to BNECK_TC_NT that divides Cm, or 16 (the warps
    split a product 2 x 4 over m16 and n8 tiles, or 4 x 2 for nt = 16);
    mw, the m16 tiles of a warp, at most: 4 runs the kernel's two-block
    instantiation, 6 its one-block one; stages, the ring's slices per tile
    (phase 1, 2 and 3 in turn); nst, the most ring stages, up to
    BNECK_TC_STAGES, with which `blocks` blocks (2, or 1 for the walk's one
    block per image) fit an SM, else with which one does; smem, the bytes
    of the th x tw tile, or, for the walk (MODE_PLAIN_POOL), of the tsh x
    tsw tile that its widest level takes; the grid (tiles_y * tiles_x,
    B).

    The bf16 channel contract, a ValueError outside it: C a multiple of 32
    up to 1024 and Cm = C/2, a multiple of 16, the k16 depth of phases 2
    and 3 (float32 keeps `_check`'s C a multiple of 16)."""
    if C % 32 or Cm * 2 != C or not 0 < C <= 1024:
        raise ValueError(f"the bfloat16 bottleneck takes C a multiple of 32 "
                         f"(<= 1024) with Cm = C/2, got C={C}, Cm={Cm}")
    plan = _tc_plan(B, H, W, C, Cm, None, mode in (MODE_POOL,
                                                   MODE_PLAIN_POOL),
                    mode == MODE_PLAIN_POOL, blocks, tile, ck)
    k1, k2, nt = C // plan["ck"], Cm // plan["ck"], plan["nt"]
    plan["stages"] = (Cm // nt) * k1 + (Cm // nt) * 9 * k2 + (C // nt) * k2
    return plan


def convskip_tc_plan(B, H, W, cin, C, Cm, blocks=2, tile=None, ck=None,
                     nst=None):
    """The plan of the bf16 conv-skip bottleneck (#6) on the tensor cores
    (csrc/bottleneck_tc.cuh, kConvSkip), `bneck_tc_plan`'s for a (B, H, W,
    cin) input, tiles chosen without pooling: the x halo is cin + 8 wide,
    ck the widest multiple of 16 up to BNECK_TC_CK (or `ck`) that divides
    both cin and Cm, and the ring carries, per tile, `stage_split` = W1
    (Cm/nt groups of cin/ck), Ws (C/nt groups of cin/ck), W2 (Cm/nt groups
    of 9 x Cm/ck) and W3 (C/nt groups of Cm/ck), in that order: `stages`
    in all. `nst` caps the ring stages (the measurement's override).

    The contract, a ValueError outside it: cin a multiple of 16 and C a
    multiple of 32 (each <= 1024), Cm = C/2. `_check_convskip` admits C a
    multiple of 16, which float32 takes; a bf16 C that is an odd multiple
    of 16 leaves Cm short of the k16 depth of phases 2 and 3."""
    if (C % 32 or Cm * 2 != C or not 0 < C <= 1024 or cin % 16
            or not 0 < cin <= 1024):
        raise ValueError(f"the bfloat16 conv-skip bottleneck takes Cin a "
                         f"multiple of 16 and C a multiple of 32 (each <= "
                         f"1024) with Cm = C/2, got Cin={cin}, C={C}, "
                         f"Cm={Cm}")
    plan = _tc_plan(B, H, W, C, Cm, cin, False, False, blocks, tile, ck,
                    nst)
    k1, k2, nt = cin // plan["ck"], Cm // plan["ck"], plan["nt"]
    plan["stage_split"] = dict(w1=(Cm // nt) * k1, ws=(C // nt) * k1,
                               w2=(Cm // nt) * 9 * k2, w3=(C // nt) * k2)
    plan["stages"] = sum(plan["stage_split"].values())
    return plan


def _tc_plan(B, H, W, C, Cm, cin, pooling, walk, blocks, tile, ck,
             nst=None):
    """What `bneck_tc_plan` and `convskip_tc_plan` share: the chunks, the
    tile (fitted as if pooling, so that a map's tiles are the same in
    every mode, except for the conv skip, which never pools), the m16
    tiles of a warp, the ring stages and the bytes; `walk` (#7) sizes the
    bytes for the unclipped tile."""
    ck = _widest(math.gcd(cin or C, Cm), ck or BNECK_TC_CK)
    nt = next((d for d in range(BNECK_TC_NT, 0, -32) if Cm % d == 0), 16)
    fit_pooling = pooling or cin is None
    tsh, tsw = next(
        ((a, b) for a, b in ((tile,) if tile else BNECK_TC_TILES)
         if _bneck_tc_mw(a, b, nt) <= 6
         and _bneck_tc_smem(a, b, C, Cm, fit_pooling, ck, nt, 2, cin)
         <= SMEM_LIMIT),
        (None, None))
    if tsh is None:
        raise ValueError(f"no bottleneck tile of {tile or BNECK_TC_TILES} "
                         f"fits {SMEM_LIMIT} bytes at C={C}, Cin={cin}")
    th, tw = (tsh, tsw) if walk else (min(H, tsh), min(W, tsw))
    mw = 4 if _bneck_tc_mw(th, tw, nt) <= 4 else 6
    smem = lambda n: _bneck_tc_smem(th, tw, C, Cm, pooling, ck, nt, n, cin)
    limits = ((SMEM_LIMIT // 2 - 1024,) if blocks == 2 and mw == 4 else ()) \
        + (SMEM_LIMIT,)
    nst = next(n for limit in limits
               for n in range(nst or BNECK_TC_STAGES, 1, -1)
               if smem(n) <= limit)
    tiles_y, tiles_x = -(-H // th), -(-W // tw)
    return dict(tsh=tsh, tsw=tsw, th=th, tw=tw, tiles_y=tiles_y,
                tiles_x=tiles_x, ck=ck, nt=nt, mw=mw, nst=nst,
                smem=smem(nst), grid=(tiles_y * tiles_x, B))


def fma_smem(kind, ts, C, Cm, itemsize=4, cin=None):
    """Bytes of shared memory of one ts x ts tile of an FMA body: "bneck"
    (csrc/bottleneck.cuh tile_smem_elems, pooling or not: #1-#3, #5 and
    #7's walk), "convskip" (#6: the Cin-wide x halo, t1 and t2) or "mobile"
    (csrc/mobile.cu: the x halo and t1 on the halo)."""
    hw2, p = (ts + 2) ** 2, ts * ts
    if kind == "bneck":
        elems = max(hw2 * C, p * Cm + p * C) + hw2 * Cm
    elif kind == "convskip":
        elems = hw2 * cin + hw2 * Cm + p * Cm
    elif kind == "mobile":
        elems = hw2 * (C + Cm)
    else:
        raise ValueError(f"no FMA body {kind!r}")
    return elems * itemsize


def fma_tile_plan(kind, C, Cm, itemsize=4, cin=None):
    """The tile of an FMA body (`fma_smem`'s kinds), which the float32
    wrappers pass to the kernel: the widest ts of FMA_TILES whose ts x ts
    tile fits one block's shared memory, clipped by the kernel to a smaller
    map. An 8 x 8 tile takes 600 bytes a channel in float32 (C=384 is the
    widest that fits) and a 4 x 4 tile 216 (up to C=1024), so at C <= 384
    every float32 tile is 8 x 8, and the conv skip, whose x halo is Cin
    wide, takes 2 x 2 at Cin = C = 1024. Returns {"ts", "smem"}; a
    ValueError where no tile fits."""
    for ts in FMA_TILES:
        smem = fma_smem(kind, ts, C, Cm, itemsize, cin)
        if smem <= SMEM_LIMIT:
            return dict(ts=ts, smem=smem)
    raise ValueError(f"no {kind} tile of {FMA_TILES} fits {SMEM_LIMIT} "
                     f"bytes at C={C}, Cm={Cm}, Cin={cin}")


def _widest(n, cap):
    """The largest multiple of 16 that divides n (a multiple of 16), at
    most cap."""
    return next(d for d in range(cap, 0, -16) if n % d == 0)


def _rows_check(x, hb):
    """The TPU kernel's strip contract: HB = min(hb, H) divides H."""
    H = x.shape[1]
    HB = min(hb, H)
    if HB < 1 or H % HB:
        raise ValueError(f"the strip height min(hb, H) = {HB} must divide "
                         f"H = {H} (hb={hb})")


def _require_cuda(x):
    if x.device.type != "cuda":
        raise RuntimeError(f"the CUDA kernel takes CUDA tensors; got "
                           f"{x.device}")


def _stream_ptr(device):
    """The cudaStream_t of `device`'s current stream, as
    `torch.cuda.current_stream(device).cuda_stream` gives it, without
    making a Stream object, which costs 0.007-0.010 ms of host time a call
    on an H100 host (scripts/torch_port_decode_host_ab.py)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def launch_bottleneck(mode, x, p: BottleneckParams, out, pooled=None,
                      u_lo=None, plan=None):
    """Launch csrc/bottleneck.cu on x's current stream (no sync): the
    tensor-core body for bfloat16 (with `plan`, by default
    `bneck_tc_plan`'s), the FMA body for float32."""
    _require_cuda(x)
    B, H, W, C = x.shape
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the kernel grid's 65535 images")
    if mode == MODE_POOL and (H % 2 or W % 2):
        raise ValueError(f"the pool epilogue needs even H and W, got {H}x{W}")
    if mode == MODE_UPADD and (u_lo is None or u_lo.shape != (
            B, H // 2, W // 2, C) or H % 2 or W % 2):
        raise ValueError(f"u_lo must be (B, H/2, W/2, C) for x "
                         f"{tuple(x.shape)}")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = (x.data_ptr(), p.w1.data_ptr(), p.w2.data_ptr(), p.w3.data_ptr(),
            p.vec.data_ptr(), out.data_ptr(),
            pooled.data_ptr() if pooled is not None else None,
            u_lo.data_ptr() if u_lo is not None else None)
    Cm = p.w1.shape[1]
    if x.dtype == torch.bfloat16:
        plan = plan or bneck_tc_plan(B, H, W, C, Cm, mode)
        err = build.lib().spe_bottleneck_tc(
            mode, *ptrs, B, H, W, C, Cm, plan["tsh"], plan["tsw"],
            plan["ck"], plan["nt"], plan["nst"], plan["smem"], stream)
    else:
        ts = fma_tile_plan("bneck", C, Cm)["ts"]
        err = build.lib().spe_bottleneck(mode, 0, *ptrs, B, H, W, C, Cm, ts,
                                         stream)
    build.check(err, "bottleneck kernel")


def fused_bottleneck(x, p: BottleneckParams):
    """x (B, H, W, C) -> (B, H, W, C), dtype of x."""
    _check(x, p)
    if x.device.type == "cpu":
        return fused_bottleneck_plain(x, p)
    out = torch.empty_like(x)
    launch_bottleneck(MODE_PLAIN, x, p, out)
    fused_bottleneck.launches += 1
    return out


def fused_bottleneck_pool(x, p: BottleneckParams):
    """Like fused_bottleneck, and also the 2x2/s2 maxpool of the output.
    Returns (out, pooled)."""
    _check(x, p)
    if x.device.type == "cpu":
        return fused_bottleneck_pool_plain(x, p)
    B, H, W, C = x.shape
    out = torch.empty_like(x)
    pooled = torch.empty((B, H // 2, W // 2, C), dtype=x.dtype,
                         device=x.device)
    launch_bottleneck(MODE_POOL, x, p, out, pooled=pooled)
    fused_bottleneck_pool.launches += 1
    return out, pooled


def fused_bottleneck_rows(x, p: BottleneckParams, hb: int = 32):
    """#5, the row-blocked bottleneck: x (B, H, W, C) -> (B, H, W, C), the
    function of `fused_bottleneck`, with the TPU kernel's contract:
    HB = min(hb, H) must divide H, or ValueError. Replaces the JAX
    package's `ops/pallas/bottleneck_kernel.py` `fused_bottleneck_rows`;
    like #1 it is bound by its operations (0.903 ms at 128 px, C=256,
    B=128 in bf16), and runs them as FMA on the CUDA cores.

    `hb` is the TPU's strip height, a VMEM blocking choice like
    `pick_nimg`. It is checked, and the kernel does not tile by it: the
    CUDA kernel cuts every map in 8x8 tiles with a one-pixel halo, so a
    map of any height runs the `fused_bottleneck` kernel (csrc/
    bottleneck.cu says why strips do not carry over). Launches count on
    `fused_bottleneck_rows.launches`, apart from `fused_bottleneck`'s."""
    _rows_check(x, hb)
    _check(x, p)
    if x.device.type == "cpu":
        return fused_bottleneck_rows_plain(x, p, hb)
    out = torch.empty_like(x)
    launch_bottleneck(MODE_PLAIN, x, p, out)
    fused_bottleneck_rows.launches += 1
    return out


def launch_convskip(x, p: ConvSkipParams, out, plan=None):
    """Launch #6 on x's current stream (no sync): the tensor-core body
    for bfloat16 (with `plan`, by default `convskip_tc_plan`'s, which
    raises ValueError outside the bf16 contract), the FMA body on the tile
    of `fma_tile_plan` for float32."""
    _require_cuda(x)
    B, H, W, cin = x.shape
    cm, c = p.w3.shape
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the kernel grid's 65535 images")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = (x.data_ptr(), p.ws.data_ptr(), p.w1.data_ptr(), p.w2.data_ptr(),
            p.w3.data_ptr(), p.vec.data_ptr(), out.data_ptr())
    if x.dtype == torch.bfloat16:
        plan = plan or convskip_tc_plan(B, H, W, cin, c, cm)
        err = build.lib().spe_convskip_tc(
            *ptrs, B, H, W, cin, c, cm, plan["tsh"], plan["tsw"], plan["ck"],
            plan["nt"], plan["nst"], plan["smem"], stream)
    else:
        ts = fma_tile_plan("convskip", c, cm, 4, cin)["ts"]
        err = build.lib().spe_convskip(0, *ptrs, B, H, W, cin, c, cm, ts,
                                       stream)
    build.check(err, "conv-skip bottleneck kernel")


def fused_bottleneck_convskip(x, p: ConvSkipParams):
    """#6, the conv-skip bottleneck: x (B, H, W, Cin) -> (B, H, W, C),
    out = round(relu(x @ Ws + bs)) + round(t3) in the storage dtype.

    Replaces the JAX package's `ops/pallas/bottleneck_kernel.py`
    `fused_bottleneck_convskip` (`front_bottleneck_3` under `fuse_front`:
    64 px, 128 -> 256 channels). Bound by its operations (0.243 ms at
    B=128 in bf16). In bfloat16 it runs the tensor-core body of
    `csrc/bottleneck_tc.cuh` (the tile of `convskip_tc_plan`: 8x8 at the
    front's widths), whose skip is a fourth product on the ring right
    after phase 1, taken while the Cin-wide x halo is still in shared
    memory; bf16 takes Cin % 16 and C % 32 (a ValueError before any
    launch otherwise). In float32 the FMA body (`convskip_kernel`) keeps
    the halo beside t1 and t2 for the skip product (csrc/bottleneck.cu)."""
    _check_convskip(x, p)
    if x.device.type == "cpu":
        return fused_bottleneck_convskip_plain(x, p)
    out = torch.empty((*x.shape[:3], p.w3.shape[1]), dtype=x.dtype,
                      device=x.device)
    launch_convskip(x, p, out)
    fused_bottleneck_convskip.launches += 1
    return out


fused_bottleneck.launches = 0
fused_bottleneck_pool.launches = 0
fused_bottleneck_rows.launches = 0
fused_bottleneck_convskip.launches = 0
