"""Fused MOBILE (separable-conv) bottleneck, its pool twin and its up-level
(inference), as hand-written CUDA kernels.

    t1  = bn1(relu(x @ W1' + b1))           W1' = dw1[:, None] * pw1, C -> Cm
    a   = round(sum of 9 taps of t1 * d2)   3x3 depthwise, float32 sums
    t2  = bn2(relu(a @ pw2 + b2))           Cm -> Cm
    t3  = bn3(relu(t2 @ W3' + b3))          W3' = dw3[:, None] * pw3, Cm -> C
    out = x + t3

Replaces `single_person_pose_estimation_tpu/ops/pallas/mobile_kernel.py`
`fused_bottleneck_mobile`, `fused_bottleneck_mobile_pool` (also returns the
2x2/s2 maxpool of `out`) and `fused_uplevel_mobile` (d = bneck_short(feat),
s = d + up2x(u_lo), out = bneck_merged(s), in two launches: the up-add
epilogue, then the plain bottleneck on s, as `uplevel_kernel.py` serves
the standard model). The kernels are `csrc/mobile.cu`; its source note
says what bounds them on the H100 and how they are tiled: in bfloat16 the
tensor-core body of `csrc/bottleneck_tc.cuh` with its mobile phase 2, on
the plan of `mobile_tc_plan`; in float32 the FMA kernel, on the tile of
`fma_tile_plan`.

Rounding follows the TPU kernel, not flax: `MobileParams.pack` (the TPU
module's `_prep_operands`) folds the 1x1 depthwise scales into the
pointwise weights in float32 and rounds once to the storage dtype, keeps
the 3x3 taps in float32, and the depthwise sum is rounded to the storage
dtype before pw2. At float32 this equals flax's two convs up to summation
order; at bfloat16 it is a band (tests/test_torch_mobile.py).

Layout is NHWC, as in the JAX package. Each wrapper runs the plain PyTorch
version for a tensor on the CPU and the kernel for a CUDA tensor; there is
no fallback from one to the other. The wrapper's `launches` attribute
counts kernel launches.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from single_person_pose_estimation_tpu_torch.ops.cuda import build
from single_person_pose_estimation_tpu_torch.ops.cuda import (
    bottleneck_kernel as bk,
)
from single_person_pose_estimation_tpu_torch.ops.cuda.bottleneck_kernel import (
    _DTYPES,
    _require_cuda,
    fma_tile_plan,
    maxpool2x2,
    upsample2x,
)

MODE_PLAIN, MODE_POOL, MODE_UPADD = 0, 1, 2


@dataclass
class MobileParams:
    """One mobile bottleneck's operands, laid out once for the kernels.

    w1 (C, Cm), w2 (Cm, Cm), w3 (Cm, C) in the storage dtype; d2 (9, Cm)
    float32 taps in row-major order; vec float32 [b1, a1, c1, b2, a2, c2]
    (Cm each) then [b3, a3, c3] (C each).
    """

    w1: torch.Tensor
    d2: torch.Tensor
    w2: torch.Tensor
    w3: torch.Tensor
    vec: torch.Tensor

    @classmethod
    def pack(cls, dw1, pw1, b1, dw2, pw2, b2, dw3, pw3, b3,
             a1, c1, a2, c2, a3, c3, *, dtype, device=None):
        """From the JAX package's `mobile_bneck_params` tuple: dw1 (C,),
        pw1 (C, Cm), dw2 (3, 3, Cm), pw2 (Cm, Cm), dw3 (Cm,), pw3 (Cm, C),
        the pointwise biases and the folded BN affines."""
        f32 = dict(dtype=torch.float32, device=device)
        t = lambda v: torch.as_tensor(v).to(**f32)
        w1 = t(dw1)[:, None] * t(pw1)
        w3 = t(dw3)[:, None] * t(pw3)
        vec = torch.cat([t(v).reshape(-1)
                         for v in (b1, a1, c1, b2, a2, c2, b3, a3, c3)])
        st = dict(dtype=dtype, device=device)
        return cls(w1.to(**st).contiguous(),
                   t(dw2).reshape(9, -1).contiguous(),
                   t(pw2).to(**st).contiguous(), w3.to(**st).contiguous(),
                   vec.contiguous())

    def stages(self):
        """(b1, a1, c1, b2, a2, c2) over Cm and (b3, a3, c3) over C."""
        cm, c = self.w1.shape[1], self.w1.shape[0]
        return (self.vec[:6 * cm].view(6, cm).unbind(0)
                + self.vec[6 * cm:].view(3, c).unbind(0))


def sepconv_params(conv):
    """(dw, pw, bias) of a port `SeparableConv` in the JAX package's
    `mobile_bneck_params` layout: a 1x1 depthwise kernel as its (C,) scales,
    a 3x3 one as (3, 3, C); the pointwise kernel as (C, Cout)."""
    dw = conv.depthwise.weight.detach().float()           # (C, 1, k, k)
    dw = dw[:, 0, 0, 0] if dw.shape[-1] == 1 else dw[:, 0].permute(1, 2, 0)
    pw = conv.pointwise.weight.detach().float()[:, :, 0, 0].t()
    return dw, pw, conv.pointwise.bias.detach().float()


# ---------------------------------------------------------------------------
# Plain PyTorch versions: the same arithmetic and rounding points.
# ---------------------------------------------------------------------------

def _mobile_t3(x, p: MobileParams):
    """Returns (x as float32, t3 as float32) of one mobile bottleneck."""
    dt = x.dtype
    H, W = x.shape[1:3]
    b1, a1, c1, b2, a2, c2, b3, a3, c3 = p.stages()
    xf = x.float()
    t1 = (torch.relu(xf @ p.w1.float() + b1) * a1 + c1).to(dt)
    t1p = F.pad(t1.float(), (0, 0, 1, 1, 1, 1))   # zero t1 outside the map
    acc = torch.zeros_like(t1p[:, :H, :W])
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        acc = acc + t1p[:, dy:dy + H, dx:dx + W] * p.d2[tap]
    t2 = (torch.relu(acc.to(dt).float() @ p.w2.float() + b2) * a2
          + c2).to(dt)
    t3 = torch.relu(t2.float() @ p.w3.float() + b3) * a3 + c3
    return xf, t3


def fused_bottleneck_mobile_plain(x, p: MobileParams):
    xf, t3 = _mobile_t3(x, p)
    return (xf + t3).to(x.dtype)


def fused_bottleneck_mobile_pool_plain(x, p: MobileParams):
    out = fused_bottleneck_mobile_plain(x, p)
    return out, maxpool2x2(out)


def bottleneck_mobile_upadd_plain(x, u_lo, p: MobileParams):
    """round(round(x + t3) + up2x(u_lo)): the first half of an up-level."""
    d = fused_bottleneck_mobile_plain(x, p)
    return (d.float() + upsample2x(u_lo).float()).to(x.dtype)


def fused_uplevel_mobile_plain(feat, u_lo, short: MobileParams,
                               merged: MobileParams):
    return fused_bottleneck_mobile_plain(
        bottleneck_mobile_upadd_plain(feat, u_lo, short), merged)


# ---------------------------------------------------------------------------
# Kernel launch.
# ---------------------------------------------------------------------------

def _check(x, p: MobileParams):
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"expected a contiguous NHWC tensor, got shape "
                         f"{tuple(x.shape)} contiguous={x.is_contiguous()}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"storage dtype must be float32 or bfloat16, got "
                        f"{x.dtype}")
    # The kernel spreads Cm/4 and C/4 channel groups over its 256 threads.
    C, Cm = p.w1.shape
    if x.shape[-1] != C or C % 16 or Cm != C // 2 or C > 1024:
        raise ValueError(f"channels must be a multiple of 16 (<= 1024) "
                         f"with Cm = C/2: x {tuple(x.shape)}, w1 "
                         f"{tuple(p.w1.shape)}")
    shapes = {"w1": (C, Cm), "w2": (Cm, Cm), "w3": (Cm, C), "d2": (9, Cm),
              "vec": (6 * Cm + 3 * C,)}
    for name, shape in shapes.items():
        t = getattr(p, name)
        dtype = x.dtype if name in ("w1", "w2", "w3") else torch.float32
        if t.shape != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {shape}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != dtype or t.device != x.device:
            raise TypeError(f"{name} is {t.dtype} on {t.device}; it must be "
                            f"{dtype} on x's device {x.device}")


def mobile_tc_plan(B, H, W, C, Cm, mode, blocks=2, tile=None, ck=None):
    """The plan of the bf16 mobile bottleneck on the tensor cores: the
    shared body of csrc/bottleneck_tc.cuh with its mobile phase 2 takes the
    standard body's tiles, chunks, ring stages and shared memory (the
    depthwise sums fit where the standard body keeps t2, and t2 where it
    keeps t1), so this is `bneck_tc_plan`'s plan for the same mode (MODE_POOL
    pools; `blocks`, `tile` and `ck` as there), with the mobile stage count:
    W1' in Cm/nt column groups of C/ck stages, pw2 in Cm/nt groups of
    Cm/ck, W3' in C/nt groups of Cm/ck.

    The bf16 contract, a ValueError outside it: C a multiple of 32 up to
    1024 and Cm = C/2, the k16 depth of the pw2 and W3' products (float32
    keeps `_check`'s C a multiple of 16)."""
    if C % 32 or Cm * 2 != C or not 0 < C <= 1024:
        raise ValueError(f"the bfloat16 mobile bottleneck takes C a multiple "
                         f"of 32 (<= 1024) with Cm = C/2, got C={C}, Cm={Cm}")
    plan = bk.bneck_tc_plan(B, H, W, C, Cm,
                            bk.MODE_POOL if mode == MODE_POOL
                            else bk.MODE_PLAIN, blocks, tile, ck)
    nt, k1, k2 = plan["nt"], C // plan["ck"], Cm // plan["ck"]
    plan["stages"] = (Cm // nt) * k1 + (Cm // nt) * k2 + (C // nt) * k2
    return plan


def _weights(p: MobileParams):
    return [t.data_ptr() for t in (p.w1, p.d2, p.w2, p.w3, p.vec)]


def launch_mobile(mode, x, p: MobileParams, out, pooled=None, u_lo=None,
                  plan=None):
    """Launch csrc/mobile.cu on x's current stream (no sync): the
    tensor-core body for bfloat16 (with `plan`, by default
    `mobile_tc_plan`'s), the FMA kernel for float32."""
    _require_cuda(x)
    B, H, W, C = x.shape
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the kernel grid's 65535 images")
    if mode != MODE_PLAIN and (H % 2 or W % 2):
        raise ValueError(f"the pool and up-add need even H and W, got "
                         f"{H}x{W}")
    if mode == MODE_UPADD and (u_lo is None
                               or u_lo.shape != (B, H // 2, W // 2, C)):
        raise ValueError(f"u_lo must be (B, H/2, W/2, C) for x "
                         f"{tuple(x.shape)}")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    Cm = p.w1.shape[1]
    ptrs = (x.data_ptr(), u_lo.data_ptr() if u_lo is not None else None,
            *_weights(p), out.data_ptr(),
            pooled.data_ptr() if pooled is not None else None)
    if x.dtype == torch.bfloat16:
        if p.d2.data_ptr() % 16:
            raise ValueError("d2 must start on a 16-byte boundary: the "
                             "kernel reads it 4 taps at a time")
        plan = plan or mobile_tc_plan(B, H, W, C, Cm, mode)
        err = build.lib().spe_mobile_tc(
            mode, *ptrs, B, H, W, C, Cm, plan["tsh"], plan["tsw"],
            plan["ck"], plan["nt"], plan["nst"], plan["smem"], stream)
    else:
        err = build.lib().spe_mobile(
            mode, 0, *ptrs, B, H, W, C, Cm,
            fma_tile_plan("mobile", C, Cm)["ts"], stream)
    build.check(err, "mobile bottleneck kernel")


def fused_bottleneck_mobile(x, p: MobileParams):
    """x (B, H, W, C) -> (B, H, W, C), dtype of x."""
    _check(x, p)
    if x.device.type == "cpu":
        return fused_bottleneck_mobile_plain(x, p)
    out = torch.empty_like(x)
    launch_mobile(MODE_PLAIN, x, p, out)
    fused_bottleneck_mobile.launches += 1
    return out


def fused_bottleneck_mobile_pool(x, p: MobileParams):
    """Like fused_bottleneck_mobile, and also the 2x2/s2 maxpool of the
    output. Returns (out, pooled)."""
    _check(x, p)
    if x.device.type == "cpu":
        return fused_bottleneck_mobile_pool_plain(x, p)
    B, H, W, C = x.shape
    out = torch.empty_like(x)
    pooled = torch.empty((B, H // 2, W // 2, C), dtype=x.dtype,
                         device=x.device)
    launch_mobile(MODE_POOL, x, p, out, pooled=pooled)
    fused_bottleneck_mobile_pool.launches += 1
    return out, pooled


def fused_uplevel_mobile(feat, u_lo, short: MobileParams,
                         merged: MobileParams):
    """feat (B, H, W, C), u_lo (B, H/2, W/2, C) -> (B, H, W, C): two
    launches per decoder level."""
    _check(feat, short)
    _check(u_lo, merged)
    if feat.device.type == "cpu":
        return fused_uplevel_mobile_plain(feat, u_lo, short, merged)
    s = torch.empty_like(feat)
    launch_mobile(MODE_UPADD, feat, short, s, u_lo=u_lo)
    fused_uplevel_mobile.launches += 1
    out = torch.empty_like(feat)
    launch_mobile(MODE_PLAIN, s, merged, out)
    fused_uplevel_mobile.launches += 1
    return out


fused_bottleneck_mobile.launches = 0
fused_bottleneck_mobile_pool.launches = 0
fused_uplevel_mobile.launches = 0
