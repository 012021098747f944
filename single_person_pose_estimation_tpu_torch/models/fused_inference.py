"""Fused inference forward: the stacked hourglass with its hourglass
bottlenecks, up-levels and heads run by the hand-written CUDA kernels.

The counterpart of the JAX package's `models/fused_inference.py`. It
consumes the same weights as `models.hourglass.StackedHourglass` (through
`prepare_fused`, which folds the BN affines and re-lays the weights once)
and returns the same per-stack heatmaps, for the standard model and for
the mobile (separable-conv) one. The front module, the maxpools outside
the kernels and the upsample-add outside the up-level kernels are plain
PyTorch (cuDNN may run the front convs, as XLA ran them in the JAX
package). Inference only.

For a CPU tensor every kernel wrapper runs its plain PyTorch version, so
the CPU tests reach this module's routing; for a CUDA tensor each wrapper
launches its kernel or raises.

The JAX package's two experimental dials run here too, off by default
as there: `fuse_front` sends `front_bottleneck_2` to the bottleneck
kernel and `front_bottleneck_3` to the conv-skip kernel
(`front_bottleneck_1`, at 128 px, stays plain); `fuse_bottom=d` runs the
innermost d levels of each hourglass as one subtree launch
(`ops/cuda/bottom_kernel.py`). Under `mobile` both are turned off, as the
JAX package turns them off. `front_s2d` computes the front's opening
7x7/s2 conv as the folded 4x4/s1 conv over the space-to-depth input
(`ops/space_to_depth.py`, plain PyTorch, as the JAX package runs it on
XLA).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from single_person_pose_estimation_tpu_torch.models.hourglass import (
    SeparableConv,
    same_pad,
)
from single_person_pose_estimation_tpu_torch.ops.cuda.bottleneck_kernel import (
    BottleneckParams,
    ConvSkipParams,
    bn_affine,
    fused_bottleneck,
    fused_bottleneck_convskip,
    fused_bottleneck_pool,
    maxpool2x2,
    upsample2x,
)
from single_person_pose_estimation_tpu_torch.ops.cuda.bottom_kernel import (
    LEVELS,
    SubtreeParams,
    fused_subtree,
)
from single_person_pose_estimation_tpu_torch.ops.cuda.head_kernel import (
    HeadParams,
    fused_head,
)
from single_person_pose_estimation_tpu_torch.ops.cuda.mobile_kernel import (
    MobileParams,
    fused_bottleneck_mobile,
    fused_bottleneck_mobile_pool,
    fused_uplevel_mobile,
    sepconv_params,
)
from single_person_pose_estimation_tpu_torch.ops.cuda.uplevel_kernel import (
    fused_uplevel,
)
from single_person_pose_estimation_tpu_torch.ops.space_to_depth import (
    front_conv_s2d_nchw,
)

_HG_BOTTLENECKS = (
    [f"downsample_{lvl}" for lvl in ("f1", "f2", "f4", "f8",
                                     "f8_1", "f8_2", "f8_3")]
    + [f"upsample_{lvl}_{kind}" for lvl in ("f8", "f4", "f2", "f1")
       for kind in ("short", "merged")])


@dataclass
class _Conv:
    """A conv in the compute dtype, OIHW, for the plain (cuDNN) layers;
    `depthwise` (C, 1, k, k) is set for a separable (mobile) conv, whose
    pointwise part is weight and bias."""
    weight: torch.Tensor
    bias: torch.Tensor
    depthwise: Optional[torch.Tensor] = None


@dataclass
class FusedParams:
    """Weights of one model laid out for `fused_apply`, built once.

    `convs` / `affines` hold every layer in the compute dtype for the plain
    layers (front, and levels above `fuse_max_h`); `bnecks` and `heads`
    hold the kernels' layouts (`MobileParams` for a mobile model; for a
    standard one also `front_bottleneck_2` and, as `ConvSkipParams`,
    `front_bottleneck_3`). `subtree(stack, depth)` packs a stack's subtree
    weights on first use and caches them in `subtrees`.
    """

    num_stacks: int
    num_channels: int
    compute_dtype: torch.dtype
    mobile: bool = False
    convs: Dict[str, _Conv] = field(default_factory=dict)
    affines: Dict[str, tuple] = field(default_factory=dict)
    bnecks: Dict[str, Union[BottleneckParams, MobileParams]] = field(
        default_factory=dict)
    heads: List[HeadParams] = field(default_factory=list)
    subtrees: Dict[Tuple[int, int], SubtreeParams] = field(
        default_factory=dict)

    def subtree(self, stack: int, depth: int) -> SubtreeParams:
        key = (stack, depth)
        if key not in self.subtrees:
            self.subtrees[key] = SubtreeParams.pack(self.bnecks,
                                                    f"hg{stack}", depth)
        return self.subtrees[key]


@torch.no_grad()
def prepare_fused(model, dtype: Optional[torch.dtype] = None) -> FusedParams:
    """Fold BN and re-lay the weights of a StackedHourglass for fused_apply,
    on the device of the model's weights. dtype defaults to the model's
    compute dtype."""
    dt = dtype or model.compute_dtype
    dev = next(model.parameters()).device
    out = FusedParams(model.num_stacks, model.num_channels, dt,
                      bool(model.mobile))
    f32 = dict(dtype=torch.float32, device=dev)
    st = dict(dtype=dt, device=dev)
    for name, mod in model.named_children():
        if isinstance(mod, torch.nn.Conv2d):
            out.convs[name] = _Conv(mod.weight.detach().to(**st),
                                    mod.bias.detach().to(**st))
        elif isinstance(mod, SeparableConv):
            out.convs[name] = _Conv(mod.pointwise.weight.detach().to(**st),
                                    mod.pointwise.bias.detach().to(**st),
                                    mod.depthwise.weight.detach().to(**st))
        else:
            a, c = bn_affine(mod.weight.to(**f32), mod.bias.to(**f32),
                             mod.running_mean.to(**f32),
                             mod.running_var.to(**f32), mod.eps)
            out.affines[name] = (a, c)

    def w(name):  # (in, out) of a 1x1, (3, 3, in, out) of a 3x3, float32
        k = getattr(model, name).weight.to(**f32)
        return k[:, :, 0, 0].t() if k.shape[-1] == 1 else k.permute(2, 3, 1, 0)

    def b(name):
        return getattr(model, name).bias.to(**f32)

    def affines(n):
        return (*out.affines[n + "_conv_1x1_1_bn"],
                *out.affines[n + "_conv_3x3_2_bn"],
                *out.affines[n + "_conv_1x1_3_bn"])

    def bneck(n, cls=BottleneckParams, *skip):
        return cls.pack(*skip, w(n + "_conv_1x1_1"), b(n + "_conv_1x1_1"),
                        w(n + "_conv_3x3_2"), b(n + "_conv_3x3_2"),
                        w(n + "_conv_1x1_3"), b(n + "_conv_1x1_3"),
                        *affines(n), dtype=dt, device=dev)

    if not out.mobile:      # the fuse_front kernels' weights
        out.bnecks["front_bottleneck_2"] = bneck("front_bottleneck_2")
        n = "front_bottleneck_3"
        out.bnecks[n] = bneck(n, ConvSkipParams, w(n + "_skip"),
                              b(n + "_skip"))

    for i in range(model.num_stacks):
        for suffix in _HG_BOTTLENECKS:
            n = f"hg{i}_{suffix}"
            if out.mobile:
                sep = lambda layer: sepconv_params(getattr(model, n + layer))
                out.bnecks[n] = MobileParams.pack(
                    *sep("_conv_1x1_1"), *sep("_conv_3x3_2"),
                    *sep("_conv_1x1_3"), *affines(n), dtype=dt, device=dev)
            else:
                out.bnecks[n] = bneck(n)
        hg = f"hg{i}"
        glue = {}
        if i < model.num_stacks - 1:
            glue = dict(w2=w(hg + "_conv_1x1_2"), b2=b(hg + "_conv_1x1_2"),
                        w3=w(hg + "_conv_1x1_3"), b3=b(hg + "_conv_1x1_3"))
        out.heads.append(HeadParams.pack(
            w(hg + "_conv_1x1_1"), b(hg + "_conv_1x1_1"),
            *out.affines[hg + "_conv_1x1_1_bn"],
            w(hg + "_conv_1x1_predict"), b(hg + "_conv_1x1_predict"),
            **glue, dtype=dt, device=dev))
    return out


# ---------------------------------------------------------------------------
# Plain layers (NHWC in, NHWC out, compute dtype), as the JAX package's XLA
# path computes them: conv + bias, relu, then a*x + c, all in the dtype.
# ---------------------------------------------------------------------------

def _conv(fp: FusedParams, x, name, stride=1):
    cv = fp.convs[name]
    k = cv.weight.shape[-1]
    xc = x.permute(0, 3, 1, 2)
    if cv.depthwise is not None:    # separable: depthwise, then pointwise
        kd = cv.depthwise.shape[-1]
        xc = F.conv2d(xc, cv.depthwise, padding=kd // 2, groups=xc.shape[1])
    if stride == 2:
        ph, pw = (same_pad(n, k, 2) for n in xc.shape[2:])
        y = F.conv2d(F.pad(xc, (*pw, *ph)), cv.weight, cv.bias, stride=2)
    else:
        y = F.conv2d(xc, cv.weight, cv.bias, padding=k // 2)
    return y.permute(0, 2, 3, 1)


def _bn(fp: FusedParams, x, name):
    a, c = fp.affines[name]
    return x * a.to(x.dtype) + c.to(x.dtype)


def _bottleneck_plain(fp: FusedParams, x, name, channels):
    if x.shape[-1] == channels:
        skip = x
    else:
        skip = torch.relu(_conv(fp, x, name + "_skip"))
    y = _bn(fp, torch.relu(_conv(fp, x, name + "_conv_1x1_1")),
            name + "_conv_1x1_1_bn")
    y = _bn(fp, torch.relu(_conv(fp, y, name + "_conv_3x3_2")),
            name + "_conv_3x3_2_bn")
    y = _bn(fp, torch.relu(_conv(fp, y, name + "_conv_1x1_3")),
            name + "_conv_1x1_3_bn")
    return skip + y


def _front(fp: FusedParams, x, fuse_front=False, front_s2d=False):
    c = fp.num_channels
    if front_s2d:
        cv = fp.convs["front_conv_1x1_1"]
        y = torch.relu(front_conv_s2d_nchw(
            x.permute(0, 3, 1, 2), cv.weight, cv.bias).permute(0, 2, 3, 1))
    else:
        y = torch.relu(_conv(fp, x, "front_conv_1x1_1", stride=2))
    y = _bn(fp, y, "front_conv_1x1_1_bn")
    y = _bottleneck_plain(fp, y, "front_bottleneck_1", c // 2)
    y = maxpool2x2(y)
    if fuse_front:
        y = fused_bottleneck(y.contiguous(), fp.bnecks["front_bottleneck_2"])
        return fused_bottleneck_convskip(y, fp.bnecks["front_bottleneck_3"])
    y = _bottleneck_plain(fp, y, "front_bottleneck_2", c // 2)
    return _bottleneck_plain(fp, y, "front_bottleneck_3", c)


def _head_plain(fp: FusedParams, u, y, name, last):
    head = _bn(fp, torch.relu(_conv(fp, u, name + "_conv_1x1_1")),
               name + "_conv_1x1_1_bn")
    pred = torch.sigmoid(_conv(fp, head, name + "_conv_1x1_predict").float())
    if last:
        return pred, None
    h2 = _conv(fp, head, name + "_conv_1x1_2")
    hm = _conv(fp, pred.to(fp.compute_dtype), name + "_conv_1x1_3")
    return pred, h2 + hm + y


# ---------------------------------------------------------------------------

@torch.no_grad()
def fused_apply(fp: FusedParams, images: torch.Tensor, *,
                fuse_levels: bool = False, pool_fuse_max_h: int = 0,
                fuse_heads: bool = False, fuse_bottom: int = 0,
                fuse_front: bool = False, front_s2d: bool = False,
                fuse_max_h: int = 64) -> List[torch.Tensor]:
    """Counterpart of `model(images)` with the kernels on the hourglasses.

    images (B, H, W, 3) on the device of fp's weights. Returns per-stack
    (B, H/4, W/4, K) float32 heatmaps. Flags route as in the JAX package's
    `fused_apply`:
    fuse_levels runs each decoder level through `fused_uplevel`;
    pool_fuse_max_h fuses the downsample maxpool into the bottleneck for
    levels with H <= it; fuse_heads runs `fused_head`; levels with H above
    fuse_max_h use the plain layers. That is the JAX package's size rule,
    not a fallback on error; each such bottleneck adds one to
    `plain_routes["level"]`. The main path (256 px input, fuse_max_h=64)
    never takes it.
    fuse_front runs front_bottleneck_2 through `fused_bottleneck` and
    front_bottleneck_3 through `fused_bottleneck_convskip`; fuse_bottom=d
    (0-4 at the four-level hourglass) runs the outer 4 - d levels as above
    and the innermost d, with the bottom block, as one `fused_subtree`
    launch per stack. front_s2d computes the front's opening conv as the
    folded conv over the space-to-depth input (an even-sized input).
    For fp prepared from a mobile model (`fp.mobile`, the JAX function's
    `mobile=True`) the bottlenecks, pools and up-levels run the mobile
    kernels (`ops/cuda/mobile_kernel.py`), the heads the same `fused_head`,
    and fuse_bottom and fuse_front are turned off.
    """
    if fp.mobile:
        fuse_bottom, fuse_front = 0, False
    depth = int(fuse_bottom)
    if not 0 <= depth <= len(LEVELS):
        raise ValueError(f"fuse_bottom must be 0..{len(LEVELS)}, got "
                         f"{fuse_bottom}")
    if images.dim() != 4 or images.shape[1] % 64 or images.shape[2] % 64:
        raise ValueError(f"input must be (B, H, W, 3) with H and W "
                         f"divisible by 64; got {tuple(images.shape)}")
    c = fp.num_channels
    x = images.to(fp.compute_dtype)
    y = _front(fp, x, fuse_front, front_s2d).contiguous()

    if fp.mobile:
        k_bneck, k_pool, k_uplevel = (fused_bottleneck_mobile,
                                      fused_bottleneck_mobile_pool,
                                      fused_uplevel_mobile)
    else:
        k_bneck, k_pool, k_uplevel = (fused_bottleneck, fused_bottleneck_pool,
                                      fused_uplevel)

    def bneck(x, name):
        if x.shape[1] > fuse_max_h:
            plain_routes["level"] += 1
            return _bottleneck_plain(fp, x, name, c)
        return k_bneck(x, fp.bnecks[name])

    def down(x, name):
        if x.shape[1] > fuse_max_h:
            plain_routes["level"] += 1
            out = _bottleneck_plain(fp, x, name, c)
            return out, maxpool2x2(out)
        if x.shape[1] <= pool_fuse_max_h:
            return k_pool(x, fp.bnecks[name])
        out = bneck(x, name)
        return out, maxpool2x2(out)

    outputs = []
    for i in range(fp.num_stacks):
        name = f"hg{i}"
        skips = []
        pd = y
        for lvl in LEVELS[::-1][:4 - depth]:
            f, pd = down(pd, f"{name}_downsample_{lvl}")
            skips.append((f, lvl))
        u = pd.contiguous()
        if depth:
            u = fused_subtree(u, fp.subtree(i, depth), depth)
        else:
            for lvl in ("f8_1", "f8_2", "f8_3"):
                u = bneck(u, f"{name}_downsample_{lvl}")
        for feat, lvl in reversed(skips):
            short = f"{name}_upsample_{lvl}_short"
            merged = f"{name}_upsample_{lvl}_merged"
            if fuse_levels and feat.shape[1] <= fuse_max_h:
                u = k_uplevel(feat, u, fp.bnecks[short], fp.bnecks[merged])
            else:
                d = bneck(feat, short)
                u = bneck((d + upsample2x(u)).contiguous(), merged)
        last = i == fp.num_stacks - 1
        if fuse_heads:
            pred, y_next = fused_head(u, None if last else y, fp.heads[i])
        else:
            pred, y_next = _head_plain(fp, u, y, name, last)
        outputs.append(pred)
        if not last:
            y = y_next.contiguous()
    return outputs


# ---------------------------------------------------------------------------
# Backend-selection policy (one source for serving, and for evaluation once
# it is ported).
# ---------------------------------------------------------------------------

# Above this input size the auto backend uses the plain model. The value is
# the JAX package's, carried over; the H100 has not measured it yet.
FUSED_AUTO_MAX_INPUT = 256

# Work that a size rule sent to the plain layers although the kernels were
# asked for: "forward" counts auto-mode forwards above FUSED_AUTO_MAX_INPUT,
# "level" counts bottlenecks above fused_apply's fuse_max_h. A run reads it
# to show whether any request left the kernels.
plain_routes = {"forward": 0, "level": 0}


def auto_use_fused(model, device) -> bool:
    """The "auto" policy: the kernels on a CUDA device with a 2-byte
    compute dtype; the plain model everywhere else."""
    return (torch.device(device).type == "cuda"
            and torch.empty((), dtype=model.compute_dtype).element_size() == 2)


def forward_last_stack(model, images, *, use_fused: bool, auto: bool,
                       prepared: Optional[FusedParams] = None):
    """Last stack's heatmaps via the fused path, or the plain model when
    disabled or when auto mode meets an input above FUSED_AUTO_MAX_INPUT
    (an explicit use_fused=True is honoured at every size). The latter is
    the JAX package's size policy, not a fallback on error; it adds one to
    `plain_routes["forward"]`. `prepared` caches `prepare_fused(model)`; it
    is built when not given."""
    if use_fused and auto and images.shape[1] > FUSED_AUTO_MAX_INPUT:
        plain_routes["forward"] += 1
    elif use_fused:
        fp = prepared if prepared is not None else prepare_fused(model)
        return fused_apply(fp, images, fuse_levels=True, pool_fuse_max_h=32,
                           fuse_heads=True)[-1]
    return model(images)[-1]
