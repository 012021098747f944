"""Train-mode forward with the hand-derived bottleneck backward.

The counterpart of the JAX package's `experimental/fused_train.py`: the
same per-stack heatmaps and running-statistics update as the port's
`StackedHourglass(x, train=True)`, but every identity-skip hourglass
bottleneck (15 per stack) goes through
`bottleneck_grad.make_bottleneck_train`, whose forward folds each BN into
the next unit and whose backward recomputes the BN/ReLU chain from the
saved activations. The front (its bottlenecks have conv skips), pooling,
upsampling and heads stay the plain model's ops under autograd, as the JAX
package leaves them to XLA.

The model's parameters stay `nn.Parameter`s: the bottleneck weights are
handed over as views ((C, Cm), (3, 3, Cm, Cm), (Cm, C) of the OIHW
weights), so autograd brings their grads back to the parameters.
Activations run NCHW in `channels_last` on the card as in the plain model,
so the NHWC view of a bottleneck's input is contiguous and the kernels
take it without a copy (their wrappers raise on a tensor that is not).

Under tensor parallelism (the model's `tensor_parallel`, see
parallel/sharding_rules.py) the bottlenecks take this rank's output
channels of each unit (`bottleneck_grad`); the rest runs through the
model's own tensor-parallel `_conv`.

Used by `training.steps.make_train_step(..., model_backend="fused")`.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from single_person_pose_estimation_tpu_torch.experimental.bottleneck_grad import (
    make_bottleneck_train,
)
from single_person_pose_estimation_tpu_torch.models.hourglass import (
    update_running,
)


def _select_fn(kernel_backend: str, on_cuda: bool, group=None, tp=None):
    """Spatial size -> the bottleneck function of that level."""
    if kernel_backend == "auto":
        kernel_backend = "cuda" if on_cuda else "plain"
    if kernel_backend.startswith("mixed:"):
        try:
            lo, hi = (int(v) for v in kernel_backend.split(":", 1)[1]
                      .split("-"))
        except ValueError:
            raise ValueError(f"kernel_backend 'mixed:LO-HI' takes two "
                             f"sizes, got {kernel_backend!r}") from None
        return lambda h: make_bottleneck_train(
            "cuda" if lo <= h <= hi else "plain", group, tp)
    fn = make_bottleneck_train(kernel_backend, group, tp)
    return lambda h: fn


def _bottleneck(model, x, name, select_fn):
    """One identity-skip bottleneck on an NCHW activation through the
    autograd function; updates its three BNs' running statistics. Under
    tensor parallelism every unit's weight must be split (C and C/2
    divisible by the model axis), and each vector leaf is read through the
    model group's `view`."""
    tp = model.tensor_parallel
    units = [name + s for s in ("_conv_1x1_1", "_conv_3x3_2", "_conv_1x1_3")]
    c1, c2, c3 = (getattr(model, u) for u in units)
    bns = [getattr(model, u + "_bn") for u in units]
    vec = model.get_parameter
    if tp is not None:
        if not all(tp.is_split(u + ".weight") for u in units):
            raise ValueError(
                f"{name}: the fused backend under tensor parallelism needs "
                f"every unit's output channels split over the {tp.size} "
                "ranks of the model axis")
        vec = lambda n: tp.view(model.get_parameter(n), n)
    xh = x.permute(0, 2, 3, 1)
    if not x.is_cuda:
        xh = xh.contiguous()
    out, stats = select_fn(x.shape[2])(
        xh,
        c1.weight[:, :, 0, 0].t(), vec(units[0] + ".bias"),
        c2.weight.permute(2, 3, 1, 0), vec(units[1] + ".bias"),
        c3.weight[:, :, 0, 0].t(), vec(units[2] + ".bias"),
        *[vec(f"{u}_bn.{leaf}") for u in units for leaf in ("weight", "bias")])
    for i, bn in enumerate(bns):
        update_running(bn, stats[2 * i], stats[2 * i + 1],
                       model.bn_momentum, tp)
    return out.permute(0, 3, 1, 2)


def fused_train_apply(model, images: torch.Tensor,
                      kernel_backend: str = "auto",
                      group=None) -> List[torch.Tensor]:
    """images (B, H, W, 3) -> per-stack (B, H/4, W/4, K) float32 heatmaps,
    as `model(images, train=True)`, updating the BN running statistics.

    kernel_backend selects the bottlenecks' implementation
    (`bottleneck_grad.make_bottleneck_train`): "plain", "cuda",
    "cuda_fwd" or "cuda_bwd" everywhere; "mixed:LO-HI" the CUDA kernels at
    the levels whose spatial size lies in [LO, HI] and plain elsewhere;
    "auto" the CUDA kernels on a CUDA tensor and plain on the CPU. "auto"
    differs from the JAX package, where it means plain ("jnp") everywhere
    after TPU measurements; here it takes the kernels, as
    `augment_backend="auto"` takes the warp kernel. It is not a measured
    choice on the H100 yet (PERF.md records both step times).

    With a process `group` (data parallel; the data group under tensor
    parallelism) every BN, in the bottlenecks and outside them, takes the
    statistics of every rank's rows together (see
    `bottleneck_grad.make_bottleneck_train`)."""
    if model.mobile:
        raise ValueError("the fused train forward supports the non-mobile "
                         "hourglass only")
    if images.dim() != 4 or images.shape[-1] != 3 or images.shape[1] % 64 \
            or images.shape[2] % 64:
        raise ValueError(f"input must be (B, H, W, 3) with H and W divisible "
                         f"by 64; got {tuple(images.shape)}")
    select_fn = _select_fn(kernel_backend, images.is_cuda, group,
                           model.tensor_parallel)
    bneck = lambda x, name: _bottleneck(model, x, name, select_fn)
    x = images.to(model.compute_dtype).permute(0, 3, 1, 2)
    if x.is_cuda:
        x = x.contiguous(memory_format=torch.channels_last)
    y = model.front(x, train=True, group=group)
    outputs = []
    for i in range(model.num_stacks):
        hg = f"hg{i}"
        feats, p = [], y
        for lvl in ("f1", "f2", "f4", "f8"):
            f = bneck(p, f"{hg}_downsample_{lvl}")
            feats.append((f, lvl))
            p = F.max_pool2d(f, 2)
        for lvl in ("f8_1", "f8_2", "f8_3"):
            p = bneck(p, f"{hg}_downsample_{lvl}")
        u = p
        for f, lvl in reversed(feats):
            d = bneck(f, f"{hg}_upsample_{lvl}_short")
            u = d + F.interpolate(u, scale_factor=2, mode="nearest")
            u = bneck(u, f"{hg}_upsample_{lvl}_merged")
        head = model._conv(u, hg + "_conv_1x1_1", bn=hg + "_conv_1x1_1_bn",
                           train=True, group=group)
        pred = model._conv(head, hg + "_conv_1x1_predict", "sigmoid")
        outputs.append(pred.float().permute(0, 2, 3, 1))
        if i != model.num_stacks - 1:
            h2 = model._conv(head, hg + "_conv_1x1_2", "linear")
            hm = model._conv(pred.to(model.compute_dtype), hg + "_conv_1x1_3",
                             "linear")
            y = h2 + hm + y
    return outputs
