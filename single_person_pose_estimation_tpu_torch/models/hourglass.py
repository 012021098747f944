"""Stacked Hourglass Network (Newell et al., arXiv:1603.06937) in PyTorch.

The plain counterpart of the JAX package's `models/hourglass.py`
`StackedHourglass.apply(..., train=...)`, standard and mobile variants.
Child modules carry the flax names (`front_conv_1x1_1`,
`hg0_downsample_f1_conv_1x1_1_bn`, a mobile layer's `depthwise` and
`pointwise`, ...), so `utils/weight_convert.py` maps variables one to
one. The public layout is NHWC in and NHWC out with float32 heatmaps, as
in the JAX package; inside, the convs run NCHW.

Reference details kept:
  * each conv is followed by ReLU and then BatchNorm (eps 1e-3), the
    reference's conv -> relu -> BN order;
  * the 7x7/s2 front conv pads like TF "SAME": 2 before and 3 after on even
    inputs (torch's padding=3 would shift the output by a pixel);
  * the last stack's next-stage convs are pruned, so S4/256 counts
    13,784,260 parameters (BN running statistics included, as Keras counts);
  * `predict_activation` ("sigmoid", the default, "linear" or "relu")
    is applied to each stack's prediction as the reference's `_activate`
    applies it: the sigmoid in float32, the other two in the compute
    dtype; the inter-stack feedback reads the activated prediction;
  * upsampling is nearest 2x;
  * H and W must be divisible by 64;
  * `mobile=True` swaps every bottleneck conv, the front bottlenecks'
    `_skip` convs included, for a `SeparableConv` (a depthwise conv with
    no bias, then a 1x1 pointwise conv with a bias); the 7x7 front conv
    and the heads stay plain convs. Mobile S4/256 counts 5,818,564
    parameters. `mobile_depthwise` picks the depthwise lowering, with the
    same parameter in every mode, as the JAX package's dial: "conv" (a
    grouped conv, the default), "dense" (a dense conv with a
    block-diagonal kernel) or "taps" (k*k shifted per-channel
    multiply-adds in float32);
  * `front_s2d=True` computes the 7x7/s2 front conv as the folded 4x4/s1
    conv over the 2x2 space-to-depth input (`ops/space_to_depth.py`),
    from the same stored (7, 7, 3, 64) parameter;
  * `remat` recomputes activations in the backward, as JAX's `nn.remat`:
    True checkpoints each hourglass module (`torch.utils.checkpoint`,
    non-reentrant); "conv_out" checkpoints the front too and saves only
    the convolution outputs (selective checkpointing), recomputing the
    ReLUs, BNs, adds, pools and upsamples. The recompute does not update
    the running statistics a second time, so they equal a step's without
    remat;
  * train-mode BatchNorm is flax's `nn.BatchNorm`, computed here by hand:
    batch mean and variance in float32 with the variance as E[x^2]-E[x]^2
    (biased, clipped at 0), normalise with that variance, and update the
    running statistics as r = m*r + (1-m)*batch with the BIASED variance
    and m = `bn_momentum` (0.99; flax's convention, not torch's).
    `F.batch_norm(training=True)` would store the unbiased variance and
    read momentum the other way round. Under data parallel
    (`forward(..., group=)`) the statistics are over the global batch;
    `nn.SyncBatchNorm` is not used: it refuses CPU tensors and computes
    its own variance, not flax's;
  * under tensor parallelism (`parallel/sharding_rules.shard_state` sets
    `tensor_parallel`) each conv whose weight is split computes this
    rank's output channels, its bias, ReLU and BN act on that slice, and
    the channels are gathered before the next layer (`_conv`).

Parameters are stored in float32; `compute_dtype` casts the activations
and weights of every conv, as flax's `dtype=` does.
"""

from __future__ import annotations

from functools import partial
from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from single_person_pose_estimation_tpu_torch.ops.space_to_depth import (
    front_conv_s2d_nchw,
)
from single_person_pose_estimation_tpu_torch.parallel.distributed import (
    all_reduce_sum,
)

_BN_EPS = 1e-3
_ACTIVATIONS = ("sigmoid", "linear", "relu")
DEPTHWISE_IMPLS = ("conv", "dense", "taps")
REMAT_MODES = (False, True, "conv_out")


def same_pad(n: int, k: int, s: int):
    """TF/flax "SAME" padding (before, after) of one spatial axis."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def update_running(bn: nn.BatchNorm2d, mean: torch.Tensor,
                   var: torch.Tensor, momentum: float, tp=None) -> None:
    """A train-mode BN's running statistics: r = m*r + (1-m)*batch, with
    flax's momentum convention. Under tensor parallelism (`tp`) a rank's
    statistics cover its channels; running statistics that the rule
    replicates take them gathered over the model group."""
    with torch.no_grad():
        if tp is not None and mean.numel() != bn.running_mean.numel():
            mean, var = tp.gather_(mean.detach()), tp.gather_(var.detach())
        bn.running_mean.copy_(momentum * bn.running_mean
                              + (1.0 - momentum) * mean)
        bn.running_var.copy_(momentum * bn.running_var
                             + (1.0 - momentum) * var)


def global_moments(xf: torch.Tensor, dims, group):
    """flax's batch mean and variance E[x^2]-E[x]^2 (clamped at 0) of a
    float32 tensor over `dims` and over every rank of `group`: one
    differentiable all_reduce of [sum x, sum x^2, count], so the ranks may
    hold different numbers of rows."""
    s1, s2 = xf.sum(dims), (xf * xf).sum(dims)
    c = s1.numel()
    tot = all_reduce_sum(torch.cat([s1, s2, xf.new_full((1,), xf.numel()
                                                        // c)]), group)
    n = tot[-1]
    mean = tot[:c] / n
    return mean, torch.clamp(tot[c:2 * c] / n - mean * mean, min=0.0)


def depthwise_conv(x: torch.Tensor, w: torch.Tensor, impl: str = "conv"
                   ) -> torch.Tensor:
    """A k x k depthwise conv (SAME, no bias) of an NCHW tensor by the
    (C, 1, k, k) weight `w` in x's dtype, lowered as `impl` says (the JAX
    package's `mobile_depthwise`): "conv" a grouped conv; "dense" a dense
    conv whose (C, C, k, k) kernel holds w on its diagonal; "taps" the k*k
    shifted per-channel multiply-adds summed in float32, in the JAX
    package's order (row, then column)."""
    c, k = x.shape[1], w.shape[-1]
    pad = k // 2
    if impl == "conv":
        return F.conv2d(x, w, padding=pad, groups=c)
    if impl == "dense":
        eye = torch.eye(c, dtype=w.dtype, device=w.device)
        return F.conv2d(x, w * eye[:, :, None, None], padding=pad)
    if impl != "taps":
        raise ValueError(f"depthwise_impl must be 'conv', 'dense', or "
                         f"'taps', got {impl!r}")
    taps = w.float()[:, 0]
    if k == 1:
        return (x.float() * taps[None, :, 0, 0, None, None]).to(x.dtype)
    h, wd = x.shape[2:]
    xp = F.pad(x, (pad, pad, pad, pad))
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for dy in range(k):
        for dx in range(k):
            acc = acc + (xp[:, :, dy:dy + h, dx:dx + wd].float()
                         * taps[None, :, dy, dx, None, None])
    return acc.to(x.dtype)


def _save_conv_out(ctx, op, *args, **kwargs):
    """The "conv_out" remat policy: save the outputs of the dense
    convolutions (the JAX package's `checkpoint_name(..., "conv_out")`
    tags each conv's output, and a separable conv's pointwise output),
    recompute everything else."""
    if op is torch.ops.aten.convolution.default and args[-1] == 1:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def bottleneck_specs(name: str, cin: int, cout: int, mobile: bool = False):
    """(child name, kind, in, out, kernel) of one reference bottleneck;
    kind is "conv", "sep" (a SeparableConv, mobile) or "bn"."""
    kind = "sep" if mobile else "conv"
    specs = []
    if cin != cout:
        specs.append((name + "_skip", kind, cin, cout, 1))
    half = cout // 2
    for suffix, ci, co, k in (("_conv_1x1_1", cin, half, 1),
                              ("_conv_3x3_2", half, half, 3),
                              ("_conv_1x1_3", half, cout, 1)):
        specs.append((name + suffix, kind, ci, co, k))
        specs.append((name + suffix + "_bn", "bn", co, co, 0))
    return specs


def hourglass_specs(num_stacks: int, c: int, num_classes: int,
                    mobile: bool = False):
    """Every child layer of the model, in flax creation order."""
    specs = [("front_conv_1x1_1", "conv", 3, 64, 7),
             ("front_conv_1x1_1_bn", "bn", 64, 64, 0)]
    bneck = lambda name, ci, co: bottleneck_specs(name, ci, co, mobile)
    specs += bneck("front_bottleneck_1", 64, c // 2)
    specs += bneck("front_bottleneck_2", c // 2, c // 2)
    specs += bneck("front_bottleneck_3", c // 2, c)
    for i in range(num_stacks):
        hg = f"hg{i}"
        for lvl in ("f1", "f2", "f4", "f8", "f8_1", "f8_2", "f8_3"):
            specs += bneck(f"{hg}_downsample_{lvl}", c, c)
        for lvl in ("f8", "f4", "f2", "f1"):
            specs += bneck(f"{hg}_upsample_{lvl}_short", c, c)
            specs += bneck(f"{hg}_upsample_{lvl}_merged", c, c)
        specs += [(hg + "_conv_1x1_1", "conv", c, c, 1),
                  (hg + "_conv_1x1_1_bn", "bn", c, c, 0),
                  (hg + "_conv_1x1_predict", "conv", c, num_classes, 1)]
        if i < num_stacks - 1:
            specs += [(hg + "_conv_1x1_2", "conv", c, c, 1),
                      (hg + "_conv_1x1_3", "conv", num_classes, c, 1)]
    return specs


class SeparableConv(nn.Module):
    """flax `SeparableConv` (Keras SeparableConv2D): a k x k depthwise conv
    (`groups=C`, no bias) then a 1x1 pointwise conv with a bias."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.depthwise = nn.Conv2d(cin, cin, k, padding=k // 2, groups=cin,
                                   bias=False)
        self.pointwise = nn.Conv2d(cin, cout, 1)


class StackedHourglass(nn.Module):
    """Forward returns [per-stack (B, H/4, W/4, K) float32 heatmaps]."""

    def __init__(self, num_classes: int = 17, num_stacks: int = 2,
                 num_channels: int = 256,
                 compute_dtype: torch.dtype = torch.float32,
                 mobile: bool = False, front_s2d: bool = False,
                 remat=False, bn_momentum: float = 0.99,
                 predict_activation: str = "sigmoid",
                 mobile_depthwise: str = "conv"):
        super().__init__()
        if predict_activation not in _ACTIVATIONS:
            raise ValueError(f"unknown activation {predict_activation}; "
                             f"expected one of {_ACTIVATIONS}")
        if remat not in REMAT_MODES:
            raise ValueError(f"remat must be one of {REMAT_MODES}: "
                             f"{remat!r}")
        if mobile_depthwise not in DEPTHWISE_IMPLS:
            raise ValueError(f"depthwise_impl must be 'conv', 'dense', or "
                             f"'taps', got {mobile_depthwise!r}")
        self.predict_activation = predict_activation
        self.num_classes = num_classes
        self.num_stacks = num_stacks
        self.num_channels = num_channels
        self.mobile = mobile
        self.compute_dtype = compute_dtype
        self.bn_momentum = bn_momentum
        self.front_s2d = bool(front_s2d)
        self.remat = remat
        self.mobile_depthwise = mobile_depthwise
        # False while a remat recompute (or a pipelined loss that carries
        # no statistics) runs the train-mode BNs: they leave the running
        # statistics as they are.
        self.update_stats = True
        # parallel/sharding_rules.TensorParallel once the state is sharded.
        self.tensor_parallel = None
        for name, kind, cin, cout, k in self._layer_specs():
            if kind == "conv":
                self.add_module(name, nn.Conv2d(cin, cout, k,
                                                stride=2 if k == 7 else 1))
            elif kind == "sep":
                self.add_module(name, SeparableConv(cin, cout, k))
            else:
                self.add_module(name, nn.BatchNorm2d(cout, eps=_BN_EPS))
        self.eval()

    def _layer_specs(self):
        """The child layers this module holds (hourglass_specs' tuples)."""
        return hourglass_specs(self.num_stacks, self.num_channels,
                               self.num_classes, self.mobile)

    def count_params(self) -> int:
        """Keras-style count: parameters plus BN running statistics."""
        n = sum(p.numel() for p in self.parameters())
        return n + sum(b.numel() for name, b in self.named_buffers()
                       if name.endswith(("running_mean", "running_var")))

    # ------------------------------------------------------------------
    def _conv(self, x, name, activation="relu", bn=None, train=False,
              group=None):
        """conv `name` (a separable conv: depthwise, then pointwise) ->
        activation -> the BN named `bn`, if any, on an NCHW tensor.

        Under tensor parallelism a conv whose weight is split runs on this
        rank's output channels (the depthwise conv, channel-local, on its
        input channels) and the result is gathered over the model group;
        one that is not split runs replicated."""
        conv = getattr(self, name)
        dt = self.compute_dtype
        tp = self.tensor_parallel
        if isinstance(conv, SeparableConv):     # depthwise, then pointwise
            dw = conv.depthwise.weight.to(dt)
            if tp is not None and tp.is_split(name + ".depthwise.weight"):
                xl = tp.local(tp.enter(x), 1)
                x = tp.gather(depthwise_conv(xl, dw, self.mobile_depthwise))
            else:
                x = depthwise_conv(x, dw, self.mobile_depthwise)
            name, conv = name + ".pointwise", conv.pointwise
        if tp is not None and not tp.is_split(name + ".weight"):
            tp = None       # every rank computes this conv whole
        w = conv.weight.to(dt)
        bias = conv.bias if tp is None else tp.view(conv.bias, name + ".bias")
        if tp is not None:
            x = tp.enter(x)
        k = w.shape[-1]
        if k == 7 and self.front_s2d:
            y = front_conv_s2d_nchw(x, w, bias)
        elif k == 7:
            ph, pw = (same_pad(n, 7, 2) for n in x.shape[2:])
            x = F.pad(x, (*pw, *ph))
            y = F.conv2d(x, w, bias.to(dt), stride=2)
        else:
            y = F.conv2d(x, w, bias.to(dt), padding=k // 2)
        if activation == "relu":
            y = torch.relu(y)
        elif activation == "sigmoid":
            y = torch.sigmoid(y.float())
        if bn is not None:
            y = self._bn(y, bn, train, group, tp)
        return y if tp is None else tp.gather(y)

    def _bn(self, x, name, train=False, group=None, tp=None):
        """BN `name` on an NCHW tensor; with `tp`, x holds this rank's
        channels and the BN reads their slice of its leaves."""
        bn = getattr(self, name)
        leaf = (lambda a: getattr(bn, a)) if tp is None else (
            lambda a: tp.view(getattr(bn, a), f"{name}.{a}"))
        if not train:
            return F.batch_norm(x.float(), leaf("running_mean"),
                                leaf("running_var"), leaf("weight"),
                                leaf("bias"), False, 0.0,
                                bn.eps).to(self.compute_dtype)
        xf = x.float()
        if group is None:
            mean = xf.mean(dim=(0, 2, 3))
            var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean,
                              min=0.0)
        else:
            mean, var = global_moments(xf, (0, 2, 3), group)
        if self.update_stats:
            update_running(bn, mean, var, self.bn_momentum, tp)
        col = lambda v: v[None, :, None, None]
        mul = torch.rsqrt(var + bn.eps) * leaf("weight")
        y = (xf - col(mean)) * col(mul) + col(leaf("bias"))
        return y.to(self.compute_dtype)

    def _bottleneck(self, x, name, cout, train=False, group=None):
        skip = x if x.shape[1] == cout else self._conv(x, name + "_skip")
        for suffix in ("_conv_1x1_1", "_conv_3x3_2", "_conv_1x1_3"):
            x = self._conv(x, name + suffix, bn=name + suffix + "_bn",
                           train=train, group=group)
        return skip + x

    def _hourglass(self, x, i, is_last, train=False, group=None):
        c, hg = self.num_channels, f"hg{i}"
        bneck = lambda v, name: self._bottleneck(v, name, c, train, group)
        feats = []
        p = x
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
        head = self._conv(u, hg + "_conv_1x1_1", bn=hg + "_conv_1x1_1_bn",
                          train=train, group=group)
        pred = self._conv(head, hg + "_conv_1x1_predict",
                          self.predict_activation)
        if is_last:
            return x, pred
        h2 = self._conv(head, hg + "_conv_1x1_2", "linear")
        hm = self._conv(pred.to(self.compute_dtype), hg + "_conv_1x1_3",
                        "linear")
        return h2 + hm + x, pred

    def front(self, x, train=False, group=None):
        """Front module on an NCHW compute-dtype tensor (H/4 x W/4 out)."""
        c = self.num_channels
        y = self._conv(x, "front_conv_1x1_1", bn="front_conv_1x1_1_bn",
                       train=train, group=group)
        y = self._bottleneck(y, "front_bottleneck_1", c // 2, train, group)
        y = F.max_pool2d(y, 2)
        y = self._bottleneck(y, "front_bottleneck_2", c // 2, train, group)
        return self._bottleneck(y, "front_bottleneck_3", c, train, group)

    def forward(self, x: torch.Tensor, train: bool = False,
                group=None) -> List[torch.Tensor]:
        """x (B, H, W, 3) -> per-stack heatmaps. `train=True` normalises
        with batch statistics and updates the running ones in place, as
        flax's `apply(..., train=True, mutable=["batch_stats"])`. With a
        process `group` (data parallel) the batch statistics are those of
        every rank's rows together: each train-mode BN all-reduces its
        sums, forward and backward (`global_moments`)."""
        x = self.input_nchw(x)
        remat = self.remat and torch.is_grad_enabled()
        if remat == "conv_out":
            y = self.rematerialize(lambda t: self.front(t, train, group), x)
        else:
            y = self.front(x, train, group)
        outputs = []
        for i in range(self.num_stacks):
            last = i == self.num_stacks - 1
            if remat:
                y, pred = self.rematerialize(
                    partial(self._hourglass, i=i, is_last=last, train=train,
                            group=group), y)
            else:
                y, pred = self._hourglass(y, i, last, train, group)
            outputs.append(pred.float().permute(0, 2, 3, 1))
        return outputs

    def input_nchw(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) images -> the compute-dtype NCHW tensor the front
        takes (channels_last on the card); H and W must divide by 64."""
        if x.dim() != 4 or x.shape[-1] != 3 or x.shape[1] % 64 \
                or x.shape[2] % 64:
            raise ValueError(
                f"input must be (B, H, W, 3) with H and W divisible by 64; "
                f"got {tuple(x.shape)}")
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        return x

    def rematerialize(self, fn, x):
        """fn(x) under `torch.utils.checkpoint` (non-reentrant); with remat
        "conv_out" only the convolution outputs are saved. The backward's
        recompute runs with `update_stats` off, so the train-mode BNs
        update the running statistics once, as under JAX's `nn.remat`."""
        calls = []

        def run(t):
            saved = self.update_stats
            self.update_stats = saved and not calls
            calls.append(1)
            try:
                return fn(t)
            finally:
                self.update_stats = saved

        extra = {}
        if self.remat == "conv_out":
            extra["context_fn"] = partial(
                create_selective_checkpoint_contexts, _save_conv_out)
        return checkpoint(run, x, use_reentrant=False, **extra)


def create_hourglass_model(num_classes: int, num_stacks: int,
                           num_channels: int,
                           input_shape: Sequence[int] = (256, 256, 3),
                           predict_activation: str = "sigmoid",
                           mobile: bool = False,
                           compute_dtype: torch.dtype = torch.float32,
                           remat=False) -> StackedHourglass:
    """The reference's factory (JAX `models/hourglass.py`
    `create_hourglass_model`), with its signature. Returns the model with
    freshly initialised torch weights; load flax-layout variables with
    `utils.weight_convert.load_variables`. `input_shape` is implied by the
    input tensor."""
    del input_shape
    return StackedHourglass(num_classes=num_classes, num_stacks=num_stacks,
                            num_channels=num_channels,
                            compute_dtype=compute_dtype, mobile=mobile,
                            remat=remat,
                            predict_activation=predict_activation)
