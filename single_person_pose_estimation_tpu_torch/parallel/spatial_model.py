"""High-resolution hourglass inference with spatial (H-axis) parallelism.

The counterpart of the JAX package's `parallel/spatial_model.py`: the
eval-mode forward of the standard stacked hourglass with its maps split
by rows over the devices of a ("spatial",) mesh (`parallel/spatial.py`)
while the global height exceeds `gather_h`, and gathered into one map
below it: after 4 poolings a sharded map would hold a few rows a device,
where halo copies dominate, so the small maps run once on the mesh's
first device. On the way up a map is split again as it grows past
`gather_h`. A model trained at 256x256 so runs at 1024x1024 with each
device holding a part of every large map.

It takes the port's `StackedHourglass` or the flax variables it loads
(`utils/weight_convert.py`), folds each BN to x*a + c (`bn_affine`, as
the JAX package's `_bn`), and returns what `model(x)` returns in eval
mode: the per-stack sigmoid heatmaps. Like the JAX function it covers the
standard model, not the mobile one. The convolutions are cuDNN's (or the
CPU's): the JAX function runs no Pallas kernel either.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Dict, List

import torch
import torch.nn.functional as F

from single_person_pose_estimation_tpu_torch.models.hourglass import (
    StackedHourglass,
    same_pad,
)
from single_person_pose_estimation_tpu_torch.ops.cuda.bottleneck_kernel import (
    bn_affine,
)
from single_person_pose_estimation_tpu_torch.parallel.spatial import (
    conv_spatial,
    gather_spatial,
    maxpool2x2_spatial,
    shard_spatial,
    upsample2x_spatial,
)
from single_person_pose_estimation_tpu_torch.utils.weight_convert import (
    to_state_dict,
)

_BN_EPS = 1e-3


class _Ops:
    """Ops on a map that is either H-sharded (a list of shards) or one
    tensor on the mesh's first device, chosen by its global height."""

    def __init__(self, weights: Dict[str, torch.Tensor], mesh,
                 spatial_axis: str, gather_h: int, dtype: torch.dtype):
        self.mesh, self.axis, self.gather_h = mesh, spatial_axis, gather_h
        dev = mesh.devices[0]
        self.w = {k: v.to(dev, torch.float32) for k, v in weights.items()}
        self.dt = dtype

    def constrain(self, x):
        """Split a map taller than gather_h, gather one at or below it."""
        sharded = isinstance(x, list)
        h = sum(t.shape[2] for t in x) if sharded else x.shape[2]
        if h > self.gather_h:
            return x if sharded else shard_spatial(x, self.mesh, self.axis)
        return gather_spatial(x, self.mesh, self.axis) if sharded else x

    @staticmethod
    def map(fn, *xs):
        """fn on every shard (in step across xs), or on the one map."""
        if isinstance(xs[0], list):
            return [fn(*ts) for ts in zip(*xs)]
        return fn(*xs)

    def conv(self, x, name, stride=1):
        w = self.w[name + ".weight"].to(self.dt)
        b = self.w[name + ".bias"].to(self.dt)
        k = w.shape[-1]
        if isinstance(x, list) and k > 1:
            y = conv_spatial(x, w, b, self.mesh, self.axis, stride)
        else:
            def one(t):
                if k > 1:
                    t = F.pad(t, [p for n in (t.shape[3], t.shape[2])
                                  for p in same_pad(n, k, stride)])
                return F.conv2d(t, w.to(t.device), b.to(t.device),
                                stride=stride)
            y = self.map(one, x)
        return self.constrain(y)

    def bn(self, x, name):
        a, c = bn_affine(self.w[name + ".weight"], self.w[name + ".bias"],
                         self.w[name + ".running_mean"],
                         self.w[name + ".running_var"], _BN_EPS)
        a, c = a[:, None, None].to(self.dt), c[:, None, None].to(self.dt)
        return self.map(lambda t: t * a.to(t.device) + c.to(t.device), x)

    def pool(self, x):
        if isinstance(x, list):
            return self.constrain(maxpool2x2_spatial(x, self.mesh, self.axis))
        return self.constrain(F.max_pool2d(x, 2))

    def upsample(self, x):
        if isinstance(x, list):
            return self.constrain(upsample2x_spatial(x, self.mesh, self.axis))
        return self.constrain(F.interpolate(x, scale_factor=2,
                                            mode="nearest"))


def _relu(ops, x):
    return ops.map(torch.relu, x)


def _add(ops, *xs):
    return ops.map(lambda *ts: sum(ts[1:], ts[0]), *xs)


def _bottleneck(ops, x, name, channels):
    c_in = (x[0] if isinstance(x, list) else x).shape[1]
    skip = x if c_in == channels else _relu(ops, ops.conv(x, name + "_skip"))
    for suffix in ("_conv_1x1_1", "_conv_3x3_2", "_conv_1x1_3"):
        x = ops.bn(_relu(ops, ops.conv(x, name + suffix)),
                   name + suffix + "_bn")
    return _add(ops, skip, x)


def _weights(model_or_variables: Any) -> Dict[str, torch.Tensor]:
    if isinstance(model_or_variables, StackedHourglass):
        model = model_or_variables
        if model.mobile or model.tensor_parallel is not None:
            raise ValueError("spatial_apply takes the standard model, "
                             "unsharded over channels")
        if model.predict_activation != "sigmoid":
            raise ValueError("spatial_apply returns sigmoid heatmaps; the "
                             f"model's activation is "
                             f"{model.predict_activation!r}")
        return {k: v.detach() for k, v in model.state_dict().items()}
    weights = to_state_dict(model_or_variables)
    if any(".depthwise." in k for k in weights):
        raise ValueError("spatial_apply takes the standard model's "
                         "variables, not the mobile model's")
    return weights


def spatial_apply(model_or_variables: Any, images: torch.Tensor, mesh,
                  spatial_axis: str = "spatial",
                  num_stacks: int = 4, gather_h: int = 64,
                  compute_dtype: torch.dtype = torch.float32
                  ) -> List[torch.Tensor]:
    """The eval-mode forward of the stacked hourglass with H-sharded maps:
    what `model(images)` returns, at resolutions where one device cannot
    hold the maps.

    images: (B, H, W, 3) with H and W divisible by 64 and the sharded
    heights by the mesh's device count (every pooled shard even). gather_h:
    the global height at or below which a map runs as one tensor on the
    mesh's first device. num_stacks: the stacks to run, at most those of
    the weights. Returns per-stack (B, H/4, W/4, K) float32 heatmaps on the
    mesh's first device."""
    weights = _weights(model_or_variables)
    stacks = sum(k.endswith("_conv_1x1_predict.weight") for k in weights)
    if not 0 < num_stacks <= stacks:
        raise ValueError(f"num_stacks {num_stacks}: the weights hold "
                         f"{stacks} stacks")
    if images.dim() != 4 or images.shape[-1] != 3 or images.shape[1] % 64 \
            or images.shape[2] % 64:
        raise ValueError(f"input must be (B, H, W, 3) with H and W divisible "
                         f"by 64; got {tuple(images.shape)}")
    ops = _Ops(weights, mesh, spatial_axis, gather_h, compute_dtype)
    x = ops.constrain(images.to(mesh.devices[0], compute_dtype)
                      .permute(0, 3, 1, 2).contiguous())

    y = ops.bn(_relu(ops, ops.conv(x, "front_conv_1x1_1", stride=2)),
               "front_conv_1x1_1_bn")
    c = weights["front_bottleneck_3_conv_1x1_3.weight"].shape[0]
    bneck = partial(_bottleneck, ops)
    y = bneck(y, "front_bottleneck_1", c // 2)
    y = ops.pool(y)
    y = bneck(y, "front_bottleneck_2", c // 2)
    y = bneck(y, "front_bottleneck_3", c)

    outputs = []
    for i in range(num_stacks):
        name = f"hg{i}"
        f1 = bneck(y, name + "_downsample_f1", c)
        f2 = bneck(ops.pool(f1), name + "_downsample_f2", c)
        f4 = bneck(ops.pool(f2), name + "_downsample_f4", c)
        f8 = bneck(ops.pool(f4), name + "_downsample_f8", c)
        b = ops.pool(f8)
        for lvl in ("f8_1", "f8_2", "f8_3"):
            b = bneck(b, f"{name}_downsample_{lvl}", c)
        u = b
        for feat, lvl in ((f8, "f8"), (f4, "f4"), (f2, "f2"), (f1, "f1")):
            d = bneck(feat, f"{name}_upsample_{lvl}_short", c)
            u = bneck(_add(ops, d, ops.upsample(u)),
                      f"{name}_upsample_{lvl}_merged", c)
        head = ops.bn(_relu(ops, ops.conv(u, name + "_conv_1x1_1")),
                      name + "_conv_1x1_1_bn")
        pred = ops.map(lambda t: torch.sigmoid(t.float()),
                       ops.conv(head, name + "_conv_1x1_predict"))
        whole = gather_spatial(pred, mesh, spatial_axis) \
            if isinstance(pred, list) else pred
        outputs.append(whole.permute(0, 2, 3, 1))
        if i < num_stacks - 1:
            h2 = ops.conv(head, name + "_conv_1x1_2")
            hm = ops.conv(ops.map(lambda t: t.to(compute_dtype), pred),
                          name + "_conv_1x1_3")
            y = _add(ops, h2, hm, y)
    return outputs
