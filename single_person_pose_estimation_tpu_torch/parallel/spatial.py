"""Spatial parallelism: feature maps split by rows over devices, with halo
exchange.

The counterpart of the JAX package's `parallel/spatial.py`. JAX runs each
op under `shard_map` over a "spatial" mesh axis and moves halos with
`ppermute`; here one process holds an H-sharded activation as a list of
NCHW tensors, one per device of a ("spatial",) mesh in order, each with
its own consecutive rows (`shard_spatial`), and a halo is a copy of the
neighbouring shard's edge rows to this shard's device. The top and bottom
shards take zero rows, which is SAME zero padding, so a sharded conv
computes the unsharded conv's sums (the block a device computes differs
from the whole map's only in where it starts).

Weights are replicated: each op moves them to every shard's device (a
no-op where the device repeats, as in `[cpu] * 4` or `[cuda:0, cuda:0]`,
which stand in for several devices). Layout: NCHW, torch's OIHW weights.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F

from single_person_pose_estimation_tpu_torch.models.hourglass import same_pad


def _check(xs, mesh, spatial_axis: str) -> None:
    if spatial_axis not in mesh.axis_names:
        raise ValueError(f"axis {spatial_axis!r} not in mesh axes "
                         f"{mesh.axis_names}")
    if len(xs) != len(mesh.devices):
        raise ValueError(f"{len(xs)} shards for a mesh of "
                         f"{len(mesh.devices)} devices")


def _halo_exchange_rows(xs: List[torch.Tensor], r: int = 1
                        ) -> List[torch.Tensor]:
    """Each (B, C, h, W) block with r rows of its neighbours above and
    below: (B, C, h + 2r, W). The first and last blocks get zero rows."""
    out = []
    for i, x in enumerate(xs):
        if x.shape[2] < r:
            raise ValueError(f"a shard of {x.shape[2]} rows cannot give a "
                             f"halo of {r}")
        zeros = torch.zeros_like(x[:, :, :r])
        top = xs[i - 1][:, :, -r:].to(x.device) if i else zeros
        bottom = xs[i + 1][:, :, :r].to(x.device) if i + 1 < len(xs) \
            else zeros
        out.append(torch.cat([top, x, bottom], dim=2))
    return out


def conv_spatial(xs: List[torch.Tensor], weight: torch.Tensor,
                 bias: Optional[torch.Tensor], mesh,
                 spatial_axis: str = "spatial",
                 stride: int = 1) -> List[torch.Tensor]:
    """k x k SAME conv (odd k, e.g. the front's 7x7/s2) on an H-sharded
    activation. Requires each shard's height to be a multiple of the
    stride.

    The halo is r = k//2 rows a side. With the stride s, TF SAME pads the
    height by k - s in all, (k - s)//2 on top, so the VALID walk over the
    halo-extended block starts at row r - (k - s)//2 (1 for the 7x7/s2,
    0 for any odd k at s=1); the width takes SAME padding."""
    _check(xs, mesh, spatial_axis)
    k = weight.shape[-1]
    if k % 2 == 0 or weight.shape[-2] != k:
        raise ValueError(f"conv_spatial takes odd square kernels, got "
                         f"{tuple(weight.shape)}")
    r = k // 2
    off = r - (k - stride) // 2
    out = []
    for x, ext in zip(xs, _halo_exchange_rows(xs, r)):
        if x.shape[2] % stride:
            raise ValueError(f"a shard of {x.shape[2]} rows does not "
                             f"split into strides of {stride}")
        w = weight.to(x.device)
        b = None if bias is None else bias.to(x.device)
        pw = same_pad(x.shape[3], k, stride)
        ext = F.pad(ext[:, :, off:], (*pw, 0, 0))
        y = F.conv2d(ext, w, b, stride=stride)
        out.append(y[:, :, :x.shape[2] // stride])
    return out


def conv3x3_spatial(xs: List[torch.Tensor], weight: torch.Tensor,
                    bias: Optional[torch.Tensor], mesh,
                    spatial_axis: str = "spatial") -> List[torch.Tensor]:
    """3x3 SAME conv on an H-sharded activation; weight (O, I, 3, 3)."""
    if tuple(weight.shape[-2:]) != (3, 3):
        raise ValueError(f"expected a 3x3 kernel, got {tuple(weight.shape)}")
    return conv_spatial(xs, weight, bias, mesh, spatial_axis)


def maxpool2x2_spatial(xs: List[torch.Tensor], mesh,
                       spatial_axis: str = "spatial") -> List[torch.Tensor]:
    """2x2/s2 maxpool on an H-sharded activation. Each shard's height must
    be even, so that no window straddles two shards."""
    _check(xs, mesh, spatial_axis)
    for x in xs:
        if x.shape[2] % 2:
            raise ValueError(f"local height must be even for 2x2 pooling, "
                             f"got {x.shape[2]}")
    return [F.max_pool2d(x, 2) for x in xs]


def upsample2x_spatial(xs: List[torch.Tensor], mesh,
                       spatial_axis: str = "spatial") -> List[torch.Tensor]:
    """Nearest 2x upsample on an H-sharded activation (local to each
    shard)."""
    _check(xs, mesh, spatial_axis)
    return [F.interpolate(x, scale_factor=2, mode="nearest") for x in xs]


def shard_spatial(x: torch.Tensor, mesh,
                  spatial_axis: str = "spatial") -> List[torch.Tensor]:
    """A (B, C, H, W) tensor -> its H-sharded form: one block of H/n rows
    per device of the mesh, in order, each on its device."""
    n = len(mesh.devices)
    if spatial_axis not in mesh.axis_names:
        raise ValueError(f"axis {spatial_axis!r} not in mesh axes "
                         f"{mesh.axis_names}")
    if x.shape[2] % n:
        raise ValueError(f"{x.shape[2]} rows do not split over {n} devices")
    return [t.to(d) for t, d in zip(x.chunk(n, dim=2), mesh.devices)]


def gather_spatial(xs: List[torch.Tensor], mesh,
                   spatial_axis: str = "spatial") -> torch.Tensor:
    """An H-sharded activation -> one (B, C, H, W) tensor on the mesh's
    first device."""
    _check(xs, mesh, spatial_axis)
    return torch.cat([x.to(mesh.devices[0]) for x in xs], dim=2)
