"""Gaussian heatmap targets, as a CUDA kernel.

Replaces `single_person_pose_estimation_tpu/experimental/heatmap_kernel.py`
`render_heatmaps_batch_pallas`, which computes the same function as the
JAX package's `ops/heatmap.py::render_heatmaps_batch`. The kernel is
`csrc/heatmap.cu`: one thread per float32 output element, NHWC. Its plain
version is `ops/heatmap.py::render_heatmaps_batch`, bound here as
`render_heatmaps_batch_plain`.

The train step renders its targets through this wrapper once per step and
the eval step once per step. `render_heatmaps_batch.launches` counts kernel
launches.
"""

from __future__ import annotations

import numpy as np
import torch

from single_person_pose_estimation_tpu_torch.ops import heatmap
from single_person_pose_estimation_tpu_torch.ops.cuda import build
from single_person_pose_estimation_tpu_torch.ops.cuda.bottleneck_kernel import (
    _require_cuda,
)

render_heatmaps_batch_plain = heatmap.render_heatmaps_batch


def render_heatmaps_batch(kps_x, kps_y, kps_v, height: int = 64,
                          width: int = 64, sigma: float = 1.0):
    """(B, K) keypoints -> (B, H, W, K) float32 heatmaps; CPU tensors take
    the plain version, CUDA tensors the kernel."""
    if kps_x.dim() != 2 or kps_y.shape != kps_x.shape \
            or kps_v.shape != kps_x.shape:
        raise ValueError(f"keypoints must be three (B, K) tensors, got "
                         f"{tuple(kps_x.shape)}, {tuple(kps_y.shape)}, "
                         f"{tuple(kps_v.shape)}")
    if kps_x.device.type == "cpu":
        return render_heatmaps_batch_plain(kps_x, kps_y, kps_v, height,
                                           width, sigma)
    _require_cuda(kps_x)
    B, K = kps_x.shape
    if B * height * width * K >= 2 ** 31:
        raise ValueError(f"{B}x{height}x{width}x{K} outputs exceed the "
                         "kernel's 32-bit index")
    dev = kps_x.device
    kx = kps_x.to(device=dev, dtype=torch.float32).contiguous()
    ky = kps_y.to(device=dev, dtype=torch.float32).contiguous()
    kv = kps_v.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty((B, height, width, K), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = build.lib().spe_heatmap(
        kx.data_ptr(), ky.data_ptr(), kv.data_ptr(), out.data_ptr(), B,
        height, width, K, int(3 * sigma),
        float(np.float32(2.0 * sigma * sigma)), stream)
    build.check(err, "heatmap kernel")
    render_heatmaps_batch.launches += 1
    return out


render_heatmaps_batch.launches = 0
