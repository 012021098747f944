"""Gaussian heatmap targets, as a CUDA kernel.

Replaces `single_person_pose_estimation_tpu/experimental/heatmap_kernel.py`
`render_heatmaps_batch_pallas`, which computes the same function as the
JAX package's `ops/heatmap.py::render_heatmaps_batch`. The kernel is
`csrc/heatmap.cu`: a block builds a chunk of one image's NHWC map (whole
rows where they fit) in shared memory, zeros and then every window's
values, and stores it once, 16 bytes at a time where a row allows it, on
the launch of `heatmap_geometry`. Its
plain version is `ops/heatmap.py::render_heatmaps_batch`, bound here as
`render_heatmaps_batch_plain`.

The train step renders its targets through this wrapper once per step and
the eval step once per step. `render_heatmaps_batch.launches` counts kernel
launches.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from single_person_pose_estimation_tpu_torch.ops import heatmap
from single_person_pose_estimation_tpu_torch.ops.cuda import build
from single_person_pose_estimation_tpu_torch.ops.cuda.bottleneck_kernel import (
    _require_cuda,
    _stream_ptr,
)

render_heatmaps_batch_plain = heatmap.render_heatmaps_batch

HEATMAP_THREADS = 256         # threads a block (csrc/heatmap.cu)
HEATMAP_BLOCK_FLOATS = 4096   # the floats a block should store, at least
HEATMAP_CHUNK_MAX = 8192      # and at most: 32 KB of shared memory


@functools.lru_cache(maxsize=256)
def heatmap_geometry(B, H, W, K, radius):
    """The launch of csrc/heatmap.cu for (B, H, W, K) float32 maps.

    A block of HEATMAP_THREADS threads builds `chunk` consecutive floats of
    one image's H*W*K in shared memory and stores them: `rows` whole rows
    of W*K floats, the least count that reaches HEATMAP_BLOCK_FLOATS, at
    most H; where one row is longer than HEATMAP_CHUNK_MAX, that many
    floats, so a chunk may start and end inside a row. The grid is B *
    chunks blocks, chunks = ceil(H*W*K / chunk), block i taking image
    i // chunks from float (i % chunks) * chunk on (the image's last
    chunk may be short). `vec`: a row holds a whole number of 16-byte
    stores (W*K % 4 == 0), so every chunk starts on 16 bytes and thread t
    stores floats 4t, 4t + 4*threads, ... of its chunk; else floats t,
    t + threads, .... `smem`: the chunk's bytes. `radius` comes back
    clamped to [-1, max(H, W)], which renders the same (no |dx| or |dy|
    exceeds max(H, W) - 1, and a negative radius renders nothing). At
    (64, 64, 64, 17), radius 3: 4 rows, 4,352 floats a block, 1024
    blocks. Cached per argument list: callers share the dict and must
    not change it."""
    r = max(-1, min(int(radius), max(H, W)))
    rowlen = W * K
    rows = max(1, min(H, -(-HEATMAP_BLOCK_FLOATS // max(rowlen, 1))))
    chunk = min(rows * rowlen, HEATMAP_CHUNK_MAX)
    chunks = -(-H * rowlen // max(chunk, 1))
    return dict(rows=rows, chunk=chunk, chunks=chunks, grid=B * chunks,
                threads=HEATMAP_THREADS, vec=rowlen % 4 == 0, radius=r,
                smem=4 * chunk)


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
    geo = heatmap_geometry(B, height, width, K, int(3 * sigma))
    out = torch.empty((B, height, width, K), dtype=torch.float32, device=dev)
    stream = _stream_ptr(dev)
    err = build.lib().spe_heatmap(
        kx.data_ptr(), ky.data_ptr(), kv.data_ptr(), out.data_ptr(), B,
        height, width, K, geo["radius"],
        float(np.float32(2.0 * sigma * sigma)), geo["chunk"], geo["chunks"],
        int(geo["vec"]), stream)
    build.check(err, "heatmap kernel")
    render_heatmaps_batch.launches += 1
    return out


render_heatmaps_batch.launches = 0
