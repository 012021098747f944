"""Batched v2 heatmap -> keypoint decode, as a CUDA kernel.

Replaces `single_person_pose_estimation_tpu/experimental/decode_kernel.py`
`decode_batch_pallas`, which computes the same function as the JAX
package's `ops/decode.py::decode_batch`: per image and keypoint the first
maximum of the map, its quarter-pixel offset toward the strongest slot of
its 3x3 patch (legacy, bug for bug, or corrected) and the confidence
threshold. The kernel is `csrc/decode.cu`: a thread-block cluster per
image, 16-byte loads whose lanes each keep to the same keypoints, on the
launch of `decode_geometry`. Its plain version is the port's
`ops/decode.py::decode_batch`, bound here as `decode_batch_plain`; the two
agree exactly.

`predict_ds` and `PoseServer` decode through this wrapper.
`decode_batch.launches` counts kernel launches.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from single_person_pose_estimation_tpu_torch.ops import decode
from single_person_pose_estimation_tpu_torch.ops.cuda import build
from single_person_pose_estimation_tpu_torch.ops.cuda.bottleneck_kernel import (
    _require_cuda,
    _stream_ptr,
)

decode_batch_plain = decode.decode_batch

K_MAX = 544               # keypoints: a row's lanes fit one block
DECODE_STAGES = 8         # copies a lane keeps in flight (csrc/decode.cu)
DECODE_THREADS = 256      # the plan's block, or one row's lanes if more
DECODE_BLOCKS = 64        # blocks the plan spreads a small batch over
DECODE_CLUSTER = 4        # the plan's largest cluster


@functools.lru_cache(maxsize=256)
def decode_geometry(B, H, W, K, vec=True):
    """The launch of csrc/decode.cu for (B, H, W, K) float32 maps.

    `vec`: every image starts on 16 bytes (H*W*K % 4 == 0 and an aligned
    base), so a lane copies VEC = 4 floats at a time; else VEC = 1. A row
    is R = lcm(VEC, K) floats (R / K pixels, `row_floats`); a block has
    `groups` groups of `lanes` = R / VEC threads, as many as
    DECODE_THREADS holds (at least one); a cluster of `cluster` blocks
    takes one image, the grid is B * cluster blocks, and group g of block
    rank q reads rows q * groups + g + i * cluster * groups. The cluster
    is DECODE_BLOCKS // B, at most DECODE_CLUSTER, at least 1; neither so
    large that a group has no row. `smem`: DECODE_STAGES copies a lane in
    flight, then a float and an int per slot of the block. At (B, 64, 64,
    17): blocks of 255 threads, B=1 and 16 in clusters of 4, B=64 and 128
    one block an image (on the H100 clusters of 8 read slower at B=1 and
    16, and any cluster at B=128: PERF.md §6). `args`: the launch's
    (vec, lanes, groups, cluster, smem) in spe_decode's order. Cached per
    argument list: callers share the dict and must not change it."""
    v = 4 if vec else 1
    R = math.lcm(v, K)
    lanes = R // v
    nrows = -(-H * W * K // R)
    cluster = max(1, min(DECODE_CLUSTER, DECODE_BLOCKS // max(B, 1), nrows))
    groups = max(1, min(DECODE_THREADS // lanes, nrows // cluster))
    smem = 4 * (DECODE_STAGES + 2) * lanes * groups * v
    return dict(vec=vec, lanes=lanes, groups=groups, cluster=cluster,
                threads=lanes * groups, grid=B * cluster, rows=nrows,
                row_floats=R, smem=smem,
                args=(int(vec), lanes, groups, cluster, smem))


def decode_batch(heatmaps: torch.Tensor, conf_threshold: float = 1e-6,
                 legacy: bool = True) -> torch.Tensor:
    """(B, H, W, K) heatmaps -> (B, K, 3) float32 (x, y, conf) in heatmap
    pixels. The maps are decoded in float32: another float dtype is cast
    to it first, as the Pallas kernel does. CPU tensors take the plain
    version, CUDA tensors the kernel."""
    if heatmaps.dim() != 4:
        raise ValueError(f"heatmaps must be (B, H, W, K), got "
                         f"{tuple(heatmaps.shape)}")
    if not heatmaps.is_floating_point():
        raise TypeError(f"heatmaps must be floating point, got "
                        f"{heatmaps.dtype}")
    hm = heatmaps.float()
    if hm.device.type == "cpu":
        return decode_batch_plain(hm, conf_threshold, legacy)
    _require_cuda(hm)
    B, H, W, K = hm.shape
    if not 1 <= K <= K_MAX or H < 1 or W < 1:
        raise ValueError(f"the decode kernel takes 1..{K_MAX} keypoints "
                         f"on a non-empty map, got {tuple(hm.shape)}")
    if H * W * K >= 2 ** 31:
        raise ValueError(f"a {H}x{W}x{K} map exceeds the kernel's 32-bit "
                         "index")
    hm = hm.contiguous()
    ptr = hm.data_ptr()
    geo = decode_geometry(B, H, W, K, (H * W * K) % 4 == 0 and ptr % 16 == 0)
    out = torch.empty((B, K, 3), dtype=torch.float32, device=hm.device)
    stream = _stream_ptr(hm.device)
    err = build.lib().spe_decode(
        ptr, out.data_ptr(), B, H, W, K, float(np.float32(conf_threshold)),
        int(bool(legacy)), *geo["args"], stream)
    build.check(err, "decode kernel")
    decode_batch.launches += 1
    return out


decode_batch.launches = 0
