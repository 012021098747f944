"""Batched v2 heatmap -> keypoint decode, as a CUDA kernel.

Replaces `single_person_pose_estimation_tpu/experimental/decode_kernel.py`
`decode_batch_pallas`, which computes the same function as the JAX
package's `ops/decode.py::decode_batch`: per image and keypoint the first
maximum of the map, its quarter-pixel offset toward the strongest slot of
its 3x3 patch (legacy, bug for bug, or corrected) and the confidence
threshold. The kernel is `csrc/decode.cu`: one block per image, threads
in groups of K over the NHWC map. Its plain version is the port's
`ops/decode.py::decode_batch`, bound here as `decode_batch_plain`; the two
agree exactly.

`predict_ds` and `PoseServer` decode through this wrapper.
`decode_batch.launches` counts kernel launches.
"""

from __future__ import annotations

import numpy as np
import torch

from single_person_pose_estimation_tpu_torch.ops import decode
from single_person_pose_estimation_tpu_torch.ops.cuda import build
from single_person_pose_estimation_tpu_torch.ops.cuda.bottleneck_kernel import (
    _require_cuda,
)

decode_batch_plain = decode.decode_batch
# The kernel's block: a multiple of K threads, K <= THREADS.
THREADS = 544


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
    if not 1 <= K <= THREADS or H < 1 or W < 1:
        raise ValueError(f"the decode kernel takes 1..{THREADS} keypoints "
                         f"on a non-empty map, got {tuple(hm.shape)}")
    if H * W * K >= 2 ** 31:
        raise ValueError(f"a {H}x{W}x{K} map exceeds the kernel's 32-bit "
                         "index")
    hm = hm.contiguous()
    out = torch.empty((B, K, 3), dtype=torch.float32, device=hm.device)
    stream = torch.cuda.current_stream(hm.device).cuda_stream
    err = build.lib().spe_decode(
        hm.data_ptr(), out.data_ptr(), B, H, W, K,
        float(np.float32(conf_threshold)), int(bool(legacy)), stream)
    build.check(err, "decode kernel")
    decode_batch.launches += 1
    return out


decode_batch.launches = 0
