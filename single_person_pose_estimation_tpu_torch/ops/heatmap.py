"""Gaussian heatmap targets, in plain PyTorch.

The counterpart of the JAX package's `ops/heatmap.py` (the reference's
`np_gen_heatmaps` + `gaussian`, from princeton-vl/pose-hg-train), and the
plain version that `ops/cuda/heatmap_kernel.py` is held against. Semantics:

  * keypoint coordinates truncate toward zero (`int(x)`);
  * a keypoint renders iff ``0 < xi < W``, ``0 < yi < H`` and ``v > 0``
    (strict: row and column 0 never host a peak);
  * the stamp is the unnormalised float32 Gaussian
    ``exp(-(dx^2 + dy^2) / (2 sigma^2))`` on the square window
    ``|dx|, |dy| <= int(3 sigma)``, zero elsewhere;
  * the output is NHWC, (B, H, W, K).
"""

from __future__ import annotations

import torch


def render_heatmaps_batch(kps_x, kps_y, kps_v, height: int = 64,
                          width: int = 64, sigma: float = 1.0) -> torch.Tensor:
    """(B, K) keypoints in heatmap space -> (B, H, W, K) float32 maps."""
    kx = torch.as_tensor(kps_x).float()
    ky = torch.as_tensor(kps_y, device=kx.device).float()
    kv = torch.as_tensor(kps_v, device=kx.device)
    xi = torch.trunc(kx).to(torch.int32)
    yi = torch.trunc(ky).to(torch.int32)
    valid = (xi > 0) & (xi < width) & (yi > 0) & (yi < height) & (kv > 0)
    radius = int(3 * sigma)
    ys = torch.arange(height, dtype=torch.int32, device=kx.device)
    xs = torch.arange(width, dtype=torch.int32, device=kx.device)
    dx = xs[None, None, :, None] - xi[:, None, None, :]      # (B, 1, W, K)
    dy = ys[None, :, None, None] - yi[:, None, None, :]      # (B, H, 1, K)
    in_window = (dx.abs() <= radius) & (dy.abs() <= radius)
    d2 = dx.float() ** 2 + dy.float() ** 2
    g = torch.exp(-d2 / (2.0 * sigma * sigma))
    return torch.where(in_window & valid[:, None, None, :], g,
                       torch.zeros((), device=kx.device))


def render_heatmaps(kps_x, kps_y, kps_v, height: int = 64, width: int = 64,
                    sigma: float = 1.0) -> torch.Tensor:
    """One example: (K,) keypoints -> (H, W, K) float32 maps."""
    return render_heatmaps_batch(
        torch.as_tensor(kps_x)[None], torch.as_tensor(kps_y)[None],
        torch.as_tensor(kps_v)[None], height, width, sigma)[0]
