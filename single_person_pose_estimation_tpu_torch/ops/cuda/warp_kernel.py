"""The two-pass affine warp of training augmentation, as a CUDA kernel.

Replaces `single_person_pose_estimation_tpu/ops/pallas/warp_kernel.py`
`resample_last_axis` and the `affine_warp_batch` around it. The kernel is
`csrc/warp.cu`; one launch resamples every line of a (B, C, L, K) float32
tensor along its last axis:

    pos = slope[b] * x' + line_coef[b] * l + line_const[b]
    out[b, c, l, x'] = sum_k img[b, c, l, k] * max(0, 1 - |pos - k|)

with zero fill outside [0, K). Only k = floor(pos) and floor(pos) + 1 can
weigh, so the kernel reads two inputs per output; a thread writes four
consecutive outputs of a line, on the launch geometry of
`resample_geometry`. `affine_warp_batch`
decomposes an inverse affine warp (flip -> scale -> rotate about the
centre) into two such passes (Catmull-Smith), with the flip folded into
pass 1; the transposes between passes are PyTorch permutes.

`resample_last_axis_plain` computes the same function with PyTorch ops, in
the kernel's order of float32 operations, so the two agree bit for bit.
`resample_last_axis.launches` counts kernel launches (two per warp).
"""

from __future__ import annotations

import torch

from single_person_pose_estimation_tpu_torch.ops.cuda import build
from single_person_pose_estimation_tpu_torch.ops.cuda.bottleneck_kernel import (
    _require_cuda,
)

RESAMPLE_THREADS = 256    # threads a block (csrc/warp.cu kResampleThreads)
RESAMPLE_VEC = 4          # consecutive outputs a thread (kResampleVec)


def _positions(slope, line_coef, line_const, L, K, device):
    """pos (B, 1, L, K) = slope*x' + line_coef*l + line_const, float32."""
    xs = torch.arange(K, dtype=torch.float32, device=device)
    ls = torch.arange(L, dtype=torch.float32, device=device)[:, None]
    return (slope[:, None, None, None] * xs
            + line_coef[:, None, None, None] * ls
            + line_const[:, None, None, None])


def resample_last_axis_plain(img, slope, line_coef, line_const):
    B, C, L, K = img.shape
    pos = _positions(slope, line_coef, line_const, L, K, img.device)
    out = None
    for f in (torch.floor(pos), torch.floor(pos) + 1.0):
        w = torch.clamp(1.0 - (pos - f).abs(), min=0.0)
        inside = (f >= 0) & (f < K)
        idx = torch.where(inside, f, 0.0).long().expand(B, C, L, K)
        v = torch.where(inside, img.gather(-1, idx), 0.0)
        out = v * w if out is None else out + v * w
    return out


def resample_geometry(B, C, L, K):
    """The launch of csrc/warp.cu for a (B, C, L, K) tensor: tx threads
    cover a line (the least power of two that holds its ceil(K / 4) groups
    of RESAMPLE_VEC outputs, at most RESAMPLE_THREADS), ty = 256 / tx lines
    share a block, and the grid is (ceil(B*C*L / ty) line blocks,
    ceil(K / (4 * tx)) segments). Thread t of block (i, j) takes line
    i * ty + t // tx and outputs from (j * tx + t % tx) * 4; those past the
    line's end or the last line do nothing. At (64, 3, 256, 256): tx 64,
    ty 4, grid (12288, 1)."""
    groups = -(-K // RESAMPLE_VEC)
    tx = min(RESAMPLE_THREADS, 1 << max(groups - 1, 0).bit_length())
    ty = RESAMPLE_THREADS // tx
    return dict(tx=tx, ty=ty, grid=(-(-B * C * L // ty), -(-groups // tx)))


def _check(img, *params):
    if img.dim() != 4 or img.dtype != torch.float32:
        raise ValueError(f"img must be (B, C, L, K) float32, got "
                         f"{tuple(img.shape)} {img.dtype}")
    for v in params:
        if v.shape != (img.shape[0],) or v.device != img.device:
            raise ValueError(f"per-image parameters must be ({img.shape[0]},)"
                             f" on {img.device}, got {tuple(v.shape)} on "
                             f"{v.device}")


def resample_last_axis(img, slope, line_coef, line_const):
    """img (B, C, L, K) float32; slope, line_coef, line_const (B,) float32.
    Returns (B, C, L, K). CPU tensors take the plain version."""
    slope, line_coef, line_const = (
        torch.as_tensor(v, device=img.device).float()
        for v in (slope, line_coef, line_const))
    _check(img, slope, line_coef, line_const)
    if img.device.type == "cpu":
        return resample_last_axis_plain(img, slope, line_coef, line_const)
    _require_cuda(img)
    B, C, L, K = img.shape
    if B * C * L >= 2 ** 31:
        raise ValueError(f"the kernel indexes lines in int32: {B * C * L} "
                         f"lines")
    img = img.contiguous()
    params = torch.stack([slope, line_coef, line_const], -1).contiguous()
    out = torch.empty_like(img)
    geo = resample_geometry(B, C, L, K)
    stream = torch.cuda.current_stream(img.device).cuda_stream
    err = build.lib().spe_resample(img.data_ptr(), params.data_ptr(),
                                   out.data_ptr(), B, C, L, K, geo["tx"],
                                   *geo["grid"], stream)
    build.check(err, "resample kernel")
    resample_last_axis.launches += 1
    return out


resample_last_axis.launches = 0


def warp_pass_params(theta, scale, flip, size: int):
    """Per-image (slope, line_coef, line_const) of both passes of the
    inverse warp of a size x size image, in the TPU kernel's float32
    order. Returns ((a1, coef1, const1), (a2, coef2, const2))."""
    ct, st = torch.cos(theta), torch.sin(theta)
    p, q = ct / scale, st / scale          # src_x = p x' + q y' + alpha
    r, t = -st / scale, ct / scale         # src_y = r x' + t y' + beta
    c = (size - 1) / 2.0
    alpha = c - p * c - q * c
    beta = c - r * c - t * c
    # Pass 1 along x: pos = a1 x' + (q/t) y + const1; the horizontal flip
    # folds in as pos -> (W-1) - pos.
    a1 = p - q * r / t
    coef1 = q / t
    const1 = alpha - q * beta / t
    a1 = torch.where(flip, -a1, a1)
    coef1 = torch.where(flip, -coef1, coef1)
    const1 = torch.where(flip, (size - 1) - const1, const1)
    # Pass 2 along y: pos = t y' + r x' + beta (lines are columns x').
    return (a1, coef1, const1), (t, r, beta)


def affine_warp_batch(images, theta, scale, flip):
    """Inverse-affine warp (flip -> scale -> rotate about the centre) of
    (B, H, W, C) float32 images, H == W; theta (B,) radians, scale (B,),
    flip (B,) bool. Argument order as in the JAX package: theta before
    scale. Returns (B, H, W, C)."""
    B, H, W, C = images.shape
    if H != W:
        raise ValueError(f"the two-pass warp needs square images, got "
                         f"{H}x{W}")
    dev = images.device
    theta, scale = (torch.as_tensor(v, device=dev).float()
                    for v in (theta, scale))
    flip = torch.as_tensor(flip, device=dev).bool()
    pass1, pass2 = warp_pass_params(theta, scale, flip, H)
    x = images.float().permute(0, 3, 1, 2).contiguous()         # (B,C,H,W)
    x = resample_last_axis(x, *pass1)
    x = x.transpose(2, 3).contiguous()                           # (B,C,W,H)
    x = resample_last_axis(x, *pass2)
    return x.permute(0, 3, 2, 1).contiguous()                    # (B,H,W,C)
