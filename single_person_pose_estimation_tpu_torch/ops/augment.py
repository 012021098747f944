"""Training-time data augmentation on the device, in PyTorch.

The counterpart of the JAX package's `ops/augment.py` (the reference's
`np_augment_1` and `augment_2`, dataset_builder.py:154-217), batched:

Geometric: a horizontal flip (p = 0.5) that also swaps the left/right
keypoint labels through the COCO flip pairs; a scale U(0.75, 1.25) and a
rotation U(-30, 30) degrees about the centre; bilinear, zero fill. The image
is warped in its own space (centre (H-1)/2) and the keypoints are moved in
heatmap space (centre label_size/2 - 0.5), the same draws in both, as the
reference does. Invisible keypoints pin to (0, 0).

Photometric: brightness delta U(-0.2, 0.2); contrast U(0.5, 2) about the
per-channel mean; saturation U(0.75, 1.25) and hue delta U(-0.1, 0.1)
through HSV; then a min-max renormalisation of each image to [0, 1], with
eps 1e-6 guarding a constant image.

Randomness comes from an explicit `torch.Generator`. Torch cannot
reproduce JAX's random stream, so `augment_batch_with_draws` takes the
draws explicitly (the tests feed it the draws JAX made); `augment_batch`
draws them from the generator and calls it.

`geometric_backend`: "gather" is the direct four-tap bilinear warp in
plain PyTorch; "matmul2pass" is the two-pass warp of
`ops/cuda/warp_kernel.py` (the CUDA kernel on the card, its plain version
on the CPU), which differs from one bilinear resample only by the second
linear pass's smoothing; "auto" takes "matmul2pass" on CUDA tensors, so
the kernel is on the training path, and "gather" on the CPU, as the JAX
package takes its gather warp off the TPU.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from single_person_pose_estimation_tpu_torch.ops.cuda import warp_kernel

DEFAULT_FLIP_PAIRS: Tuple[Tuple[int, int], ...] = (
    (1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (11, 12), (13, 14), (15, 16),
)
BACKENDS = ("auto", "gather", "matmul2pass")
# The reference's photometric ranges (dataset_builder.py:204-217); the JAX
# package's augment_batch always uses them.
BRIGHTNESS, CONTRAST, SATURATION, HUE = 0.2, (0.5, 2.0), (0.75, 1.25), 0.1


class AugmentDraws(NamedTuple):
    """Per-image random draws of one augmented batch, each (B,)."""
    s: torch.Tensor           # scale
    theta: torch.Tensor       # rotation, radians
    flip: torch.Tensor        # bool
    delta: torch.Tensor       # brightness
    contrast: torch.Tensor
    saturation: torch.Tensor
    hue: torch.Tensor


def _uniform(generator, n, lo, hi, device):
    u = torch.rand(n, generator=generator, device=device)
    return u * (hi - lo) + lo


def _flip_permutation(num_keypoints: int, flip_pairs) -> torch.Tensor:
    if flip_pairs and max(max(p) for p in flip_pairs) >= num_keypoints:
        raise ValueError(
            f"flip_pairs index out of range for {num_keypoints} keypoints")
    perm = list(range(num_keypoints))
    for a, b in flip_pairs:
        perm[a], perm[b] = perm[b], perm[a]
    return torch.tensor(perm, dtype=torch.long)


def _affine_params(generator, n: int, scale_min=0.75, scale_max=1.25,
                   rotate_deg=30.0, device="cpu"):
    """(s, theta, flip), each (n,), drawn from `generator`."""
    s = _uniform(generator, n, scale_min, scale_max, device)
    theta = _uniform(generator, n, -rotate_deg, rotate_deg, device) \
        * (math.pi / 180.0)
    flip = torch.rand(n, generator=generator, device=device) < 0.5
    return s, theta, flip


def draw_augment_params(generator, n: int, scale_min=0.75, scale_max=1.25,
                        rotate_deg=30.0, device="cpu") -> AugmentDraws:
    """All draws of one batch, from `generator`, on `device`."""
    s, theta, flip = _affine_params(generator, n, scale_min, scale_max,
                                    rotate_deg, device)
    u = lambda lo, hi: _uniform(generator, n, lo, hi, device)
    return AugmentDraws(s, theta, flip, u(-BRIGHTNESS, BRIGHTNESS),
                        u(*CONTRAST), u(*SATURATION), u(-HUE, HUE))


def _transform_keypoints(kps_x, kps_y, kps_v, s, theta, flip,
                         label_size: int, flip_perm: torch.Tensor):
    """Forward-transform (B, K) keypoints in heatmap space; swap the flip
    pairs of flipped images. Invisible keypoints pin to (0, 0)."""
    c = label_size / 2.0 - 0.5      # imgaug's rotation centre: size/2 - 0.5
    f = flip[:, None]
    perm = flip_perm.to(kps_x.device)
    x = kps_x - c
    y = kps_y - c
    x = torch.where(f, -x, x)       # flip first, then swap labels, then affine
    fx = torch.where(f, x[:, perm], x)
    fy = torch.where(f, y[:, perm], y)
    fv = torch.where(f, kps_v[:, perm], kps_v)
    cos_t, sin_t = torch.cos(theta)[:, None], torch.sin(theta)[:, None]
    s = s[:, None]
    nx = s * (cos_t * fx - sin_t * fy) + c
    ny = s * (sin_t * fx + cos_t * fy) + c
    vis = fv > 0
    zero = torch.zeros((), dtype=nx.dtype, device=nx.device)
    return torch.where(vis, nx, zero), torch.where(vis, ny, zero), fv


def _warp_image(images, s, theta, flip):
    """Inverse-warp (B, H, W, C) images by flip -> scale -> rotate about the
    centre: a direct four-tap bilinear gather, zero outside."""
    B, H, W, C = images.shape
    dev = images.device
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None] - cy
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :] - cx
    # Output pixel p_out = A p_in  =>  p_in = A^{-1} p_out, with
    # A = R(theta) s F  =>  A^{-1} = F (1/s) R(-theta).
    cos_t = torch.cos(theta)[:, None, None]
    sin_t = torch.sin(theta)[:, None, None]
    inv_s = (1.0 / s)[:, None, None]
    src_x = inv_s * (cos_t * xs + sin_t * ys)
    src_y = inv_s * (-sin_t * xs + cos_t * ys)
    src_x = torch.where(flip[:, None, None], -src_x, src_x) + cx
    src_y = src_y + cy
    x0, y0 = torch.floor(src_x), torch.floor(src_y)
    wx, wy = (src_x - x0)[..., None], (src_y - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    flat = images.reshape(B, H * W, C)

    def tap(yi, xi):
        valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        v = flat.gather(1, idx.reshape(B, H * W, 1).expand(B, H * W, C))
        return torch.where(valid[..., None], v.reshape(B, H, W, C), 0.0)

    top = tap(y0, x0) * (1 - wx) + tap(y0, x0 + 1) * wx
    bot = tap(y0 + 1, x0) * (1 - wx) + tap(y0 + 1, x0 + 1) * wx
    return top * (1 - wy) + bot * wy


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    rng = maxc - minc
    safe_rng = torch.where(rng == 0, 1.0, rng)
    s = torch.where(maxc == 0, 0.0, rng / torch.where(maxc == 0, 1.0, maxc))
    rc = (maxc - r) / safe_rng
    gc = (maxc - g) / safe_rng
    bc = (maxc - b) / safe_rng
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(rng == 0, 0.0, torch.remainder(h / 6.0, 1.0))
    return torch.stack([h, s, v], dim=-1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)

    def select(*choices):
        out = choices[-1]
        for k in range(4, -1, -1):
            out = torch.where(i == k, choices[k], out)
        return out

    return torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p),
                        select(p, p, t, v, v, q)], dim=-1)


def augment_photometric(images, delta, contrast, saturation, hue_delta):
    """Brightness, contrast, saturation and hue jitter of (B, H, W, 3)
    images with per-image (B,) draws, then a min-max renormalisation of each
    image to [0, 1] (not a clip, despite the reference's comment)."""
    col = lambda v: v[:, None, None, None]
    image = images + col(delta)
    mean = image.mean(dim=(1, 2), keepdim=True)      # per-channel mean
    image = (image - mean) * col(contrast) + mean
    hsv = rgb_to_hsv(torch.clamp(image, 0.0, 1.0))
    h, s, v = hsv.unbind(-1)
    s = torch.clamp(s * saturation[:, None, None], 0.0, 1.0)
    h = torch.remainder(h + hue_delta[:, None, None], 1.0)
    image = hsv_to_rgb(torch.stack([h, s, v], dim=-1))
    max_val = image.amax(dim=(1, 2, 3), keepdim=True)
    min_val = image.amin(dim=(1, 2, 3), keepdim=True)
    # eps guards a constant image, where the reference divides by zero.
    return (image - min_val) / torch.clamp(max_val - min_val, min=1e-6)


def resolve_backend(geometric_backend: str, device) -> str:
    if geometric_backend not in BACKENDS:
        raise ValueError(f"unknown geometric_backend {geometric_backend!r}: "
                         f"use one of {BACKENDS}")
    if geometric_backend == "auto":
        return "matmul2pass" if torch.device(device).type == "cuda" \
            else "gather"
    return geometric_backend


def augment_geometric_with_draws(images, kps_x, kps_y, kps_v, draws,
                                 label_size: int = 64,
                                 flip_pairs=DEFAULT_FLIP_PAIRS,
                                 geometric_backend: str = "gather"):
    """Flip, scale and rotate images and keypoints with the given draws."""
    backend = resolve_backend(geometric_backend, images.device)
    perm = _flip_permutation(kps_x.shape[1], flip_pairs)
    ox, oy, ov = _transform_keypoints(kps_x, kps_y, kps_v, draws.s,
                                      draws.theta, draws.flip, label_size,
                                      perm)
    if backend == "gather":
        imgs = _warp_image(images, draws.s, draws.theta, draws.flip)
    else:
        imgs = warp_kernel.affine_warp_batch(images, draws.theta, draws.s,
                                             draws.flip)
    return imgs, ox, oy, ov


def augment_batch_with_draws(images, kps_x, kps_y, kps_v,
                             draws: AugmentDraws, label_size: int = 64,
                             flip_pairs=DEFAULT_FLIP_PAIRS,
                             geometric_backend: str = "gather"):
    """Geometric then photometric augmentation of (B, H, W, 3) images in
    [0, 1] and (B, K) keypoints, with explicit draws. Returns (images, kx,
    ky, kv)."""
    imgs, ox, oy, ov = augment_geometric_with_draws(
        images, kps_x, kps_y, kps_v, draws, label_size, flip_pairs,
        geometric_backend)
    imgs = augment_photometric(imgs, draws.delta, draws.contrast,
                               draws.saturation, draws.hue)
    return imgs, ox, oy, ov


def augment_batch(generator, images, kps_x, kps_y, kps_v,
                  label_size: int = 64, flip_pairs=DEFAULT_FLIP_PAIRS,
                  geometric_backend: str = "gather", scale_min: float = 0.75,
                  scale_max: float = 1.25, rotate_deg: float = 30.0,
                  shard: Tuple[int, int] = (0, 1)):
    """Full train-time augmentation of a batch with draws from `generator`
    (a torch.Generator on the images' device). Returns (images, kx, ky,
    kv).

    shard=(i, n) (data parallel): the B images are rows i*B..(i+1)*B of a
    global batch of n*B rows. The draws are made for the whole global
    batch and this rank keeps its rows, so every rank's generator stays in
    step with the others' and the n ranks together augment as one process
    does the concatenated batch."""
    index, count = shard
    b = images.shape[0]
    draws = draw_augment_params(generator, b * count, scale_min, scale_max,
                                rotate_deg, device=images.device)
    if count > 1:
        draws = AugmentDraws(*(d[index * b:(index + 1) * b] for d in draws))
    return augment_batch_with_draws(images, kps_x, kps_y, kps_v, draws,
                                    label_size, flip_pairs,
                                    geometric_backend)
