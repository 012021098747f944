"""Bounding-box and crop geometry on tensors of any device.

The counterpart of the JAX package's `ops/geometry.py`, function for
function, with the semantics of reference utilities/data_utils.py:
  - transform_bbox_square (data_utils.py:16-45)
  - crop_and_pad          (data_utils.py:48-98)
and eval.py's _undo_bbox (eval.py:153-158).

`crop_and_resize` resamples with one gather and out-of-frame masking, so
a batch of crops with different boxes is one set of tensor ops on the
image's device (the demo runs it on the card). These are plain PyTorch
functions: the JAX versions are XLA programs, not Pallas kernels.
"""

from __future__ import annotations

from typing import Tuple

import torch


def transform_bbox_square(bbox, scale: float = 1.0):
    """Grow a (x, y, w, h) box to a square of side max(w, h) * scale, same
    center.

    `bbox` is a 4-tuple of Python numbers (returns a 4-tuple) or an array
    or tensor whose last axis is 4 (returns a float tensor, batched).
    Reference: utilities/data_utils.py:16-45.
    """
    if isinstance(bbox, (tuple, list)):
        x, y, w, h = bbox
    else:
        bbox = torch.as_tensor(bbox)
        x, y, w, h = bbox[..., 0], bbox[..., 1], bbox[..., 2], bbox[..., 3]
    cx = x + w / 2
    cy = y + h / 2
    side = (torch.maximum(w, h) if isinstance(w, torch.Tensor)
            else max(w, h))
    side = side * scale
    nx = cx - side / 2
    ny = cy - side / 2
    if isinstance(bbox, (tuple, list)):
        return nx, ny, side, side
    return torch.stack([nx, ny, side, side], dim=-1)


def crop_and_resize(image: torch.Tensor, square_bbox: torch.Tensor,
                    out_height: int = 256,
                    out_width: int = 256) -> torch.Tensor:
    """Crop `image` to `square_bbox` (zero-padding outside the frame) and
    resize the crop to (out_height, out_width) in one bilinear gather.

    The reference's crop_and_pad (data_utils.py:48-98) followed by
    tf.image.resize (demo.py:52-53), as one resample with a static output
    shape. tf.image.resize uses half-pixel centers: output pixel (i, j)
    samples the crop at ((j + 0.5) * w/out_w - 0.5,
    (i + 0.5) * h/out_h - 0.5).

    Args:
      image: (H, W, C) float tensor.
      square_bbox: (4,) box (x, y, w, h), may be fractional; or (P, 4)
        boxes, which give (P, out_height, out_width, C).
    """
    boxes = torch.as_tensor(square_bbox, dtype=torch.float32,
                            device=image.device)
    single = boxes.dim() == 1
    boxes = boxes.reshape(-1, 4)
    # The reference floors box coords to ints when cropping
    # (data_utils.py:95-96: int(max(ymin, 0)), int(h), int(w)).
    boxes = torch.floor(boxes)
    x, y, w, h = (boxes[:, i].view(-1, 1, 1) for i in range(4))
    H, W = image.shape[0], image.shape[1]

    # Sample positions in *crop space*. tf.image.resize clamps its bilinear
    # taps to the crop bounds (edge replication): because the reference
    # materializes the crop before resizing, out-of-crop content must NOT
    # leak in, so taps are clamped in crop space before mapping to image
    # space (where out-of-image taps read as zero padding).
    rows = torch.arange(out_height, dtype=torch.float32, device=image.device)
    cols = torch.arange(out_width, dtype=torch.float32, device=image.device)
    ys = ((rows + 0.5).view(1, -1, 1) * (h / out_height) - 0.5).expand(
        -1, out_height, out_width)
    xs = ((cols + 0.5).view(1, 1, -1) * (w / out_width) - 0.5).expand(
        -1, out_height, out_width)

    fy, fx = torch.floor(ys), torch.floor(xs)
    wy = ys - fy
    wx = xs - fx
    hi_y = torch.clamp(h - 1, min=0)
    hi_x = torch.clamp(w - 1, min=0)
    zero = torch.zeros((), device=image.device)
    y0c = torch.clamp(fy, zero, hi_y).to(torch.int64)
    y1c = torch.clamp(fy + 1, zero, hi_y).to(torch.int64)
    x0c = torch.clamp(fx, zero, hi_x).to(torch.int64)
    x1c = torch.clamp(fx + 1, zero, hi_x).to(torch.int64)
    yi = y.to(torch.int64)
    xi = x.to(torch.int64)

    def tap(yc, xc):
        gy = yc + yi
        gx = xc + xi
        valid = (gy >= 0) & (gy < H) & (gx >= 0) & (gx < W)
        v = image[gy.clamp(0, H - 1), gx.clamp(0, W - 1)]
        return torch.where(valid[..., None], v, torch.zeros((), dtype=v.dtype,
                                                            device=v.device))

    wx, wy = wx[..., None], wy[..., None]
    top = tap(y0c, x0c) * (1 - wx) + tap(y0c, x1c) * wx
    bot = tap(y1c, x0c) * (1 - wx) + tap(y1c, x1c) * wx
    out = top * (1 - wy) + bot * wy
    return out[0] if single else out


def crop_and_pad(image: torch.Tensor, square_bbox,
                 out_size: Tuple[int, int]) -> torch.Tensor:
    """Reference-compatible crop: zero-pad so the box is valid, crop to
    it, then resize to `out_size` (the reference's every caller resizes
    its dynamic-size crop at once: gen_tfrecords.py:29, demo.py:52-53).
    See `crop_and_resize`."""
    return crop_and_resize(image, square_bbox, out_size[0], out_size[1])


def undo_bbox(x, y, width, height, normalized_xs, normalized_ys):
    """Map crop-normalized keypoints back into original-image coordinates.

    Reference: eval.py:153-158.
    """
    return normalized_xs * width + x, normalized_ys * height + y


def keypoints_to_crop_frame(xs, ys, vs, bbox):
    """Shift COCO keypoints into the crop frame of `bbox` = (x, y, w, h),
    zeroing any keypoint outside the open box or invisible.

    Replicates gen_tfrecords.py:44-54: a keypoint survives iff
    0 < x - bx < w and 0 < y - by < h and v > 0; otherwise (x, y, v) = 0.
    Vectorized over the keypoint axis; returns float32, float32 and int32
    tensors.
    """
    xs = torch.as_tensor(xs, dtype=torch.float32)
    ys = torch.as_tensor(ys, dtype=torch.float32)
    vs = torch.as_tensor(vs, dtype=torch.int32)
    bx, by, bw, bh = bbox[0], bbox[1], bbox[2], bbox[3]
    sx = xs - bx
    sy = ys - by
    keep = (sx > 0) & (sx < bw) & (sy > 0) & (sy < bh) & (vs > 0)
    return (
        torch.where(keep, sx, torch.zeros_like(sx)),
        torch.where(keep, sy, torch.zeros_like(sy)),
        torch.where(keep, vs, torch.zeros_like(vs)),
    )
