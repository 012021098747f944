"""Space-to-depth folding of the front 7x7/s2 convolution, in PyTorch.

The counterpart of the JAX package's `ops/space_to_depth.py`. The front
module opens with a 7x7 stride-2 conv over the 3-channel input. The same
function is a 4x4 stride-1 conv over the input blocked 2x2 into channels
(256x256x3 -> 128x128x12), whose kernel is the 7x7 kernel zero-padded to
8x8 and blocked the same way:

    SAME padding of k=7, s=2 on an even input pads (2, 3), so
    out[y] = sum_i W[i] X[2y + i - 2]; writing i - 2 = 2k + d, d in {0, 1},
    maps the 7 taps onto a 4-tap stride-1 conv with padding (1, 2) over
    the d-interleaved input: K2[a, b, (d1 d2 c)] = Wpad[2a + d1, 2b + d2, c].

The fold is exact up to the order of the sums, differentiable, and keeps
the stored (7, 7, C, 64) parameter, so checkpoints are interchangeable.
Here it is plain PyTorch (`F.conv2d` over the 12-channel input): the JAX
package runs it on XLA, not in a Pallas kernel.

The functions named as in the JAX package take NHWC tensors and HWIO
kernels; the `_nchw` ones take the model's NCHW tensors and OIHW weights.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# (left, right) = (top, bottom) padding of the folded 4x4 conv.
_PAD = (1, 2)


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/b, W/b, b*b*C); channel index (d1, d2, c)."""
    b, h, w, c = x.shape
    if h % block or w % block:
        raise ValueError(f"spatial dims {(h, w)} not divisible by {block}")
    x = x.reshape(b, h // block, block, w // block, block, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // block, w // block,
                                               block * block * c)


def space_to_depth_nchw(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """(B, C, H, W) -> (B, b*b*C, H/b, W/b), channels ordered (d1, d2, c)
    as `space_to_depth`."""
    b, c, h, w = x.shape
    if h % block or w % block:
        raise ValueError(f"spatial dims {(h, w)} not divisible by {block}")
    x = x.reshape(b, c, h // block, block, w // block, block)
    return x.permute(0, 3, 5, 1, 2, 4).reshape(b, block * block * c,
                                               h // block, w // block)


def fold_front_kernel(kernel: torch.Tensor) -> torch.Tensor:
    """Fold a (7, 7, C, O) stride-2 kernel to the equivalent (4, 4, 4C, O)
    stride-1 kernel over the space-to-depth input."""
    kh, kw, c, o = kernel.shape
    if (kh, kw) != (7, 7):
        raise ValueError(f"front fold expects a 7x7 kernel, got "
                         f"{tuple(kernel.shape)}")
    wpad = F.pad(kernel, (0, 0, 0, 0, 0, 1, 0, 1))
    k2 = wpad.reshape(4, 2, 4, 2, c, o).permute(0, 2, 1, 3, 4, 5)
    return k2.reshape(4, 4, 4 * c, o)


def fold_front_weight(weight: torch.Tensor) -> torch.Tensor:
    """`fold_front_kernel` on an OIHW weight: (O, C, 7, 7) -> (O, 4C, 4,
    4)."""
    return fold_front_kernel(weight.permute(2, 3, 1, 0)).permute(3, 2, 0, 1)


def front_conv_s2d_nchw(x: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor) -> torch.Tensor:
    """The front's conv7x7/s2 (SAME) + bias on an even-sized NCHW input,
    as the folded conv; weight (O, C, 7, 7) OIHW, in x's dtype."""
    xs = F.pad(space_to_depth_nchw(x), (*_PAD, *_PAD))
    return F.conv2d(xs, fold_front_weight(weight).to(x.dtype),
                    bias.to(x.dtype))


def front_conv_s2d(x: torch.Tensor, kernel: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """Exact replacement for the front's conv7x7/s2 (SAME) + bias on an
    even-sized NHWC input; kernel (7, 7, C, O) HWIO."""
    y = front_conv_s2d_nchw(x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1),
                            bias)
    return y.permute(0, 2, 3, 1)
