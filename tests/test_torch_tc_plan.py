"""The tile and chunk plan of the tensor-core 3x3 units (`unit3_plan`,
`dw3_plan` of `ops/cuda/bottleneck_train_kernel.py`), which the wrappers
pass to `csrc/bottleneck_train.cu` as integers: at every level of the
fused step (64 px down to 4 px), batch 1, 8 and 64, and 16, 48, 128 and
1024 channels, each plan fits one block's shared memory on the H100, the
tiles cover every output pixel once, and the weight gradient's slices
cover every tile once with partials within DW_WORKSPACE. Pure Python: the
kernels themselves run only on the card (`tests/test_torch_cuda_kernels.py`)."""

import numpy as np
import pytest
import torch

from single_person_pose_estimation_tpu_torch.ops.cuda import (
    bottleneck_train_kernel as tk,
)

LEVELS = (64, 32, 16, 8, 4)
BATCHES = (1, 8, 64)
CHANNELS = (16, 48, 128, 1024)


def _tile_pixels(B, H, W, t):
    """(b, y, x) of the output pixels of tile t that lie in the batch, as
    csrc/bottleneck_train.cu decodes t (tile_origin) and the tile's rows m
    (tile_pixel)."""
    ni, th, tw, tiles_x, tiles_y, _ = tk.tc_tiles(B, H, W)
    r = t % (tiles_y * tiles_x)
    m = np.arange(ni * th * tw)
    b = (t // (tiles_y * tiles_x)) * ni + m // (th * tw)
    y = (r // tiles_x) * th + (m // tw) % th
    x = (r % tiles_x) * tw + m % tw
    keep = (b < B) & (y < H) & (x < W)
    return b[keep], y[keep], x[keep]


def _covered(B, h):
    """How many tiles cover each output pixel, (B, h, h)."""
    count = np.zeros((B, h, h), np.int64)
    for t in range(tk.tc_tiles(B, h, h)[-1]):
        np.add.at(count, _tile_pixels(B, h, h, t), 1)
    return count


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("h", LEVELS)
def test_unit3_plan_fits_and_tiles_cover_each_pixel_once(h, B):
    ni, th, tw, *_ = tk.tc_tiles(B, h, h)
    assert ni * th * tw <= tk.TC_M
    assert (_covered(B, h) == 1).all()
    for c in CHANNELS:
        p = tk.unit3_plan(B, h, h, c, c)
        assert p["smem"] <= tk.SMEM_LIMIT
        assert c % p["ck"] == 0 and p["ck"] % 16 == 0 and p["ck"] <= tk.TC_CK
        assert c % p["nt"] == 0 and p["nt"] % 16 == 0 and p["nt"] <= tk.TC_NT
        assert p["work"] == p["ntiles"] * (c // p["nt"])


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("h", LEVELS)
def test_dw3_plan_fits_and_slices_cover_each_row_once(h, B):
    for c in CHANNELS:
        p = tk.dw3_plan(B, h, h, c, c)
        assert p["smem"] <= tk.SMEM_LIMIT
        assert p["workspace"] <= tk.DW_WORKSPACE
        assert p["ti"] in (16, 32) and c % p["ti"] == 0
        assert p["to"] % 16 == 0 and c % p["to"] == 0
        # accumulators of one warp (one tap): at most 64 floats a lane
        assert p["ti"] * p["to"] // 32 <= 64
        # slice s takes tiles [s * per, (s + 1) * per): each tile once,
        # no slice empty
        owner = np.arange(p["ntiles"]) // p["per"]
        assert np.array_equal(np.unique(owner), np.arange(p["slices"]))
        assert p["length"] == 9 * c * c + c
        if p["slices"] > 1:
            assert p["workspace"] == p["slices"] * p["length"]


def test_plans_at_the_fused_step_shapes():
    """S4's 3x3 unit at batch 64 (Cm = 128): 8 x 16 tiles at 64 px, the
    partials of 33 slices (19.5 MB), and the output chunk halved on the
    small maps, down to 32, while the work items number fewer than
    TC_MIN_WORK."""
    p = tk.unit3_plan(64, 64, 64, 128, 128)
    assert (p["ni"], p["th"], p["tw"], p["ntiles"], p["nt"]) == \
        (1, 8, 16, 2048, 128)
    assert [(tk.unit3_plan(64, h, h, 128, 128)["nt"],
             tk.unit3_plan(64, h, h, 128, 128)["work"])
            for h in (32, 16, 8, 4)] == [(128, 512), (64, 256), (32, 128),
                                         (32, 32)]
    d = tk.dw3_plan(64, 64, 64, 128, 128)
    assert (d["ti"], d["to"], d["ctiles"], d["slices"]) == (32, 64, 8, 33)
    assert d["workspace"] * 4 <= 32 << 20


@pytest.mark.parametrize("c", [8, 24, 1040])
def test_bf16_shapes_outside_the_contract_raise(c):
    """Channels must be multiples of 16, at most 1024: the plans and the
    wrappers on a non-CPU tensor refuse others before any launch."""
    with pytest.raises(ValueError, match="multiples of 16"):
        tk.unit3_plan(2, 8, 8, c, 16)
    with pytest.raises(ValueError, match="multiples of 16"):
        tk.dw3_plan(2, 8, 8, 16, c)
    x = torch.empty((2, 8, 8, c), dtype=torch.bfloat16, device="meta")
    w = torch.empty((3, 3, c, c), device="meta")
    v = torch.empty((c,), device="meta")
    with pytest.raises(ValueError, match="multiple of 16"):
        tk.conv3x3_relu_stats(x, w, v, v, v)
    with pytest.raises(ValueError, match="multiple of 16"):
        tk.unit3x3_bwd(x, x, x, w, torch.empty((3, c), device="meta"),
                       torch.empty((2, c), device="meta"))
