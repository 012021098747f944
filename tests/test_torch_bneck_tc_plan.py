"""The plan of the bf16 bottleneck body on the tensor cores (`bneck_tc_plan`
of `ops/cuda/bottleneck_kernel.py`), which the wrappers of #1-#3, #5 and
#7 pass to `csrc/bottleneck_tc.cuh` as integers: at every level of the
S4/256 forward (64 px down to 4 px), batch 1, 8, 11 and 128, in every
mode, each plan fits one block's shared memory on the H100 (two blocks an
SM at C=256), its tiles cover every output pixel once and pool in even
tiles, the subtree walk's plan (#7) fits at depths 1-3 and serves each of
its levels with the separate launches' tiles, and shapes outside the bf16
contract raise. Pure Python: the kernel runs only on the card
(`tests/test_torch_cuda_kernels.py`)."""

import numpy as np
import pytest
import torch

from single_person_pose_estimation_tpu_torch.ops.cuda import (
    bottleneck_kernel as bk,
)

LEVELS = (64, 32, 16, 8, 4)
BATCHES = (1, 8, 11, 128)
MODES = (bk.MODE_PLAIN, bk.MODE_POOL, bk.MODE_UPADD)
C = 256


def _coverage(plan, H, W):
    """How many tiles of the grid cover each pixel of one image, as
    csrc/bottleneck.cu bneck_tc_kernel places tile blockIdx.x."""
    count = np.zeros((H, W), np.int64)
    for t in range(plan["grid"][0]):
        y0 = (t // plan["tiles_x"]) * plan["th"]
        x0 = (t % plan["tiles_x"]) * plan["tw"]
        count[y0:y0 + plan["th"], x0:x0 + plan["tw"]] += 1
    return count


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("h", LEVELS)
def test_plan_fits_and_tiles_cover_each_pixel_once(h, B):
    for mode in MODES:
        p = bk.bneck_tc_plan(B, h, h, C, C // 2, mode)
        assert p["smem"] <= bk.SMEM_LIMIT // 2 - 1024   # two blocks an SM
        assert p["grid"] == (p["tiles_y"] * p["tiles_x"], B)
        assert p["th"] == min(h, p["tsh"]) and p["tw"] == min(h, p["tsw"])
        assert (_coverage(p, h, h) == 1).all()
        if mode == bk.MODE_POOL:
            assert p["th"] % 2 == 0 and p["tw"] % 2 == 0


@pytest.mark.parametrize("mode", MODES)
def test_plan_at_the_main_shape(mode):
    """64 px, B=128, C=256: 8x8 tiles, chunks of 64 in and 128 out, two
    ring stages, 114,816 bytes (bottleneck_tc.cuh's note), 26 stages."""
    p = bk.bneck_tc_plan(128, 64, 64, 256, 128, mode)
    assert (p["th"], p["tw"], p["ck"], p["nt"], p["mw"], p["nst"]) == \
        (8, 8, 64, 128, 4, 2)
    assert p["smem"] == 114816 and p["stages"] == 4 + 18 + 4
    assert p["grid"] == (64, 128)


@pytest.mark.parametrize("c", [32, 64, 96, 128, 512, 1024])
def test_plan_fits_at_every_width_of_the_contract(c):
    for h in (64, 12, 4):
        for mode in MODES:
            p = bk.bneck_tc_plan(2, h, h, c, c // 2, mode)
            assert p["smem"] <= bk.SMEM_LIMIT
            assert (c // 2) % p["ck"] == 0 and p["ck"] % 16 == 0
            assert p["ck"] <= bk.BNECK_TC_CK
            assert (c // 2) % p["nt"] == 0 and p["nt"] <= bk.BNECK_TC_NT
            assert p["nt"] == 16 or p["nt"] % 32 == 0
            assert 2 <= p["nst"] <= bk.BNECK_TC_STAGES
            assert (_coverage(p, h, h) == 1).all()
            if mode == bk.MODE_POOL and h % 2 == 0:
                assert p["th"] % 2 == 0 and p["tw"] % 2 == 0


@pytest.mark.parametrize("tile,ck,blocks", [((8, 16), None, 2),
                                            ((8, 16), 32, 2),
                                            ((8, 8), 32, 2),
                                            ((8, 8), None, 1)])
def test_plans_of_the_tile_measurement_fit(tile, ck, blocks):
    """The plans that scripts/torch_port_bneck_tc_ab.py times: an 8 x 16
    tile gives a warp 6 m16 tiles of the halo, one block an SM; each fits
    and covers every pixel once at every level."""
    for h in LEVELS:
        for mode in MODES:
            p = bk.bneck_tc_plan(128, h, h, C, C // 2, mode, blocks=blocks,
                                 tile=tile, ck=ck)
            assert p["smem"] <= bk.SMEM_LIMIT
            assert p["mw"] == (6 if bk._bneck_tc_mw(p["th"], p["tw"],
                                                    p["nt"]) > 4 else 4)
            assert (_coverage(p, h, h) == 1).all()
            if p["mw"] == 4 and blocks == 2:
                assert p["smem"] <= bk.SMEM_LIMIT // 2 - 1024


def test_ragged_tiles_cover_a_map_that_is_no_multiple_of_the_tile():
    p = bk.bneck_tc_plan(3, 12, 20, 64, 32, bk.MODE_POOL)
    assert (p["th"], p["tw"], p["tiles_y"], p["tiles_x"]) == (8, 8, 2, 3)
    assert (_coverage(p, 12, 20) == 1).all()


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_walk_plan_serves_every_level(depth):
    """#7's one-image walk: the plan of its widest level fits one block,
    and each level's tiles are the separate launches' (the same tile side,
    clipped to the map), even wherever the walk pools."""
    top = 4 << depth
    for B in BATCHES:
        w = bk.bneck_tc_plan(B, top, top, C, C // 2, bk.MODE_PLAIN_POOL,
                             blocks=1)
        assert w["smem"] <= bk.SMEM_LIMIT
        for k in range(depth + 1):
            h = top >> k
            for mode in MODES:
                g = bk.bneck_tc_plan(B, h, h, C, C // 2, mode)
                assert (g["tsh"], g["tsw"]) == (w["tsh"], w["tsw"])
                assert g["ck"] == w["ck"] and g["nt"] == w["nt"]
                th, tw = min(h, w["tsh"]), min(h, w["tsw"])
                assert bk._bneck_tc_smem(th, tw, C, C // 2, True, w["ck"],
                                         w["nt"], w["nst"]) <= w["smem"]
                assert (g["th"], g["tw"]) == (th, tw)
                if k < depth:                # the down levels pool
                    assert th % 2 == 0 and tw % 2 == 0


@pytest.mark.parametrize("c,cm", [(16, 8), (48, 24), (2048, 1024),
                                  (256, 64), (256, 256)])
def test_shapes_outside_the_bf16_contract_raise(c, cm):
    with pytest.raises(ValueError, match="bfloat16 bottleneck"):
        bk.bneck_tc_plan(8, 16, 16, c, cm, bk.MODE_PLAIN)


def test_cpu_tensors_below_the_bf16_contract_run_the_plain_version():
    """C=16 is within the float32 contract and, on the CPU, runs the plain
    version in either dtype: only a CUDA bf16 tensor needs the plan."""
    rng = np.random.default_rng(0)
    p = bk.BottleneckParams.pack(
        *(rng.uniform(-.3, .3, s).astype(np.float32) for s in (
            (16, 8), (8,), (3, 3, 8, 8), (8,), (8, 16), (16,),
            (8,), (8,), (8,), (8,), (16,), (16,))),
        dtype=torch.bfloat16)
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 4, 4, 16)).astype(
        np.float32)).to(torch.bfloat16)
    assert torch.equal(bk.fused_bottleneck(x, p),
                       bk.fused_bottleneck_plain(x, p))
    with pytest.raises(ValueError, match="bfloat16 bottleneck"):
        bk.bneck_tc_plan(2, 4, 4, 16, 8, bk.MODE_PLAIN)
