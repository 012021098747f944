"""The plan of the bf16 conv-skip bottleneck (#6) on the tensor cores
(`convskip_tc_plan` of `ops/cuda/bottleneck_kernel.py`), which the wrapper
passes to `csrc/bottleneck.cu` `convskip_tc_kernel` as integers, and the
launch geometry of the warp resample (#11, `resample_geometry` of
`ops/cuda/warp_kernel.py`): the plan fits one block's shared memory at
every width of its contract, Cin != C included (two blocks an SM at the
front's 128 -> 256), its tiles cover every output pixel once on ragged
maps too, its ring carries W1 + Ws + W2 + W3 slices a tile, and shapes
outside the contract raise; the geometry gives every element of a line
to one thread, at odd L and K too. Pure Python: the kernels run only on
the card (`tests/test_torch_cuda_kernels.py`)."""

import math

import numpy as np
import pytest
import torch

from single_person_pose_estimation_tpu_torch.ops.cuda import (
    bottleneck_kernel as bk,
    warp_kernel as wk,
)

BATCHES = (1, 11, 128)


def _coverage(plan, H, W):
    """How many tiles of the grid cover each pixel of one image, as
    convskip_tc_kernel places tile blockIdx.x."""
    count = np.zeros((H, W), np.int64)
    for t in range(plan["grid"][0]):
        y0 = (t // plan["tiles_x"]) * plan["th"]
        x0 = (t % plan["tiles_x"]) * plan["tw"]
        count[y0:y0 + plan["th"], x0:x0 + plan["tw"]] += 1
    return count


def _smem(th, tw, cin, c, ck, nt, nst):
    """csrc/bottleneck_tc.cuh bneck_tc_smem for the conv skip, written out:
    the cin-wide x halo (or t2, whichever is larger), t1 on the halo, the
    ring, all bf16 rows padded by 8."""
    hw2, p, cm = (th + 2) * (tw + 2), th * tw, c // 2
    return 2 * (max(hw2 * (cin + 8), p * (cm + 8)) + hw2 * (cm + 8)
                + nst * ck * (nt + 8))


def test_plan_at_the_front():
    """front_bottleneck_3 at 64 px, B=128, 128 -> 256: 8x8 tiles, chunks of
    64 in and 128 out, three ring stages in 106,624 bytes (two blocks an
    SM), 2 + 4 + 18 + 4 = 28 stages a tile."""
    p = bk.convskip_tc_plan(128, 64, 64, 128, 256, 128)
    assert (p["th"], p["tw"], p["ck"], p["nt"], p["mw"], p["nst"]) == \
        (8, 8, 64, 128, 4, 3)
    assert p["smem"] == 106624 <= bk.SMEM_LIMIT // 2 - 1024
    assert p["stage_split"] == dict(w1=2, ws=4, w2=18, w3=4)
    assert p["stages"] == 28 and p["grid"] == (64, 128)


@pytest.mark.parametrize("c", range(32, 1025, 32))
def test_plan_fits_at_every_width_of_the_contract(c):
    """Cin = C/2 (the model's front), Cin = C, the narrowest and widest Cin,
    and an odd multiple of 16, at 8 and 12 px."""
    cm = c // 2
    for cin in sorted({max(16, cm - cm % 16), c, 16, 48, 1024}):
        for h in (8, 12):
            p = bk.convskip_tc_plan(2, h, h, cin, c, cm)
            assert p["smem"] <= bk.SMEM_LIMIT
            assert p["smem"] == _smem(p["th"], p["tw"], cin, c, p["ck"],
                                      p["nt"], p["nst"])
            assert p["ck"] % 16 == 0 and p["ck"] <= bk.BNECK_TC_CK
            assert cin % p["ck"] == 0 and cm % p["ck"] == 0
            assert p["ck"] == max(d for d in range(16, 65, 16)
                                  if math.gcd(cin, cm) % d == 0)
            assert cm % p["nt"] == 0 and p["nt"] <= bk.BNECK_TC_NT
            assert p["nt"] == 16 or p["nt"] % 32 == 0
            assert 2 <= p["nst"] <= bk.BNECK_TC_STAGES
            assert p["mw"] in (4, 6)
            if p["mw"] == 4 and p["smem"] > bk.SMEM_LIMIT // 2 - 1024:
                # One block an SM: the plan took as many stages as fit it.
                assert p["nst"] == bk.BNECK_TC_STAGES or _smem(
                    p["th"], p["tw"], cin, c, p["ck"], p["nt"],
                    p["nst"] + 1) > bk.SMEM_LIMIT


@pytest.mark.parametrize("hw", [(64, 64), (12, 20), (7, 9), (4, 4),
                                (1, 13), (30, 2)])
def test_tiles_cover_each_pixel_once(hw):
    H, W = hw
    for B in BATCHES:
        for cin, c in ((128, 256), (32, 64), (1024, 1024), (48, 32)):
            p = bk.convskip_tc_plan(B, H, W, cin, c, c // 2)
            assert p["th"] == min(H, p["tsh"]) and p["tw"] == min(W, p["tsw"])
            assert p["grid"] == (p["tiles_y"] * p["tiles_x"], B)
            assert (_coverage(p, H, W) == 1).all()


@pytest.mark.parametrize("cin,c", [(128, 256), (32, 64), (48, 32),
                                   (1024, 1024), (512, 1024), (16, 960)])
def test_stage_count_is_w1_ws_w2_w3(cin, c):
    """The ring's slices a tile: W1 (Cin x Cm), Ws (Cin x C), the nine W2
    taps (Cm x Cm each) and W3 (Cm x C), each cut in ck x nt slices."""
    cm = c // 2
    p = bk.convskip_tc_plan(8, 16, 16, cin, c, cm)
    ck, nt = p["ck"], p["nt"]
    slices = lambda k, n: (k // ck) * (n // nt)
    assert p["stage_split"] == dict(w1=slices(cin, cm), ws=slices(cin, c),
                                    w2=9 * slices(cm, cm), w3=slices(cm, c))
    assert p["stages"] == slices(cin, cm) + slices(cin, c) \
        + 9 * slices(cm, cm) + slices(cm, c)


def test_measurement_overrides_fit():
    """The plans scripts/torch_port_bneck_tc_ab.py times for #6."""
    for over in ({}, dict(nst=2), dict(ck=32), dict(blocks=1),
                 dict(tile=(8, 16))):
        p = bk.convskip_tc_plan(128, 64, 64, 128, 256, 128, **over)
        assert p["smem"] <= bk.SMEM_LIMIT
        assert (_coverage(p, 64, 64) == 1).all()
        if over.get("nst"):
            assert p["nst"] == over["nst"]


@pytest.mark.parametrize("cin,c,cm", [(128, 48, 24), (128, 16, 8),
                                      (8, 256, 128), (24, 256, 128),
                                      (2048, 256, 128), (128, 2048, 1024),
                                      (128, 256, 64), (0, 256, 128)])
def test_shapes_outside_the_bf16_contract_raise(cin, c, cm):
    with pytest.raises(ValueError, match="bfloat16 conv-skip"):
        bk.convskip_tc_plan(8, 16, 16, cin, c, cm)


def test_cpu_tensors_below_the_bf16_contract_run_the_plain_version():
    """C=16 is within `_check_convskip` (float32 on the card) and, on the
    CPU, runs the plain version in either dtype: only a CUDA bf16 tensor
    needs the plan, which raises there before any launch."""
    rng = np.random.default_rng(0)
    u = lambda *s: rng.uniform(-.3, .3, s).astype(np.float32)
    p = bk.ConvSkipParams.pack(u(16, 16), u(16), u(16, 8), u(8), u(3, 3, 8, 8),
                               u(8), u(8, 16), u(16), u(8), u(8), u(8), u(8),
                               u(16), u(16), dtype=torch.bfloat16)
    x = torch.from_numpy(u(2, 4, 4, 16)).to(torch.bfloat16)
    assert torch.equal(bk.fused_bottleneck_convskip(x, p),
                       bk.fused_bottleneck_convskip_plain(x, p))
    with pytest.raises(ValueError, match="bfloat16 conv-skip"):
        bk.convskip_tc_plan(2, 4, 4, 16, 16, 8)


def _resample_coverage(B, C, L, K):
    """How many threads of the launch write each element, as
    csrc/warp.cu resample_kernel assigns lines and outputs."""
    g = wk.resample_geometry(B, C, L, K)
    tx, ty, (gx, gy) = g["tx"], g["ty"], g["grid"]
    assert tx * ty == wk.RESAMPLE_THREADS and tx & (tx - 1) == 0
    lines = B * C * L
    count = np.zeros((lines, K), np.int64)
    t = np.arange(wk.RESAMPLE_THREADS)
    for i in range(gx):
        line = i * ty + t // tx
        for j in range(gy):
            x0 = (j * tx + t % tx) * wk.RESAMPLE_VEC
            live = (line < lines) & (x0 < K)
            for e in range(wk.RESAMPLE_VEC):
                ok = live & (x0 + e < K)
                np.add.at(count, (line[ok], x0[ok] + e), 1)
    return g, count


@pytest.mark.parametrize("shape", [(2, 3, 5, 7), (1, 3, 9, 1), (3, 1, 7, 13),
                                   (1, 1, 3, 1027), (2, 3, 17, 256),
                                   (1, 2, 1, 4096)])
def test_resample_geometry_covers_every_element_once(shape):
    g, count = _resample_coverage(*shape)
    assert (count == 1).all()
    assert g["grid"][1] <= 65535


def test_resample_geometry_at_the_warp():
    """The training warp's passes, (64, 3, 256, 256): 64 threads a line,
    four lines a block, 12,288 blocks; every store is 16 bytes."""
    assert wk.resample_geometry(64, 3, 256, 256) == dict(
        tx=64, ty=4, grid=(12288, 1))
