"""The plans of the bf16 head (#4) and mobile body (#8-#10) on the tensor
cores (`head_tc_plan` of `ops/cuda/head_kernel.py`, `mobile_tc_plan` of
`ops/cuda/mobile_kernel.py`) and the tile choices of the float32 FMA
kernels (`fma_tile_plan`, `head_fma_plan`), which the wrappers pass to
`csrc/head.cu`, `csrc/mobile.cu`, `csrc/bottleneck.cu` and `csrc/bottom.cu`
as integers: at every level of the S4/256 forwards (64 px down to 4 px),
batch 1, 8, 11 and 128, in every mode, each plan fits one block's shared
memory on the H100 (two blocks an SM at C=256), covers every row or pixel
once and pools in even tiles; the float32 tiles fit at every width the
wrappers admit (C = 16 to 1024), where an 8 x 8 tile stops fitting above
C=384; and widths outside each contract raise. Pure Python: the kernels
run only on the card (`tests/test_torch_cuda_kernels.py`)."""

import numpy as np
import pytest
import torch

from single_person_pose_estimation_tpu_torch.ops.cuda import (
    bottleneck_kernel as bk,
    head_kernel as hk,
    mobile_kernel as mk,
)

LEVELS = (64, 32, 16, 8, 4)
BATCHES = (1, 8, 11, 128)
MOBILE_MODES = (mk.MODE_PLAIN, mk.MODE_POOL, mk.MODE_UPADD)
WIDTHS = tuple(range(16, 1025, 16))
C, K = 256, 17


def _pixel_coverage(plan, H, W):
    """How many tiles of the grid cover each pixel of one image, as
    csrc/mobile.cu mobile_tc_kernel places tile blockIdx.x."""
    count = np.zeros((H, W), np.int64)
    for t in range(plan["grid"][0]):
        y0 = (t // plan["tiles_x"]) * plan["th"]
        x0 = (t % plan["tiles_x"]) * plan["tw"]
        count[y0:y0 + plan["th"], x0:x0 + plan["tw"]] += 1
    return count


def _row_coverage(plan, M):
    """How many blocks write each of the M pixel rows, as csrc/head.cu
    head_tc_kernel places block blockIdx.x (rows past M are masked)."""
    count = np.zeros(M, np.int64)
    for blk in range(plan["blocks_m"]):
        r0 = blk * plan["rows"]
        count[r0:min(r0 + plan["rows"], M)] += 1
    return count


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("h", LEVELS)
def test_head_plan_fits_and_covers_each_row_once(h, B):
    M = B * h * h
    p = hk.head_tc_plan(M, C, K)
    assert p["smem"] <= bk.SMEM_LIMIT // 2 - 1024     # two blocks an SM
    assert p["smem"] == hk._head_tc_smem(p["rows"], C, K, p["ck"], p["nt"],
                                         p["nst"])
    assert (_row_coverage(p, M) == 1).all()
    assert p["rows"] % 16 == 0 and C % p["ck"] == 0 and C % p["nt"] == 0


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("h", LEVELS)
def test_mobile_plan_fits_and_tiles_cover_each_pixel_once(h, B):
    for mode in MOBILE_MODES:
        p = mk.mobile_tc_plan(B, h, h, C, C // 2, mode)
        assert p["smem"] <= bk.SMEM_LIMIT // 2 - 1024   # two blocks an SM
        assert p["grid"] == (p["tiles_y"] * p["tiles_x"], B)
        assert p["th"] == min(h, p["tsh"]) and p["tw"] == min(h, p["tsw"])
        assert (_pixel_coverage(p, h, h) == 1).all()
        if mode == mk.MODE_POOL:
            assert p["th"] % 2 == 0 and p["tw"] % 2 == 0


def test_head_plan_at_the_main_shape():
    """64 px, B=128, C=256, K=17: 64 rows, chunks of 64 in and 128 out, two
    ring stages, 102,400 bytes (csrc/head.cu's note), 22 stages of a mid
    stack, 8,192 blocks."""
    p = hk.head_tc_plan(128 * 64 * 64, 256, 17)
    assert (p["rows"], p["ck"], p["nt"], p["nst"], p["smem"]) == \
        (64, 64, 128, 2, 102400)
    assert p["stages"] == 8 + 4 + 10 and p["blocks_m"] == 8192


@pytest.mark.parametrize("mode", MOBILE_MODES)
def test_mobile_plan_at_the_main_shape(mode):
    """64 px, B=128, C=256: the standard body's 8x8 tiles, chunks, two
    stages and 114,816 bytes, and 10 ring stages a tile (4 of W1', 2 of
    pw2, 4 of W3') against the standard body's 26."""
    p = mk.mobile_tc_plan(128, 64, 64, 256, 128, mode)
    assert (p["th"], p["tw"], p["ck"], p["nt"], p["mw"], p["nst"]) == \
        (8, 8, 64, 128, 4, 2)
    assert p["smem"] == 114816 and p["stages"] == 4 + 2 + 4
    assert p["grid"] == (64, 128)


@pytest.mark.parametrize("c", [32, 64, 96, 512, 1024])
def test_head_and_mobile_plans_fit_at_every_width_of_the_contract(c):
    for m in (11 * 12 * 12, 2 * 4 * 4, 128 * 64 * 64):
        p = hk.head_tc_plan(m, c, K)
        assert p["smem"] <= bk.SMEM_LIMIT
        assert (_row_coverage(p, m) == 1).all()
        assert p["ck"] >= hk.HEAD_NP and c % p["ck"] == 0
    for h in (64, 12, 4):
        for mode in MOBILE_MODES:
            p = mk.mobile_tc_plan(2, h, h, c, c // 2, mode)
            assert p["smem"] <= bk.SMEM_LIMIT
            assert (_pixel_coverage(p, h, h) == 1).all()
            if mode == mk.MODE_POOL and h % 2 == 0:
                assert p["th"] % 2 == 0 and p["tw"] % 2 == 0


@pytest.mark.parametrize("over", [{}, dict(ck=32), dict(rows=32),
                                  dict(blocks=1), dict(rows=32, ck=32)])
def test_head_plans_of_the_measurement_fit(over):
    """The head plans that scripts/torch_port_bneck_tc_ab.py times."""
    p = hk.head_tc_plan(128 * 64 * 64, C, K, **over)
    assert p["smem"] <= bk.SMEM_LIMIT
    if over.get("blocks", 2) == 2:
        assert p["smem"] <= bk.SMEM_LIMIT // 2 - 1024
    assert (_row_coverage(p, 128 * 64 * 64) == 1).all()


@pytest.mark.parametrize("kind,cin", [("bneck", None), ("mobile", None),
                                      ("convskip", 0.5), ("convskip", 1.0)])
def test_fma_tiles_fit_at_every_admitted_width(kind, cin):
    """The float32 FMA tiles fit one block at C = 16..1024 (the wrappers'
    contract), and stay 8 x 8 up to C=384, as before the tile was chosen
    by width; the conv skip's x halo is Cin wide (Cin = C/2 on the model's
    front, up to C in the wrapper's contract)."""
    for c in WIDTHS:
        ci = None if cin is None else int(c * cin)
        p = bk.fma_tile_plan(kind, c, c // 2, 4, ci)
        assert p["smem"] <= bk.SMEM_LIMIT
        assert p["smem"] == bk.fma_smem(kind, p["ts"], c, c // 2, 4, ci)
        if kind != "convskip" and c <= 384:
            assert p["ts"] == 8
        if kind == "convskip":
            # The bf16 conv skip runs the tensor-core plan (C % 32).
            if c % 32 == 0:
                assert bk.convskip_tc_plan(2, 8, 8, ci, c, c // 2)[
                    "smem"] <= bk.SMEM_LIMIT
        else:
            assert bk.fma_tile_plan(kind, c, c // 2, 2, ci)["smem"] <= \
                bk.SMEM_LIMIT


@pytest.mark.parametrize("kind", ["bneck", "mobile"])
def test_an_8x8_float32_tile_overflows_above_384_channels(kind):
    """The fault the width-chosen tile repairs: an 8 x 8 float32 tile takes
    600 bytes a channel, over 232,448 bytes from C=400 on, where the tile
    is now 4 x 4 (216 bytes a channel)."""
    for c in WIDTHS:
        over = bk.fma_smem(kind, 8, c, c // 2) > bk.SMEM_LIMIT
        assert over == (c > 384)
        assert bk.fma_tile_plan(kind, c, c // 2)["ts"] == (4 if over else 8)
    assert bk.fma_smem(kind, 8, 384, 192) == 600 * 384
    assert bk.fma_smem(kind, 4, 1024, 512) == 216 * 1024


def test_fma_head_rows_fit_at_every_admitted_width():
    """64 rows a block up to C=432 at K=17 (bit-equal tiles to the fixed
    64-row block below that), 32 from C=448, 16 at C=1024."""
    for c in WIDTHS:
        p = hk.head_fma_plan(c, K)
        assert p["smem"] <= bk.SMEM_LIMIT
        assert p["rows"] == (64 if c <= 432 else 32 if c <= 896 else 16)
    assert (2 * 64 * 512 + 64 * 20) * 4 > bk.SMEM_LIMIT   # 64 rows at 512


@pytest.mark.parametrize("c,k", [(48, 17), (16, 17), (2048, 17), (256, 33),
                                 (256, 0)])
def test_head_widths_outside_the_bf16_contract_raise(c, k):
    with pytest.raises(ValueError, match="bfloat16 head"):
        hk.head_tc_plan(128, c, k)


@pytest.mark.parametrize("c,cm", [(16, 8), (48, 24), (2048, 1024),
                                  (256, 64)])
def test_mobile_widths_outside_the_bf16_contract_raise(c, cm):
    with pytest.raises(ValueError, match="bfloat16 mobile bottleneck"):
        mk.mobile_tc_plan(8, 16, 16, c, cm, mk.MODE_PLAIN)


def test_head_above_1024_channels_raises_before_any_launch():
    """The head's check admits C % 16 up to 1024: the FMA kernel spreads
    C/4 channel groups over 256 threads and would leave the rest of head
    and y' unwritten."""
    c = 1040
    p = hk.HeadParams.pack(torch.zeros(c, c), torch.zeros(c), torch.ones(c),
                           torch.zeros(c), torch.zeros(c, K), torch.zeros(K),
                           dtype=torch.float32)
    with pytest.raises(ValueError, match="does not fit"):
        hk.fused_head(torch.zeros(1, 2, 2, c), None, p)


def test_fma_plans_raise_where_no_tile_fits():
    with pytest.raises(ValueError, match="no convskip tile"):
        bk.fma_tile_plan("convskip", 4096, 2048, 4, 4096)
    with pytest.raises(ValueError, match="no float32 head block"):
        hk.head_fma_plan(1024, 8000)


@pytest.mark.parametrize("k", [17, 16, 32])
def test_head_params_pad_wp_and_w3_to_32(k):
    """wpp (C, 32) and w3p (32, C) hold Wp and W3 with zero padding, so the
    padded pred columns (forced to zero) and W3's padded rows add nothing;
    the FMA kernel reads the first K rounded up to 4 rows of w3p."""
    rng = np.random.default_rng(k)
    r = lambda *s: torch.from_numpy(rng.uniform(-1, 1, s).astype(np.float32))
    c = 64
    p = hk.HeadParams.pack(r(c, c), r(c), r(c), r(c), r(c, k), r(k),
                           w2=r(c, c), b2=r(c), w3=r(k, c), b3=r(c),
                           dtype=torch.bfloat16)
    assert p.wpp.shape == (c, 32) and p.w3p.shape == (32, c)
    assert torch.equal(p.wpp[:, :k], p.wpT.t())
    assert not p.wpp[:, k:].any() and not p.w3p[k:].any()
