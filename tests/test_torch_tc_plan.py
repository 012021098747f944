"""The tile and chunk plans of the tensor-core units (`unit3_plan`,
`dw3_plan`, `unit1_plan`, `dw1_plan` of
`ops/cuda/bottleneck_train_kernel.py`), which the wrappers pass to
`csrc/bottleneck_train.cu` as integers: at every level of the fused step
(64 px down to 4 px), batch 1, 8 and 64 (and 11 for the 1x1 units), and
16, 48, 128 and 1024 channels (and 256, with Cin != Cout, for the 1x1
units, forward and backward), each plan fits one block's shared memory on
the H100, the tiles cover every output pixel or row once, and the weight
gradients' slices cover every tile once with partials within
DW_WORKSPACE. Pure Python: the kernels themselves run only on the card
(`tests/test_torch_cuda_kernels.py`)."""

import itertools

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


# The 1x1 backward units (unit1_plan, dw1_plan): (K, N) of the din GEMM,
# which are (Ci, Co) read the other way round for dW.
BATCHES_1X1 = (1, 8, 11, 64)
PAIRS_1X1 = ((16, 16), (48, 48), (128, 128), (1024, 1024), (256, 128),
             (128, 256), (48, 1024), (1024, 48), (16, 256))
EPIS = (tk.EPI_DIN, tk.EPI_DIN_SUMS, tk.EPI_DIN_SKIP)


def _unit1_smem(p, K, N, epi):
    """unit1_tc_kernel's shared memory, laid out as the kernel does: the B
    operand (W^T, or W for the forward) when resident, the ring (a stage
    holds the raw dz and a, or the forward's raw x), the item buffers, the
    sums."""
    a16 = lambda n: -(-n // 16) * 16
    raw = 1 if epi == tk.EPI_RELU_STATS else 2
    stage = a16((raw * tk.TC_M * (p["ck"] + 8)
                 + (0 if p["wres"] else p["ck"] * (p["nt"] + 8))) * 2)
    sums = epi in (tk.EPI_DIN_SUMS, tk.EPI_RELU_STATS)
    return ((a16(K * (N + 8) * 2) if p["wres"] else 0) + p["nst"] * stage
            + p["na"] * a16(tk.TC_M * (p["nt"] + 8) * 2)
            + ((8 * p["nt"] + 2 * N) * 4 if sums else 0))


def _rows_once(p, rows, N):
    """Tile i holds rows [i * TC_M, (i + 1) * TC_M) below `rows`: each row
    once, the last tile ragged where TC_M does not divide rows; work item t
    is tile t // (N / nt), chunk t % (N / nt)."""
    assert p["rows"] == rows and p["ntiles"] == -(-rows // tk.TC_M)
    tiles = np.arange(p["ntiles"])
    count = np.zeros(rows, np.int64)
    for lo in tiles * tk.TC_M:
        count[lo:lo + tk.TC_M] += 1
    assert (count == 1).all()
    nch = N // p["nt"]
    assert p["work"] == p["ntiles"] * nch
    assert np.array_equal(np.unique(np.arange(p["work"]) // nch), tiles)


@pytest.mark.parametrize("B", BATCHES_1X1)
@pytest.mark.parametrize("h", LEVELS)
def test_unit1_plan_fits_and_tiles_cover_each_row_once(h, B):
    rows = B * h * h
    for (K, N), epi in itertools.product(PAIRS_1X1, EPIS):
        p = tk.unit1_plan(B, h, h, K, N, epi)
        assert p["smem"] == _unit1_smem(p, K, N, epi) <= tk.SMEM_LIMIT
        assert K % p["ck"] == 0 and p["ck"] % 16 == 0 and p["ck"] <= tk.TC_CK
        assert N % p["nt"] == 0 and p["nt"] % 16 == 0 and p["nt"] <= tk.TC_NT
        assert 2 <= p["nst"] <= tk.TC_STAGES
        # an aux tile is issued only once the item buffer it lands in has
        # been stored out
        if epi != tk.EPI_DIN:
            assert p["na"] * (K // p["ck"]) >= p["nst"]
        _rows_once(p, rows, N)


@pytest.mark.parametrize("B", BATCHES_1X1)
@pytest.mark.parametrize("h", LEVELS)
def test_dw1_plan_fits_and_slices_cover_each_row_once(h, B):
    rows = B * h * h
    for Co, Ci in PAIRS_1X1:
        p = tk.dw1_plan(B, h, h, Ci, Co)
        assert p["smem"] <= tk.SMEM_LIMIT
        # the db reduction reuses the ring: 256 threads x 8 floats
        assert 256 * 8 * 4 <= p["smem"]
        assert p["workspace"] <= tk.DW_WORKSPACE
        assert Ci % p["ti"] == 0 and p["ti"] % 16 == 0
        assert Co % p["to"] == 0 and p["to"] % 16 == 0
        # 4 x 2 warps of 32 x to/2 cover the tile; a warp's accumulators
        # (32 * to/2 floats over 32 lanes) stay at most 64 a lane
        assert p["ti"] <= 4 * 32 and 32 * (p["to"] // 2) // 32 <= 64
        assert p["ctiles"] == (Ci // p["ti"]) * (Co // p["to"])
        assert p["length"] == Ci * Co + Co
        # slice s takes row tiles [s * per, (s + 1) * per) of DW1_M rows:
        # each tile once, no slice empty, each row in one tile
        assert p["ntiles"] == -(-rows // tk.DW1_M)
        owner = np.arange(p["ntiles"]) // p["per"]
        assert np.array_equal(np.unique(owner), np.arange(p["slices"]))
        if p["slices"] > 1:
            assert p["workspace"] == p["slices"] * p["length"]
        else:
            assert p["workspace"] == 0


def test_unit1_plans_at_the_fused_step_shapes():
    """S4's 1x1 backward units at batch 64 (C = 256, Cm = 128), as the
    source note of csrc/bottleneck_train.cu says: at 64 px one output
    chunk of 128 (#14d's din) or two (#14f's dx), W^T resident (64 KB);
    the chunk halved down to 16 on the small maps while the work items
    number fewer than TC_MIN_WORK; the weight gradients in 128 x 128
    channel tiles over 66 row slices (8.7 MB of partials), always more
    than one slice, so the launch counts per call stay 4 and 3."""
    d = tk.unit1_plan(64, 64, 64, 256, 128, tk.EPI_DIN_SUMS)
    assert (d["ck"], d["nt"], d["wres"], d["work"]) == (64, 128, True, 2048)
    f = tk.unit1_plan(64, 64, 64, 128, 256, tk.EPI_DIN_SKIP)
    assert (f["ck"], f["nt"], f["wres"], f["work"]) == (64, 128, True, 4096)
    assert 256 * (128 + 8) * 2 == 69632 and 128 * (256 + 8) * 2 == 67584
    assert [(tk.unit1_plan(64, h, h, 256, 128, tk.EPI_DIN_SUMS)["nt"],
             tk.unit1_plan(64, h, h, 256, 128, tk.EPI_DIN_SUMS)["work"])
            for h in (32, 16, 8, 4)] == [(128, 512), (64, 256), (16, 256),
                                         (16, 64)]
    for ci, co in ((128, 256), (256, 128)):
        w = tk.dw1_plan(64, 64, 64, ci, co)
        assert (w["ti"], w["to"], w["ctiles"], w["slices"]) == \
            (128, 128, 2, 66)
        assert w["workspace"] * 4 <= 32 << 20
        assert all(tk.dw1_plan(64, h, h, ci, co)["slices"] > 1
                   for h in LEVELS)
    assert tk.dw1_plan(1, 4, 4, 128, 256)["workspace"] == 0


@pytest.mark.parametrize("c", [8, 24, 1040])
def test_bf16_1x1_shapes_outside_the_contract_raise(c):
    """The 1x1 plans and wrappers refuse channels that are not multiples
    of 16 or exceed 1024, on either side, before any launch."""
    for k, n in ((c, 16), (16, c)):
        with pytest.raises(ValueError, match="multiples of 16"):
            tk.unit1_plan(2, 8, 8, k, n, tk.EPI_DIN_SUMS)
        with pytest.raises(ValueError, match="multiples of 16"):
            tk.dw1_plan(2, 8, 8, k, n)
    x = torch.empty((2, 8, 8, c), dtype=torch.bfloat16, device="meta")
    y = torch.empty((2, 8, 8, 16), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="multiple of 16"):
        tk.unit1x1_bwd(x, x, y, torch.empty((16, c), device="meta"),
                       torch.empty((3, c), device="meta"),
                       torch.empty((2, 16), device="meta"))
    with pytest.raises(ValueError, match="multiple of 16"):
        tk.unit1_bwd(y, y, x, x, torch.empty((c, 16), device="meta"),
                     torch.empty((3, 16), device="meta"))


# The forward 1x1 unit #14a (unit1_plan with EPI_RELU_STATS): the
# bottleneck's two call forms, unit 1 (C -> Cm) and unit 3 (Cm -> C), and
# the other widths of the contract.
FWD_FORMS = ((256, 128), (128, 256))


@pytest.mark.parametrize("B", BATCHES_1X1)
@pytest.mark.parametrize("h", LEVELS)
def test_unit1_fwd_plan_fits_and_tiles_cover_each_row_once(h, B):
    """Both call forms and every PAIRS_1X1 width: the plan fits one block's
    shared memory, laid out as the kernel lays it out (one raw x tile a
    stage, one item buffer: the forward has no aux tile), and its row
    tiles cover each row once, the last ragged at batch 11 on the 8 and 4
    px maps."""
    rows = B * h * h
    for K, N in FWD_FORMS + PAIRS_1X1:
        p = tk.unit1_plan(B, h, h, K, N, tk.EPI_RELU_STATS)
        assert p["smem"] == _unit1_smem(p, K, N, tk.EPI_RELU_STATS) \
            <= tk.SMEM_LIMIT
        assert K % p["ck"] == 0 and p["ck"] % 16 == 0 and p["ck"] <= tk.TC_CK
        assert N % p["nt"] == 0 and p["nt"] % 16 == 0 and p["nt"] <= tk.TC_NT
        assert 2 <= p["nst"] <= tk.TC_STAGES and p["na"] == 1
        _rows_once(p, rows, N)
        if B == 11 and h <= 8:
            assert rows % tk.TC_M      # a ragged last tile to mask


def test_unit1_fwd_plans_at_the_fused_step_shapes():
    """#14a at batch 64 (C = 256, Cm = 128): at 64 px both forms take the
    WIDE plan (ck = 64, nt = 128) with W resident (256 x 136 and 128 x 264
    bf16, 69.6 and 67.6 KB); unit 3's 256 outputs are two work items of 128
    per row tile. On the small maps the chunk is halved toward
    TC_MIN_WORK items, as for the backward."""
    u1 = tk.unit1_plan(64, 64, 64, 256, 128, tk.EPI_RELU_STATS)
    u3 = tk.unit1_plan(64, 64, 64, 128, 256, tk.EPI_RELU_STATS)
    for p in (u1, u3):
        assert (p["ck"], p["nt"], p["wres"], p["nst"], p["na"]) == \
            (tk.TC_CK, tk.TC_NT, True, 4, 1)
    assert (u1["work"], u3["work"]) == (2048, 4096)
    assert (u1["smem"], u3["smem"]) == (183296, 182272)
    assert [(tk.unit1_plan(64, h, h, k, n, tk.EPI_RELU_STATS)["nt"],
             tk.unit1_plan(64, h, h, k, n, tk.EPI_RELU_STATS)["work"])
            for k, n in FWD_FORMS for h in (32, 16, 8, 4)] == \
        [(128, 512), (64, 256), (16, 256), (16, 64),
         (128, 1024), (128, 256), (32, 256), (16, 128)]


@pytest.mark.parametrize("c", [8, 24, 1040])
def test_bf16_1x1_forward_shapes_outside_the_contract_raise(c):
    """The forward's plan and wrapper refuse channels that are not
    multiples of 16 or exceed 1024, on either side, before any launch."""
    for k, n in ((c, 16), (16, c)):
        with pytest.raises(ValueError, match="multiples of 16"):
            tk.unit1_plan(2, 8, 8, k, n, tk.EPI_RELU_STATS)
        x = torch.empty((2, 8, 8, k), dtype=torch.bfloat16, device="meta")
        w = torch.empty((k, n), device="meta")
        v = torch.empty((n,), device="meta")
        with pytest.raises(ValueError, match="multiple of 16"):
            tk.conv1x1_relu_stats(x, w, v)
        with pytest.raises(ValueError, match="multiple of 16"):
            tk.conv1x1_relu_stats(x, w, v, torch.empty((k,), device="meta"),
                                  torch.empty((k,), device="meta"))
