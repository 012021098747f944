"""The port's CUDA kernels against their plain PyTorch versions, on the
card: the inference kernels (standard and mobile) at every main-path
shape at batch 2, float32 (TF32 off) and bfloat16, and the bf16
bottleneck body, the head and the mobile body at the edges of their
contracts (up to 1024 channels, float32 too), the training kernels
(warp, heatmap) at the train step's batch 64, at chip_smoke.py's
tolerances, the heatmap kernel at chip_smoke.HEATMAP_EDGES, the decode
kernel at batch 12 and at chip_smoke.DECODE_EDGES, legacy and corrected,
exactly, and the six train-unit kernels (#14a-f) at every level at batch
2, float32 and bfloat16, with the same bits on a rerun, and the dial
kernels #5-#7 (the row-blocked bottleneck at 128 px, the conv-skip
bottleneck at 64 px and at its contract's edges, the subtree at depths
1-3) at batch 2, float32 and
bfloat16, also with the same bits on a rerun, and the 3x3 units (#14b,
#14e) and the 1x1 backward units (#14d, #14f) at the edges of their
contract (bfloat16 on the tensor cores). Skips on a host without a card."""

import numpy as np
import pytest
import torch

import chip_smoke

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = \
        tf32


def _hold_cases(cases, dt):
    for label, _, kern, plain, *hold in cases:
        hold = hold[0] if hold else chip_smoke.max_err
        got, want = kern(), plain()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            if w is None:
                continue
            assert g.shape == w.shape and g.dtype == w.dtype, label
            err, ok = hold(g, w, dt)
            assert ok, (label, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_match_plain_versions_on_card(card, dtype):
    """#1-#4 at the main path's shapes, #1-#3 at chip_smoke.BNECK_EDGES
    (batch 11, 32, 64, 512 and 1024 channels, 4 and 12 px maps, kUpAdd at
    8 px) and #4 at chip_smoke.HEAD_EDGES; a rerun gives the same bits."""
    dt = getattr(torch, dtype)
    cases = chip_smoke.main_kernel_cases(np.random.default_rng(0), dt,
                                         "cuda", 2)
    _hold_cases(cases, dt)
    for label, _, kern, *_ in cases:
        got, again = kern(), kern()
        got = got if isinstance(got, tuple) else (got,)
        again = again if isinstance(again, tuple) else (again,)
        assert all(g is None or torch.equal(g, a)
                   for g, a in zip(got, again)), label


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dial_kernels_match_plain_versions_on_card(card, dtype):
    """#6 at 64 px (128 -> 256) and at chip_smoke.CONVSKIP_EDGES (batch 11,
    4 and 12 px, Cin/C from 32/64 to 1024/1024), #7 at depths 1, 2 and 3
    (and at batch 11, at 64 channels, and at 512 and 1024), #5 at 128 px;
    a rerun gives the same bits."""
    dt = getattr(torch, dtype)
    cases = chip_smoke.dial_kernel_cases(np.random.default_rng(3), dt,
                                         "cuda", 2)
    _hold_cases(cases, dt)
    for label, _, kern, *_ in cases:
        assert torch.equal(kern(), kern()), label


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mobile_kernels_match_plain_versions_on_card(card, dtype):
    """#8 at 64 and 4 px, #9 at 32, 16 and 8 px, #10 at 64, 32, 16 and
    8 px, and at chip_smoke.MOBILE_EDGES; a rerun gives the same bits."""
    dt = getattr(torch, dtype)
    cases = chip_smoke.mobile_main_cases(np.random.default_rng(1), dt,
                                         "cuda", 2)
    _hold_cases(cases, dt)
    for label, _, kern, *_ in cases:
        got, again = kern(), kern()
        got = got if isinstance(got, tuple) else (got,)
        again = again if isinstance(again, tuple) else (again,)
        assert all(torch.equal(g, a) for g, a in zip(got, again)), label


def test_training_kernels_match_plain_versions_on_card(card):
    """#11 (both warp passes) bit for bit and #12 within chip_smoke's 1e-6,
    at the train step's shapes."""
    from single_person_pose_estimation_tpu_torch.ops.cuda import (
        heatmap_kernel as hk,
        warp_kernel as wk,
    )

    rng = np.random.default_rng(4)
    imgs, theta, scale, flip = chip_smoke.warp_inputs(rng, "cuda")
    for x, p in chip_smoke.warp_passes(imgs, theta, scale, flip):
        got = wk.resample_last_axis(x, *p)
        want = wk.resample_last_axis_plain(x, *p)
        torch.cuda.synchronize()
        assert (got - want).abs().max().item() <= chip_smoke.TOL_RESAMPLE
    kx, ky, kv = chip_smoke.keypoint_inputs(rng, "cuda")
    got = hk.render_heatmaps_batch(kx, ky, kv)
    want = hk.render_heatmaps_batch_plain(kx, ky, kv)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= chip_smoke.TOL_TRAIN_KERNELS


def test_heatmap_kernel_at_the_edges_on_card(card):
    """#12 at chip_smoke.HEATMAP_EDGES (batch 1 at K = 1, 16, 17 and sigma
    2; W*K not a multiple of 4; non-square; rows of 9,100 floats; 4,099
    keypoints; sigma 40)
    within chip_smoke's 1e-6, with the plain version's support; a rerun
    gives the same bits."""
    from single_person_pose_estimation_tpu_torch.ops.cuda import (
        heatmap_kernel as hk,
    )

    for label, kps, h, w, sigma in chip_smoke.heatmap_edge_cases(
            np.random.default_rng(5), "cuda"):
        got = hk.render_heatmaps_batch(*kps, h, w, sigma)
        again = hk.render_heatmaps_batch(*kps, h, w, sigma)
        want = hk.render_heatmaps_batch_plain(*kps, h, w, sigma)
        torch.cuda.synchronize()
        assert torch.equal(got, again), label
        assert torch.equal(got > 0, want > 0), label
        assert (got - want).abs().max().item() <= \
            chip_smoke.TOL_TRAIN_KERNELS, label


@pytest.mark.parametrize("legacy", [True, False], ids=["legacy", "corrected"])
def test_decode_kernel_at_the_edges_on_card(card, legacy):
    """#13 at chip_smoke.DECODE_EDGES (batch 1, 3, 16 and 128; K = 1, 16,
    17, 33, 543 and 544, the wrapper's K_MAX, with blocks of 543 threads
    past 48 KB of shared memory, alone and in clusters of 4; non-square;
    H*W*K not a multiple of 4) and on a batch whose base lies off 16
    bytes, exactly; a rerun gives the same bits. One keypoint past K_MAX
    raises ValueError before any launch."""
    from single_person_pose_estimation_tpu_torch.ops.cuda import (
        decode_kernel as dk,
    )

    for label, hm in chip_smoke.decode_edge_cases(
            np.random.default_rng(12)).items():
        got = dk.decode_batch(hm, legacy=legacy)
        again = dk.decode_batch(hm, legacy=legacy)
        want = dk.decode_batch_plain(hm, legacy=legacy)
        torch.cuda.synchronize()
        assert torch.equal(got, want), label
        assert torch.equal(got, again), label
    before = dk.decode_batch.launches
    with pytest.raises(ValueError, match="keypoints"):
        dk.decode_batch(torch.zeros((1, 4, 4, dk.K_MAX + 1), device="cuda"))
    assert dk.decode_batch.launches == before


@pytest.mark.parametrize("legacy", [True, False], ids=["legacy", "corrected"])
def test_decode_kernel_matches_plain_version_on_card(card, legacy):
    """#13 on chip_smoke's decode cases (every kind twice), exactly."""
    from single_person_pose_estimation_tpu_torch.ops.cuda import (
        decode_kernel as dk,
    )

    hm = torch.from_numpy(chip_smoke.decode_inputs(
        np.random.default_rng(11), 12)).cuda()
    before = dk.decode_batch.launches
    got = dk.decode_batch(hm, legacy=legacy)
    want = dk.decode_batch_plain(hm, legacy=legacy)
    torch.cuda.synchronize()
    assert dk.decode_batch.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("batch", [2, chip_smoke.B_TRAIN])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_unit_kernels_match_plain_versions_on_card(card, dtype, batch):
    """#14a-f on chip_smoke's cases (64, 32, 16, 8 and 4 px), at batch 2
    and at the train step's batch, within its train-unit tolerances; a
    rerun gives the same bits."""
    dt = getattr(torch, dtype)
    for label, _, kern, plain, kinds in chip_smoke.train_unit_cases(
            np.random.default_rng(2), dt, "cuda", batch):
        got, again, want = kern(), kern(), plain()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        again = again if isinstance(again, tuple) else (again,)
        want = want if isinstance(want, tuple) else (want,)
        for g, a, w, kind in zip(got, again, want, kinds):
            assert g.shape == w.shape and g.dtype == w.dtype, label
            assert torch.equal(g, a), label
            err, used = chip_smoke.unit_err(g, w, kind, dt)
            assert used <= 1.0, (label, err, used)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unit3_kernels_at_the_contract_edges_on_card(card, dtype):
    """#14b and #14e at chip_smoke.UNIT3_EDGES (16, 48 and 1024 channels;
    batch 11, a partial last group of images at 8 and 4 px) within the
    train-unit tolerances; a rerun gives the same bits."""
    dt = getattr(torch, dtype)
    failures = chip_smoke.hold_unit_cases(
        {}, chip_smoke.unit3_edge_cases(np.random.default_rng(3), dt, "cuda"),
        dt, "")
    assert not failures, failures


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unit1_kernels_at_the_contract_edges_on_card(card, dtype):
    """#14d (with and without the next sums) and #14f at
    chip_smoke.UNIT1_EDGES (16 and 48 channels, 1024, 48 against 1024 both
    ways; batch 11, ragged last row tiles at 8 and 4 px) within the
    train-unit tolerances; a rerun gives the same bits."""
    dt = getattr(torch, dtype)
    failures = chip_smoke.hold_unit_cases(
        {}, chip_smoke.unit1_edge_cases(np.random.default_rng(4), dt, "cuda"),
        dt, "")
    assert not failures, failures
