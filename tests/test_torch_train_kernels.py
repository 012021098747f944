"""The training kernels' plain PyTorch versions against the JAX package:
the heatmap targets against `ops/heatmap.py::render_heatmaps_batch` and
the Pallas `render_heatmaps_batch_pallas` in interpret mode (exact, or
atol 1e-6 where the two exp implementations round apart); the warp's
`resample_last_axis` and `affine_warp_batch` against the Pallas kernel in
interpret mode (atol 1e-5: the Pallas version sums its two taps in a
float32 dot that may fuse a multiply-add, and cos/sin may round apart by
an ulp). And the wrappers' routing: CPU tensors take the plain version
and leave the launch counters at 0.

The CUDA kernels themselves are held against these plain versions on the
card by `chip_smoke.py` and `tests/test_torch_cuda_kernels.py`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from single_person_pose_estimation_tpu.experimental.heatmap_kernel import (
    render_heatmaps_batch_pallas,
)
from single_person_pose_estimation_tpu.ops import heatmap as jheatmap
from single_person_pose_estimation_tpu.ops.pallas import warp_kernel as jwarp
from single_person_pose_estimation_tpu_torch.ops import heatmap
from single_person_pose_estimation_tpu_torch.ops.cuda import (
    heatmap_kernel as thk,
    warp_kernel as twk,
)

ATOL_HEATMAP = 1e-6
ATOL_WARP = 1e-5


def _keypoints(rng, b, k, size):
    """Uniform keypoints plus the border, negative and invisible cases."""
    kx = rng.uniform(-3, size + 3, (b, k)).astype(np.float32)
    ky = rng.uniform(-3, size + 3, (b, k)).astype(np.float32)
    kx[0, :6] = [0.0, 0.5, size - 1.0, size - 0.1, float(size), -0.7]
    ky[1, :6] = [0.0, 0.5, size - 1.0, size - 0.1, float(size), -0.7]
    kv = rng.integers(0, 3, (b, k)).astype(np.int32)
    return kx, ky, kv


@pytest.mark.parametrize("size,sigma", [(64, 1.0), (32, 2.0)])
def test_heatmaps_match_jax_and_pallas(size, sigma):
    kx, ky, kv = _keypoints(np.random.default_rng(size), 3, 17, size)
    got = thk.render_heatmaps_batch(*map(torch.from_numpy, (kx, ky, kv)),
                                    height=size, width=size, sigma=sigma)
    assert got.shape == (3, size, size, 17) and got.dtype == torch.float32
    want = np.asarray(jheatmap.render_heatmaps_batch(
        jnp.asarray(kx), jnp.asarray(ky), jnp.asarray(kv), height=size,
        width=size, sigma=sigma))
    pallas = np.asarray(render_heatmaps_batch_pallas(
        jnp.asarray(kx), jnp.asarray(ky), jnp.asarray(kv), height=size,
        width=size, sigma=sigma, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL_HEATMAP)
    np.testing.assert_allclose(got.numpy(), pallas, rtol=0,
                               atol=ATOL_HEATMAP)
    # Same support and the same peaks, exactly.
    np.testing.assert_array_equal(got.numpy() > 0, want > 0)
    np.testing.assert_array_equal(got.numpy() == 1.0, want == 1.0)


def test_render_heatmaps_single_example():
    kx, ky, kv = _keypoints(np.random.default_rng(1), 2, 17, 16)
    got = heatmap.render_heatmaps(kx[0], ky[0], kv[0], 16, 16, 1.0)
    want = np.asarray(jheatmap.render_heatmaps(kx[0], ky[0], kv[0], 16, 16,
                                               1.0))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL_HEATMAP)


def _warp_params(rng, b):
    theta = rng.uniform(-np.pi / 6, np.pi / 6, b).astype(np.float32)
    scale = rng.uniform(0.5, 1.6, b).astype(np.float32)
    flip = np.arange(b) % 2 == 1
    return theta, scale, flip


def test_resample_last_axis_matches_pallas():
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (2, 3, 32, 32)).astype(np.float32)
    slope = np.array([0.8, -1.3], np.float32)
    coef = np.array([0.2, -0.1], np.float32)
    const = np.array([3.5, 40.0], np.float32)   # the second runs off the edge
    want = np.asarray(jwarp.resample_last_axis(
        jnp.asarray(img), jnp.asarray(slope), jnp.asarray(coef),
        jnp.asarray(const), interpret=True))
    got = twk.resample_last_axis(*map(torch.from_numpy,
                                      (img, slope, coef, const)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL_WARP)
    assert (want == 0).any(), "no sample fell off the edge"


def test_affine_warp_batch_matches_pallas():
    rng = np.random.default_rng(1)
    images = rng.uniform(0, 1, (4, 32, 32, 3)).astype(np.float32)
    theta, scale, flip = _warp_params(rng, 4)
    want = np.asarray(jwarp.affine_warp_batch(
        jnp.asarray(images), jnp.asarray(theta), jnp.asarray(scale),
        jnp.asarray(flip), interpret=True))
    got = twk.affine_warp_batch(torch.from_numpy(images),
                                torch.from_numpy(theta),
                                torch.from_numpy(scale),
                                torch.from_numpy(flip))
    assert got.shape == images.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL_WARP)


def test_warp_rejects_non_square_images():
    with pytest.raises(ValueError, match="square"):
        twk.affine_warp_batch(torch.zeros(1, 32, 16, 3), torch.zeros(1),
                              torch.ones(1), torch.zeros(1, dtype=bool))


def test_cpu_tensors_take_the_plain_versions():
    thk.render_heatmaps_batch.launches = 0
    twk.resample_last_axis.launches = 0
    kx = torch.full((1, 17), 10.0)
    thk.render_heatmaps_batch(kx, kx, torch.ones(1, 17, dtype=torch.int32))
    twk.affine_warp_batch(torch.rand(1, 16, 16, 3), torch.zeros(1),
                          torch.ones(1), torch.zeros(1, dtype=bool))
    assert thk.render_heatmaps_batch.launches == 0
    assert twk.resample_last_axis.launches == 0
