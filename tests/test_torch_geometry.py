"""The port's `ops/geometry.py` against the JAX package's, function for
function, on numpy-seeded inputs: boxes inside, partly and wholly outside
the image, fractional and degenerate; float32 within 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from single_person_pose_estimation_tpu.ops import geometry as jgeo
from single_person_pose_estimation_tpu_torch import ops
from single_person_pose_estimation_tpu_torch.ops import geometry as geo

TOL = 1e-5
H, W = 37, 53
BOXES = {
    "inside": (4.0, 6.0, 20.0, 20.0),
    "fractional": (3.7, 5.2, 17.9, 17.9),
    "partly_left_top": (-9.5, -4.25, 30.0, 30.0),
    "partly_right_bottom": (40.3, 25.8, 24.6, 24.6),
    "wholly_outside": (60.0, 45.0, 12.0, 12.0),
    "larger_than_image": (-20.0, -30.0, 90.0, 90.0),
    "tiny": (10.0, 10.0, 0.6, 0.6),
}


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(0).uniform(0, 1, (H, W, 3)).astype(
        np.float32)


def test_ops_package_exports_geometry():
    assert ops.geometry is geo


@pytest.mark.parametrize("name", sorted(BOXES))
@pytest.mark.parametrize("out", [(16, 16), (12, 20)])
def test_crop_and_resize_matches_jax(image, name, out):
    box = np.asarray(BOXES[name], np.float32)
    want = np.asarray(jgeo.crop_and_resize(jnp.asarray(image),
                                           jnp.asarray(box), *out))
    got = geo.crop_and_resize(torch.from_numpy(image), torch.from_numpy(box),
                              *out).numpy()
    assert got.shape == want.shape == (*out, 3)
    assert np.abs(got - want).max() <= TOL
    pad = np.asarray(jgeo.crop_and_pad(jnp.asarray(image), box, out))
    got_pad = geo.crop_and_pad(torch.from_numpy(image), box, out).numpy()
    assert np.abs(got_pad - pad).max() <= TOL


def test_batched_boxes_equal_one_by_one(image):
    boxes = np.asarray([BOXES[k] for k in sorted(BOXES)], np.float32)
    got = geo.crop_and_resize(torch.from_numpy(image),
                              torch.from_numpy(boxes), 16, 16).numpy()
    assert got.shape == (len(boxes), 16, 16, 3)
    for i, box in enumerate(boxes):
        want = np.asarray(jgeo.crop_and_resize(jnp.asarray(image),
                                               jnp.asarray(box), 16, 16))
        assert np.abs(got[i] - want).max() <= TOL
    assert not got[sorted(BOXES).index("wholly_outside")].any()


def test_transform_bbox_square_matches_jax():
    rng = np.random.default_rng(1)
    boxes = rng.uniform(-20, 80, (6, 4)).astype(np.float32)
    boxes[:, 2:] = np.abs(boxes[:, 2:])
    want = np.asarray(jgeo.transform_bbox_square(jnp.asarray(boxes), 1.25))
    got = geo.transform_bbox_square(torch.from_numpy(boxes), 1.25).numpy()
    assert np.abs(got - want).max() <= TOL
    for box in boxes.astype(float).tolist():
        tw = jgeo.transform_bbox_square(tuple(box), 1.25)
        tp = geo.transform_bbox_square(tuple(box), 1.25)
        assert isinstance(tp, tuple) and tp == tuple(tw)


def test_undo_bbox_and_crop_frame_match_jax():
    rng = np.random.default_rng(2)
    nx, ny = rng.uniform(0, 1, (2, 17)).astype(np.float32)
    want = jgeo.undo_bbox(3.5, -2.0, 40.0, 30.0, jnp.asarray(nx),
                          jnp.asarray(ny))
    got = geo.undo_bbox(3.5, -2.0, 40.0, 30.0, torch.from_numpy(nx),
                        torch.from_numpy(ny))
    for g, w in zip(got, want):
        assert np.abs(g.numpy() - np.asarray(w)).max() <= TOL
    xs, ys = rng.uniform(-10, 70, (2, 17)).astype(np.float32)
    vs = rng.integers(0, 3, 17).astype(np.int32)
    bbox = (5.0, 8.0, 40.0, 44.0)
    want = jgeo.keypoints_to_crop_frame(xs, ys, vs, bbox)
    got = geo.keypoints_to_crop_frame(xs, ys, vs, bbox)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[2].dtype == torch.int32 and (got[2] == 0).any()
