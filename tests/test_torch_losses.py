"""The port's losses against the JAX package's `losses.py` on the same
NHWC maps (rtol 1e-6: the same float32 operations, summed in another
order), and the name dispatch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from single_person_pose_estimation_tpu import losses as jlosses
from single_person_pose_estimation_tpu_torch import losses as tlosses

RTOL = 1e-6


@pytest.fixture(scope="module")
def maps():
    rng = np.random.default_rng(0)
    y_true = rng.uniform(0, 1, (3, 16, 16, 17)).astype(np.float32)
    y_true[y_true < 0.6] = 0.0           # background, as targets have
    y_true[1, :, :, 4] = 0.0             # an empty (invisible) channel
    preds = [rng.uniform(0, 1, y_true.shape).astype(np.float32)
             for _ in range(2)]
    return y_true, preds


@pytest.mark.parametrize("name", ["mse", "weighted_mse", "iou",
                                  "weighted_keypoint_mse",
                                  "mean_squared_error",
                                  "weight_mean_squared_error"])
def test_loss_matches_jax(maps, name):
    y_true, preds = maps
    want = jlosses.get_loss_from_string(name)(jnp.asarray(y_true),
                                              jnp.asarray(preds[0]))
    got = tlosses.get_loss_from_string(name)(torch.from_numpy(y_true),
                                             torch.from_numpy(preds[0]))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=0)


def test_per_stack_and_total_match_jax(maps):
    y_true, preds = maps
    want = jlosses.per_stack_losses(jlosses.iou, jnp.asarray(y_true),
                                    [jnp.asarray(p) for p in preds])
    got = tlosses.per_stack_losses(tlosses.iou, torch.from_numpy(y_true),
                                   [torch.from_numpy(p) for p in preds])
    np.testing.assert_allclose([g.item() for g in got],
                               [float(w) for w in want], rtol=RTOL)
    total = tlosses.total_loss(tlosses.weighted_mse, torch.from_numpy(y_true),
                               [torch.from_numpy(p) for p in preds])
    np.testing.assert_allclose(total.item(), float(jlosses.total_loss(
        jlosses.weighted_mse, jnp.asarray(y_true),
        [jnp.asarray(p) for p in preds])), rtol=RTOL)


def test_unknown_loss_raises_and_names_match():
    with pytest.raises(ValueError, match="Unknown loss"):
        tlosses.get_loss_from_string("bogus")
    assert set(tlosses._REGISTRY) == set(jlosses._REGISTRY)
    assert tlosses.get_loss_from_string("IOU") is tlosses.iou
