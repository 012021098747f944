"""The port's `predict_ds` (CPU: the kernels' plain versions) against the
JAX package's `predict_ds`, on the same flax variables and the same
records, plain and with flip-TTA: the last stack's heatmaps within 1e-4,
the confidences (heatmap values) within 1e-4, and every other field of
the prediction records (keypoints, ids, GT, visibilities, bbox) exactly.
The fixture is peaked (`make_spot_coco`, `peaked_variables`): every
channel's maximum leads its runner-up by more than 1e-4, which the test
asserts, so float32 rounding cannot move a keypoint. Also
`unflip_heatmaps` against JAX's (exact) and the uint8 wire's drift."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from single_person_pose_estimation_tpu.configs.default_config import (
    Config as JConfig,
)
from single_person_pose_estimation_tpu.data import pipeline as jpipe
from single_person_pose_estimation_tpu.evaluation import predict as jpred
from single_person_pose_estimation_tpu.models import fused_inference as jfi
from single_person_pose_estimation_tpu.models.hourglass import (
    StackedHourglass as JHourglass,
)
from single_person_pose_estimation_tpu.ops.augment import (
    _flip_permutation as j_flip_permutation,
)
from single_person_pose_estimation_tpu_torch import Config
from single_person_pose_estimation_tpu_torch.data import coco, pipeline
from single_person_pose_estimation_tpu_torch.evaluation import predict
from single_person_pose_estimation_tpu_torch.models.fused_inference import (
    forward_last_stack,
)
from single_person_pose_estimation_tpu_torch.ops.augment import (
    DEFAULT_FLIP_PAIRS,
    _flip_permutation,
)
from single_person_pose_estimation_tpu_torch.parallel.mesh import create_mesh
from torch_port_fixtures import (
    make_spot_coco,
    peaked_variables,
    torch_model,
)

SMALL = dict(image_height=64, image_width=64, label_height=16,
             label_width=16, batch_size=2, host_workers=1,
             min_num_keypoints=1, num_examples_per_record=3)
TOL_HEATMAP = 1e-4
MARGIN = 1e-4


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("predict"))
    make_spot_coco(root, "val2017", n_images=4)
    make_spot_coco(root, "train2017", n_images=1, seed=12)
    coco.gen_trainval_records(Config(dataset_dir=root, **SMALL))
    return root


@pytest.fixture(scope="module")
def variables():
    return peaked_variables()


def _jax_predictions(root, variables, **kw):
    state = types.SimpleNamespace(params=variables["params"],
                                  batch_stats=variables["batch_stats"])
    ds = jpipe.DatasetBuilder(JConfig(dataset_dir=root, **SMALL))
    return jpred.predict_ds(JHourglass(num_stacks=1, num_channels=16), state,
                            ds.get_ds_prediction(), save_path=None, **kw)


def _port_predictions(root, variables, **kw):
    with pipeline.DatasetBuilder(Config(dataset_dir=root, **SMALL)) as ds:
        return predict.predict_ds(torch_model(variables, 1, 16), None,
                                  ds.get_ds_prediction(), save_path=None,
                                  device="cpu", **kw)


def test_heatmaps_match_jax_and_the_fixture_is_peaked(data, variables):
    with pipeline.DatasetBuilder(Config(dataset_dir=data, **SMALL)) as ds:
        images = np.concatenate([b for b, _ in ds.get_ds_prediction()])
    assert images.shape == (4, 64, 64, 3)
    jmodel = JHourglass(num_stacks=1, num_channels=16)
    perm = j_flip_permutation(17, DEFAULT_FLIP_PAIRS)

    @jax.jit
    def jmaps(v, x):
        # One forward over the batch and its mirror image.
        both = jfi.forward_last_stack(
            jmodel, v, jnp.concatenate([x, x[:, :, ::-1]]), use_fused=False,
            auto=False)
        h, hf = both[:len(x)], both[len(x):]
        return h, 0.5 * (h + jpred.unflip_heatmaps(hf, perm))

    want = [np.asarray(m) for m in jmaps(variables, jnp.asarray(images))]
    model = torch_model(variables, 1, 16)
    x = torch.from_numpy(images)
    tperm = _flip_permutation(17, DEFAULT_FLIP_PAIRS)
    with torch.inference_mode():
        for use_fused in (False, True):
            fwd = lambda im: forward_last_stack(model, im, use_fused=use_fused,
                                                auto=False)
            h = fwd(x)
            got = [h, 0.5 * (h + predict.unflip_heatmaps(fwd(x.flip(2)),
                                                         tperm))]
            for g, w in zip(got, want):
                assert np.abs(g.numpy() - w).max() <= TOL_HEATMAP
    for w in want:
        top2 = np.sort(w.reshape(4, -1, 17), axis=1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > MARGIN


@pytest.mark.parametrize("flip_test", [False, True], ids=["plain", "flip"])
def test_predictions_match_jax_exactly(data, variables, flip_test):
    want = _jax_predictions(data, variables, flip_test=flip_test)
    got = _port_predictions(data, variables, flip_test=flip_test)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        assert {k: v for k, v in g.items() if k != "confs"} == \
            {k: v for k, v in w.items() if k != "confs"}
        np.testing.assert_allclose(g["confs"], w["confs"], rtol=0,
                                   atol=TOL_HEATMAP)
    assert {p["ann_id"] for p in got} == {500, 501, 502, 503}
    assert all(0 < c < 1 for p in got for c in p["confs"])


def test_uint8_wire_drifts_less_than_a_pixel(data, variables):
    f32 = _port_predictions(data, variables)
    with pipeline.DatasetBuilder(Config(dataset_dir=data,
                                        eval_transfer_dtype="uint8",
                                        **SMALL)) as ds:
        u8 = predict.predict_ds(torch_model(variables, 1, 16), None,
                                ds.get_ds_prediction(), save_path=None,
                                device="cpu")
    # One heatmap pixel is 64 / 16 = 4 crop pixels (64 px crops).
    drift = max(abs(a - b) for p, q in zip(f32, u8)
                for key in ("xs/pred", "ys/pred")
                for a, b in zip(p[key], q[key]))
    assert drift < 4.0


def test_unflip_heatmaps_matches_jax():
    hm = np.random.default_rng(0).uniform(0, 1, (2, 8, 8, 17)).astype(
        np.float32)
    perm = _flip_permutation(17, DEFAULT_FLIP_PAIRS)
    for shift in (True, False):
        np.testing.assert_array_equal(
            predict.unflip_heatmaps(torch.from_numpy(hm), perm,
                                    shift=shift).numpy(),
            np.asarray(jpred.unflip_heatmaps(jnp.asarray(hm),
                                             jnp.asarray(perm.numpy()),
                                             shift=shift)))


def test_predict_ds_device_and_mesh_are_explicit(data, variables):
    model = torch_model(variables, 1, 16)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            predict.predict_ds(model, None, [])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            predict.predict_ds(model, None, [],
                               mesh=create_mesh(devices=["cuda:0"] * 2))
    fn = predict.make_predict_decode_fn(model, device="cpu")
    assert fn is predict.make_predict_decode_fn(model, device="cpu")
    assert not fn.use_fused
