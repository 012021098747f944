"""The port's `utils/export.py` on the CPU: the inference artifact's round
trip is exact, its `predict` lies within 1e-4 of the JAX package's
`load_inference_artifact` predict on a JAX artifact of the same weights,
and TFLite raises with its message. The `torch.export` program is
tests/test_torch_export_program.py's."""

import os

import numpy as np
import pytest
import torch

from single_person_pose_estimation_tpu.configs.default_config import (
    Config as JConfig,
)
from single_person_pose_estimation_tpu.utils import export as jexport
from single_person_pose_estimation_tpu_torch import Config
from single_person_pose_estimation_tpu_torch.utils import export
from torch_port_fixtures import images, random_variables, torch_model

SMALL = dict(image_height=64, image_width=64, label_height=16,
             label_width=16, hg_num_stacks=1, hg_num_channels=16,
             compute_dtype="float32")
TOL_JAX = 1e-4


@pytest.fixture(scope="module")
def variables():
    return random_variables(1, 16, seed=21)


@pytest.fixture(scope="module")
def model(variables):
    return torch_model(variables, 1, 16)


def test_artifact_round_trip_is_exact(tmp_path, model):
    cfg = Config(**SMALL)
    export.save_inference_artifact(cfg, model, str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["config.json", "weights.pt"]
    assert Config.from_json((tmp_path / "config.json").read_text()) == cfg
    loaded, state_dict, predict = export.load_inference_artifact(
        str(tmp_path), device="cpu")
    want = model.state_dict()
    assert state_dict.keys() == want.keys()
    assert all(torch.equal(state_dict[k], want[k]) for k in want)
    assert (loaded.num_stacks, loaded.num_channels, loaded.mobile) == (
        1, 16, False)
    x = images(3, seed=22)
    with torch.no_grad():
        plain = model(torch.from_numpy(x))[-1]
    got = predict(x)
    assert got.shape == (3, 16, 16, 17)
    assert torch.equal(got, plain)
    assert torch.equal(predict(torch.from_numpy(x)), plain)


def test_predict_matches_the_jax_artifact(tmp_path, model, variables):
    jcfg = JConfig(**SMALL)
    jexport.save_inference_artifact(jcfg, variables["params"],
                                    variables["batch_stats"],
                                    str(tmp_path / "jax"))
    _, _, jpredict = jexport.load_inference_artifact(str(tmp_path / "jax"))
    export.save_inference_artifact(Config.from_json(jcfg.to_json()), model,
                                   str(tmp_path / "port"))
    _, _, predict = export.load_inference_artifact(str(tmp_path / "port"),
                                                   device="cpu")
    x = images(2, seed=23)
    want = np.asarray(jpredict(x))
    got = predict(x).numpy()
    assert got.shape == want.shape == (2, 16, 16, 17)
    assert np.abs(got - want).max() <= TOL_JAX


def test_tflite_raises_with_its_message(model):
    with pytest.raises(NotImplementedError, match="TFLite") as exc:
        export.export_tflite(Config(**SMALL), model, "/nonexistent.tflite")
    assert "no installed converter" in str(exc.value)


def test_model_from_config_follows_the_config():
    m = export.model_from_config(Config(**{**SMALL, "mobile": True,
                                           "compute_dtype": "bfloat16",
                                           "hm_activation": "linear"}))
    assert m.mobile and m.compute_dtype == torch.bfloat16
    assert m.predict_activation == "linear"
