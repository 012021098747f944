"""The port's `utils/export.py` `export_savedmodel` on the CPU: a
`torch.export` program of the plain last-stack forward with a dynamic
batch dimension, written to model.pt2 beside config.json and loaded back
by `load_exported`, lies within 1e-5 of the model at two batch
sizes."""

import json
import os

import pytest
import torch

from single_person_pose_estimation_tpu_torch import Config
from single_person_pose_estimation_tpu_torch.utils import export
from torch_port_fixtures import images, random_variables, torch_model

SMALL = dict(image_height=64, image_width=64, label_height=16,
             label_width=16, hg_num_stacks=1, hg_num_channels=16,
             compute_dtype="float32")
TOL_PROGRAM = 1e-5


@pytest.fixture(scope="module")
def model():
    return torch_model(random_variables(1, 16, seed=21), 1, 16)


def test_exported_program_matches_the_model(tmp_path, model):
    cfg = Config(**SMALL)
    out = export.export_savedmodel(cfg, model, str(tmp_path),
                                   device="cpu")
    assert out == str(tmp_path / "model.pt2")
    assert sorted(os.listdir(tmp_path)) == ["config.json", "model.pt2"]
    assert json.loads((tmp_path / "config.json").read_text())[
        "hg_num_channels"] == 16
    program = export.load_exported(str(tmp_path))
    for b in (1, 5):                     # one program, two batch sizes
        x = torch.from_numpy(images(b, seed=24 + b))
        with torch.no_grad():
            want = model(x)[-1]
            got = program(x)
        assert got.shape == (b, 16, 16, 17)
        assert (got - want).abs().max().item() <= TOL_PROGRAM

