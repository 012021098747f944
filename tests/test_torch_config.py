"""The port's own copy of `Config` against the JAX package's: the same
fields and defaults, the same JSON, the same validation."""

import dataclasses

import pytest

from single_person_pose_estimation_tpu.configs import default_config as jcfg
from single_person_pose_estimation_tpu_torch import Config
from single_person_pose_estimation_tpu_torch.configs import default_config as tcfg


def test_same_fields_defaults_and_json():
    jf = [(f.name, f.default) for f in dataclasses.fields(jcfg.Config)]
    tf = [(f.name, f.default) for f in dataclasses.fields(Config)]
    assert tf == jf
    assert Config().to_json() == jcfg.Config().to_json()
    cfg = Config.from_json(jcfg.Config(hg_num_stacks=4).to_json())
    assert cfg == Config(hg_num_stacks=4) and hash(cfg) == hash(
        Config(hg_num_stacks=4))
    assert cfg.flip_pairs == jcfg.COCO_INDEX_FLIP_PAIRS
    assert tcfg.COCO_SKELETON == jcfg.COCO_SKELETON
    assert cfg.checkpoints_path == jcfg.Config().checkpoints_path


def test_same_validation():
    with pytest.raises(ValueError, match="compute_dtype"):
        Config(compute_dtype="bf16")
    with pytest.raises(TypeError):
        Config.from_json('{"bogus": 1}')
    with pytest.raises(dataclasses.FrozenInstanceError):
        Config().batch_size = 4
    assert Config().replace(batch_size=4).batch_size == 4
