"""The port's record `DatasetBuilder` against the JAX package's on the same
records and seed: train and valid batches in their shuffled and ordered
orders, on the float32 and the uint8 wire, and every image and meta field
of `get_ds_prediction`, also for records written with `record_image_size`
(exact). Then `close()` joins the threads of its own builder, and
`Trainer` trains from the builder."""

import math
import shutil
import threading

import numpy as np
import pytest

from single_person_pose_estimation_tpu.configs.default_config import (
    Config as JConfig,
)
from single_person_pose_estimation_tpu.data import pipeline as jpipe
from single_person_pose_estimation_tpu_torch import Config
from single_person_pose_estimation_tpu_torch.data import coco, pipeline
from single_person_pose_estimation_tpu_torch.training.trainer import Trainer
from test_data import make_synthetic_coco
from torch_port_fixtures import random_variables, torch_model

SMALL = dict(image_height=64, image_width=64, label_height=16,
             label_width=16, batch_size=4, shuffle_buffer=8, host_workers=2,
             num_examples_per_record=4, seed=3)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """Dataset roots with records at the full crop size and pre-resized to
    48 px (record_image_size): {size: root}."""
    base = tmp_path_factory.mktemp("pipeline")
    src = str(base / "src")
    make_synthetic_coco(src, "train2017", n_images=3, people_per=2)
    make_synthetic_coco(src, "val2017", n_images=3, people_per=1)
    out = {}
    for size in (0, 48):
        root = str(base / f"r{size}")
        shutil.copytree(src, root)
        coco.gen_trainval_records(Config(dataset_dir=root,
                                         record_image_size=size, **SMALL))
        out[size] = root
    return out


def _configs(root, **kw):
    args = dict(SMALL, dataset_dir=root, **kw)
    return JConfig(**args), Config(**args)


def _assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b


@pytest.mark.parametrize("wire", ["float32", "uint8"])
def test_train_and_valid_batches_match_jax(roots, wire):
    jcfg, tcfg = _configs(roots[0], train_transfer_dtype=wire)
    jb, tb = jpipe.DatasetBuilder(jcfg), pipeline.DatasetBuilder(tcfg)
    assert (tb.num_train_examples, tb.num_valid_examples) == \
        (jb.num_train_examples, jb.num_valid_examples) == (6, 3)
    jits = jb.build_datasets()
    with tb:
        tits = tb.build_datasets()
        # 5 train batches cross two epoch ends (6 examples, batch 4).
        for jit, tit, n in zip(jits, tits, (5, 3)):
            for _ in range(n):
                got = next(tit)
                _assert_same(next(jit), got)
            # The wire applies to the training split only.
            assert got["image"].dtype == np.dtype(
                wire if tit is tits[0] else "float32")
    for it in jits:
        it.close()


@pytest.mark.parametrize("size,wire", [(0, "float32"), (48, "float32"),
                                       (0, "uint8")])
def test_prediction_batches_and_metas_match_jax(roots, size, wire):
    jcfg, tcfg = _configs(roots[size], eval_transfer_dtype=wire,
                          record_image_size=size)
    want = list(jpipe.DatasetBuilder(jcfg).get_ds_prediction())
    with pipeline.DatasetBuilder(tcfg) as tb:
        got = list(tb.get_ds_prediction())
    assert [len(m) for _, m in got] == [3]
    _assert_same(want, got)
    meta = got[0][1][0]
    if size:
        # Pre-resized records: keypoints in the 48 px frame, un-cropped by
        # the true square side recovered from the original bbox.
        assert (meta["frame_w"], meta["frame_h"]) == (48, 48)
        side = int(max(meta["original_bbox"][2:]) * tcfg.bbox_scale)
        assert meta["bbox_w"] == meta["bbox_h"] == side != 48


def test_close_joins_this_builders_threads(roots):
    _, tcfg = _configs(roots[0])
    builder = pipeline.DatasetBuilder(tcfg)
    other = pipeline.DatasetBuilder(tcfg)
    assert builder.thread_prefix != other.thread_prefix

    def mine():
        return [t for t in threading.enumerate()
                if t.name.startswith(builder.thread_prefix) and t.is_alive()]

    train, valid = builder.build_datasets()
    pred = builder.get_ds_prediction()
    next(train), next(valid), next(pred)
    # The endless iterators' batching threads and their decode threads run
    # until closed (the finite prediction pass may have ended by now).
    names = {t.name.rsplit("-", 1)[-1].split("_")[0] for t in mine()}
    assert {"batches", "train", "valid"} <= names, names
    builder.close()
    assert not mine(), [t.name for t in mine()]


def test_trainer_trains_from_records(roots, tmp_path):
    _, cfg = _configs(roots[0], batch_size=2, hg_num_stacks=1,
                      hg_num_channels=16, compute_dtype="float32",
                      temporary_dir=str(tmp_path))
    builder = pipeline.DatasetBuilder(cfg)
    model = torch_model(random_variables(1, 16), 1, 16)
    trainer = Trainer(model, builder, 1, 1e-3, "weighted_mse", cfg,
                      device="cpu")
    try:
        assert trainer.steps_per_epoch == 3 and trainer.valid_steps == 1
        trainer.train()
        rows = trainer.logger.rows
        assert len(rows) == 1 and math.isfinite(rows[0]["loss"]) \
            and math.isfinite(rows[0]["val_loss"])
        assert trainer.state.model is model
    finally:
        trainer.close()
        builder.close()
