"""The port's Trainer on the CPU: two epochs, then a resume in a new
Trainer; epoch accounting, best-val promotion across sessions, the full
state a checkpoint brings back, and the metrics files, which the JAX
package's own `training/metrics.py` reads with the columns its
`stack_metric_columns` makes. Also the CheckpointManager's pruning and the
device prefetcher."""

import csv
import json
import os

import numpy as np
import pytest
import torch

from single_person_pose_estimation_tpu.training import metrics as jmetrics
from single_person_pose_estimation_tpu_torch import Config, losses
from single_person_pose_estimation_tpu_torch.data.device_prefetch import (
    DevicePrefetcher,
)
from single_person_pose_estimation_tpu_torch.data.in_memory import (
    ArrayDatasetBuilder,
    synthetic_crops,
)
from single_person_pose_estimation_tpu_torch.parallel.mesh import create_mesh
from single_person_pose_estimation_tpu_torch.training.checkpoint import (
    CheckpointManager,
)
from single_person_pose_estimation_tpu_torch.training.trainer import Trainer
from torch_port_fixtures import random_variables, torch_model

B = 2


def _cfg(tmp_path):
    return Config(image_height=64, image_width=64, label_height=16,
                  label_width=16, hg_num_stacks=1, hg_num_channels=16,
                  batch_size=B, compute_dtype="float32",
                  temporary_dir=str(tmp_path))


def _builder(**kw):
    return ArrayDatasetBuilder(synthetic_crops(5, 64, label_size=16, seed=0),
                               synthetic_crops(3, 64, label_size=16, seed=1),
                               B, **kw)


def _trainer(tmp_path, epochs, seed=0, **kw):
    model = torch_model(random_variables(1, 16, seed=seed), 1, 16)
    return Trainer(model, _builder(), epochs, 1e-3, "weighted_mse",
                   _cfg(tmp_path), device="cpu", **kw)


def _state_tensors(state):
    """Params, BN statistics, Adam moments, generator state."""
    out = {f"model.{k}": v.clone()
           for k, v in state.model.state_dict().items()}
    for i, st in state.optimizer.state_dict()["adam"]["state"].items():
        out.update({f"adam.{i}.{k}": v.clone() for k, v in st.items()})
    out["generator"] = state.generator.get_state()
    return out


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two epochs, then a one-epoch resume in a new Trainer."""
    tmp = tmp_path_factory.mktemp("trainer")
    first = _trainer(tmp, 2)
    first.epochs_seen = []
    first.epoch_callback = first.epochs_seen.append
    first.train()
    saved = _state_tensors(first.state)
    first.close()
    second = _trainer(tmp, 1, seed=5)
    second.epochs_seen = []
    second.epoch_callback = second.epochs_seen.append
    before = _state_tensors(second.state)
    second.ckpt.restore(second.state)
    restored = _state_tensors(second.state)
    second.resume_training()
    second.close()
    return tmp, first, second, saved, before, restored


def test_epoch_accounting_and_steps(trained):
    _, first, second, _, _, _ = trained
    # num_train // batch and num_valid // batch, as the reference counts.
    assert (first.steps_per_epoch, first.valid_steps) == (2, 1)
    assert first.state.step == 4 and second.state.step == 6
    assert second.epochs == 3 and second.ckpt.latest_epoch() == 3


def test_epoch_callback_gets_each_1_based_epoch(trained):
    """Called once per epoch, after its checkpoint, in train() and in
    resume_training() (reference trainer.py:205-206)."""
    _, first, second, _, _, _ = trained
    assert first.epochs_seen == [1, 2]
    assert second.epochs_seen == [3]


def test_reference_names_on_the_trainer(trained):
    _, _, second, _, _, _ = trained
    assert Trainer.get_lattest_weights_model is \
        Trainer.get_latest_weights_model
    model, state = second.get_lattest_weights_model()
    assert model is second.model and state.step == 6
    assert Trainer.get_loss_from_string("weighted_mse") is \
        losses.get_loss_from_string("weighted_mse")
    with pytest.raises(ValueError, match="Unknown loss"):
        Trainer.get_loss_from_string("bogus")


def test_resume_restores_the_full_state(trained):
    _, _, _, saved, before, restored = trained
    assert saved.keys() == restored.keys()
    for k in saved:
        assert torch.equal(saved[k], restored[k]), k
    # The new Trainer started elsewhere: the restore did the work.
    assert not torch.equal(before["model.front_conv_1x1_1.weight"],
                           saved["model.front_conv_1x1_1.weight"])
    assert not torch.equal(before["generator"], saved["generator"])


def test_metrics_files_match_the_jax_format(trained):
    tmp, first, _, _, _, _ = trained
    logs = os.path.join(tmp, "logs")
    assert sorted(f for f in os.listdir(logs) if f.endswith(".csv")) == [
        "log_E2_lr0.001.csv", "log_E3_lr0.001.csv"]
    rows = jmetrics.read_all_session_logs(logs)
    assert len(rows) == 2 + 1           # each session writes its own epochs
    want_cols = list(jmetrics.stack_metric_columns(
        {"loss": 0, "loss/hg0": 0}, {"loss": 0, "loss/hg0": 0}, 1))
    with open(os.path.join(logs, "log_E2_lr0.001.csv")) as f:
        assert next(csv.reader(f)) == [""] + want_cols
    assert all(np.isfinite(v) for r in rows for v in r.values())
    with open(os.path.join(logs, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["epoch"] for r in recs] == [1, 2, 3]
    assert all(r["images_per_sec"] > 0 for r in recs)


def test_best_checkpoint_tracks_the_lowest_val_loss(trained):
    tmp, first, second, _, _, _ = trained
    rows = jmetrics.read_all_session_logs(os.path.join(tmp, "logs"))
    best, best_epoch = jmetrics.best_val_loss(rows)
    meta = second.ckpt.best_meta()
    assert meta["epoch"] == best_epoch
    np.testing.assert_allclose(meta["val_loss"], best, rtol=1e-6)
    model, state = second.get_best_weights_model()
    assert model is second.model and state.step == 2 * best_epoch


def test_resume_errors(tmp_path):
    fresh = _trainer(tmp_path, 1)
    with pytest.raises(FileNotFoundError):
        fresh.resume_training()
    fresh.train()
    fresh.close()
    ema = _trainer(tmp_path, 1, ema_decay=0.9)
    with pytest.raises(ValueError, match="EMA"):
        ema.resume_training()
    ema.close()
    with pytest.raises(ValueError, match="model_axis requires a mesh"):
        _trainer(tmp_path, 1, model_axis="model")
    with pytest.raises(ValueError, match="one process per device"):
        _trainer(tmp_path, 1, mesh=create_mesh(devices=["cpu"] * 2))


def test_checkpoint_manager_keeps_max_to_keep(tmp_path):
    trainer = _trainer(tmp_path, 1)
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    for epoch in (1, 2, 3):
        mgr.save(epoch, trainer.state, {"epoch": epoch})
    assert sorted(os.listdir(tmp_path / "ck" / "latest")) == ["2", "3"]
    assert mgr.read_meta() == {"epoch": 3}
    assert mgr.read_meta(epoch=2) == {"epoch": 2}
    assert mgr.maybe_promote_best(1.0, trainer.state, {"epoch": 1})
    assert not mgr.maybe_promote_best(2.0, trainer.state, {"epoch": 2})
    assert mgr.best_meta() == {"epoch": 1, "val_loss": 1.0}
    trainer.close()


def test_device_prefetcher_cpu_and_errors():
    src = iter([{"image": np.full((2, 3), i, np.float32)} for i in range(3)])
    pf = DevicePrefetcher(src, "cpu")
    got = [b["image"][0, 0].item() for b in pf]
    assert got == [0.0, 1.0, 2.0]

    def broken():
        yield {"image": np.zeros(1)}
        raise OSError("corrupt record")

    pf = DevicePrefetcher(broken(), "cpu")
    next(pf)
    with pytest.raises(OSError, match="corrupt"):
        next(pf)
    pf.close()


def test_uint8_builder_quantises_on_the_host():
    train, _ = _builder(transfer_dtype="uint8").build_datasets()
    batch = next(train)
    assert batch["image"].dtype == np.uint8 and batch["kv"].dtype == np.int32
