"""The port's `training/auto_resume.py` and `utils/profiling.py` on the
CPU: `FaultInjector` raises on the same calls as the JAX package's;
`train_with_auto_resume` on a tiny port `Trainer` with one injected fault
reaches the target epoch and leaves the same checkpoint epochs as a run
without a fault; `StepTimer` summaries equal JAX's under the same patched
clock; `trace` writes a Chrome trace holding an `annotate` span."""

import glob
import json
import os
import types

import pytest

from single_person_pose_estimation_tpu.training import (
    auto_resume as jauto,
)
from single_person_pose_estimation_tpu.utils import profiling as jprof
from single_person_pose_estimation_tpu_torch import Config
from single_person_pose_estimation_tpu_torch.data.in_memory import (
    ArrayDatasetBuilder,
    synthetic_crops,
)
from single_person_pose_estimation_tpu_torch.training import auto_resume
from single_person_pose_estimation_tpu_torch.training.trainer import Trainer
from single_person_pose_estimation_tpu_torch.utils import profiling
from single_person_pose_estimation_tpu_torch.utils.model_utils import (
    list_checkpoints,
)
from torch_port_fixtures import random_variables, torch_model

B = 2
TARGET = 3


def _raises(injector, epochs):
    out = []
    for e in epochs:
        try:
            injector(e)
            out.append(None)
        except Exception as exc:  # recorded and compared below
            out.append((type(exc).__name__, str(exc)))
    return out


@pytest.mark.parametrize("after,times", [(1, 1), (2, 2), (3, 1), (1, 3)])
def test_fault_injector_raises_on_the_same_calls(after, times):
    epochs = list(range(1, 12))
    got = _raises(auto_resume.FaultInjector(after, times, ValueError),
                  epochs)
    want = _raises(jauto.FaultInjector(after, times, ValueError), epochs)
    assert got == want
    assert sum(r is not None for r in got) == times


def _run(root, fault):
    cfg = Config(image_height=64, image_width=64, label_height=16,
                 label_width=16, hg_num_stacks=1, hg_num_channels=16,
                 batch_size=B, compute_dtype="float32",
                 temporary_dir=str(root))
    injector = auto_resume.FaultInjector(2) if fault else None
    restarts = []

    def make_trainer(epochs):
        model = torch_model(random_variables(1, 16, seed=0), 1, 16)
        builder = ArrayDatasetBuilder(
            synthetic_crops(4, 64, label_size=16, seed=0),
            synthetic_crops(2, 64, label_size=16, seed=1), B)
        t = Trainer(model, builder, epochs, 1e-3, "weighted_mse", cfg,
                    augment=False, device="cpu")
        t.epoch_callback = injector
        return t

    trainer = auto_resume.train_with_auto_resume(
        make_trainer, TARGET, max_restarts=1,
        on_restart=lambda n, e: restarts.append((n, str(e))))
    trainer.close()
    return list_checkpoints(cfg.checkpoints_path), restarts, trainer


def test_auto_resume_after_a_fault_matches_a_clean_run(tmp_path):
    clean, clean_restarts, _ = _run(tmp_path / "clean", fault=False)
    faulty, restarts, trainer = _run(tmp_path / "faulty", fault=True)
    assert clean == faulty == ([1, 2, 3], True)
    assert clean_restarts == []
    assert restarts == [(1, "injected fault after epoch 2 (1/1)")]
    assert trainer.epochs == TARGET
    assert trainer.ckpt.latest_epoch() == TARGET


def test_step_timer_matches_jax_under_a_patched_clock(monkeypatch):
    clock = [0.0, 5.0, 5.5, 5.75, 6.5, 6.625, 7.0, 9.0]
    summaries = []
    for mod in (profiling, jprof):
        it = iter(clock)
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            perf_counter=lambda: next(it)))
        timer = mod.StepTimer(window=4)
        assert timer.summary() == {}
        for n in range(len(clock)):
            timer.tick(n)
        summaries.append(timer.summary())
    assert summaries[0] == summaries[1]
    # The first step (5 s) is dropped; the window keeps the last four.
    assert summaries[0]["mean_step_s"] == (0.75 + 0.125 + 0.375 + 2.0) / 4


def test_trace_writes_a_chrome_trace_with_the_span(tmp_path):
    import torch

    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("serve"):
            torch.ones(64).cumsum(0)
    paths = glob.glob(os.path.join(tmp_path, "*.json"))
    assert paths == [prof.trace_path]
    names = {e.get("name") for e in json.load(open(paths[0]))["traceEvents"]}
    assert "serve" in names
    assert any(e.key == "serve" for e in prof.key_averages())
