"""Checkpoint discovery and model-loading helpers.

The port's counterpart of the JAX package's `utils/model_utils.py`
(reference utilities/model_utils.py: `compile_model_from_checkpoint`,
lines 5-21, and `get_epochs_from_ckpt_path`, lines 23-44), on the port's
own checkpoint format (`training/checkpoint.py`): a checkpoint is a
(state, meta) pair under <ckpt_dir>/latest/<epoch>/ or <ckpt_dir>/best/0/.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

from single_person_pose_estimation_tpu_torch.training import (
    steps as steps_lib,
)
from single_person_pose_estimation_tpu_torch.training.checkpoint import (
    CheckpointManager,
)


def load_model_from_checkpoint(model, ckpt_dir: str,
                               epoch: Optional[int] = None,
                               best: bool = False,
                               learning_rate: float = 1e-3,
                               ema_decay: Optional[float] = None,
                               device="cuda"):
    """Build a TrainState around `model` on `device` and restore it from
    `ckpt_dir`, in place: the params and BN statistics, the optimizer's
    Adam moments, schedule count and EMA, the step and the generator.

    best=True restores the best-val-loss checkpoint; otherwise `epoch`
    (default latest). Returns (state, meta).

    The optimizer extras a Trainer used (lr schedule, warmup, EMA) shape
    the optimizer state; the checkpoint's meta records them, so this reads
    the meta first and builds a matching optimizer: checkpoints from any
    Trainer configuration load without the caller knowing how they were
    trained. `ema_decay` overrides the meta (for checkpoints whose meta
    lacks it); its value only decides whether an EMA is tracked.
    """
    mgr = CheckpointManager(ckpt_dir)
    try:
        meta0 = mgr.read_meta(epoch=epoch, best=best) or {}
        if ema_decay is None:
            ema_decay = meta0.get("ema_decay")
        warmup = meta0.get("warmup_steps", 0) or 0
        state = steps_lib.TrainState.create(
            model, lambda m: steps_lib.make_optimizer(
                m, learning_rate, schedule=meta0.get("lr_schedule"),
                # The meta does not record the schedule's length: a cosine
                # schedule rebuilt here ends right after the warmup. This
                # state is for evaluation; Trainer.resume_training builds
                # its own optimizer.
                total_steps=warmup + 1, warmup_steps=warmup,
                ema_decay=ema_decay),
            device=device)
        if best:
            return mgr.restore_best(state)
        return mgr.restore(state, epoch=epoch)
    finally:
        mgr.close()


def list_checkpoints(ckpt_dir: str) -> Tuple[List[int], bool]:
    """(available epochs sorted ascending, best-exists): the sweep-eval
    enumeration of the reference's get_epochs_from_ckpt_path
    (model_utils.py:23-44)."""
    epochs: List[int] = []
    latest_dir = os.path.join(ckpt_dir, "latest")
    if os.path.isdir(latest_dir):
        for name in os.listdir(latest_dir):
            if name.isdigit():
                epochs.append(int(name))
    best = os.path.isdir(os.path.join(ckpt_dir, "best", "0"))
    return sorted(epochs), best
