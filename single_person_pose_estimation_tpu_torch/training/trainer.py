"""Trainer: epoch loop, validation, checkpointing, resume.

The counterpart of the JAX package's `training/trainer.py`, with the same
API (reference trainer.py:19-245): ``Trainer(model, ds_builder, epochs,
learning_rate, loss_str, config)``, ``.train()``, ``.resume_training()``,
``.get_best_weights_model()``, ``.get_latest_weights_model()`` (also under
the reference's spelling ``get_lattest_weights_model``),
``.get_loss_from_string()`` and the ``epoch_callback`` hook. Steps come
from training/steps.py and checkpoints from training/checkpoint.py (the
full state: params, BN statistics, Adam moments and the generator survive
a resume).

Epoch accounting as the reference's: steps_per_epoch = num_train // batch,
valid_steps = num_valid // batch (at least 1 each). The best-val-loss
checkpoint is promoted across sessions. Each epoch appends to
`metrics.jsonl`; each session writes `log_E{epochs}_lr{lr}.csv`.

`model` is the port's `StackedHourglass` with its weights; the trainer
moves it to `device`. `ds_builder` is any object with `build_datasets()`
(two iterators of numpy batches), `num_train_examples` and
`num_valid_examples`: the TFRecord `data/pipeline.py::DatasetBuilder`, or
`data/in_memory.py::ArrayDatasetBuilder` for crops held in memory.

Data parallel (`mesh=`, one process per device; see parallel/mesh.py):
every rank builds a Trainer over its own data, `DatasetBuilder(...,
process_index, process_count)`, whose `config.batch_size` is the rank's
share of the global batch. The model is trained on the rank's
`mesh.device`, starts from rank 0's weights (broadcast), and takes the
same number of steps an epoch on every rank (the fewest any rank's data
gives); a short last batch of a pass is skipped, so every step has
`batch_size` rows on every rank. The train step all-reduces the BN sums
and the gradients (training/steps.py); validation means are combined by
example count (`parallel.distributed.aggregate_metrics`), so every rank
promotes the same best checkpoint. Rank 0 writes the checkpoints and
every rank restores them.

Tensor parallel (`model_axis="model"` on a ("data", "model") mesh, as in
the JAX package): after the broadcast the state is sharded
(`parallel.sharding_rules.shard_state`), so each rank holds its slice of
every split parameter, Adam moment and EMA leaf; the ranks of a model
group must read the same rows (`DatasetBuilder(..., mesh.data_index,
mesh.data_size)`). Checkpoints hold the full state (training/
checkpoint.py), so they resume with or without tensor parallelism.
"""

from __future__ import annotations

import time
from datetime import date, timedelta
from typing import Dict, Optional

import torch
import torch.distributed as dist

from single_person_pose_estimation_tpu_torch import losses as losses_lib
from single_person_pose_estimation_tpu_torch.configs.default_config import Config
from single_person_pose_estimation_tpu_torch.data.device_prefetch import (
    device_prefetch,
)
from single_person_pose_estimation_tpu_torch.parallel.distributed import (
    aggregate_metrics,
)
from single_person_pose_estimation_tpu_torch.parallel.sharding_rules import (
    shard_state,
)
from single_person_pose_estimation_tpu_torch.training import metrics as metrics_lib
from single_person_pose_estimation_tpu_torch.training import steps as steps_lib
from single_person_pose_estimation_tpu_torch.training.checkpoint import (
    CheckpointManager,
)


def _mean_metrics(collected) -> Dict[str, float]:
    """Average a list of on-device metric dicts with one copy to the
    host."""
    keys = list(collected[0])
    means = torch.stack([torch.stack([m[k] for m in collected]).mean()
                         for k in keys]).cpu()
    return {k: float(v) for k, v in zip(keys, means)}


class Trainer:
    def __init__(self, model, ds_builder, epochs: int, learning_rate: float,
                 loss_str: str, config: Config, mesh=None,
                 augment: bool = True, model_axis: Optional[str] = None,
                 bn_mode: str = "batch", accum_steps: int = 1,
                 lr_schedule: Optional[str] = None, warmup_steps: int = 0,
                 ema_decay: Optional[float] = None, device="cuda"):
        steps_lib.check_model_axis(mesh, model_axis)
        steps_lib.mesh_group(mesh)
        self.mesh = mesh
        # The whole process group: the ranks agree on the epoch length, the
        # weights, the validation metrics and the checkpoints over it.
        self.group = None if mesh is None else mesh.group
        if mesh is not None:
            device = mesh.device
        self.device = steps_lib.resolve_device(device)
        self.model = model
        self.config = config
        self.epochs = epochs
        self.learning_rate = learning_rate
        self.loss_fn = losses_lib.get_loss_from_string(loss_str)
        self.loss_str = loss_str
        self.ds_builder = ds_builder
        host_train, host_valid = ds_builder.build_datasets()
        # Batch N+1 is copied to the device while step N runs; the
        # validation prefetcher is built on first use, so it does not hold
        # device batches and a thread through the training epochs.
        self.ds_train = device_prefetch(host_train, self.device)
        self._host_valid = host_valid
        self._ds_valid = None
        self.steps_per_epoch = max(1, ds_builder.num_train_examples
                                   // config.batch_size)
        self.valid_steps = max(1, ds_builder.num_valid_examples
                               // config.batch_size)
        self.batch_size = config.batch_size
        if self.group is not None:
            if ds_builder.num_train_examples < config.batch_size:
                raise ValueError(
                    f"{ds_builder.num_train_examples} train examples on "
                    f"rank {mesh.rank} fill no batch of {config.batch_size}")
            agreed = torch.tensor([self.steps_per_epoch], device=self.device)
            dist.all_reduce(agreed, op=dist.ReduceOp.MIN, group=self.group)
            self.steps_per_epoch = int(agreed.item())
            model.to(self.device)
            with torch.no_grad():
                for t in [*model.parameters(), *model.buffers()]:
                    dist.broadcast(t, src=0, group=self.group)

        self.ema_decay = ema_decay
        self.lr_schedule = lr_schedule
        self.warmup_steps = warmup_steps
        total = epochs * self.steps_per_epoch
        self.state = steps_lib.TrainState.create(
            model, lambda m: steps_lib.make_optimizer(
                m, learning_rate, schedule=lr_schedule, total_steps=total,
                warmup_steps=warmup_steps, ema_decay=ema_decay),
            seed=config.seed, device=self.device)
        self.state = shard_state(self.state, mesh, model_axis)
        self.train_step = steps_lib.make_train_step(
            self.loss_fn, config, augment=augment, bn_mode=bn_mode,
            accum_steps=accum_steps, mesh=mesh, model_axis=model_axis)
        self.eval_step = steps_lib.make_eval_step(self.loss_fn, config,
                                                  mesh=mesh,
                                                  model_axis=model_axis)

        self.ckpt = CheckpointManager(config.checkpoints_path,
                                      group=self.group)
        self.logger = metrics_lib.HistoryLogger(config.logs_path)
        self.num_stacks = model.num_stacks
        # Called with the 1-based epoch number after each epoch, once its
        # checkpoint is saved (reference trainer.py:132, :205-206).
        self.epoch_callback = None

    # ------------------------------------------------------------------

    @property
    def ds_valid(self):
        if self._ds_valid is None:
            self._ds_valid = device_prefetch(self._host_valid, self.device)
        return self._ds_valid

    def _run_epoch(self) -> Dict[str, float]:
        collected = []
        t0 = time.time()
        n_images = 0
        for _ in range(self.steps_per_epoch):
            batch = next(self.ds_train)
            while (self.group is not None
                   and batch["image"].shape[0] != self.batch_size):
                batch = next(self.ds_train)     # a pass's short last batch
            n_images += batch["image"].shape[0]
            self.state, m = self.train_step(self.state, batch)
            collected.append(m)
        train_metrics = _mean_metrics(collected)  # waits for the device
        dt = time.time() - t0
        train_metrics["_step_time_s"] = dt / self.steps_per_epoch
        train_metrics["_images_per_sec"] = n_images / dt
        return train_metrics

    def _run_validation(self) -> Dict[str, float]:
        collected, n = [], 0
        for _ in range(self.valid_steps):
            batch = next(self.ds_valid)
            n += batch["image"].shape[0]
            collected.append(self.eval_step(self.state, batch))
        metrics = _mean_metrics(collected)
        if self.group is None:
            return metrics
        # Every rank must see the same val metrics: the best-checkpoint
        # promotion below must not diverge across the ranks.
        return aggregate_metrics(metrics, weight=n, group=self.group)

    def _fit(self, initial_epoch: int, final_epoch: int) -> None:
        for epoch in range(initial_epoch, final_epoch):
            train_m = self._run_epoch()
            val_m = self._run_validation()
            row = metrics_lib.stack_metric_columns(train_m, val_m,
                                                   self.num_stacks)
            self.logger.log_epoch(
                epoch + 1, row,
                step_time_s=train_m["_step_time_s"],
                images_per_sec=train_m["_images_per_sec"])
            print(f"Epoch {epoch + 1}/{final_epoch} - "
                  f"loss: {row['loss']:.4f} - val_loss: {row['val_loss']:.4f}"
                  f" - lr: {self.learning_rate} - "
                  f"{train_m['_images_per_sec']:.1f} img/s")
            meta = {"epoch": epoch + 1, "loss_str": self.loss_str,
                    "learning_rate": self.learning_rate,
                    "lr_schedule": self.lr_schedule,
                    "warmup_steps": self.warmup_steps}
            if self.ema_decay is not None:
                meta["ema_decay"] = self.ema_decay
            if (epoch + 1) % self.config.checkpoint_every_epochs == 0 \
                    or epoch + 1 == final_epoch:
                self.ckpt.save(epoch + 1, self.state, meta)
            self.ckpt.maybe_promote_best(row["val_loss"], self.state, meta)
            if self.epoch_callback is not None:
                self.epoch_callback(epoch + 1)

    # ------------------------------------------------------------------

    def train(self) -> None:
        """First training session (reference train(), trainer.py:34-71)."""
        today = date.today().strftime("%d-%m-%Y")
        print(f"First training with:\n"
              f"  1. Current date {today}.\n"
              f"  2. Number of epochs {self.epochs}.\n"
              f"  3. Batch size {self.batch_size}.\n"
              f"  4. Loss {self.loss_str}, Adam lr {self.learning_rate}.")
        start = time.time()
        self._fit(0, self.epochs)
        self.ckpt.wait()
        self.logger.write_session_csv(self.epochs, self.learning_rate)
        print("-" * 57)
        print(f"Finished training!!\n"
              f"  Total training time "
              f"{timedelta(seconds=time.time() - start)}\n"
              f"  Checkpoints at {self.config.checkpoints_path}\n"
              f"  Logs at {self.config.logs_path}")

    def resume_training(self) -> None:
        """Resume from the latest checkpoint, restoring the full state
        (params, BN statistics, Adam moments, schedule count, generator);
        afterwards the best checkpoint is promoted if this session improved
        val_loss (reference resume_training(), trainer.py:73-178)."""
        prev_epoch = self.ckpt.latest_epoch()
        if prev_epoch is None:
            raise FileNotFoundError(
                f"no checkpoint to resume in {self.config.checkpoints_path}")
        self._check_resume_ema()
        print(f"Loading state from epoch {prev_epoch}")
        self.state, _ = self.ckpt.restore(self.state)

        rows = metrics_lib.read_all_session_logs(self.config.logs_path)
        if rows:
            print("-" * 57)
            print(f"- Result from last session at epoch {prev_epoch}:")
            for k, v in rows[-1].items():
                print(f"  {k}: {v}")
            best, best_epoch = metrics_lib.best_val_loss(rows)
            print(f"- Best val_loss so far {best} at epoch {best_epoch}")
            print("-" * 57)

        total_epochs = self.epochs + prev_epoch
        print(f"Resume training for {self.epochs} epochs, "
              f"from epoch {prev_epoch} to epoch {total_epochs}.")
        start = time.time()
        self._fit(prev_epoch, total_epochs)
        self.ckpt.wait()
        self.logger.write_session_csv(total_epochs, self.learning_rate)
        self.epochs = total_epochs
        print(f"Finished training!! Total time "
              f"{timedelta(seconds=time.time() - start)}")

    def _check_resume_ema(self) -> None:
        """Fail a resume whose optimizer state cannot fit with a clear
        message: only the presence of an EMA shapes it here (a schedule is
        a function of the saved count)."""
        meta = self.ckpt.read_meta()
        if meta is None or "lr_schedule" not in meta:
            return
        ckpt_ema = meta.get("ema_decay") is not None
        if ckpt_ema != (self.ema_decay is not None):
            raise ValueError(
                f"cannot resume: the checkpoint "
                f"{'tracks' if ckpt_ema else 'does not track'} an EMA "
                f"(ema_decay={meta.get('ema_decay')}) but this Trainer was "
                f"built with ema_decay={self.ema_decay}")

    # ------------------------------------------------------------------

    def get_best_weights_model(self):
        """Restore the best-val-loss state. Returns (model, state)."""
        self.state, _ = self.ckpt.restore_best(self.state)
        return self.model, self.state

    def get_latest_weights_model(self):
        """Restore the most recent checkpoint. Returns (model, state)."""
        self.state, _ = self.ckpt.restore(self.state)
        return self.model, self.state

    # The reference's spelling (reference trainer.py:326).
    get_lattest_weights_model = get_latest_weights_model

    @staticmethod
    def get_loss_from_string(loss_str: str):
        return losses_lib.get_loss_from_string(loss_str)

    def get_ema_params(self):
        """Polyak-averaged params (requires Trainer(ema_decay=...))."""
        return steps_lib.get_ema_params(self.state.optimizer)

    def close(self) -> None:
        self.ds_train.close()
        if self._ds_valid is not None:
            self._ds_valid.close()
        else:
            self._host_valid.close()
        self.ckpt.close()
        self.logger.close()
