"""Checkpoints of the full training state, with `torch.save`.

The counterpart of the JAX package's Orbax `training/checkpoint.py`, with
the same methods. A checkpoint holds the params and BN statistics (the
model's `state_dict`), the optimizer's state (Adam moments, schedule count,
EMA), the step count, the generator's state and a metadata dict:

    <ckpt_dir>/latest/<epoch>/{state.pt, meta.json}   rolling, max_to_keep
    <ckpt_dir>/best/0/{state.pt, meta.json}           lowest val_loss seen

Each checkpoint is written into a temporary directory and renamed into
place, so a reader never sees half of one. Saves are synchronous, so
`wait` has nothing to wait for (the JAX package's Orbax saves may run in
the background).

Data parallel (`group=`, one process per device): the ranks hold the same
state, so rank 0 alone writes, and every save ends in a barrier; the
directory must be one that every rank reads (one host, or a shared file
system). Every rank restores from it.

Tensor parallel (the model sharded by `parallel.sharding_rules`): every
rank gathers each split leaf over its model group before rank 0 writes,
so the file is the one an unsharded run writes, and a restore keeps this
rank's slice of the full state. A checkpoint written under tensor
parallelism restores without it, and the other way round.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from single_person_pose_estimation_tpu_torch.parallel.sharding_rules import (
    map_split_leaves,
)
from single_person_pose_estimation_tpu_torch.training.steps import TrainState

_STATE, _META = "state.pt", "meta.json"


def state_payload(state: TrainState) -> dict:
    """The full state; under tensor parallelism a collective of the model
    group, which gathers every split leaf."""
    payload = {"model": state.model.state_dict(),
               "optimizer": state.optimizer.state_dict(),
               "step": state.step,
               "generator": state.generator.get_state()}
    tp = state.model.tensor_parallel
    if tp is None:
        return payload
    return map_split_leaves(payload, list(state.optimizer.params), tp,
                            tp.gather_list_)


def apply_payload(state: TrainState, payload: dict) -> TrainState:
    """Load a full state; under tensor parallelism this rank keeps its
    slice of every split leaf."""
    tp = state.model.tensor_parallel
    if tp is not None:
        payload = map_split_leaves(payload, list(state.optimizer.params), tp,
                                   tp.local_list)
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    state.generator.set_state(payload["generator"])
    return state


class CheckpointManager:
    """Latest and best checkpoints of a TrainState."""

    def __init__(self, ckpt_dir: str, max_to_keep: int = 3, group=None):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1: {max_to_keep}")
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        self.max_to_keep = max_to_keep
        self._latest = os.path.join(self.ckpt_dir, "latest")
        self._best = os.path.join(self.ckpt_dir, "best")
        self.group = group
        self._writer = group is None or dist.get_rank(group) == 0

    def _barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)

    # -- save ------------------------------------------------------------

    @staticmethod
    def _write(path: str, payload: dict, meta: dict) -> None:
        parent = os.path.dirname(path)
        os.makedirs(parent, exist_ok=True)
        tmp = os.path.join(parent, f".tmp-{os.path.basename(path)}-"
                                   f"{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(payload, os.path.join(tmp, _STATE))
        with open(os.path.join(tmp, _META), "w") as f:
            json.dump(meta, f)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.replace(tmp, path)

    def _epochs(self):
        if not os.path.isdir(self._latest):
            return []
        return sorted(int(d) for d in os.listdir(self._latest) if d.isdigit())

    def save(self, epoch: int, state: TrainState, meta: dict) -> None:
        """Save state and metadata under `epoch`; keep the newest
        max_to_keep. Every rank calls it (module docstring)."""
        payload = state_payload(state)
        if self._writer:
            self._write(os.path.join(self._latest, str(epoch)), payload,
                        meta)
            for old in self._epochs()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self._latest, str(old)))
        self._barrier()

    def save_best(self, state: TrainState, meta: dict) -> None:
        payload = state_payload(state)
        if self._writer:
            self._write(os.path.join(self._best, "0"), payload, meta)
        self._barrier()

    def maybe_promote_best(self, val_loss: float, state: TrainState,
                           meta: dict) -> bool:
        """Promote `state` to best/ iff `val_loss` beats the stored best.
        Returns True when promoted."""
        best_meta = self.best_meta()
        prev = best_meta.get("val_loss") if best_meta else None
        self._barrier()     # every rank has read before rank 0 writes
        if prev is None or val_loss < prev:
            self.save_best(state, {**meta, "val_loss": float(val_loss)})
            return True
        return False

    # -- restore ---------------------------------------------------------

    def latest_epoch(self) -> Optional[int]:
        epochs = self._epochs()
        return epochs[-1] if epochs else None

    @staticmethod
    def _read(path: str, state: TrainState) -> Tuple[TrainState, dict]:
        payload = torch.load(os.path.join(path, _STATE), map_location="cpu",
                             weights_only=True)
        with open(os.path.join(path, _META)) as f:
            meta = json.load(f)
        return apply_payload(state, payload), meta

    def restore(self, state: TrainState, epoch: Optional[int] = None
                ) -> Tuple[TrainState, dict]:
        """Load the checkpoint of `epoch` (default: the latest) into
        `state`, in place. Returns (state, meta)."""
        if epoch is None:
            epoch = self.latest_epoch()
        if epoch is None:
            raise FileNotFoundError(f"no checkpoints in {self.ckpt_dir}")
        return self._read(os.path.join(self._latest, str(epoch)), state)

    def restore_best(self, state: TrainState) -> Tuple[TrainState, dict]:
        path = os.path.join(self._best, "0")
        if not os.path.isdir(path):
            raise FileNotFoundError(f"no best checkpoint in {self.ckpt_dir}")
        return self._read(path, state)

    def read_meta(self, epoch: Optional[int] = None,
                  best: bool = False) -> Optional[dict]:
        """Only the metadata dict of a checkpoint; None if there is none."""
        if best:
            return self.best_meta()
        if epoch is None:
            epoch = self.latest_epoch()
        if epoch is None:
            return None
        with open(os.path.join(self._latest, str(epoch), _META)) as f:
            return json.load(f)

    def best_meta(self) -> Optional[dict]:
        path = os.path.join(self._best, "0", _META)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def wait(self) -> None:
        """Saves are synchronous; nothing is in flight."""

    def close(self) -> None:
        self.wait()
