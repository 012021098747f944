"""Failure recovery: automatic resume-from-latest-checkpoint.

The port's copy of the JAX package's `training/auto_resume.py`
(framework-free). The reference's recovery story is a human re-running
`resume_training()` in Colab after the session dies. Here recovery is
automated: the port's `Trainer` checkpoints its full state
(training/checkpoint.py), and `train_with_auto_resume` wraps its epoch
loop so a crash mid-session restarts from the latest checkpoint, up to a
retry budget. It uses the Trainer's `ckpt` (`latest_epoch`, `wait`),
`train`, `resume_training` and `close`.

`FaultInjector` is the matching *test utility* (not production code): it
raises a chosen exception after N train epochs to exercise the recovery
path deterministically; register it as the Trainer's `epoch_callback`.
"""

from __future__ import annotations

import time
from typing import Callable, Optional


class FaultInjector:
    """Raises `exc_type` after `fail_after_epochs` completed epochs, once
    per configured failure. Register with Trainer via `epoch_callback`."""

    def __init__(self, fail_after_epochs: int, times: int = 1,
                 exc_type=RuntimeError):
        self.fail_after_epochs = fail_after_epochs
        self.times = times
        self.exc_type = exc_type
        self.fired = 0
        self._epochs_seen = 0

    def __call__(self, epoch: int) -> None:
        self._epochs_seen += 1
        if (self.fired < self.times
                and self._epochs_seen >= self.fail_after_epochs):
            self.fired += 1
            self._epochs_seen = 0
            raise self.exc_type(
                f"injected fault after epoch {epoch} "
                f"({self.fired}/{self.times})")


def train_with_auto_resume(make_trainer: Callable[[int], "Trainer"],
                           target_epochs: int,
                           max_restarts: int = 3,
                           backoff_s: float = 0.0,
                           on_restart: Optional[Callable[[int, BaseException],
                                                         None]] = None):
    """Train until `target_epochs` total epochs exist, resuming from the
    latest checkpoint after any failure.

    `make_trainer(remaining_epochs)` must build a FRESH Trainer each
    attempt (the reference's resume contract too: "should be called on a
    newly created instance", trainer.py:75). The first attempt calls
    `.train()`; later attempts `.resume_training()` for the remaining
    epochs. Returns the final trainer.
    """
    restarts = 0
    trainer = None
    while True:
        probe = make_trainer(1)
        done = probe.ckpt.latest_epoch() or 0
        probe.close()
        remaining = target_epochs - done
        if remaining <= 0:
            return trainer if trainer is not None else make_trainer(0)
        trainer = make_trainer(remaining)
        try:
            if done == 0:
                trainer.train()
            else:
                trainer.resume_training()
            return trainer
        except KeyboardInterrupt:
            raise
        except BaseException as e:  # noqa: BLE001 — deliberate: any crash
            trainer.ckpt.wait()
            restarts += 1
            if restarts > max_restarts:
                raise
            if on_restart is not None:
                on_restart(restarts, e)
            if backoff_s:
                time.sleep(backoff_s)
