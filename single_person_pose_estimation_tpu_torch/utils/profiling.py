"""Profiling and tracing utilities, on `torch.profiler`.

The counterpart of the JAX package's `utils/profiling.py`:

  * `trace(log_dir)` records the host and, when a card is present, the
    device activity of its block with `torch.profiler.profile`, and
    writes it as a Chrome trace (`chrome://tracing`, Perfetto) into
    `log_dir` when the block ends;
  * `annotate(name)` is a named span inside such a trace
    (`torch.profiler.record_function`);
  * `StepTimer` is a step-time and throughput meter that drops the first
    step, where the kernels build and warm up on the card.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator["torch.profiler.profile"]:
    """Capture a trace of the block into `log_dir`. Usage:

        with profiling.trace("/tmp/trace") as prof:
            with profiling.annotate("serve"):
                keypoints = server.predict(images)

    CUDA activity is recorded when `torch.cuda.is_available()`; the block
    is synchronized with the card before the trace closes. Yields the
    profiler (its `key_averages()` and `events()` read the same trace);
    its `trace_path` attribute names the written file once the block
    ends.
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.trace_path = None
    with prof:
        try:
            yield prof
        finally:
            if cuda:
                torch.cuda.synchronize()
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}"
                                 ".pt.trace.json")
    prof.export_chrome_trace(path)
    prof.trace_path = path


def annotate(name: str):
    """Named span that shows up inside profiler traces
    (torch.profiler.record_function)."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Rolling step-time / throughput meter.

    Call `tick(n_items)` once per step; read `.summary()` for
    {mean_step_s, p50, p90, items_per_sec} over the window (the first
    step, where the kernels build and warm up, is excluded).
    """

    def __init__(self, window: int = 100):
        self.window = window
        self._times = []
        self._items = []
        self._last: Optional[float] = None
        self._seen_first = False

    def tick(self, n_items: int = 0) -> None:
        now = time.perf_counter()
        if self._last is not None:
            if self._seen_first:
                self._times.append(now - self._last)
                self._items.append(n_items)
                if len(self._times) > self.window:
                    self._times.pop(0)
                    self._items.pop(0)
            else:
                self._seen_first = True  # drop the warm-up step
        self._last = now

    def summary(self) -> Dict[str, float]:
        if not self._times:
            return {}
        ts = sorted(self._times)
        total_t = sum(self._times)
        return {
            "mean_step_s": total_t / len(ts),
            "p50_step_s": ts[len(ts) // 2],
            "p90_step_s": ts[int(len(ts) * 0.9)],
            "items_per_sec": (sum(self._items) / total_t) if total_t else 0.0,
        }
