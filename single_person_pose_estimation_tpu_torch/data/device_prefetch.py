"""Double-buffered host -> device batch prefetch.

The counterpart of the JAX package's `data/device_prefetch.py`. A
background thread pulls batch N+1 from the host iterator and starts its
copy to the device while the device runs step N, so the step loop
dispatches against device-resident batches. On CUDA the producer copies
each array into pinned host memory and then to the card with
`non_blocking=True` on a side stream, and records an event; the consumer's
stream waits on that event before it uses the batch. On the CPU the
"copy" is `torch.from_numpy`.

`Prefetcher` is the port's own copy of the JAX package's
`data/pipeline.py::_Prefetcher` (background thread, bounded queue, errors
re-raised at the consumer, clean close), without its JAX-free but
pipeline-bound home module.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np
import torch


class Prefetcher:
    """Run an iterator on a background thread with a bounded queue.

    `map_fn` (optional) is applied to each item ON the producer thread. A
    producer exception re-raises at the consumer's next(); `on_stop` runs
    on the producer thread when it exits (the thread that owns the source
    iterator)."""

    _SENTINEL = object()

    def __init__(self, it: Iterator, depth: int = 2,
                 on_stop: Optional[Callable] = None,
                 map_fn: Optional[Callable] = None,
                 name: Optional[str] = None):
        if depth < 1:
            raise ValueError(f"depth must be >= 1: {depth}")
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._on_stop = on_stop
        self._map = map_fn
        self._thread = threading.Thread(target=self._run, args=(it,),
                                        daemon=True, name=name)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _run(self, it):
        try:
            while not self._stop.is_set():
                try:
                    item = next(it)
                except StopIteration:
                    break
                if self._map is not None:
                    item = self._map(item)
                if not self._put(item):
                    break
        except BaseException as e:  # re-raised at the consumer's next()
            self._error = e
        finally:
            self._put(self._SENTINEL)
            if self._on_stop is not None:
                self._on_stop()

    def close(self) -> None:
        self._stop.set()
        try:
            self._q.put_nowait(self._SENTINEL)
        except queue.Full:
            pass
        self._thread.join(timeout=5.0)

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            try:
                item = self._q.get(timeout=0.5)
                break
            except queue.Empty:
                if not self._thread.is_alive() and self._q.empty():
                    item = self._SENTINEL
                    break
        if item is self._SENTINEL:
            self._stop.set()
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item


class DevicePrefetcher(Prefetcher):
    """Wrap an iterator of dicts of numpy arrays; yield dicts of tensors on
    `device`. depth 2 is classic double buffering."""

    def __init__(self, it: Iterator, device, depth: int = 2,
                 on_stop: Optional[Callable] = None):
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        super().__init__(it, depth=depth, on_stop=on_stop, map_fn=self._copy)

    def _copy(self, batch):
        host = {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in batch.items()}
        if not self._cuda:
            return host, None
        with torch.cuda.stream(self._stream):
            out = {k: v.pin_memory().to(self.device, non_blocking=True)
                   for k, v in host.items()}
            done = torch.cuda.Event()
            done.record(self._stream)
        return out, done

    def __next__(self):
        batch, done = super().__next__()
        if done is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            for t in batch.values():
                # Allocated on the side stream, used on this one: keep the
                # caching allocator from reusing it too early.
                t.record_stream(stream)
        return batch


def device_prefetch(it: Iterator, device=None, depth: int = 2,
                    mesh=None) -> DevicePrefetcher:
    """The Trainer's prefetcher: closes the source iterator when done.
    With a data-parallel `mesh` (one process per device) each rank's
    batches go to its own device, `mesh.device` (cuda:LOCAL_RANK under
    torchrun); `device` must then be None or that device."""
    if mesh is not None:
        if device is not None and torch.device(device) != mesh.device:
            raise ValueError(f"device {device} is not this rank's mesh "
                             f"device {mesh.device}")
        device = mesh.device
    if device is None:
        raise ValueError("device_prefetch needs a device or a mesh")
    return DevicePrefetcher(it, device, depth=depth,
                            on_stop=getattr(it, "close", None))
