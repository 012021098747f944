"""Batched pose-estimation serving: a micro-batching queue over the fused
forward and an on-device decode, in PyTorch.

The counterpart of the JAX package's `serving.py` `PoseServer`, with the
same API: callers `submit` single images from any thread and get a Future;
a batcher thread drains the queue, pads each micro-batch to a bucket size
of an ascending ladder, runs one step (forward to the last stack's heatmaps,
then decode) on the device and hands the result to a resolver thread,
which copies it to the host and resolves the futures. The model is the
standard stacked hourglass or the mobile (separable-conv) one; the
forward takes each through its own kernels.

- The batcher admits at most `max_batch` requests per step and waits at
  most `max_wait_s` for stragglers.
- The decode runs on the device (the v2 decode through the CUDA decode
  kernel of `ops/cuda/decode_kernel.py`): the host sees (B, K, 3)
  keypoints, not (B, 64, 64, K) heatmaps.
- `transfer_dtype="uint8"` sends pixels as bytes and normalises to [0, 1]
  on the device, a quarter of the float32 traffic; "bfloat16" halves it
  with rounding-level error; "float32" is exact.
- Dispatch is pipelined: the device runs the step while the resolver
  waits on the previous one (`max_in_flight` bounds the queue between
  them).
- The step runs under `torch.inference_mode()`; a failure in it (a kernel
  that does not launch, a fault found at the copy back) reaches the caller
  through `Future.result()`.

`device` is explicit. `device="cuda"` raises when CUDA is absent; the
tests serve on `device="cpu"`, where the kernels' plain versions run.
With `mesh=` (parallel/mesh.py) the server keeps a replica of the model
on each device of the mesh and splits every step's bucket evenly over
them, as the JAX package's server shards its buckets over the mesh.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from functools import partial
from typing import Sequence

import numpy as np
import torch

from single_person_pose_estimation_tpu_torch.models.fused_inference import (
    auto_use_fused,
    forward_last_stack,
    prepare_fused,
)
from single_person_pose_estimation_tpu_torch.ops.cuda.decode_kernel import (
    decode_batch,
)
from single_person_pose_estimation_tpu_torch.ops.decode import (
    decode_v1_batch,
)
from single_person_pose_estimation_tpu_torch.parallel import mesh as mesh_lib

_WIRE = {"uint8": torch.uint8, "bfloat16": torch.bfloat16,
         "float32": torch.float32}


class PoseServer:
    """Micro-batching inference server for the stacked hourglass.

    Args:
      model: a port StackedHourglass (standard or mobile=True) holding its
        weights; it is moved to `device`.
      device: "cuda", "cuda:N" or "cpu"; required unless `mesh` is given.
      buckets: ascending micro-batch sizes; a batch of n pads to the
        smallest bucket >= n. The largest bucket is max_batch.
      max_wait_s: how long the batcher waits to fill a larger bucket.
      use_fused: route through models.fused_inference.fused_apply (the
        CUDA kernels). "auto" = CUDA device and a 2-byte compute dtype.
      decode_version / legacy / conf_threshold: reference decode knobs.
      mesh: a `parallel.mesh.Mesh`: a replica of the model on each of its
        local devices, each step's bucket split evenly over them. Every
        bucket is rounded UP to a multiple of the replica count, so
        (1, 4, 16, 64) over 8 devices becomes (8, 16, 64).
    """

    def __init__(self, model, *, device=None,
                 buckets: Sequence[int] = (1, 4, 16, 64),
                 max_wait_s: float = 0.002,
                 use_fused="auto",
                 decode_version: int = 2,
                 legacy: bool = True,
                 conf_threshold: float = 1e-6,
                 mesh=None,
                 transfer_dtype: str = "uint8",
                 max_in_flight: int = 2):
        if sorted(set(buckets)) != list(buckets):
            raise ValueError(f"buckets must be ascending+unique: {buckets}")
        if mesh is None:
            if device is None:
                raise ValueError("PoseServer needs a device or a mesh")
            self._devices = (torch.device(device),)
            if self._devices[0].type == "cuda" \
                    and not torch.cuda.is_available():
                raise RuntimeError(f"device={device!r} but CUDA is not "
                                   "available")
            models = [model.to(self._devices[0])]
        else:
            self._devices = mesh.local_devices
            models = mesh_lib.replicas(model, mesh)
            n = len(self._devices)
            buckets = tuple(sorted({-(-b // n) * n for b in buckets}))
        self._device = self._devices[0]
        if transfer_dtype not in _WIRE:
            raise ValueError(f"transfer_dtype: {transfer_dtype!r}")
        for m in models:
            m.eval()
        self._model = models[0]
        self._buckets = tuple(buckets)
        self._bucket_set = frozenset(self._buckets)
        self._max_wait_s = max_wait_s
        self._fused_auto = use_fused == "auto"
        if self._fused_auto:
            use_fused = auto_use_fused(model, self._device)
        self._use_fused = bool(use_fused)
        prepared = {id(m): prepare_fused(m) if self._use_fused else None
                    for m in models}
        self._replicas = [(m, prepared[id(m)], d)
                          for m, d in zip(models, self._devices)]
        self._transfer_dtype = transfer_dtype
        if decode_version == 1:
            self._decode = partial(decode_v1_batch,
                                   conf_threshold=conf_threshold)
        else:
            self._decode = partial(decode_batch,
                                   conf_threshold=conf_threshold,
                                   legacy=legacy)
        self._queue: "queue.Queue" = queue.Queue()
        self._inflight: "queue.Queue" = queue.Queue(maxsize=max_in_flight)
        self._closed = False
        self._latencies: list = []
        self._served = 0
        self._steps = 0
        self._lock = threading.Lock()
        # Makes submit()'s closed-check + enqueue atomic against close(), so
        # no request can slip in after close() has drained the queue.
        self._close_lock = threading.Lock()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._resolver = threading.Thread(target=self._resolve_loop,
                                          daemon=True)
        self._thread.start()
        self._resolver.start()

    @property
    def use_fused(self) -> bool:
        return self._use_fused

    @property
    def buckets(self):
        return self._buckets

    # ------------------------------------------------------------------
    # Device step.
    # ------------------------------------------------------------------

    def _step(self, wire: torch.Tensor) -> torch.Tensor:
        """Host wire batch -> (B, K, 3) keypoints on the first device
        (async): each replica takes an equal share of the rows."""
        outs = []
        with torch.inference_mode():
            for (model, prepared, dev), piece in zip(
                    self._replicas, wire.chunk(len(self._replicas))):
                with mesh_lib.on_device(dev):
                    x = piece.to(dev, non_blocking=True)
                    if x.dtype == torch.uint8:
                        x = x.float() / 255.0
                    else:
                        x = x.float()
                    hms = forward_last_stack(model, x,
                                             use_fused=self._use_fused,
                                             auto=self._fused_auto,
                                             prepared=prepared)
                    outs.append(self._decode(hms))
            if len(outs) == 1:
                return outs[0]
            return torch.cat([o.to(self._device) for o in outs])

    def _to_wire(self, img) -> torch.Tensor:
        img = np.asarray(img, np.float32)
        if self._transfer_dtype == "uint8":
            return torch.from_numpy(
                np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8))
        return torch.from_numpy(img).to(_WIRE[self._transfer_dtype])

    def warmup(self, image_shape=(256, 256, 3)):
        """Run every bucket once (builds the kernels and cuDNN plans)."""
        for b in self._buckets:
            out = self._step(torch.zeros((b, *image_shape),
                                         dtype=_WIRE[self._transfer_dtype]))
            out.cpu()

    # ------------------------------------------------------------------
    # Public API.
    # ------------------------------------------------------------------

    def submit(self, image: np.ndarray) -> Future:
        """Enqueue one (H, W, 3) float image in [0, 1]; resolves to a
        (K, 3) float32 array of x, y, confidence in heatmap units."""
        wire = self._to_wire(image)  # convert outside the lock
        with self._close_lock:
            if self._closed:
                raise RuntimeError("server is closed")
            fut: Future = Future()
            self._queue.put((wire, fut, time.perf_counter()))
        return fut

    def predict(self, images: np.ndarray) -> np.ndarray:
        """Synchronous batch convenience: (N, H, W, 3) -> (N, K, 3)."""
        futs = [self.submit(img) for img in images]
        if not futs:
            return np.zeros((0, self._model.num_classes, 3), np.float32)
        return np.stack([f.result() for f in futs])

    def stats(self) -> dict:
        with self._lock:
            lat = sorted(self._latencies)
            n = len(lat)
            return {
                "served": self._served,
                "steps": self._steps,
                "avg_batch": self._served / max(1, self._steps),
                "latency_p50_ms": 1e3 * lat[n // 2] if n else None,
                "latency_p99_ms": 1e3 * lat[min(n - 1, int(n * 0.99))]
                                  if n else None,
            }

    def close(self):
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        self._queue.put(None)  # wake the batcher
        # No timeout: the batcher always ends once it drains to the
        # sentinel, and a timed-out join could strand an in-flight batch.
        self._thread.join()
        self._inflight.put(None)  # wake the resolver after the batcher
        self._resolver.join()
        # If the batcher died abnormally, requests may still sit in the
        # queue: fail them rather than leave callers blocked forever.
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                item[1].set_exception(RuntimeError("server is closed"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------
    # Batcher and resolver.
    # ------------------------------------------------------------------

    def _take_batch(self):
        """Block for the first request, then admit up to max_batch,
        waiting at most max_wait_s for stragglers."""
        first = self._queue.get()
        if first is None:
            return None
        batch = [first]
        deadline = time.perf_counter() + self._max_wait_s
        max_batch = self._buckets[-1]
        while len(batch) < max_batch:
            if len(batch) in self._bucket_set:
                # A bucket exactly filled ships at once unless more work
                # is already queued.
                try:
                    item = self._queue.get_nowait()
                except queue.Empty:
                    break
            else:
                remaining = deadline - time.perf_counter()
                try:
                    item = self._queue.get(timeout=remaining) \
                        if remaining > 0 else self._queue.get_nowait()
                except queue.Empty:
                    break
            if item is None:
                self._queue.put(None)  # re-signal shutdown after draining
                break
            batch.append(item)
        return batch

    def _bucket_for(self, n: int) -> int:
        for b in self._buckets:
            if b >= n:
                return b
        return self._buckets[-1]

    def _loop(self):
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            images = [b[0] for b in batch]
            futs = [b[1] for b in batch]
            t_in = [b[2] for b in batch]
            n = len(images)
            try:
                x = torch.zeros((self._bucket_for(n), *images[0].shape),
                                dtype=images[0].dtype)
                x[:n] = torch.stack(images)
                out = self._step(x)
            except Exception as e:  # resolve the futures with the error
                for f in futs:
                    f.set_exception(e)
                continue
            self._inflight.put((out, futs, t_in, n))

    def _resolve_loop(self):
        while True:
            item = self._inflight.get()
            if item is None:
                return
            out, futs, t_in, n = item
            try:
                res = out.cpu().numpy()
            except Exception as e:
                for f in futs:
                    f.set_exception(e)
                continue
            now = time.perf_counter()
            with self._lock:
                self._steps += 1
                self._served += n
                self._latencies.extend(now - t for t in t_in)
                if len(self._latencies) > 10000:
                    self._latencies = self._latencies[-5000:]
            for i, f in enumerate(futs):
                f.set_result(res[i])
