"""The mesh: devices in order, the rows each one takes, and the process
groups of its axes.

The counterpart of the JAX package's `parallel/mesh.py`. JAX builds a
`jax.sharding.Mesh` and lets GSPMD split the batch and insert the
collectives; here the mesh is a small object that says which devices take
part and, in a multi-process run, which process groups join them, and the
code that runs over it splits the batch and calls the collectives itself.
Three layouts:

* ("data",), training, one process per device (`torchrun`): the mesh holds
  every rank's device in rank order and the process group. Each process
  feeds its own rows; `training/steps.py` all-reduces the BN sums and the
  gradients over the group;
* ("data",), evaluation and serving, one process over the devices it
  sees: the mesh holds those devices and no group. `predict_ds` and
  `PoseServer` keep a model replica per device, split each batch evenly
  over them and gather the results;
* ("data", "model"), training with tensor parallelism, one process per
  device: rank = data_index * model_size + model_index, as JAX reshapes
  its devices row-major. The ranks of one data index form a model group,
  which splits the channels of the model (`parallel/sharding_rules.py`);
  the ranks of one model index form a data group, over which the step
  reduces the BN sums and the gradients. The ranks of a model group read
  the same rows;
* ("spatial",), H-sharded inference, one process over a list of devices
  and no group (`parallel/spatial.py`);
* ("pipe",), the GPipe pipeline over stacks (`parallel/pipeline.py`), one
  process over a list of P devices and no group: stage p runs on
  `devices[p]`;
* ("data", "pipe"), the pipeline on d data replicas: the devices are the
  d x P grid, row-major (replica i's stage p on `devices[i * P + p]`).
  Training runs one process per data index (`torchrun`), each driving
  its own P pipe devices, joined by a group of d ranks over which the
  step reduces the front's BN sums and the gradients; the forward may run
  in one process over the whole grid, with no group.

A device list may repeat a device, as `[cpu, cpu]` or `[cuda:0, cuda:0]`:
the replicas (or ranks, or shards) then share that device, and each still
takes its own rows. That is how the tests and a machine with one card
stand in for several cards, as the JAX tests spoof 8 CPU devices.

Any other layout raises (AXES_MISSING).
"""

from __future__ import annotations

import contextlib
import copy
import os
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

AXES_MISSING = (
    "the mesh axes are ('data',), ('data', 'model'), ('spatial',), "
    "('pipe',) or ('data', 'pipe'); the pipeline takes one data axis "
    "beside 'pipe', as the JAX package's does")
LAYOUTS = (("data",), ("data", "model"), ("spatial",), ("pipe",),
           ("data", "pipe"))
PIPE_LAYOUTS = (("pipe",), ("data", "pipe"))


@dataclass(frozen=True)
class Mesh:
    """`devices`: one per member, in order (rank order in a multi-process
    run). `group`: the process group of a multi-process run, one process
    per device, or None when one process drives every device. `rank`: this
    process's index in `devices` (0 without a group). `axis_names`: one of
    LAYOUTS. With a "model" axis, `model_size` ranks in a row split the
    model's channels: `model_group` joins this rank's row and `data_group`
    its column (None when the data axis has one member); on a ("data",)
    mesh the data group is `group`. With a "pipe" axis, `pipe_size`
    devices in a row run one replica's pipeline stages; with a group its
    ranks are the data indices and the data group is `group`."""

    devices: Tuple[torch.device, ...]
    group: Optional[Any] = None
    rank: int = 0
    axis_names: Tuple[str, ...] = ("data",)
    model_size: int = 1
    model_group: Optional[Any] = None
    data_group: Optional[Any] = None
    pipe_size: int = 1

    def __post_init__(self):
        if self.axis_names in (("data",), ("data", "pipe")) \
                and self.data_group is None:
            object.__setattr__(self, "data_group", self.group)

    @property
    def data_size(self) -> int:
        return len(self.devices) // (self.model_size * self.pipe_size)

    def pipe_devices(self, data_index: Optional[int] = None
                     ) -> Tuple[torch.device, ...]:
        """The P devices of one data replica's pipeline stages (this
        process's replica by default)."""
        i = self.data_index if data_index is None else data_index
        p = self.pipe_size
        return self.devices[i * p:(i + 1) * p]

    @property
    def data_index(self) -> int:
        return self.rank // self.model_size

    @property
    def model_index(self) -> int:
        return self.rank % self.model_size

    @property
    def shape(self) -> dict:
        if self.axis_names == ("spatial",):
            return {"spatial": len(self.devices)}
        sizes = {"data": self.data_size, "model": self.model_size,
                 "pipe": self.pipe_size}
        return {a: sizes[a] for a in self.axis_names}

    @property
    def device(self) -> torch.device:
        """This process's device (the first one without a group; its
        first pipe device on a pipe mesh)."""
        return self.devices[self.rank * self.pipe_size]

    @property
    def local_devices(self) -> Tuple[torch.device, ...]:
        """The devices this process drives: its own with a group (its pipe
        devices on a pipe mesh), all of them without."""
        if self.group is None:
            return self.devices
        return self.pipe_devices() if "pipe" in self.axis_names \
            else (self.device,)


def _check_device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"mesh device {d} but CUDA is not available")
        if d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        if d.index >= torch.cuda.device_count():
            raise ValueError(f"mesh device {d}: only "
                             f"{torch.cuda.device_count()} CUDA devices")
    return d


def local_device() -> torch.device:
    """A process's own card under `torchrun`: cuda:LOCAL_RANK."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass the mesh's devices "
                           "explicitly (e.g. devices=['cpu', 'cpu'])")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def create_mesh(mesh_shape: Sequence[int] = (-1,),
                axis_names: Sequence[str] = ("data",),
                devices: Optional[Sequence] = None) -> Mesh:
    """Build a mesh of one of LAYOUTS.

    ("data",): in a process that joined a process group
    (`distributed.initialize`), the mesh spans the group: `devices` lists
    one device per rank in rank order (default: each rank's
    `local_device()`, gathered over the group). Otherwise it spans
    `devices` (default: every visible CUDA device; raises without CUDA).
    `mesh_shape` is (-1,) or (n,) with n the device count.

    ("data", "model"): `mesh_shape` (n, m), n may be -1; needs a process
    group of n*m ranks, one per device, and builds the model and data
    groups (`dist.new_group`, a collective of every rank).

    ("spatial",): one process over `devices` (default: every visible CUDA
    device), `mesh_shape` (-1,) or (n,); no group.

    ("pipe",): one process over `devices` (default: every visible CUDA
    device), `mesh_shape` (-1,) or (P,); no group.

    ("data", "pipe"): `mesh_shape` (n, P) with P given, n may be -1;
    `devices` the n x P grid in row-major order. In a process group of n
    ranks each rank drives its row (default: cuda:LOCAL_RANK*P + j,
    gathered over the group); without one, one process drives the grid
    (default: every visible CUDA device).

    A CUDA device on a host without CUDA raises, and so does any other
    layout (AXES_MISSING).
    """
    axis_names = tuple(axis_names)
    if axis_names not in LAYOUTS or len(mesh_shape) != len(axis_names):
        raise NotImplementedError(f"mesh axes {axis_names} of shape "
                                  f"{tuple(mesh_shape)}: {AXES_MISSING}")
    if axis_names in PIPE_LAYOUTS:
        return _pipe_mesh(tuple(mesh_shape), axis_names, devices)
    spatial = axis_names == ("spatial",)
    group = dist.group.WORLD if not spatial and dist.is_available() \
        and dist.is_initialized() else None
    if axis_names == ("data", "model") and group is None:
        raise ValueError("a 'model' axis runs one process per device: "
                         "launch with torchrun and build the mesh after "
                         "parallel.distributed.initialize()")
    if devices is None:
        if group is not None:
            gathered: List[Optional[str]] = [None] * dist.get_world_size()
            dist.all_gather_object(gathered, str(local_device()))
            devices = gathered
        else:
            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device; pass the mesh's devices "
                                   "explicitly (e.g. devices=['cpu', 'cpu'])")
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
    devices = tuple(_check_device(d) for d in devices)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    rank = 0
    if group is not None:
        rank = dist.get_rank()
        if len(devices) != dist.get_world_size():
            raise ValueError(f"{len(devices)} devices for a process group "
                             f"of {dist.get_world_size()}: give one device "
                             "per rank")
    m = mesh_shape[1] if len(mesh_shape) == 2 else 1
    if m < 1 or len(devices) % m:
        raise ValueError(f"a model axis of {m} does not divide "
                         f"{len(devices)} devices")
    n = mesh_shape[0]
    if n not in (-1, len(devices) // m):
        raise ValueError(f"mesh shape {tuple(mesh_shape)} does not cover "
                         f"{len(devices)} devices")
    if axis_names != ("data", "model"):
        return Mesh(devices, group, rank, axis_names)
    return Mesh(devices, group, rank, axis_names, m,
                *_model_and_data_groups(len(devices), m, rank))


def _pipe_mesh(shape, axis_names, devices) -> Mesh:
    """create_mesh for PIPE_LAYOUTS."""
    group = None
    if axis_names == ("data", "pipe") and dist.is_available() \
            and dist.is_initialized():
        group = dist.group.WORLD
    p = shape[-1]
    if axis_names == ("data", "pipe") and p < 1:
        raise ValueError(f"mesh shape {shape}: give the pipe axis's size")
    if devices is None:
        if group is not None:
            first = local_device().index * p
            gathered: List[Optional[List[str]]] = \
                [None] * dist.get_world_size()
            dist.all_gather_object(gathered, [f"cuda:{first + j}"
                                              for j in range(p)])
            devices = [d for row in gathered for d in row]
        else:
            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device; pass the mesh's devices "
                                   "explicitly (e.g. devices=['cpu'] * 4)")
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
    devices = tuple(_check_device(d) for d in devices)
    if p == -1:
        p = len(devices)
    if not devices or len(devices) % p:
        raise ValueError(f"a pipe axis of {p} does not divide "
                         f"{len(devices)} devices")
    n = len(devices) // p
    if shape[0] not in (-1, n if len(shape) == 2 else p):
        raise ValueError(f"mesh shape {shape} does not cover "
                         f"{len(devices)} devices")
    rank = 0
    if group is not None:
        rank = dist.get_rank()
        if n != dist.get_world_size():
            raise ValueError(f"{len(devices)} devices for a process group "
                             f"of {dist.get_world_size()}: give {p} pipe "
                             "devices per rank")
    return Mesh(devices, group, rank, axis_names, pipe_size=p)


def _model_and_data_groups(world: int, m: int, rank: int):
    """(this rank's model group, its data group or None): every rank
    creates every group, in one order, as `dist.new_group` requires."""
    rows = [dist.new_group(list(range(i, i + m)))
            for i in range(0, world, m)]
    cols = [dist.new_group(list(range(j, world, m)))
            for j in range(m)] if world > m else None
    return rows[rank // m], None if cols is None else cols[rank % m]


# ---------------------------------------------------------------------------
# Batches over the mesh.
# ---------------------------------------------------------------------------

def _map(fn, batch):
    if isinstance(batch, dict):
        return {k: fn(v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(fn(v) for v in batch)
    return fn(batch)


def _leading(batch) -> int:
    if isinstance(batch, dict):
        batch = next(iter(batch.values()))
    elif isinstance(batch, (list, tuple)):
        batch = batch[0]
    return batch.shape[0]


def batch_sharding(mesh: Mesh, n: int) -> List[slice]:
    """The rows of an n-row global batch that each local device takes:
    this rank's data share with a group (the ranks of a model group take
    the same rows), one share per device without. n must divide evenly
    (see pad_batch_to_devices)."""
    if n % mesh.data_size:
        raise ValueError(f"a batch of {n} does not split over "
                         f"{mesh.data_size} devices; pad it first")
    per = n // mesh.data_size
    first = mesh.data_index if mesh.group is not None else 0
    return [slice((first + i) * per, (first + i + 1) * per)
            for i in range(len(mesh.local_devices))]


def shard_batch(batch, mesh: Mesh) -> list:
    """A global batch (a tensor, an array, or a dict/list of them) ->
    one piece per local device, each on its device: with a group, this
    rank's rows; without, every device's rows in order."""
    pieces = []
    for dev, rows in zip(mesh.local_devices,
                         batch_sharding(mesh, _leading(batch))):
        pieces.append(_map(lambda x: torch.as_tensor(x[rows]).to(dev),
                           batch))
    return pieces


def pad_batch_to_devices(batch, n_devices: int):
    """Zero-pad the batch dim up to a multiple of the device count (the
    last partial eval batch otherwise cannot split). Returns (batch,
    n_valid); numpy arrays stay numpy arrays, tensors stay tensors."""
    n = _leading(batch)
    pad = -n % n_devices
    if pad == 0:
        return batch, n

    def _pad(x):
        if isinstance(x, torch.Tensor):
            return torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])
        x = np.asarray(x)
        return np.concatenate([x, np.zeros((pad, *x.shape[1:]), x.dtype)])

    return _map(_pad, batch), n


def replicas(model: torch.nn.Module, mesh: Mesh) -> List[torch.nn.Module]:
    """One model per local device, in order: `model` itself moved to the
    first device, a copy on each other device, and the same module again
    where a device repeats."""
    devices = mesh.local_devices
    by_device = {devices[0]: model.to(devices[0])}
    for d in devices[1:]:
        if d not in by_device:
            by_device[d] = copy.deepcopy(model).to(d)
    return [by_device[d] for d in devices]


def on_device(device: torch.device):
    """Make `device` the current CUDA device (the kernels launch on the
    current device); nothing on the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()
