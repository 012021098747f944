"""Pipeline parallelism over hourglass stacks (GPipe over a "pipe" mesh
axis), in PyTorch.

The counterpart of the JAX package's `parallel/pipeline.py`. The stacks
chain through the inter-stack residual, so they split into P stages of
num_stacks / P stacks each: stage p holds its stacks' modules on
`devices[p]` of a ("pipe",) mesh (one process over P devices) or of its
row of a ("data", "pipe") mesh (one process per data index under
`torchrun`). The front module runs on the first stage's device.

Schedule: GPipe. The batch splits into M microbatches and the loop runs
M + P - 1 ticks; at tick t stage p runs microbatch t - p, and its output
hops to the next stage's device by `.to(device, non_blocking=True)`.
Autograd carries the backward across the devices. Bubble fraction
(P - 1) / (M + P - 1). JAX runs the loop as a `lax.scan` inside a
`shard_map` with `ppermute` hops; here the host issues each tick's work in
order, and CUDA's asynchronous launches let the stages' devices overlap.

The stages run the port's plain modules (cuDNN and autograd), as the JAX
pipeline runs flax modules and no Pallas kernel. The train step augments
on the device and renders the targets once a step over the whole batch,
so with `augment_backend` "auto" on the card it launches the warp kernel
twice and the heatmap kernel once a step.

BatchNorm in train mode, as in the JAX package:
  * the front normalises over the global batch: with a data group its BN
    all-reduces [sum x, sum x^2, n] (the JAX front runs outside the
    `shard_map`, where GSPMD makes it sync BN over "data");
  * each stage normalises each microbatch over its replica's rows (ghost
    BN) and updates its running statistics once a valid microbatch, with
    the model's momentum; the carried statistics are then averaged over
    the data group (JAX's `pmean`). On a pipe-only mesh at M = 1 the step
    equals the sequential step.

Variables: `split_pipeline_variables` / `merge_pipeline_variables` work on
the flax-layout numpy tree that `utils/weight_convert.py` speaks (the JAX
functions' layout: the front's `front_*` leaves, and every per-stack leaf
stacked on a leading num_stacks axis under its `hg0_*` name). The true
last stack's pruned `conv_1x1_2`/`conv_1x1_3` are zero-padded by split, so
every stage runs one program; its interface output is discarded, so
those convs get no gradient and stay zero, and merge drops them.
"""

from __future__ import annotations

import contextlib
import copy
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from single_person_pose_estimation_tpu_torch.configs.default_config import (
    Config,
)
from single_person_pose_estimation_tpu_torch.models.hourglass import (
    StackedHourglass,
    hourglass_specs,
)
from single_person_pose_estimation_tpu_torch.ops import augment as augment_lib
from single_person_pose_estimation_tpu_torch.ops.cuda.heatmap_kernel import (
    render_heatmaps_batch,
)
from single_person_pose_estimation_tpu_torch.parallel.mesh import (
    Mesh,
    on_device,
)
from single_person_pose_estimation_tpu_torch.training import steps as steps_lib
from single_person_pose_estimation_tpu_torch.utils.weight_convert import (
    load_variables,
    to_variables,
)

_PRUNED = ("hg0_conv_1x1_2", "hg0_conv_1x1_3")


class HourglassFront(StackedHourglass):
    """The front module alone (256^2 -> 64^2 x C), with the full model's
    `front_*` layer names, so the split front variables load as they
    are."""

    def __init__(self, **kwargs):
        super().__init__(num_stacks=0, **kwargs)

    def forward(self, x: torch.Tensor, train: bool = False,
                group=None) -> torch.Tensor:
        """(B, H, W, 3) images -> (B, H/4, W/4, C) compute-dtype features
        (an NHWC view of the NCHW result)."""
        return self.front(self.input_nchw(x), train, group).permute(
            0, 2, 3, 1)


class HourglassStage(StackedHourglass):
    """One hourglass stack with the canonical `hg0_*` layer names. It always
    computes the inter-stack interface, so every stage runs one program
    whatever its position."""

    def __init__(self, **kwargs):
        super().__init__(num_stacks=1, **kwargs)

    def _layer_specs(self):
        return [s for s in hourglass_specs(2, self.num_channels,
                                           self.num_classes, self.mobile)
                if s[0].startswith("hg0_")]

    def run(self, x: torch.Tensor, train: bool = False):
        """NCHW compute-dtype x -> (next stack's input, NCHW prediction)."""
        return self._hourglass(x, 0, False, train)

    def forward(self, x: torch.Tensor, train: bool = False):
        """(B, h, w, C) features -> (next_x (B, h, w, C), the stack's
        (B, h, w, K) float32 heatmaps)."""
        nx, pred = self.run(x.to(self.compute_dtype).permute(0, 3, 1, 2),
                            train)
        return nx.permute(0, 2, 3, 1), pred.float().permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# Variables: split / merge, and modules placed on the pipe devices.
# ---------------------------------------------------------------------------

def _strip_prefix(tree: dict, prefix: str, rename: str = "") -> dict:
    return {rename + k[len(prefix):]: v
            for k, v in tree.items() if k.startswith(prefix)}


def _map_leaves(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map_leaves(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def split_pipeline_variables(variables: dict, num_stacks: int
                             ) -> Tuple[dict, dict]:
    """Full-model variables -> (front_vars, stacked_stage_vars), numpy.

    front_vars: the `front_*` subtree, which loads into HourglassFront.
    stacked_stage_vars: every per-stack leaf stacked on a new leading axis
    of length num_stacks, under its `hg0_*` name (HourglassStage's). The
    last stack's pruned `conv_1x1_2`/`conv_1x1_3` are zero-filled, so every
    stack has one tree structure.
    """
    as_np = lambda a: np.asarray(a, np.float32)
    front = {col: _map_leaves(as_np, _strip_prefix(tree, "front_",
                                                   "front_"))
             for col, tree in variables.items()}
    stacks = [{col: _strip_prefix(tree, f"hg{i}_", "hg0_")
               for col, tree in variables.items()}
              for i in range(num_stacks)]
    params0 = stacks[0]["params"]
    c = np.shape(params0["hg0_conv_1x1_1"]["kernel"])[-1]
    k = np.shape(params0["hg0_conv_1x1_predict"]["kernel"])[-1]
    templates = {
        "hg0_conv_1x1_2": {"kernel": np.zeros((1, 1, c, c), np.float32),
                           "bias": np.zeros((c,), np.float32)},
        "hg0_conv_1x1_3": {"kernel": np.zeros((1, 1, k, c), np.float32),
                           "bias": np.zeros((c,), np.float32)},
    }
    for s in stacks:
        for name, tmpl in templates.items():
            s["params"].setdefault(name, tmpl)
    stacked = _map_leaves(lambda *xs: np.stack([as_np(x) for x in xs]),
                          *stacks)
    return front, stacked


def merge_pipeline_variables(front: dict, stacked: dict,
                             num_stacks: int) -> dict:
    """Inverse of split_pipeline_variables: the full model's variables,
    with the zero-padded pruned convs of the last stack dropped, so they
    load into StackedHourglass (`weight_convert.load_variables`)."""
    out = {col: dict(_strip_prefix(tree, "front_", "front_"))
           for col, tree in front.items()}
    for col in stacked:
        out.setdefault(col, {})
        for name, sub in stacked[col].items():
            for i in range(num_stacks):
                if i == num_stacks - 1 and col == "params" \
                        and name in _PRUNED:
                    continue
                out[col][f"hg{i}" + name[len("hg0"):]] = _map_leaves(
                    lambda a: np.asarray(a[i]), sub)
    return out


def _stage_kwargs(model: StackedHourglass) -> dict:
    """The settings of HourglassFront and HourglassStage, `model`'s as the
    JAX package takes them: the 7x7 front, the "conv" depthwise lowering,
    no remat."""
    return dict(num_classes=model.num_classes,
                num_channels=model.num_channels,
                predict_activation=model.predict_activation,
                mobile=model.mobile, compute_dtype=model.compute_dtype,
                bn_momentum=model.bn_momentum)


def _check(model, mesh: Mesh, pipe_axis: str) -> None:
    if pipe_axis != "pipe" or pipe_axis not in mesh.axis_names:
        raise ValueError(f"pipe axis {pipe_axis!r} not in mesh axes "
                         f"{mesh.axis_names}")
    if model.num_stacks % mesh.pipe_size:
        raise ValueError(f"{model.num_stacks} stacks do not split over "
                         f"{mesh.pipe_size} pipeline stages")


def place_pipeline(model: StackedHourglass, front: dict, stacked: dict,
                   devices: Sequence[torch.device]
                   ) -> Tuple[HourglassFront, List[HourglassStage]]:
    """Split variables -> (the front on devices[0], one HourglassStage per
    stack, stack s on the device of its stage: devices[s // (num_stacks /
    P)] for P = len(devices))."""
    per = model.num_stacks // len(devices)
    kwargs = _stage_kwargs(model)
    f_mod = load_variables(HourglassFront(**kwargs), front).to(devices[0])
    stages = []
    for s in range(model.num_stacks):
        one = {col: _map_leaves(lambda a: np.asarray(a[s]), tree)
               for col, tree in stacked.items()}
        stages.append(load_variables(HourglassStage(**kwargs), one)
                      .to(devices[s // per]))
    return f_mod, stages


def pipeline_variables(front: HourglassFront,
                       stacked: Sequence[HourglassStage]) -> Tuple[dict, dict]:
    """Placed modules -> (front_vars, stacked_stage_vars), numpy, as
    split_pipeline_variables lays them out."""
    stages = [to_variables(st) for st in stacked]
    return (to_variables(front),
            _map_leaves(lambda *xs: np.stack(xs), *stages))


def _stats_tree(modules) -> dict:
    """{bn name: {"mean", "var"}} of one module's running statistics."""
    return {name: {"mean": m.running_mean.detach().clone(),
                   "var": m.running_var.detach().clone()}
            for name, m in modules.named_children()
            if isinstance(m, nn.BatchNorm2d)}


def _stacked_stats(stacked, device) -> dict:
    trees = [_stats_tree(st) for st in stacked]
    return _map_leaves(lambda *xs: torch.stack([x.to(device) for x in xs]),
                       *trees)


@contextlib.contextmanager
def _updating_stats(modules, on: bool):
    """Train-mode BNs of `modules` update their running statistics (on) or
    leave them as they are (off) inside the block."""
    saved = [m.update_stats for m in modules]
    for m in modules:
        m.update_stats = on
    try:
        yield
    finally:
        for m, was in zip(modules, saved):
            m.update_stats = was


def _stat_buffers(stacked) -> List[torch.Tensor]:
    return [b for st in stacked for name, b in st.named_buffers()
            if name.endswith(("running_mean", "running_var"))]


def _all_reduce_mean(tensors: Sequence[torch.Tensor], group, world: int,
                     device) -> torch.Tensor:
    """Average `tensors` (on any devices) over `group` in one all_reduce of
    a flat float32 buffer on `device`, written back in place."""
    flat = torch.cat([t.detach().reshape(-1).float().to(device)
                      for t in tensors])
    dist.all_reduce(flat, group=group)
    flat.div_(world)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()
    return flat


# ---------------------------------------------------------------------------
# The engine.
# ---------------------------------------------------------------------------

def _microbatch(x: torch.Tensor, num_microbatches: int) -> List[torch.Tensor]:
    b = x.shape[0]
    if b % num_microbatches:
        raise ValueError(f"batch {b} not divisible by "
                         f"num_microbatches={num_microbatches}")
    return list(x.chunk(num_microbatches))


def _gpipe(x_mb: List[torch.Tensor], stacked: Sequence[HourglassStage],
           devices: Sequence[torch.device], train: bool,
           targets_mb: Optional[List[torch.Tensor]] = None,
           loss_fn: Optional[Callable] = None):
    """The GPipe loop over one replica's P stages. x_mb: M microbatches of
    NCHW front features on devices[0]. Predict mode (loss_fn None): the
    last stack's (mb, h, w, K) heatmaps of each microbatch, on the last
    stage's device. Loss mode: the per-stack losses (each the mean over
    microbatches of the Keras per-output mean), on devices[0]."""
    n_stages, m_count = len(devices), len(x_mb)
    per = len(stacked) // n_stages
    inbox: List[Dict[int, torch.Tensor]] = [{} for _ in range(n_stages)]
    preds: List[Optional[torch.Tensor]] = [None] * m_count
    lacc: List[Optional[torch.Tensor]] = [None] * len(stacked)
    for t in range(m_count + n_stages - 1):
        for p in range(n_stages):
            m = t - p
            if not 0 <= m < m_count:
                continue
            dev = devices[p]
            x = x_mb[m] if p == 0 else inbox[p].pop(m)
            if loss_fn is not None:
                tgt = targets_mb[m].to(dev, non_blocking=True)
            with on_device(dev):
                for s in range(p * per, (p + 1) * per):
                    x, pred = stacked[s].run(x, train)
                    head = pred.float().permute(0, 2, 3, 1)
                    if loss_fn is not None:
                        loss = torch.mean(loss_fn(tgt, head))
                        lacc[s] = loss if lacc[s] is None else lacc[s] + loss
                if p + 1 < n_stages:
                    inbox[p + 1][m] = x.to(devices[p + 1], non_blocking=True)
                elif loss_fn is None:
                    preds[m] = head
    if loss_fn is None:
        return preds
    return [(v / m_count).to(devices[0]) for v in lacc]


def _replica_stages(stacked, devices):
    """One data replica's stages on its row of devices: the given modules
    where the device is theirs, copies elsewhere."""
    per = len(stacked) // len(devices)
    return [st if next(st.parameters()).device == devices[s // per]
            else copy.deepcopy(st).to(devices[s // per])
            for s, st in enumerate(stacked)]


def _as_modules(model, front, stacked, devices):
    if isinstance(front, HourglassFront):
        return front, list(stacked)
    return place_pipeline(model, front, stacked, devices)


def make_pipeline_forward(model: StackedHourglass, mesh: Mesh,
                          num_microbatches: int, pipe_axis: str = "pipe",
                          train: bool = False):
    """Pipelined inference: fn(front, stacked, images) -> the last stack's
    (B, h, w, K) float32 heatmaps (the reference's eval output).

    front, stacked: the split variables (numpy trees, placed on the call),
    or an HourglassFront and one HourglassStage per stack already placed
    (a PipelineTrainState's `front` and `stacked`). On a ("data", "pipe")
    mesh without a group, one process drives every replica: the front
    runs once over the batch, and replica d takes the d-th share of each
    microbatch's rows, as the JAX pipeline shards the microbatch over
    "data". With a group each process runs its own rows on its replica.
    `train=True` normalises with batch statistics (ghost BN in the stages)
    and leaves the running statistics as they are, as JAX's forward drops
    its BN mutation."""
    _check(model, mesh, pipe_axis)
    group = mesh.data_group if mesh.group is not None else None
    replicas = [mesh.pipe_devices(d) for d in range(mesh.data_size)] \
        if group is None else [mesh.pipe_devices()]

    @torch.no_grad()
    def forward(front, stacked, images):
        first = replicas[0][0]
        f_mod, stages = _as_modules(model, front, stacked, replicas[0])
        with _updating_stats([f_mod, *stages], False), on_device(first):
            x = torch.as_tensor(images).to(first)
            x0_mb = _microbatch(f_mod.front(f_mod.input_nchw(x), train,
                                            group), num_microbatches)
            outs = []
            for d, devices in enumerate(replicas):
                shard = [xm.chunk(len(replicas))[d].to(devices[0])
                         for xm in x0_mb]
                outs.append(_gpipe(shard, _replica_stages(stages, devices),
                                   devices, train))
        return torch.cat([torch.cat([o[m].to(first) for o in outs])
                          for m in range(num_microbatches)])

    return forward


def make_pipeline_loss_fn(model: StackedHourglass, mesh: Mesh,
                          loss_fn: Callable, num_microbatches: int,
                          pipe_axis: str = "pipe", train: bool = True,
                          carry_stats: bool = False):
    """Differentiable pipelined loss: fn(front, stacked, images, targets)
    -> (total, per_stack_losses), with front an HourglassFront and stacked
    one HourglassStage per stack, placed (`place_pipeline`; split
    variables are placed on the call, and their grads are lost with them).

    total = the sum over stacks of each stack's loss averaged over the
    microbatches: the sequential intermediate-supervision objective, so
    its backward is the pipelined training gradient. With a data group
    each rank's total covers its rows; the train step averages the grads
    and metrics over the group.

    train=True normalises with batch statistics; without carry_stats the
    running statistics are left as they are. carry_stats=True (train only)
    updates them in place, the front's once with the global batch's
    moments and the stages' once a microbatch, averages the stages' over
    the data group, and returns (total, (per_stack, front_stats,
    stacked_stats)): {bn name: {"mean", "var"}} trees, the stacked ones on
    a leading num_stacks axis.
    """
    _check(model, mesh, pipe_axis)
    if carry_stats and not train:
        raise ValueError("carry_stats needs train=True")
    if mesh.group is None and mesh.data_size > 1:
        raise ValueError("a pipelined loss over several data replicas runs "
                         "one process per data index: launch with torchrun "
                         "and build the mesh after "
                         "parallel.distributed.initialize()")
    devices = mesh.pipe_devices()
    group = mesh.data_group if mesh.group is not None else None
    world = mesh.data_size if group is not None else 1

    def pipelined_loss(front, stacked, images, targets):
        f_mod, stages = _as_modules(model, front, stacked, devices)
        with _updating_stats([f_mod, *stages], carry_stats):
            with on_device(devices[0]):
                x = torch.as_tensor(images).to(devices[0])
                x0_mb = _microbatch(f_mod.front(f_mod.input_nchw(x), train,
                                                group), num_microbatches)
                tgt_mb = _microbatch(torch.as_tensor(targets).to(
                    devices[0], torch.float32), num_microbatches)
            per_stack = _gpipe(x0_mb, stages, devices, train, tgt_mb,
                               loss_fn)
        total = torch.stack(per_stack).sum()
        if not carry_stats:
            return total, per_stack
        if group is not None:
            _all_reduce_mean(_stat_buffers(stages), group, world, devices[0])
        return total, (per_stack, _stats_tree(f_mod),
                       _stacked_stats(stages, devices[0]))

    return pipelined_loss


# ---------------------------------------------------------------------------
# Training.
# ---------------------------------------------------------------------------

@dataclass
class PipelineTrainState:
    """The pipelined trainer's state: the front and one stage module per
    stack placed on this process's pipe devices, Adam over both (its
    moments live beside each parameter, on the stage's device), the
    generator of the augmentation, and the step count. `variables()`
    gives the full model's variables (merge_pipeline_variables) for a
    checkpoint or a StackedHourglass."""

    front: HourglassFront
    stacked: nn.ModuleList
    optimizer: steps_lib.Optimizer
    generator: torch.Generator
    step: int = 0

    @classmethod
    def create(cls, model: StackedHourglass,
               optimizer_fn: Callable[[nn.Module], steps_lib.Optimizer],
               mesh: Mesh, seed: int = 0, variables: Optional[dict] = None,
               pipe_axis: str = "pipe") -> "PipelineTrainState":
        """Split `variables` (default: `model`'s weights) over this
        process's pipe devices, build the optimizer over the placed
        modules, and seed a generator on the first pipe device."""
        _check(model, mesh, pipe_axis)
        if variables is None:
            variables = to_variables(model)
        front, stacked = place_pipeline(
            model, *split_pipeline_variables(variables, model.num_stacks),
            mesh.pipe_devices())
        stacked = nn.ModuleList(stacked)
        opt = optimizer_fn(nn.ModuleDict({"front": front,
                                          "stacked": stacked}))
        gen = torch.Generator(device=mesh.pipe_devices()[0])
        gen.manual_seed(seed)
        return cls(front, stacked, opt, gen)

    @property
    def device(self) -> torch.device:
        return next(self.front.parameters()).device

    def variables(self) -> dict:
        return merge_pipeline_variables(
            *pipeline_variables(self.front, self.stacked),
            len(self.stacked))


def _metrics(total, per_stack) -> Dict[str, torch.Tensor]:
    m = {"loss": total.detach()}
    for i, v in enumerate(per_stack):
        m[f"loss/hg{i}"] = v.detach()
    return m


def make_pipeline_train_step(model: StackedHourglass, loss_fn: Callable,
                             config: Config, mesh: Mesh,
                             num_microbatches: int, pipe_axis: str = "pipe",
                             augment: bool = True):
    """The pipelined train step, (state, batch) -> (state, metrics), with
    the contract of `training.steps.make_train_step`: on-device
    augmentation (config.augment_backend) and heatmap targets over the
    whole batch, the GPipe forward and backward, and one Adam update of
    the state's optimizer (the JAX function's `tx`). BatchNorm and the
    carried running statistics follow the module docstring.

    On a ("data", "pipe") mesh each process passes its own rows, the same
    number on each rank; microbatch m is the m-th chunk of them. After the
    backward one all_reduce averages the gradients and the metrics over
    the data group, so every rank applies the same update.
    """
    pipe_loss = make_pipeline_loss_fn(model, mesh, loss_fn, num_microbatches,
                                      pipe_axis, train=True,
                                      carry_stats=True)
    group = mesh.data_group if mesh.group is not None else None
    world = mesh.data_size if group is not None else 1
    shard = (mesh.data_index, world) if group is not None else (0, 1)
    label_h, label_w = config.label_height, config.label_width

    def step(state: PipelineTrainState, batch):
        dev = state.device
        images, kx, ky, kv = steps_lib._to_device(batch, dev)
        with on_device(dev):
            if augment:
                images, kx, ky, kv = augment_lib.augment_batch(
                    state.generator, images, kx, ky, kv,
                    label_size=label_w, flip_pairs=config.flip_pairs,
                    geometric_backend=config.augment_backend,
                    scale_min=config.aug_scale_min,
                    scale_max=config.aug_scale_max,
                    rotate_deg=config.aug_rotate_deg, shard=shard)
            targets = render_heatmaps_batch(kx, ky, kv, height=label_h,
                                            width=label_w,
                                            sigma=config.hm_sigma)
        state.optimizer.zero_grad()
        total, (per_stack, _, _) = pipe_loss(state.front, state.stacked,
                                             images, targets)
        total.backward()
        if group is not None:
            params = [p for p in state.optimizer.params.values()
                      if p.grad is not None]
            flat = _all_reduce_mean(
                [p.grad for p in params]
                + [torch.stack([total.detach(), *per_stack]).detach()],
                group, world, dev)
            n = len(per_stack) + 1
            total, *per_stack = flat[-n:]
        state.optimizer.step()
        state.step += 1
        return state, _metrics(total, per_stack)

    return step


def recalibrate_pipeline_batch_stats(model: StackedHourglass,
                                     state: PipelineTrainState, batches,
                                     momentum: float = 0.0
                                     ) -> PipelineTrainState:
    """BN recalibration of a pipelined state (the pipeline's
    `training.steps.recalibrate_batch_stats`): the merged variables drive
    the sequential model in train mode over `batches` with BN momentum
    `momentum` (0 adopts each batch's moments), and the refreshed running
    statistics go back into the placed modules. Params and the optimizer
    are untouched."""
    dev = state.device
    seq = StackedHourglass(num_classes=model.num_classes,
                           num_stacks=model.num_stacks,
                           num_channels=model.num_channels,
                           compute_dtype=model.compute_dtype,
                           mobile=model.mobile, bn_momentum=momentum,
                           predict_activation=model.predict_activation)
    seq = load_variables(seq, state.variables()).to(dev)
    with torch.no_grad(), on_device(dev):
        for batch in batches:
            images = batch["image"] if isinstance(batch, dict) else batch
            images = torch.as_tensor(images).to(dev)
            if images.dtype == torch.uint8:
                images = images.float() / 255.0
            seq(images, train=True)
    front, stacked = split_pipeline_variables(to_variables(seq),
                                              model.num_stacks)
    stats = lambda v: {"params": {}, "batch_stats": v["batch_stats"]}
    _load_stats(state.front, stats(front))
    for s, st in enumerate(state.stacked):
        _load_stats(st, {"params": {}, "batch_stats": _map_leaves(
            lambda a: np.asarray(a[s]), stacked["batch_stats"])})
    return state


def _load_stats(module: nn.Module, variables: dict) -> None:
    with torch.no_grad():
        for name, leaves in variables["batch_stats"].items():
            bn = getattr(module, name)
            bn.running_mean.copy_(torch.from_numpy(leaves["mean"]))
            bn.running_var.copy_(torch.from_numpy(leaves["var"]))
