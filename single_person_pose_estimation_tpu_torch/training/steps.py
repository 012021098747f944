"""Train and eval steps with on-device preprocessing, in PyTorch.

The counterpart of the JAX package's `training/steps.py`. One train step
takes a batch of raw crops and keypoints on the host or the device and runs
everything on the device: augmentation (the warp kernel of
`ops/cuda/warp_kernel.py`), Gaussian target rendering (the heatmap kernel
of `ops/cuda/heatmap_kernel.py`), forward, loss, backward (autograd; cuDNN
for the convs) and one Adam update. The JAX step is a pure function of a
donated state; here the step updates its `TrainState` in place and returns
it, so the call reads the same: `state, metrics = step(state, batch)`.

Data parallel (`mesh=`, one process per device joined by a process
group; see parallel/mesh.py): each rank passes its own rows, the same
number on every rank. Every train-mode BN takes the statistics of the
global batch (an all_reduce of its sums, forward and backward), the
augmentation draws for the global batch and keeps the rank's rows, and
after `backward()` one all_reduce of a flat buffer of every gradient and
the step's metrics, divided by the world size, gives each rank the
gradient of the mean loss over the global batch and the global metrics.
Every rank then applies the same update to the same numbers, so the
ranks' parameters stay bit-identical. The model is not wrapped in
DistributedDataParallel: its reducer is armed by the wrapper's forward,
which `fused_train_apply` never calls.

Tensor parallel (`mesh=` with a ("data", "model") mesh and
`model_axis="model"`, the state sharded by
`parallel.sharding_rules.shard_state`): the ranks of a model group pass
the same rows and split the model's channels (its forward gathers them
over the model group). The BN sums, the augmentation's shard and the
gradient all_reduce run over the data group, which each rank's gradient
of a split leaf shares with the ranks that hold the same slice. Before
it, the gradients of the replicated leaves are made equal over the model
group (`TensorParallel.reduce_grads`: summed where the forward reads
them in slices, else the group's first rank's), so the replicated leaves
stay bit-identical.

A batch is a dict with
  "image": (B, H, W, 3) float32 in [0, 1], or uint8 (divided by 255 on the
           device: the uint8 wire of `config.train_transfer_dtype`);
  "kx", "ky": (B, K) float32 keypoints in heatmap space;
  "kv": (B, K) integer visibility.
Metrics are 0-dim tensors on the device ("loss", "loss/hg{i}"), so a step
does not wait for the device.

Adam is `torch.optim.Adam` with Keras' defaults (b1 0.9, b2 0.999, eps
1e-7). Like optax, it bias-corrects both moments and adds eps outside the
square root: lr/(1-b1^t) * m / (sqrt(v)/sqrt(1-b2^t) + eps) is
lr * m_hat / (sqrt(v_hat) + eps). The learning rate of step t is the
schedule at t, counted before the step, as optax counts: a warmup's first
step runs at lr 0.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from single_person_pose_estimation_tpu_torch import losses as losses_lib
from single_person_pose_estimation_tpu_torch.configs.default_config import Config
from single_person_pose_estimation_tpu_torch.experimental.fused_train import (
    fused_train_apply,
)
from single_person_pose_estimation_tpu_torch.ops import augment as augment_lib
from single_person_pose_estimation_tpu_torch.ops.cuda.heatmap_kernel import (
    render_heatmaps_batch,
)
from single_person_pose_estimation_tpu_torch.parallel import mesh as mesh_lib


def resolve_device(device) -> torch.device:
    """The explicit device of an entry point: CUDA raises when absent."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return device


# ---------------------------------------------------------------------------
# Optimizer: Adam, a learning-rate schedule and an EMA of the params
# ---------------------------------------------------------------------------

def make_lr_schedule(learning_rate: float, schedule: Optional[str] = None,
                     total_steps: Optional[int] = None,
                     warmup_steps: int = 0) -> Callable[[int], float]:
    """Step count -> learning rate, as the JAX package's optax schedules.

    None/"constant": the reference's fixed lr (after a linear warmup from 0
    when warmup_steps > 0). "cosine": linear warmup from 0, then a cosine
    decay to 0 at total_steps."""

    def warmup(count):
        return learning_rate * min(count, warmup_steps) / warmup_steps

    if schedule in (None, "constant"):
        if warmup_steps:
            return warmup
        return lambda count: learning_rate
    if schedule == "cosine":
        if not total_steps:
            raise ValueError("schedule='cosine' requires total_steps")
        decay_steps = total_steps - warmup_steps
        if decay_steps <= 0:
            raise ValueError(f"cosine decay needs total_steps > "
                             f"warmup_steps: {total_steps}, {warmup_steps}")

        def cosine(count):
            if count < warmup_steps:
                return warmup(count)
            c = min(count - warmup_steps, decay_steps)
            return learning_rate * 0.5 * (1 + math.cos(math.pi * c
                                                       / decay_steps))
        return cosine
    raise ValueError(
        f"unknown schedule {schedule!r}: use None/'constant'/'cosine'")


class Optimizer:
    """Adam over a model's parameters, a learning-rate schedule, and an
    optional exponential moving average of the params (ema <- decay * ema
    + (1 - decay) * params after each update, starting from a copy of the
    params). Its `state_dict` holds all three and checkpoints with the
    rest of the state."""

    def __init__(self, model: torch.nn.Module, learning_rate: float,
                 schedule: Optional[str] = None,
                 total_steps: Optional[int] = None, warmup_steps: int = 0,
                 ema_decay: Optional[float] = None):
        if ema_decay is not None and not 0.0 <= ema_decay < 1.0:
            raise ValueError(f"ema decay must be in [0, 1): {ema_decay}")
        self.params = dict(model.named_parameters())
        self.lr_fn = make_lr_schedule(learning_rate, schedule, total_steps,
                                      warmup_steps)
        self.adam = torch.optim.Adam(self.params.values(),
                                     lr=self.lr_fn(0), betas=(0.9, 0.999),
                                     eps=1e-7)
        self.count = 0
        self.ema_decay = ema_decay
        self.ema = None if ema_decay is None else {
            n: p.detach().clone() for n, p in self.params.items()}

    def zero_grad(self):
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> float:
        """One update with the current grads; returns the lr it used."""
        lr = self.lr_fn(self.count)
        for group in self.adam.param_groups:
            group["lr"] = lr
        self.adam.step()
        self.count += 1
        if self.ema is not None:
            d = self.ema_decay
            with torch.no_grad():
                for n, p in self.params.items():
                    self.ema[n].copy_(self.ema[n] * d + (1.0 - d) * p)
        return lr

    def state_dict(self) -> dict:
        return {"adam": self.adam.state_dict(), "count": self.count,
                "ema": self.ema}

    def load_state_dict(self, sd: dict):
        self.adam.load_state_dict(sd["adam"])
        self.count = int(sd["count"])
        if (sd["ema"] is None) != (self.ema is None):
            raise ValueError("the saved optimizer state and this optimizer "
                             "disagree on tracking an EMA of the params")
        if self.ema is not None:
            for n, v in sd["ema"].items():
                self.ema[n].copy_(v)


def make_optimizer(model, learning_rate: float,
                   schedule: Optional[str] = None,
                   total_steps: Optional[int] = None, warmup_steps: int = 0,
                   ema_decay: Optional[float] = None) -> Optimizer:
    """Adam with Keras' defaults (the reference's optimizer), an optional
    lr schedule (see make_lr_schedule) and an optional EMA of the params."""
    return Optimizer(model, learning_rate, schedule, total_steps,
                     warmup_steps, ema_decay)


def get_ema_params(optimizer: Optimizer) -> Dict[str, torch.Tensor]:
    """The EMA params tracked by make_optimizer(ema_decay=...)."""
    if optimizer.ema is None:
        raise ValueError("optimizer state has no EMA component; build it "
                         "with make_optimizer(..., ema_decay=0.999)")
    return optimizer.ema


@dataclass
class TrainState:
    """The model (params and BN statistics), the optimizer (Adam moments,
    schedule count, EMA), the step count and the generator that draws the
    augmentation. Everything a checkpoint saves."""

    model: torch.nn.Module
    optimizer: Optimizer
    generator: torch.Generator
    step: int = 0

    @classmethod
    def create(cls, model, optimizer_fn: Callable[[torch.nn.Module],
                                                  Optimizer],
               seed: int = 0, device="cuda") -> "TrainState":
        """Move `model` to `device`, build its optimizer there, and seed a
        generator on the device."""
        device = resolve_device(device)
        model.to(device)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return cls(model=model, optimizer=optimizer_fn(model), generator=gen)

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------

def _to_device(batch, device):
    images = batch["image"]
    images = torch.as_tensor(images).to(device, non_blocking=True)
    if images.dtype == torch.uint8:
        images = images.float() / 255.0
    kx, ky, kv = (torch.as_tensor(batch[k]).to(device, non_blocking=True)
                  for k in ("kx", "ky", "kv"))
    return images, kx.float(), ky.float(), kv


MODEL_BACKENDS = ("flax", "fused")


def forward_loss(model, loss_fn, images, heatmaps, bn_mode: str = "batch",
                 model_backend: str = "flax", group=None):
    """(total, per-stack losses). bn_mode "batch" normalises with batch
    statistics and updates the running ones; "frozen" normalises with the
    running statistics and leaves them as they are, whatever the backend.
    model_backend "flax" runs the model's forward under autograd (the JAX
    package's name for `nn.Module.apply`); "fused" runs
    `experimental.fused_train.fused_train_apply` (train-mode BN only).
    With a process `group` the batch statistics are the global batch's."""
    if bn_mode == "frozen":
        outs = model(images, train=False)
    elif model_backend == "fused":
        outs = fused_train_apply(model, images, group=group)
    else:
        outs = model(images, train=True, group=group)
    per_stack = losses_lib.per_stack_losses(loss_fn, heatmaps, outs)
    return torch.stack(per_stack).sum(), per_stack


def _metrics(total, per_stack):
    m = {"loss": total.detach()}
    for i, v in enumerate(per_stack):
        m[f"loss/hg{i}"] = v.detach()
    return m


def mesh_group(mesh):
    """The process group a step all-reduces over, the mesh's data group:
    None without a mesh, on a mesh of one device that no group joins, and
    on a data axis of one rank."""
    if mesh is None:
        return None
    if mesh.group is None:
        if mesh.data_size > 1:
            raise ValueError(
                "training over several devices runs one process per device: "
                "launch with torchrun and build the mesh after "
                "parallel.distributed.initialize()")
        return None
    return mesh.data_group


def check_model_axis(mesh, model_axis: Optional[str]) -> None:
    """A tensor-parallel axis needs a mesh that has it, as in the JAX
    package's Trainer."""
    if model_axis is None:
        return
    if mesh is None:
        raise ValueError("model_axis requires a mesh")
    if model_axis not in mesh.axis_names:
        raise ValueError(f"model_axis {model_axis!r} not in mesh axes "
                         f"{mesh.axis_names}")


def _tensor_parallel(model, mesh, model_axis):
    """The model's TensorParallel, which must match `model_axis`: a state
    sharded for this mesh's model group with it, unsharded without."""
    tp = model.tensor_parallel
    if (tp is None) != (model_axis is None) or (
            tp is not None and tp.group is not mesh.model_group):
        raise ValueError(
            f"model_axis={model_axis!r} needs the state "
            f"{'sharded for this mesh' if model_axis else 'unsharded'} "
            "(parallel.sharding_rules.shard_state)")
    return tp


def _all_reduce_step(params, metrics: torch.Tensor, group,
                     world: int) -> torch.Tensor:
    """One all_reduce of a flat float32 buffer of every gradient and the
    step's metrics, divided by the world size; the grads are written back
    in place and the global metrics returned."""
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads] + [metrics])
    dist.all_reduce(flat, group=group)
    flat.div_(world)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
    return flat[offset:]


def make_train_step(loss_fn: Callable, config: Config, augment: bool = True,
                    bn_mode: str = "batch", accum_steps: int = 1,
                    model_backend: str = "flax", mesh=None,
                    model_axis: Optional[str] = None):
    """Build the train step, (state, batch) -> (state, metrics).

    model_backend: "flax" (the model's forward and autograd; cuDNN convs)
    or "fused" (`experimental.fused_train.fused_train_apply`: every
    identity-skip hourglass bottleneck through the hand-derived backward
    and, on the card, the six train-unit CUDA kernels; the non-mobile
    hourglass only, a mobile model raises ValueError at the step).
    bn_mode="frozen" runs the eval-mode forward whatever the backend.

    accum_steps: the batch is split into N equal microbatches; their grads
    are summed and divided by N, and one optimizer update follows. With
    train-mode BN each microbatch normalises by its own statistics and the
    running statistics chain through the microbatches in order, as in the
    JAX package. Augmentation and targets run once on the whole batch.

    config.augment_backend "auto" takes the CUDA warp kernel on the card
    (see ops/augment.py). After the step each parameter's `.grad` holds the
    gradient the update used.

    mesh: a `parallel.mesh.Mesh` whose process group joins one process per
    device (module docstring). Each rank passes its own rows, the same
    number on each. With accum_steps > 1, microbatch m of the global batch
    is every rank's m-th chunk. A mesh of several devices without a group
    raises ValueError.

    model_axis: "model" on a ("data", "model") mesh trains a state sharded
    by `parallel.sharding_rules.shard_state` (module docstring); each rank
    passes its data index's rows. A model_axis without a mesh that has it,
    or a state that does not match it, raises ValueError.
    """
    check_model_axis(mesh, model_axis)
    if bn_mode not in ("batch", "frozen"):
        raise ValueError(f"bn_mode must be 'batch' or 'frozen': {bn_mode!r}")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1: {accum_steps}")
    if model_backend not in MODEL_BACKENDS:
        raise ValueError(f"model_backend must be one of {MODEL_BACKENDS}: "
                         f"{model_backend!r}")
    label_h, label_w = config.label_height, config.label_width
    sigma = config.hm_sigma
    group = mesh_group(mesh)
    world = mesh.data_size if group is not None else 1
    shard = (mesh.data_index, world) if group is not None else (0, 1)

    def step(state: TrainState, batch):
        model, opt = state.model, state.optimizer
        tp = _tensor_parallel(model, mesh, model_axis)
        if model_backend == "fused" and model.mobile:
            raise ValueError("model_backend='fused' supports the non-mobile "
                             "hourglass only")
        images, kx, ky, kv = _to_device(batch, state.device)
        if augment:
            images, kx, ky, kv = augment_lib.augment_batch(
                state.generator, images, kx, ky, kv, label_size=label_w,
                flip_pairs=config.flip_pairs,
                geometric_backend=config.augment_backend,
                scale_min=config.aug_scale_min,
                scale_max=config.aug_scale_max,
                rotate_deg=config.aug_rotate_deg, shard=shard)
        heatmaps = render_heatmaps_batch(kx, ky, kv, height=label_h,
                                         width=label_w, sigma=sigma)
        opt.zero_grad()
        if accum_steps > 1:
            b = images.shape[0]
            if b % accum_steps:
                raise ValueError(f"batch size {b} not divisible by "
                                 f"accum_steps {accum_steps}")
            totals, stacks = [], []
            for imgs_m, hms_m in zip(images.chunk(accum_steps),
                                     heatmaps.chunk(accum_steps)):
                tot_m, ps_m = forward_loss(model, loss_fn, imgs_m, hms_m,
                                           bn_mode, model_backend, group)
                tot_m.backward()
                totals.append(tot_m.detach())
                stacks.append(torch.stack(ps_m).detach())
            for p in opt.params.values():
                if p.grad is not None:
                    p.grad.div_(accum_steps)
            total = torch.stack(totals).mean()
            per_stack = list(torch.stack(stacks).mean(0))
        else:
            total, per_stack = forward_loss(model, loss_fn, images, heatmaps,
                                            bn_mode, model_backend, group)
            total.backward()
        if tp is not None:
            tp.reduce_grads(opt.params.items())
        if group is not None:
            total, *per_stack = _all_reduce_step(
                opt.params.values(),
                torch.stack([total.detach(), *per_stack]).detach(), group,
                world)
        opt.step()
        state.step += 1
        return state, _metrics(total, per_stack)

    return step


def make_eval_step(loss_fn: Callable, config: Config, mesh=None,
                   model_axis: Optional[str] = None):
    """Validation step, (state, batch) -> metrics: targets without
    augmentation, forward with the running BN statistics, per-stack
    losses. On a mesh with a process group each rank evaluates its own
    rows, with no collective of its own (under tensor parallelism the
    model's forward gathers channels over the model group, whose ranks
    pass the same rows); `parallel.distributed.aggregate_metrics`
    combines the ranks' means (as `Trainer` does). A mesh of several
    devices without a group, or a model_axis that the mesh or the state
    does not match, raises ValueError."""
    mesh_group(mesh)
    check_model_axis(mesh, model_axis)
    label_h, label_w = config.label_height, config.label_width
    sigma = config.hm_sigma

    def step(state: TrainState, batch):
        _tensor_parallel(state.model, mesh, model_axis)
        images, kx, ky, kv = _to_device(batch, state.device)
        with torch.no_grad():
            heatmaps = render_heatmaps_batch(kx, ky, kv, height=label_h,
                                             width=label_w, sigma=sigma)
            outs = state.model(images, train=False)
            per_stack = losses_lib.per_stack_losses(loss_fn, heatmaps, outs)
            return _metrics(torch.stack(per_stack).sum(), per_stack)

    return step


def make_predict_fn(model, mesh=None):
    """images -> the LAST stack's heatmaps (the reference's eval
    convention), with the running BN statistics.

    mesh: a model replica per local device (`parallel.mesh.replicas`);
    the rows are padded to a multiple of their count, split evenly over
    them, and the heatmaps gathered on the first device without the
    padding."""
    if mesh is None:
        def predict(images):
            with torch.inference_mode():
                return model(images, train=False)[-1]

        return predict
    models = mesh_lib.replicas(model, mesh)

    def predict_mesh(images):
        padded, n = mesh_lib.pad_batch_to_devices(images, len(models))
        outs = []
        with torch.inference_mode():
            for m, dev, piece in zip(models, mesh.local_devices,
                                     padded.chunk(len(models))):
                with mesh_lib.on_device(dev):
                    outs.append(m(piece.to(dev), train=False)[-1])
        return torch.cat([o.to(mesh.local_devices[0]) for o in outs])[:n]

    return predict_mesh


def recalibrate_batch_stats(state: TrainState, batches,
                            momentum: float = 0.0) -> TrainState:
    """Refresh the BN running statistics by forwarding `batches` in train
    mode, params untouched. momentum=0.0 adopts each batch's statistics
    outright, as the JAX package's `model.clone(bn_momentum=0.0)`."""
    model = state.model
    saved = model.bn_momentum
    model.bn_momentum = momentum
    try:
        with torch.no_grad():
            for batch in batches:
                images = batch["image"] if isinstance(batch, dict) else batch
                images = torch.as_tensor(images).to(state.device)
                if images.dtype == torch.uint8:
                    images = images.float() / 255.0
                model(images, train=True)
    finally:
        model.bn_momentum = saved
    return state
