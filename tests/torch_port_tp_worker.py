"""One rank of the port's four-process tensor-parallel checks, on the CPU.

    RANK=r WORLD_SIZE=4 LOCAL_RANK=r MASTER_ADDR=127.0.0.1 MASTER_PORT=p \
        python tests/torch_port_tp_worker.py OUT_DIR

`tests/test_torch_tensor_parallel.py` starts four of these with
torchrun's environment and a gloo process group, on a ("data", "model")
mesh of 2 x 2 (rank = data index * 2 + model index); they import torch and
the port, never JAX. Each rank reads the global batch from
OUT_DIR/inputs.npz, takes its data index's rows, and writes what it
computed to OUT_DIR/rank{R}.pt, every tensor its own (sharded) copy:

* "flax", "fused", "mobile", "frozen", "mobile_frozen": one
  `make_train_step(mesh=, model_axis="model")` step of a state sharded by
  `shard_state` (the standard S2/C32 on each backend, the fused one on its
  kernels' plain versions; the mobile S2/C32; the standard one with
  augmentation and the mobile one, both with frozen BN): its metrics,
  grads, state after the step, Adam moments and EMA copies;
* "bottleneck": the fused bottleneck under tensor parallelism
  (`make_bottleneck_train(backend, data group, tp)`, "plain" and "cuda",
  the latter on the kernels' plain versions) on this rank's rows of
  `bottleneck_inputs()` and its channels of the weights: output,
  statistics and the grads of its 13 inputs for a fixed cotangent;
* "ckpt": the "flax" step's state saved by `CheckpointManager`, then
  restored into a new sharded state made from other weights; the
  checkpoint OUT_DIR/plain (written without tensor parallelism) restored
  into another; best promotion of three val losses;
* "eval": `make_eval_step(mesh=, model_axis=)` on the initial state;
* "trainer": one epoch of `Trainer(mesh=, model_axis="model")` over
  synthetic crops of its data index;
* "refusals": the messages of what must raise: a model group on a backend
  other than gloo and NCCL, a tensor on a device the group cannot reduce,
  a step with model_axis over an unsharded state, a state sharded twice.
"""

import os
import sys
from unittest import mock

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

from single_person_pose_estimation_tpu_torch import Config, losses  # noqa: E402
from single_person_pose_estimation_tpu_torch.data.in_memory import (  # noqa: E402
    ArrayDatasetBuilder,
    synthetic_crops,
)
from single_person_pose_estimation_tpu_torch.experimental import (  # noqa: E402
    bottleneck_grad,
)
from single_person_pose_estimation_tpu_torch.parallel import (  # noqa: E402
    distributed,
    mesh as mesh_lib,
    sharding_rules,
)
from single_person_pose_estimation_tpu_torch.training import (  # noqa: E402
    steps,
)
from single_person_pose_estimation_tpu_torch.training.checkpoint import (  # noqa: E402
    CheckpointManager,
)
from single_person_pose_estimation_tpu_torch.training.trainer import (  # noqa: E402
    Trainer,
)
from torch_port_dp_worker import bottleneck_inputs  # noqa: E402
from torch_port_fixtures import random_variables, torch_model  # noqa: E402

STACKS, CH, SIZE, LABEL, LR, EMA = 2, 32, 64, 16, 1e-3, 0.9
DATA, MODEL = 2, 2
# The worker's steps: (model_backend, mobile, augment, bn_mode).
RUNS = {"flax": ("flax", False, False, "batch"),
        "fused": ("fused", False, False, "batch"),
        "mobile": ("flax", True, False, "batch"),
        "frozen": ("flax", False, True, "frozen"),
        "mobile_frozen": ("flax", True, False, "frozen")}


def step_config(b):
    return Config(image_height=SIZE, image_width=SIZE, label_height=LABEL,
                  label_width=LABEL, hg_num_stacks=STACKS,
                  hg_num_channels=CH, batch_size=b, compute_dtype="float32")


def new_state(mobile=False, seed=0, mesh=None):
    """The S2/C32 train state (Adam with an EMA) from random_variables,
    sharded over `mesh`'s model axis when a mesh is given."""
    model = torch_model(random_variables(STACKS, CH, seed=seed,
                                         mobile=mobile), STACKS, CH,
                        mobile=mobile)
    state = steps.TrainState.create(
        model, lambda m: steps.make_optimizer(m, LR, ema_decay=EMA), seed=7,
        device="cpu")
    if mesh is not None:
        state = sharding_rules.shard_state(state, mesh)
    return state


def snapshot(state) -> dict:
    """Copies of the state's tensors by name: "state" (params and
    buffers), "grads", "exp_avg", "exp_avg_sq" and "ema"; and "split",
    the names of the leaves the model's tensor parallelism splits."""
    opt = state.optimizer
    adam = {n: opt.adam.state[p] for n, p in opt.params.items()
            if p in opt.adam.state}
    tp = state.model.tensor_parallel
    return {"split": frozenset() if tp is None else tp.split,
            "state": {k: v.clone()
                      for k, v in state.model.state_dict().items()},
            "grads": {n: p.grad.clone() for n, p in opt.params.items()
                      if p.grad is not None},
            "exp_avg": {n: s["exp_avg"].clone() for n, s in adam.items()},
            "exp_avg_sq": {n: s["exp_avg_sq"].clone()
                           for n, s in adam.items()},
            "ema": {n: t.clone() for n, t in (opt.ema or {}).items()}}


def one_step(mesh, batch, backend, mobile, augment, bn_mode):
    """One train step; over `mesh`'s model axis when a mesh is given."""
    state = new_state(mobile, mesh=mesh)
    step = steps.make_train_step(
        losses.weighted_mse, step_config(len(batch["image"])),
        augment=augment, bn_mode=bn_mode, model_backend=backend, mesh=mesh,
        model_axis=None if mesh is None else "model")
    state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    return state, {"metrics": {k: v.item() for k, v in m.items()},
                   **snapshot(state)}


def bottleneck_run(backend, rows=slice(None), group=None, tp=None):
    """(out, stats, grads of the 13 inputs) of the fused bottleneck on
    `rows` of bottleneck_inputs(); with `tp`, this rank's output channels
    of each unit's weight and BN leaves."""
    args, cot = bottleneck_inputs()
    args[0], cot = args[0][rows], cot[rows]
    if tp is not None:
        # w1 (C, Cm), b1, w2 (3, 3, Cm, Cm), b2, w3 (Cm, C), b3: output
        # channels last; then the BN leaves.
        args = [args[0]] + [np.ascontiguousarray(tp.local(
            torch.from_numpy(a), a.ndim - 1).numpy()) for a in args[1:]]
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    out, stats = bottleneck_grad.make_bottleneck_train(backend, group, tp)(
        *leaves)
    (out * torch.from_numpy(cot)).sum().backward()
    return {"out": out.detach(), "stats": [t.clone() for t in stats],
            "grads": [t.grad.clone() for t in leaves]}


def ckpt_run(out, mesh, state):
    """Save `state` under tensor parallelism, restore it and the
    unsharded checkpoint OUT_DIR/plain into new sharded states, and
    promote three val losses."""
    mgr = CheckpointManager(os.path.join(out, "tp_ckpt"), group=mesh.group)
    mgr.save(1, state, {"epoch": 1})
    promoted = [mgr.maybe_promote_best(v, state, {"epoch": 1})
                for v in (0.5, 0.7, 0.3)]
    restored, _ = mgr.restore(new_state(seed=3, mesh=mesh))
    plain, _ = CheckpointManager(os.path.join(out, "plain")).restore(
        new_state(seed=4, mesh=mesh))
    return {"restored": snapshot(restored), "plain": snapshot(plain),
            "promoted": promoted, "best": mgr.best_meta()}


def trainer_run(out, mesh):
    cfg = step_config(4).replace(temporary_dir=os.path.join(out, "run"),
                                 seed=5)
    crops = synthetic_crops(8, SIZE, label_size=LABEL,
                            seed=20 + mesh.data_index)
    builder = ArrayDatasetBuilder(crops, crops, cfg.batch_size, seed=5)
    model = torch_model(random_variables(STACKS, CH), STACKS, CH)
    trainer = Trainer(model, builder, 1, LR, "weighted_mse", cfg, mesh=mesh,
                      model_axis="model", device="cpu")
    trainer.train()
    res = {"rows": trainer.logger.rows, "step": trainer.state.step,
           "steps_per_epoch": trainer.steps_per_epoch,
           **snapshot(trainer.state)}
    trainer.close()
    return res


def refusals(mesh, batch):
    """What must raise under tensor parallelism, by name: its message."""
    def message(fn):
        try:
            fn()
        except ValueError as e:
            return str(e)
        return None

    tp = new_state(mesh=mesh).model.tensor_parallel
    step = steps.make_train_step(losses.weighted_mse, step_config(4),
                                 augment=False, mesh=mesh, model_axis="model")
    with mock.patch.object(torch.distributed, "get_backend",
                           return_value="mpi"):
        backend = message(lambda: sharding_rules.TensorParallel(
            mesh.model_group, MODEL, mesh.model_index))
    return {"backend": backend,
            "device": message(lambda: tp.sum_(torch.zeros(2,
                                                          device="meta"))),
            "unsharded": message(lambda: step(new_state(), {
                k: torch.from_numpy(v) for k, v in batch.items()})),
            "twice": message(lambda: sharding_rules.shard_state(
                new_state(mesh=mesh), mesh))}


def main(out):
    if not distributed.initialize(backend="gloo", timeout_s=60):
        raise RuntimeError("no cluster environment")
    world = torch.distributed.get_world_size()
    mesh = mesh_lib.create_mesh((DATA, MODEL), ("data", "model"),
                                devices=["cpu"] * world)
    inputs = np.load(os.path.join(out, "inputs.npz"))
    b = len(inputs["image"]) // DATA
    rows = slice(mesh.data_index * b, (mesh.data_index + 1) * b)
    batch = {k: inputs[k][rows] for k in ("image", "kx", "ky", "kv")}
    res = {"rank": mesh.rank, "data_index": mesh.data_index,
           "model_index": mesh.model_index, "shape": mesh.shape}
    for name, run in RUNS.items():
        state, res[name] = one_step(mesh, batch, *run)
        if name == "flax":
            res["ckpt"] = ckpt_run(out, mesh, state)
    tp = new_state(mesh=mesh).model.tensor_parallel
    res["split"], res["partial"] = tp.split, tp.partial
    bneck_rows = slice(mesh.data_index * 2, (mesh.data_index + 1) * 2)
    res["bottleneck"] = {
        backend: bottleneck_run(backend, bneck_rows, mesh.data_group, tp)
        for backend in ("plain", "cuda")}
    state = new_state(mesh=mesh)
    eval_step = steps.make_eval_step(losses.weighted_mse, step_config(b),
                                     mesh=mesh, model_axis="model")
    res["eval"] = {k: v.item() for k, v in eval_step(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}).items()}
    res["trainer"] = trainer_run(out, mesh)
    res["refusals"] = refusals(mesh, batch)
    torch.save(res, os.path.join(out, f"rank{mesh.rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
