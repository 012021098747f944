"""One rank of the port's two-process data-parallel checks, on the CPU.

    RANK=r WORLD_SIZE=2 LOCAL_RANK=r MASTER_ADDR=127.0.0.1 MASTER_PORT=p \
        python tests/torch_port_dp_worker.py OUT_DIR

`tests/test_torch_parallel.py` starts two of these with torchrun's
environment and a gloo process group; they import torch and the port,
never JAX. Each rank reads the global batch from OUT_DIR/inputs.npz, takes
its rows, and writes what it computed to OUT_DIR/rank{R}.pt:

* "flax", "fused": one `make_train_step(mesh=)` step per backend (the
  fused one on its kernels' plain versions), augmentation off: metrics,
  grads, running statistics and params after the step;
* "augment": the same with augmentation on;
* "bottleneck": the fused bottleneck (`make_bottleneck_train(backend,
  group)`, "plain" and "cuda", the latter on the kernels' plain versions)
  on this rank's rows of `bottleneck_inputs()`: output, statistics and the
  grads of its 13 inputs for a fixed cotangent;
* "trainer": a 2-epoch `Trainer(mesh=)` over this rank's record shards
  (OUT_DIR/data), its epoch rows, best checkpoint meta and final state;
  then a new Trainer, built from another seed, resumed from rank 0's
  checkpoint for one epoch;
* "cli": `cli train --data-parallel --device cpu` for one epoch under the
  same group.
"""

import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

from single_person_pose_estimation_tpu_torch import Config, cli  # noqa: E402
from single_person_pose_estimation_tpu_torch import losses  # noqa: E402
from single_person_pose_estimation_tpu_torch.data.pipeline import (  # noqa: E402
    DatasetBuilder,
)
from single_person_pose_estimation_tpu_torch.experimental import (  # noqa: E402
    bottleneck_grad,
)
from single_person_pose_estimation_tpu_torch.parallel import (  # noqa: E402
    distributed,
    mesh as mesh_lib,
)
from single_person_pose_estimation_tpu_torch.training import (  # noqa: E402
    steps,
)
from single_person_pose_estimation_tpu_torch.training.trainer import (  # noqa: E402
    Trainer,
)
from torch_port_fixtures import random_variables, torch_model  # noqa: E402

STACKS, CH, SIZE, LABEL, LR = 2, 16, 64, 16, 1e-3


def step_config(b):
    return Config(image_height=SIZE, image_width=SIZE, label_height=LABEL,
                  label_width=LABEL, hg_num_stacks=STACKS,
                  hg_num_channels=CH, batch_size=b, compute_dtype="float32")


def data_config(root, tmp):
    return Config(dataset_dir=root, temporary_dir=tmp, image_height=SIZE,
                  image_width=SIZE, label_height=LABEL, label_width=LABEL,
                  hg_num_stacks=1, hg_num_channels=CH, batch_size=4,
                  num_examples_per_record=4, min_num_keypoints=1,
                  shuffle_buffer=4, host_workers=1, compute_dtype="float32",
                  seed=5)


def one_step(mesh, batch, backend, augment):
    model = torch_model(random_variables(STACKS, CH), STACKS, CH)
    state = steps.TrainState.create(
        model, lambda m: steps.make_optimizer(m, LR), seed=7, device="cpu")
    step = steps.make_train_step(losses.weighted_mse,
                                 step_config(len(batch["image"])),
                                 augment=augment, model_backend=backend,
                                 mesh=mesh)
    state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    sd = state.model.state_dict()
    return {"metrics": {k: v.item() for k, v in m.items()},
            "grads": {n: p.grad.clone()
                      for n, p in state.model.named_parameters()},
            "state": {k: v.clone() for k, v in sd.items()}}


def bottleneck_inputs(seed=9, b=4, h=8, c=32):
    """The 13 inputs (x, w1, b1, w2, b2, w3, b3, g1, be1, g2, be2, g3,
    be3) of one fused bottleneck over a global batch of b rows, and an
    output cotangent, from a seed."""
    rng = np.random.default_rng(seed)
    n = lambda *s, sc=0.1: (rng.standard_normal(s) * sc).astype(np.float32)
    cm = c // 2
    args = [n(b, h, h, c, sc=.5), n(c, cm), n(cm), n(3, 3, cm, cm), n(cm),
            n(cm, c), n(c), 1 + n(cm), n(cm), 1 + n(cm), n(cm), 1 + n(c),
            n(c)]
    return args, n(b, h, h, c, sc=1.0)


def bottleneck_run(backend, rows=slice(None), group=None):
    """(out, stats, grads of the 13 inputs) of the fused bottleneck on
    `rows` of bottleneck_inputs(); x and the cotangent take the rows."""
    args, cot = bottleneck_inputs()
    args[0], cot = args[0][rows], cot[rows]
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    out, stats = bottleneck_grad.make_bottleneck_train(backend, group)(
        *leaves)
    (out * torch.from_numpy(cot)).sum().backward()
    return {"out": out.detach(), "stats": [t.clone() for t in stats],
            "grads": [t.grad.clone() for t in leaves]}


def state_tensors(trainer):
    return {k: v.clone() for k, v in trainer.state.model.state_dict().items()}


def trainer_run(out, mesh):
    cfg = data_config(os.path.join(out, "data"), os.path.join(out, "run"))
    builder = DatasetBuilder(cfg, process_index=mesh.rank,
                             process_count=mesh.data_size)
    model = torch_model(random_variables(1, CH), 1, CH)
    trainer = Trainer(model, builder, 2, LR, "weighted_mse", cfg, mesh=mesh)
    trainer.train()
    res = {"train_files": builder.train_filenames,
           "valid_files": builder.valid_filenames,
           "steps_per_epoch": trainer.steps_per_epoch,
           "rows": trainer.logger.rows,
           "best": trainer.ckpt.best_meta(),
           "state": state_tensors(trainer),
           "generator": trainer.state.generator.get_state()}
    trainer.close()
    builder.close()
    # A new Trainer from other weights, resumed from rank 0's checkpoint.
    builder = DatasetBuilder(cfg, process_index=mesh.rank,
                             process_count=mesh.data_size)
    model = torch_model(random_variables(1, CH, seed=11 + mesh.rank), 1, CH)
    trainer = Trainer(model, builder, 1, LR, "weighted_mse", cfg, mesh=mesh)
    trainer.resume_training()
    res.update(resumed_step=trainer.state.step,
               resumed_epochs=trainer.ckpt._epochs(),
               resumed_state=state_tensors(trainer))
    trainer.close()
    builder.close()
    return res


def cli_run(out):
    root = os.path.join(out, "data")
    sets = []
    for k, v in dict(dataset_dir=root, temporary_dir=os.path.join(out, "cli"),
                     image_height=SIZE, image_width=SIZE, label_height=LABEL,
                     label_width=LABEL, hg_num_stacks=1, hg_num_channels=CH,
                     batch_size=4, num_examples_per_record=4,
                     min_num_keypoints=1, host_workers=1,
                     compute_dtype="float32").items():
        sets += ["--set", f"{k}={v}"]
    cli.main(sets + ["--device", "cpu", "train", "--epochs", "1", "--lr",
                     str(LR), "--loss", "weighted_mse", "--no-augment"])
    cfg = cli._apply_overrides(Config(), sets[1::2])
    from single_person_pose_estimation_tpu_torch.training.checkpoint import (
        CheckpointManager,
    )
    return {"meta": CheckpointManager(cfg.checkpoints_path).read_meta()}


def main(out):
    if not distributed.initialize(backend="gloo", timeout_s=60):
        raise RuntimeError("no cluster environment")
    rank = torch.distributed.get_rank()
    world = torch.distributed.get_world_size()
    mesh = mesh_lib.create_mesh(devices=["cpu"] * world)
    inputs = np.load(os.path.join(out, "inputs.npz"))
    b = len(inputs["image"]) // world
    rows = slice(rank * b, (rank + 1) * b)
    batch = {k: inputs[k][rows] for k in ("image", "kx", "ky", "kv")}
    res = {"rank": rank, "world": world, "devices": mesh.devices}
    for backend in ("flax", "fused"):
        res[backend] = one_step(mesh, batch, backend, augment=False)
    res["augment"] = one_step(mesh, batch, "flax", augment=True)
    rows = slice(rank * 2, (rank + 1) * 2)
    res["bottleneck"] = {backend: bottleneck_run(backend, rows, mesh.group)
                         for backend in ("plain", "cuda")}
    res["trainer"] = trainer_run(out, mesh)
    res["cli"] = cli_run(out)
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
