"""One rank of the port's two-process GPipe check, on the CPU.

    RANK=r WORLD_SIZE=2 LOCAL_RANK=r MASTER_ADDR=127.0.0.1 MASTER_PORT=p \
        python tests/torch_port_pp_worker.py OUT_DIR

`tests/test_torch_gpipe.py` starts two of these with torchrun's
environment and a gloo process group over a ("data", "pipe") mesh of 2 x 2
CPU devices; they import torch and the port, never JAX. Each rank takes
its rows of `step_batch()` (`rank_rows`), runs STEPS pipelined train steps
(`make_pipeline_train_step`, augmentation off) and writes to
OUT_DIR/rank{R}.pt: each step's metrics, the gradients of the first step
as flax-layout params, the merged variables after the last step, and the
mesh it saw.

The constants and input builders are shared with the test and with
`tests/gen_torch_gpipe_fixtures.py`, which computes the JAX package's
references from the same numbers.
"""

import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

from single_person_pose_estimation_tpu_torch import Config, losses  # noqa: E402
from single_person_pose_estimation_tpu_torch.models.hourglass import (  # noqa: E402
    StackedHourglass,
)
from single_person_pose_estimation_tpu_torch.parallel import (  # noqa: E402
    distributed,
    mesh as mesh_lib,
    pipeline,
)
from single_person_pose_estimation_tpu_torch.training import (  # noqa: E402
    steps,
)
from single_person_pose_estimation_tpu_torch.utils.weight_convert import (  # noqa: E402
    to_variables,
)
from torch_port_fixtures import random_variables  # noqa: E402

# The train-mode cases: S2/C16 at 64x64, 16x16 labels, a global batch of
# 8 in M = 2 microbatches, the iou loss, Adam at LR.
STACKS, CH, SIZE, LABEL, B, M, LR, STEPS = 2, 16, 64, 16, 8, 2, 1e-3, 2
WORLD = PIPE = 2
SEED = 3


def step_config():
    return Config(image_height=SIZE, image_width=SIZE, label_height=LABEL,
                  label_width=LABEL, hg_num_stacks=STACKS,
                  hg_num_channels=CH, batch_size=B, compute_dtype="float32")


def step_batch(seed=SEED):
    rng = np.random.default_rng(seed)
    return {"image": rng.uniform(0, 1, (B, SIZE, SIZE, 3)).astype(np.float32),
            "kx": rng.uniform(1, LABEL - 1, (B, 17)).astype(np.float32),
            "ky": rng.uniform(1, LABEL - 1, (B, 17)).astype(np.float32),
            "kv": rng.integers(0, 3, (B, 17)).astype(np.int32)}


def rank_rows(rank, world=WORLD, b=B, m=M):
    """The global rows a rank passes, so that its local microbatch j holds
    its share of global microbatch j: JAX splits the batch into M
    microbatches of consecutive rows and shards each over "data"."""
    mb, share = b // m, b // m // world
    return np.concatenate([np.arange(j * mb + rank * share,
                                     j * mb + (rank + 1) * share)
                           for j in range(m)])


def grads_tree(modules):
    """The gradients of placed modules as flax-layout params (zeros where
    a parameter has none)."""
    return to_variables({n: p.grad if p.grad is not None
                         else torch.zeros_like(p)
                         for n, p in modules.named_parameters()})["params"]


def main(out):
    if not distributed.initialize(backend="gloo", timeout_s=60):
        raise RuntimeError("no cluster environment")
    rank = torch.distributed.get_rank()
    mesh = mesh_lib.create_mesh((WORLD, PIPE), ("data", "pipe"),
                                devices=["cpu"] * (WORLD * PIPE))
    model = StackedHourglass(num_stacks=STACKS, num_channels=CH)
    state = pipeline.PipelineTrainState.create(
        model, lambda m: steps.make_optimizer(m, LR), mesh, seed=7,
        variables=random_variables(STACKS, CH))
    step = pipeline.make_pipeline_train_step(
        model, losses.iou, step_config(), mesh, M, augment=False)
    rows = rank_rows(rank)
    batch = {k: torch.from_numpy(v[rows]) for k, v in step_batch().items()}
    res = {"rank": rank, "shape": mesh.shape,
           "devices": mesh.pipe_devices(), "metrics": []}
    for i in range(STEPS):
        state, m = step(state, batch)
        res["metrics"].append({k: v.item() for k, v in m.items()})
        if i == 0:
            res["front_grads"] = grads_tree(state.front)
            res["stacked_grads"] = [grads_tree(st) for st in state.stacked]
    res["variables"] = state.variables()
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
