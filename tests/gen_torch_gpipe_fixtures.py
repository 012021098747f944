"""Generate the JAX package's GPipe references for tests/test_torch_gpipe.py.

The JAX pipeline's compiles take 5 s (a forward) to 90 s (a train step on
a ("data", "pipe") mesh) each on an 8-core CPU host, past the port test's
time budget, so its references are computed here once, from the same
numpy-seeded variables and inputs as the test, and committed as
tests/fixtures/torch_gpipe_jax_ref.npz (float32 arrays, a flat
"<case>/<path>" key per leaf):

* fwd32/fwd64: `make_pipeline_forward` of S4/C16 (`random_variables(4,
  16)`) on a 4-device ("pipe",) mesh at M = 4, in float32 and float64;
  fwd_dp32: the same on a (2, 2) ("data", "pipe") mesh at M = 2;
  mobile32/mobile64: the mobile S4/C16 on the ("pipe",) mesh;
* eval32/eval64: `make_pipeline_loss_fn(train=False)` (iou) on the
  ("pipe",) mesh at M = 4: total and per-stack losses;
* loss32/loss64: `make_pipeline_loss_fn(train=True, carry_stats=True)` of
  S2/C16 on a 2-device ("pipe",) mesh at M = 2 and its grads: total,
  per-stack, carried front and stacked statistics, front and stacked
  param grads;
* step32/step64: two `make_pipeline_train_step` steps (Adam, augment off)
  on the (2, 2) mesh: each step's metrics, the grads of the first step
  (Adam's first moment is 0.1 g after one step) and the merged variables
  after the second.

Usage: python tests/gen_torch_gpipe_fixtures.py   (JAX on the CPU, ~5 min)
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from single_person_pose_estimation_tpu import losses  # noqa: E402
from single_person_pose_estimation_tpu.configs.default_config import (  # noqa: E402
    Config,
)
from single_person_pose_estimation_tpu.models.hourglass import (  # noqa: E402
    StackedHourglass,
)
from single_person_pose_estimation_tpu.parallel import (  # noqa: E402
    mesh as mesh_lib,
    pipeline,
)
from single_person_pose_estimation_tpu.training import (  # noqa: E402
    steps as steps_lib,
)
from torch_port_fixtures import random_variables  # noqa: E402
from torch_port_pp_worker import (  # noqa: E402
    CH,
    LABEL,
    LR,
    M,
    SIZE,
    STACKS,
    STEPS,
    step_batch,
)

OUT = os.path.join(HERE, "fixtures", "torch_gpipe_jax_ref.npz")
FWD_STACKS, FWD_B = 4, 8


def fwd_inputs():
    """(images, iou targets) of the forward and eval-loss cases."""
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (FWD_B, SIZE, SIZE, 3)).astype(np.float32)
    t = rng.uniform(0, 1, (FWD_B, LABEL, LABEL, 17)).astype(np.float32)
    return x, t


def flat(tree, prefix):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: np.asarray(tree, np.float32)}


def cast(tree, dt):
    return jax.tree.map(lambda a: jnp.asarray(a, dt), tree)


def forward_cases(dt, tag):
    out = {}
    x, t = fwd_inputs()
    pipe4 = mesh_lib.create_mesh((4,), ("pipe",), devices=jax.devices()[:4])
    for name, mobile in (("fwd", False), ("mobile", True)):
        model = StackedHourglass(num_stacks=FWD_STACKS, num_channels=CH,
                                 mobile=mobile, compute_dtype=dt)
        f, s = cast(pipeline.split_pipeline_variables(
            random_variables(FWD_STACKS, CH, mobile=mobile), FWD_STACKS), dt)
        fwd = pipeline.make_pipeline_forward(model, pipe4, num_microbatches=4)
        out[f"{name}{tag}"] = np.asarray(fwd(f, s, jnp.asarray(x, dt)))
        if mobile:
            continue
        if tag == "32":
            dp = mesh_lib.create_mesh((2, 2), ("data", "pipe"),
                                      devices=jax.devices()[4:8])
            fwd = pipeline.make_pipeline_forward(model, dp, num_microbatches=2)
            out["fwd_dp32"] = np.asarray(fwd(f, s, x))
        loss = jax.jit(pipeline.make_pipeline_loss_fn(
            model, pipe4, losses.iou, num_microbatches=4, train=False))
        total, per = loss(f, s, jnp.asarray(x, dt), jnp.asarray(t, dt))
        out.update(flat({"total": total, "per_stack": per}, f"eval{tag}"))
    return out


def loss_case(dt, tag):
    b = step_batch()
    x = jnp.asarray(b["image"], dt)
    t = jnp.asarray(np.random.default_rng(4).uniform(
        0, 1, (len(b["image"]), LABEL, LABEL, 17)), dt)
    model = StackedHourglass(num_stacks=STACKS, num_channels=CH,
                             compute_dtype=dt)
    mesh = mesh_lib.create_mesh((2,), ("pipe",), devices=jax.devices()[:2])
    f, s = cast(pipeline.split_pipeline_variables(
        random_variables(STACKS, CH), STACKS), dt)
    loss = pipeline.make_pipeline_loss_fn(model, mesh, losses.iou, M,
                                          train=True, carry_stats=True)
    (total, (per, fs, ss)), (gf, gs) = jax.jit(jax.value_and_grad(
        lambda a, c: loss(a, c, x, t), argnums=(0, 1), has_aux=True))(f, s)
    return flat({"total": total, "per_stack": per, "front_stats": fs,
                 "stacked_stats": ss, "front_grads": gf["params"],
                 "stacked_grads": gs["params"]}, f"loss{tag}")


def step_case(dt, tag):
    b = step_batch()
    model = StackedHourglass(num_stacks=STACKS, num_channels=CH,
                             compute_dtype=dt)
    cfg = Config().replace(hg_num_stacks=STACKS, hg_num_channels=CH,
                           image_height=SIZE, image_width=SIZE,
                           label_height=LABEL, label_width=LABEL)
    mesh = mesh_lib.create_mesh((2, 2), ("data", "pipe"),
                                devices=jax.devices()[:4])
    tx = steps_lib.make_optimizer(LR)
    front, stacked = cast(pipeline.split_pipeline_variables(
        random_variables(STACKS, CH), STACKS), dt)
    state = pipeline.PipelineTrainState(
        step=jnp.zeros((), jnp.int32), front=front, stacked=stacked,
        opt_state=tx.init((front["params"], stacked["params"])),
        rng=jax.random.PRNGKey(7))
    batch = {"image": jnp.asarray(b["image"], dt),
             "kx": jnp.asarray(b["kx"], dt), "ky": jnp.asarray(b["ky"], dt),
             "kv": jnp.asarray(b["kv"])}
    step = pipeline.make_pipeline_train_step(model, tx, losses.iou, cfg,
                                             mesh, M, augment=False)
    out = {}
    for i in range(STEPS):
        state, m = step(state, batch)
        out.update(flat({k: v for k, v in m.items()},
                        f"step{tag}/metrics/{i}"))
        if i == 0:
            mu = next(s.mu for s in jax.tree_util.tree_leaves(
                state.opt_state, is_leaf=lambda a: hasattr(a, "mu"))
                if hasattr(s, "mu"))
            out.update(flat({"front": jax.tree.map(lambda a: a / 0.1, mu[0]),
                             "stacked": jax.tree.map(lambda a: a / 0.1,
                                                     mu[1])},
                            f"step{tag}/grads"))
    merged = pipeline.merge_pipeline_variables(state.front, state.stacked,
                                               STACKS)
    out.update(flat(merged, f"step{tag}/variables"))
    return out


def main():
    out = {}
    for dt, tag in ((jnp.float32, "32"), (jnp.float64, "64")):
        with jax.enable_x64(dt == jnp.float64):
            for case in (forward_cases, loss_case, step_case):
                out.update(case(dt, tag))
                print(case.__name__, tag, flush=True)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT}: {len(out)} arrays")


if __name__ == "__main__":
    main()
