"""The GPipe pipeline over stacks in the port (`parallel/pipeline.py` and
the pipe layouts of `parallel/mesh.py`), on the CPU.

The JAX package's pipelined compiles take 5-90 s each on this kind of host
(tests/gen_torch_gpipe_fixtures.py), so its pipeline's results on the same
numpy-seeded variables and inputs are read from
tests/fixtures/torch_gpipe_jax_ref.npz, which that script writes; JAX's
`split_pipeline_variables` runs live. A two-process gloo cluster
(tests/torch_port_pp_worker.py, a 60 s limit from launch) runs the
("data", "pipe") train step while this process checks the rest.

Tolerances:
* split/merge: equal leaf for leaf, and an exact round trip;
* forwards (S4/C16, 64x64, 4-device ("pipe",) and 2x2 ("data", "pipe")
  meshes of CPU devices, standard and mobile): atol 1e-4 of JAX's float32
  pipeline, its own test's tolerance (tests/test_pipeline.py): at these
  weights (saturated sigmoids, four stacks) JAX's float32 lies 4.1e-5 from
  its float64 result and the port 3.2e-5, so 1e-5 is out of reach of
  either; and no further from JAX's float64 result than 2x JAX's float32;
* the eval-mode loss: abs 1e-5 of JAX's (its own test's tolerance);
* train mode (S2/C16, the batch of 8 in M = 2 microbatches): every
  quantity (losses, carried statistics, grads) no further from JAX's
  float64 result than JAX's own float32 lies from it, times FACTOR, or
  1e-6 of the largest value where JAX's float32 is exact (the
  E[x^2]-E[x]^2 variance over 4 rows at the 1x1 hourglass bottom turns
  float32 reordering into large relative errors; tests/
  test_torch_train_step.py), and losses within RTOL_LOSS;
* at M = 1 on a pipe-only mesh the pipelined step equals the sequential
  step of `training/steps.py`: loss and running statistics bit for bit,
  grads within 1e-6 of the largest |g|;
* recalibration: the sequential recalibration's statistics, bit for bit.
"""

import os
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from single_person_pose_estimation_tpu.parallel import pipeline as jpipeline
from single_person_pose_estimation_tpu_torch import losses
from single_person_pose_estimation_tpu_torch.models.hourglass import (
    StackedHourglass,
)
from single_person_pose_estimation_tpu_torch.parallel import mesh as mesh_lib
from single_person_pose_estimation_tpu_torch.parallel import pipeline
from single_person_pose_estimation_tpu_torch.training import steps
from single_person_pose_estimation_tpu_torch.utils.weight_convert import (
    load_variables,
    to_variables,
)
from torch_port_fixtures import random_variables
from torch_port_pp_worker import (
    CH,
    LABEL,
    LR,
    M,
    PIPE,
    SIZE,
    STACKS,
    STEPS,
    WORLD,
    grads_tree,
    step_batch,
    step_config,
)

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_port_pp_worker.py")
REF = os.path.join(HERE, "fixtures", "torch_gpipe_jax_ref.npz")
LAUNCH_TIMEOUT_S = 60
FWD_STACKS, FWD_B = 4, 8
ATOL_FWD = 1e-4
ATOL_EVAL = 1e-5
RTOL_LOSS = 1e-5
FACTOR = 2.0


def _fwd_inputs():
    """The forward cases' images and iou targets (the fixture script's
    `fwd_inputs`)."""
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (FWD_B, SIZE, SIZE, 3)).astype(np.float32)
    t = rng.uniform(0, 1, (FWD_B, LABEL, LABEL, 17)).astype(np.float32)
    return x, t


def _ref(prefix):
    """The fixture's arrays under `prefix`, as a nested dict of float64."""
    out = {}
    with np.load(REF) as f:
        for key in f.files:
            if key == prefix:
                return f[key].astype(np.float64)
            if not key.startswith(prefix + "/"):
                continue
            node = out
            *path, leaf = key[len(prefix) + 1:].split("/")
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = f[key].astype(np.float64)
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().numpy()
    return [np.asarray(tree, np.float64)]


def _dist(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [x.shape for x in la] == [x.shape for x in lb]
    return max(np.abs(x - y).max() for x, y in zip(la, lb))


def _within_jax_f32(got, name):
    """got no further from JAX's float64 result than FACTOR times JAX's
    float32 result lies from it (1e-6 of the largest value at least)."""
    f64, f32 = _ref(name.format("64")), _ref(name.format("32"))
    d, control = _dist(got, f64), _dist(f32, f64)
    floor = 1e-6 * max(np.abs(x).max() for x in _leaves(f64))
    assert d <= max(FACTOR * control, floor), (name, d, control)
    return d, control


def _pipe_mesh(p):
    return mesh_lib.create_mesh((p,), ("pipe",), devices=["cpu"] * p)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    """Start the two ranks now; the first test that needs them waits."""
    out = str(tmp_path_factory.mktemp("pp"))
    port = _free_port()
    deadline = time.monotonic() + LAUNCH_TIMEOUT_S
    procs = []
    for rank in range(WORLD):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE=str(WORLD), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), CUDA_VISIBLE_DEVICES="",
                   OMP_NUM_THREADS="2")
        log = open(os.path.join(out, f"rank{rank}.log"), "w")
        procs.append((subprocess.Popen([sys.executable, WORKER, out],
                                       env=env, stdout=log,
                                       stderr=subprocess.STDOUT), log))
    results = {}

    def wait():
        if results:
            return results["ranks"]
        try:
            for p, _ in procs:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p, log in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                log.close()
        for rank, (p, _) in enumerate(procs):
            if p.returncode != 0:
                with open(os.path.join(out, f"rank{rank}.log")) as f:
                    tail = f.read()[-3000:]
                pytest.fail(f"rank {rank} exited {p.returncode}:\n{tail}")
        results["ranks"] = [torch.load(os.path.join(out, f"rank{r}.pt"),
                                       weights_only=False)
                            for r in range(WORLD)]
        return results["ranks"]

    yield wait
    wait()


@pytest.fixture(scope="module")
def fwd_model():
    v = random_variables(FWD_STACKS, CH)
    return (StackedHourglass(num_stacks=FWD_STACKS, num_channels=CH),
            pipeline.split_pipeline_variables(v, FWD_STACKS), v)


# ---------------------------------------------------------------------------
# Variables.
# ---------------------------------------------------------------------------

def test_split_and_merge_match_jax_leaf_for_leaf(cluster, fwd_model):
    model, (front, stacked), v = fwd_model
    jfront, jstacked = jpipeline.split_pipeline_variables(v, FWD_STACKS)
    for got, want in ((front, jfront), (stacked, jstacked)):
        assert jax.tree.structure(got) == jax.tree.structure(
            jax.tree.map(np.asarray, want))
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, np.asarray(b))
    k2 = stacked["params"]["hg0_conv_1x1_2"]["kernel"]
    assert k2.shape[0] == FWD_STACKS and not k2[-1].any() and k2[0].any()
    merged = pipeline.merge_pipeline_variables(front, stacked, FWD_STACKS)
    assert jax.tree.structure(merged) == jax.tree.structure(v)
    for a, b in zip(jax.tree.leaves(merged), jax.tree.leaves(v)):
        np.testing.assert_array_equal(a, b)
    # Placed modules give the same variables back, and so does a state.
    placed = pipeline.pipeline_variables(*pipeline.place_pipeline(
        model, front, stacked, [torch.device("cpu")] * 4))
    for a, b in zip(jax.tree.leaves(placed), jax.tree.leaves((front,
                                                              stacked))):
        np.testing.assert_array_equal(a, b)
    state = pipeline.PipelineTrainState.create(
        model, lambda m: steps.make_optimizer(m, LR), _pipe_mesh(4),
        variables=v)
    for a, b in zip(jax.tree.leaves(state.variables()), jax.tree.leaves(v)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Forward and eval loss against JAX's pipeline.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["pipe", "data_pipe"])
def test_forward_matches_jax(fwd_model, layout):
    model, (front, stacked), _ = fwd_model
    x, _ = _fwd_inputs()
    if layout == "pipe":
        mesh, m, want = _pipe_mesh(4), 4, _ref("fwd32")
    else:
        mesh = mesh_lib.create_mesh((2, 2), ("data", "pipe"),
                                    devices=["cpu"] * 4)
        m, want = 2, _ref("fwd_dp32")
    assert mesh.shape == ({"pipe": 4} if layout == "pipe"
                          else {"data": 2, "pipe": 2})
    got = pipeline.make_pipeline_forward(model, mesh, m)(
        front, stacked, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL_FWD)
    _within_jax_f32(got, "fwd{}")
    # Placed modules (a state's) give the same heatmaps, and a train-mode
    # forward leaves the running statistics as they are.
    f_mod, stages = pipeline.place_pipeline(model, front, stacked,
                                            mesh.pipe_devices())
    before = [b.clone() for b in f_mod.buffers()]
    again = pipeline.make_pipeline_forward(model, mesh, m)(
        f_mod, stages, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(again, got)
    pipeline.make_pipeline_forward(model, mesh, m, train=True)(
        f_mod, stages, torch.from_numpy(x))
    assert all(torch.equal(a, b) for a, b in zip(before, f_mod.buffers()))


def test_eval_loss_matches_jax(fwd_model):
    model, (front, stacked), _ = fwd_model
    x, t = _fwd_inputs()
    loss = pipeline.make_pipeline_loss_fn(model, _pipe_mesh(4), losses.iou,
                                          4, train=False)
    total, per_stack = loss(front, stacked, torch.from_numpy(x),
                            torch.from_numpy(t))
    want = _ref("eval32")
    assert abs(total.item() - want["total"]) <= ATOL_EVAL
    np.testing.assert_allclose(torch.stack(per_stack).detach().numpy(),
                               want["per_stack"], atol=ATOL_EVAL)


def test_mobile_forward_matches_jax():
    v = random_variables(FWD_STACKS, CH, mobile=True)
    model = StackedHourglass(num_stacks=FWD_STACKS, num_channels=CH,
                             mobile=True)
    x, _ = _fwd_inputs()
    got = pipeline.make_pipeline_forward(model, _pipe_mesh(4), 4)(
        *pipeline.split_pipeline_variables(v, FWD_STACKS),
        torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, _ref("mobile32"), atol=ATOL_FWD)
    _within_jax_f32(got, "mobile{}")


# ---------------------------------------------------------------------------
# Train mode.
# ---------------------------------------------------------------------------

def _train_inputs():
    b = step_batch()
    t = np.random.default_rng(4).uniform(
        0, 1, (len(b["image"]), LABEL, LABEL, 17)).astype(np.float32)
    return torch.from_numpy(b["image"]), torch.from_numpy(t)


def test_train_loss_stats_and_grads_match_jax():
    """make_pipeline_loss_fn(carry_stats=True) at M = 2 on a 2-device pipe
    mesh: the losses, the carried statistics (returned, and in the
    modules) and the grads."""
    model = StackedHourglass(num_stacks=STACKS, num_channels=CH)
    f_mod, stages = pipeline.place_pipeline(
        model, *pipeline.split_pipeline_variables(
            random_variables(STACKS, CH), STACKS), [torch.device("cpu")] * 2)
    loss = pipeline.make_pipeline_loss_fn(model, _pipe_mesh(2), losses.iou,
                                          M, train=True, carry_stats=True)
    x, t = _train_inputs()
    total, (per_stack, front_stats, stacked_stats) = loss(f_mod, stages, x, t)
    total.backward()
    want = _ref("loss64")
    np.testing.assert_allclose(total.item(), want["total"], rtol=RTOL_LOSS)
    np.testing.assert_allclose(torch.stack(per_stack).detach().numpy(),
                               want["per_stack"], rtol=RTOL_LOSS)
    _within_jax_f32(front_stats, "loss{}/front_stats")
    _within_jax_f32(stacked_stats, "loss{}/stacked_stats")
    _within_jax_f32(grads_tree(f_mod), "loss{}/front_grads")
    _within_jax_f32(pipeline._map_leaves(
        lambda *xs: np.stack(xs), *[grads_tree(s) for s in stages]),
        "loss{}/stacked_grads")
    for name, bn in front_stats.items():
        assert torch.equal(bn["mean"], getattr(f_mod, name).running_mean)
    # The last stack's zero-padded interface convs get no gradient.
    assert stages[-1].hg0_conv_1x1_2.weight.grad is None
    # Without carry_stats the running statistics stay as they are.
    before = [b.clone() for s in stages for b in s.buffers()]
    loss = pipeline.make_pipeline_loss_fn(model, _pipe_mesh(2), losses.iou,
                                          M, train=True)
    loss(f_mod, stages, x, t)
    after = [b for s in stages for b in s.buffers()]
    assert all(torch.equal(a, b) for a, b in zip(before, after))


def test_train_step_on_a_gloo_cluster_matches_jax(cluster):
    """Two processes over a (2, 2) ("data", "pipe") mesh, two steps: each
    step's metrics, the first step's grads and the variables after the
    second, against JAX's `make_pipeline_train_step` on its (2, 2) mesh;
    both ranks hold the same metrics and bits."""
    ranks = cluster()
    for r, res in enumerate(ranks):
        assert res["rank"] == r and res["shape"] == {"data": WORLD,
                                                     "pipe": PIPE}
        assert res["devices"] == (torch.device("cpu"),) * PIPE
    a, b = ranks
    assert a["metrics"] == b["metrics"]
    for x, y in zip(jax.tree.leaves(a["variables"]),
                    jax.tree.leaves(b["variables"])):
        np.testing.assert_array_equal(x, y)
    with np.load(REF) as f:
        for i in range(STEPS):
            got = a["metrics"][i]
            assert sorted(got) == sorted(
                k.split("/", 3)[-1] for k in f.files
                if k.startswith(f"step64/metrics/{i}/"))
            for k, v in got.items():
                want, jax32 = (float(f[f"step{t}/metrics/{i}/{k}"])
                               for t in ("64", "32"))
                if i == 0:
                    np.testing.assert_allclose(v, want, rtol=RTOL_LOSS,
                                               err_msg=k)
                # After an Adam step the params where the gradient is
                # noise have moved by +-LR (JAX's float32 and float64 too).
                assert abs(v - want) <= max(FACTOR * abs(jax32 - want),
                                            RTOL_LOSS * abs(want)), (i, k)
    grads = {"front": a["front_grads"], "stacked": pipeline._map_leaves(
        lambda *xs: np.stack(xs), *a["stacked_grads"])}
    _within_jax_f32(grads, "step{}/grads")
    _within_jax_f32(a["variables"]["batch_stats"], "step{}/variables/"
                    "batch_stats")
    _within_jax_f32(a["variables"]["params"], "step{}/variables/params")


def test_m1_step_equals_the_sequential_step():
    """At M = 1 on a pipe-only mesh the pipelined step is the sequential
    step: the front and every stack normalise the whole batch."""
    v = random_variables(STACKS, CH)
    model = StackedHourglass(num_stacks=STACKS, num_channels=CH)
    state = pipeline.PipelineTrainState.create(
        model, lambda m: steps.make_optimizer(m, LR), _pipe_mesh(2),
        variables=v)
    step = pipeline.make_pipeline_train_step(model, losses.iou, step_config(),
                                             _pipe_mesh(2), 1, augment=False)
    batch = {k: torch.from_numpy(a) for k, a in step_batch().items()}
    state, m = step(state, batch)
    seq = steps.TrainState.create(
        load_variables(StackedHourglass(num_stacks=STACKS, num_channels=CH),
                       v), lambda m: steps.make_optimizer(m, LR), device="cpu")
    seq_step = steps.make_train_step(losses.iou, step_config(), augment=False)
    seq, want = seq_step(seq, batch)
    assert {k: t.item() for k, t in m.items()} == \
        {k: t.item() for k, t in want.items()}
    merged = state.variables()
    ref = to_variables(seq.model)
    for a, b in zip(jax.tree.leaves(merged["batch_stats"]),
                    jax.tree.leaves(ref["batch_stats"])):
        np.testing.assert_array_equal(a, b)
    grads = {n: p.grad for n, p in seq.model.named_parameters()}
    scale = max(g.abs().max().item() for g in grads.values())
    got = [grads_tree(state.front)] + [grads_tree(s) for s in state.stacked]
    want_g = to_variables(grads)["params"]
    for i, tree in enumerate(got):
        for name, leaves in tree.items():
            if i > 0:
                name = f"hg{i - 1}" + name[len("hg0"):]
                if name not in want_g:      # the last stack's pruned convs
                    assert not any(np.abs(a).max() for a in
                                   jax.tree.leaves(leaves))
                    continue
            assert _dist(leaves, want_g[name]) <= 1e-6 * scale, name


def test_recalibrate_pipeline_batch_stats():
    v = random_variables(STACKS, CH)
    model = StackedHourglass(num_stacks=STACKS, num_channels=CH)
    state = pipeline.PipelineTrainState.create(
        model, lambda m: steps.make_optimizer(m, LR), _pipe_mesh(2),
        variables=v)
    images = step_batch()["image"]
    params_before = state.variables()["params"]
    state = pipeline.recalibrate_pipeline_batch_stats(
        model, state, [{"image": images}], momentum=0.0)
    seq = steps.TrainState.create(
        load_variables(StackedHourglass(num_stacks=STACKS, num_channels=CH),
                       v), lambda m: steps.make_optimizer(m, LR), device="cpu")
    steps.recalibrate_batch_stats(seq, [{"image": images}], momentum=0.0)
    got = state.variables()
    for a, b in zip(jax.tree.leaves(got["batch_stats"]),
                    jax.tree.leaves(to_variables(seq.model)["batch_stats"])):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree.leaves(got["params"]),
                    jax.tree.leaves(params_before)):
        np.testing.assert_array_equal(a, b)


def test_indivisible_batch_or_stacks_raise(fwd_model):
    model, (front, stacked), _ = fwd_model
    x = torch.from_numpy(_fwd_inputs()[0])
    with pytest.raises(ValueError, match="not divisible"):
        pipeline.make_pipeline_forward(model, _pipe_mesh(4), 3)(front,
                                                                 stacked, x)
    with pytest.raises(ValueError, match="do not split"):
        pipeline.make_pipeline_forward(model, _pipe_mesh(3), 2)
    with pytest.raises(ValueError, match="one process per data index"):
        pipeline.make_pipeline_loss_fn(
            model, mesh_lib.create_mesh((2, 2), ("data", "pipe"),
                                        devices=["cpu"] * 4), losses.iou, 2)
    with pytest.raises(ValueError, match="pipe axis"):
        pipeline.make_pipeline_forward(
            model, mesh_lib.create_mesh(devices=["cpu"] * 2), 2)
    with pytest.raises(ValueError, match="give the pipe axis"):
        mesh_lib.create_mesh((2, -1), ("data", "pipe"), devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="does not divide"):
        mesh_lib.create_mesh((-1, 3), ("data", "pipe"), devices=["cpu"] * 4)
