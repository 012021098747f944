"""Data parallel in the port (`parallel/`, and the `mesh=` seams of the
train step, the Trainer, the CLI, `predict_ds` and `PoseServer`), on the
CPU.

One two-process gloo cluster (tests/torch_port_dp_worker.py, torchrun's
environment, a 60 s limit) runs the multi-process checks at S2/C16, 64x64
input, 16x16 labels and 4 rows a rank; this process computes the
references meanwhile:

* the step, both backends (the fused one on its plain backend), with
  augmentation off, against the JAX package's `make_train_step` on a
  2-device mesh over the same global batch of 8, evaluated in float64:
  losses rtol 1e-5 and running statistics within STATS_REL of each
  tensor's largest value. The grads are held against JAX and against one
  port process on the concatenated batch (the step that
  tests/test_torch_train_step.py and test_torch_fused_train.py hold
  against JAX) through a one-ulp control: the distance that one ulp on
  the input pixels moves the one-process grads. The data-parallel grads
  lie within ULP_FACTOR (2) times that control of the one-process grads,
  and no further from JAX's than those plus it. The JAX package's own
  `test_data_parallel_matches_single_device` holds params within 2e-4
  after an SGD step; grads within 2e-4 are out of reach in float32 here:
  at these random weights (1x1 maps at the hourglass bottom, BN over 8
  values) the float32 grads of either package lie up to 0.6 (JAX) and
  5.8 (the port) from float64 at a largest |g| of 27.9, while the port
  run in float64 lies 9.3e-6 from JAX's float64 step (measured once);
* the fused bottleneck alone, "plain" and "cuda" backends (the latter
  on the kernels' plain versions): the ranks' outputs, statistics and
  input grads are those of one process on the concatenated rows, and the
  ranks' weight and BN parameter grads are shares that sum to that
  process's grads; W times a share would miss them;
* with augmentation on, the two ranks together equal one port process on
  the concatenated batch (the draws are made for the global batch);
* a 2-epoch `Trainer(mesh=)` over disjoint record shards: the same rows,
  best checkpoint and bit-equal state on both ranks, the aggregated
  val_loss equal to one process's over the union of the shards, and a
  resume from rank 0's checkpoint; then `cli train --data-parallel`.

The one-process seams (`predict_ds`, `PoseServer`, `make_predict_fn` over
a mesh of [cpu, cpu]) are held against the same call without a mesh on a
peaked fixture (keypoints equal, confidences within ATOL_CONF), and the
mesh and process helpers against their contracts.
"""

import os
import socket
import subprocess
import sys
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from single_person_pose_estimation_tpu import losses as jlosses
from single_person_pose_estimation_tpu.configs.default_config import (
    Config as JConfig,
)
from single_person_pose_estimation_tpu.models.hourglass import (
    create_hourglass_model,
)
from single_person_pose_estimation_tpu.parallel import mesh as jmesh
from single_person_pose_estimation_tpu.training import steps as jsteps
from single_person_pose_estimation_tpu_torch import Config, losses
from single_person_pose_estimation_tpu_torch.data import coco, pipeline
from single_person_pose_estimation_tpu_torch.data.device_prefetch import (
    device_prefetch,
)
from single_person_pose_estimation_tpu_torch.evaluation import predict
from single_person_pose_estimation_tpu_torch.parallel import distributed
from single_person_pose_estimation_tpu_torch.parallel import mesh as mesh_lib
from single_person_pose_estimation_tpu_torch.serving import PoseServer
from single_person_pose_estimation_tpu_torch.training import steps
from single_person_pose_estimation_tpu_torch.training.checkpoint import (
    CheckpointManager,
)
from single_person_pose_estimation_tpu_torch.utils.weight_convert import (
    to_state_dict,
)
from torch_port_dp_worker import (
    CH,
    LABEL,
    LR,
    SIZE,
    STACKS,
    bottleneck_run,
    data_config,
    one_step,
    step_config,
)
from torch_port_fixtures import (
    make_spot_coco,
    peaked_variables,
    random_variables,
    torch_model,
)

WORLD, B = 2, 4
WORKER = os.path.join(os.path.dirname(__file__), "torch_port_dp_worker.py")
LAUNCH_TIMEOUT_S = 60
RTOL_LOSS = 1e-5
ULP_FACTOR = 2.0
STATS_REL = 3e-4
BNECK_REL = 1e-5       # of each tensor's largest |value|
# The worker's steps: (model_backend, augment).
RUNS = {"flax": ("flax", False), "fused": ("fused", False),
        "augment": ("flax", True)}
RTOL_VAL = 1e-6
# The CPU's convolutions round a half batch differently from a whole one
# (1.8e-7 at most on these heatmaps), so over a mesh the keypoints are
# equal and the confidences (heatmap maxima) agree within ATOL_CONF.
ATOL_CONF = 1e-6


def _global_batch(seed=3):
    rng = np.random.default_rng(seed)
    n = WORLD * B
    return {"image": rng.uniform(0, 1, (n, SIZE, SIZE, 3)).astype(np.float32),
            "kx": rng.uniform(1, LABEL - 1, (n, 17)).astype(np.float32),
            "ky": rng.uniform(1, LABEL - 1, (n, 17)).astype(np.float32),
            "kv": rng.integers(0, 3, (n, 17)).astype(np.int32)}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_cluster(out):
    """Launch the ranks; returns (deadline, [(process, log file)])."""
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
    return deadline, procs


def _wait_cluster(cluster, out):
    """Every worker's result; a worker that fails or outlives
    LAUNCH_TIMEOUT_S from the launch fails the fixture."""
    deadline, procs = cluster
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
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(WORLD)]


def _write_records(root):
    make_spot_coco(root, "train2017", n_images=16, seed=2)
    make_spot_coco(root, "val2017", n_images=16, seed=3)
    coco.gen_trainval_records(data_config(root, root))


def jax_mesh_step(batch):
    """One JAX `make_train_step` on a 2-device mesh, augmentation off, in
    float64: its loss metrics, grads (Adam's first moment after one step
    is 0.1 g) and running statistics, in the port's state_dict layout."""
    v = random_variables(STACKS, CH)
    with jax.enable_x64(True):
        model = create_hourglass_model(17, STACKS, CH,
                                       compute_dtype=jnp.float64)
        tx = jsteps.make_optimizer(LR)
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                              v["params"])
        mesh = jmesh.create_mesh(devices=jax.devices()[:WORLD])
        state = jsteps.TrainState(
            step=jnp.zeros((), jnp.int32), params=params,
            batch_stats=jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                                     v["batch_stats"]),
            opt_state=tx.init(params), rng=jax.random.PRNGKey(0))
        state = jax.device_put(state, jmesh.replicated(mesh))
        cfg = step_config(WORLD * B)
        step = jsteps.make_train_step(
            model, tx, jlosses.weighted_mse,
            JConfig(**{f: getattr(cfg, f) for f in (
                "image_height", "image_width", "label_height",
                "label_width", "hg_num_stacks", "hg_num_channels",
                "batch_size")}),
            mesh=mesh, augment=False)
        jbatch = jmesh.shard_batch(
            {k: jnp.asarray(a) for k, a in batch.items()}, mesh)
        state, m = step(state, jbatch)
        mu = next(s.mu for s in jax.tree_util.tree_leaves(
            state.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
            if hasattr(s, "mu"))
        grads = to_state_dict({"params": jax.tree.map(
            lambda a: np.asarray(a, np.float64) / 0.1, mu)})
        stats = to_state_dict({"params": {}, "batch_stats": jax.tree.map(
            lambda a: np.asarray(a, np.float64), state.batch_stats)})
        return {k: float(x) for k, x in m.items()}, grads, stats


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dp"))
    batch = _global_batch()
    np.savez(os.path.join(out, "inputs.npz"), **batch)
    _write_records(os.path.join(out, "data"))
    cluster = _start_cluster(out)
    try:
        ref = types.SimpleNamespace()
        ref.metrics, ref.grads, ref.stats = jax_mesh_step(batch)
        ulp = dict(batch, image=np.nextafter(batch["image"], np.float32(2)))
        ref.single = {k: one_step(None, batch, *run)
                      for k, run in RUNS.items()}
        ref.ulp = {k: one_step(None, ulp, *run)["grads"]
                   for k, run in RUNS.items()}
        ref.bottleneck = {b: bottleneck_run(b) for b in ("plain", "cuda")}
    finally:
        ranks = _wait_cluster(cluster, out)
    return types.SimpleNamespace(out=out, ranks=ranks, ref=ref)


# ---------------------------------------------------------------------------
# The two-process cluster.
# ---------------------------------------------------------------------------

def test_ranks_form_one_gloo_mesh(dp):
    for rank, res in enumerate(dp.ranks):
        assert (res["rank"], res["world"]) == (rank, WORLD)
        assert res["devices"] == (torch.device("cpu"),) * WORLD


def _max_dist(a, b):
    return max((a[n].double() - b[n].double()).abs().max().item() for n in b)


def _l2_dist(a, b):
    return torch.cat([(a[n].double() - b[n].double()).flatten()
                      for n in b]).norm().item()


@pytest.mark.parametrize("backend", ["flax", "fused"])
def test_step_matches_the_jax_mesh_step(dp, backend):
    single, ulp = dp.ref.single[backend]["grads"], dp.ref.ulp[backend]
    for res in dp.ranks:
        got = res[backend]
        assert got["metrics"].keys() == dp.ref.metrics.keys()
        for k, want in dp.ref.metrics.items():
            np.testing.assert_allclose(got["metrics"][k], want,
                                       rtol=RTOL_LOSS, err_msg=k)
        for n, want in dp.ref.stats.items():
            d = (got["state"][n].double() - want).abs().max().item()
            assert d <= STATS_REL * want.abs().max().item(), (n, d)
        grads = got["grads"]
        assert grads.keys() == dp.ref.grads.keys()
        for dist in (_max_dist, _l2_dist):
            assert dist(grads, dp.ref.grads) <= dist(
                single, dp.ref.grads) + ULP_FACTOR * dist(ulp, single)


@pytest.mark.parametrize("backend", list(RUNS))
def test_step_equals_one_process_on_the_concatenated_batch(dp, backend):
    """With augmentation ("augment") each rank draws for the global batch,
    so the ranks together augment as one process does the concatenated
    batch."""
    want = dp.ref.single[backend]
    control = _max_dist(dp.ref.ulp[backend], want["grads"])
    for res in dp.ranks:
        got = res[backend]
        for k, w in want["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], w, rtol=RTOL_LOSS,
                                       err_msg=k)
        d = _max_dist(got["grads"], want["grads"])
        assert d <= ULP_FACTOR * control, (d, control)
        for n, w in want["state"].items():
            if "running" in n:
                d = (got["state"][n] - w).abs().max().item()
                assert d <= STATS_REL * w.abs().max().item(), (n, d)
    # One update of the same numbers on both ranks: the same bits.
    a, b = (res[backend] for res in dp.ranks)
    for n in a["grads"]:
        assert torch.equal(a["grads"][n], b["grads"][n]), n
    for n in a["state"]:
        assert torch.equal(a["state"][n], b["state"][n]), n


def test_fused_bn_parameter_grads_are_the_ranks_shares(dp):
    """The step's BN parameter grads: the shares the all-reduce sums are
    each rank's own; W times them (what global sums in dgamma/dbeta
    would give) misses the one-process grads by far more than the
    tolerance above."""
    want = dp.ref.single["fused"]["grads"]
    control = _max_dist(dp.ref.ulp["fused"], want)
    got = dp.ranks[0]["fused"]["grads"]
    bn = [n for n in want if "_bn." in n]
    assert _max_dist({n: got[n] for n in bn},
                     {n: want[n] for n in bn}) <= ULP_FACTOR * control
    assert _max_dist({n: WORLD * got[n] for n in bn},
                     {n: want[n] for n in bn}) > 10 * ULP_FACTOR * control


@pytest.mark.parametrize("backend", ["plain", "cuda"])
def test_fused_bottleneck_takes_global_sums_and_local_shares(dp, backend):
    """One bottleneck of the fused backend on 2 rows a rank: outputs,
    statistics and the input grad of each rank are one process's on its
    rows (global sums); the weight and BN parameter grads of the ranks
    are shares that sum to one process's grads (local sums). Were
    dgamma/dbeta computed from the global sums, each rank would hold the
    whole and their sum would be WORLD times the grad."""
    want = dp.ref.bottleneck[backend]
    got = [res["bottleneck"][backend] for res in dp.ranks]
    def close(a, b):
        tol = BNECK_REL * b.abs().max().item()
        torch.testing.assert_close(a, b, rtol=0, atol=tol)
    close(torch.cat([g["out"] for g in got]), want["out"])
    close(torch.cat([g["grads"][0] for g in got]), want["grads"][0])
    for r in got:
        for a, b in zip(r["stats"], want["stats"]):
            close(a, b)
    for i in range(1, 13):
        total = got[0]["grads"][i] + got[1]["grads"][i]
        close(total, want["grads"][i])
        if i >= 7:      # gamma and beta of the three BNs
            w = want["grads"][i]
            assert (WORLD * total - w).abs().max() \
                > 100 * BNECK_REL * w.abs().max(), i


def test_trainer_over_disjoint_shards(dp):
    t0, t1 = (res["trainer"] for res in dp.ranks)
    assert set(t0["train_files"]).isdisjoint(t1["train_files"])
    assert set(t0["valid_files"]).isdisjoint(t1["valid_files"])
    assert t0["steps_per_epoch"] == t1["steps_per_epoch"] == 2
    assert t0["rows"] == t1["rows"] and len(t0["rows"]) == 2
    best = min(range(2), key=lambda e: t0["rows"][e]["val_loss"]) + 1
    assert t0["best"] == t1["best"] and t0["best"]["epoch"] == best
    for n in t0["state"]:
        assert torch.equal(t0["state"][n], t1["state"][n]), n
    assert torch.equal(t0["generator"], t1["generator"])
    # A resume from rank 0's checkpoint: both ranks start from epoch 2's
    # state (not their own new weights) and end equal.
    assert t0["resumed_step"] == t1["resumed_step"] == 6
    assert t0["resumed_epochs"] == [1, 2, 3]
    for n in t0["resumed_state"]:
        assert torch.equal(t0["resumed_state"][n], t1["resumed_state"][n]), n


def test_aggregated_val_loss_equals_one_process_over_the_union(dp):
    """The last epoch's val_loss, weighted over the ranks by example
    count, against one process's eval of epoch 2's checkpoint over every
    validation shard."""
    cfg = data_config(os.path.join(dp.out, "data"), os.path.join(dp.out,
                                                                 "run"))
    model = torch_model(random_variables(1, CH), 1, CH)
    state = steps.TrainState.create(model, lambda m: steps.make_optimizer(
        m, LR), device="cpu")
    state, meta = CheckpointManager(cfg.checkpoints_path).restore(state, 2)
    eval_step = steps.make_eval_step(losses.weighted_mse, cfg)
    with pipeline.DatasetBuilder(cfg) as builder:
        _, valid = builder.build_datasets()
        n = builder.num_valid_examples // cfg.batch_size
        vals = [eval_step(state, next(valid))["loss"].item()
                for _ in range(n)]
    assert n == 4
    want = float(np.mean(vals))
    got = dp.ranks[0]["trainer"]["rows"][-1]["val_loss"]
    np.testing.assert_allclose(got, want, rtol=RTOL_VAL)


def test_cli_train_data_parallel(dp):
    for res in dp.ranks:
        assert res["cli"]["meta"]["epoch"] == 1


# ---------------------------------------------------------------------------
# One process over a mesh of [cpu, cpu].
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def peaked():
    return peaked_variables(1, CH)


def _cpu_mesh():
    return mesh_lib.create_mesh(devices=["cpu"] * WORLD)


def test_predict_ds_over_a_mesh_equals_no_mesh(tmp_path, peaked):
    root = str(tmp_path)
    make_spot_coco(root, "val2017", n_images=5, seed=4)
    make_spot_coco(root, "train2017", n_images=2, seed=5)
    cfg = data_config(root, root).replace(batch_size=3)
    coco.gen_trainval_records(cfg)
    got = {}
    for name, mesh in (("plain", None), ("mesh", _cpu_mesh())):
        with pipeline.DatasetBuilder(cfg) as builder:
            got[name] = predict.predict_ds(
                torch_model(peaked, 1, CH), None,
                builder.get_ds_prediction(), save_path=None, mesh=mesh,
                device="cpu")
    # Batches of 3 and 2 rows: the first pads to 4 and drops the padding.
    assert len(got["mesh"]) == len(got["plain"]) == 5
    for a, b in zip(got["mesh"], got["plain"]):
        confs_a, confs_b = a.pop("confs"), b.pop("confs")
        assert a == b
        np.testing.assert_allclose(confs_a, confs_b, rtol=0, atol=ATOL_CONF)


def test_pose_server_over_a_mesh_equals_no_mesh(peaked):
    x = np.random.default_rng(6).uniform(0, 1, (5, SIZE, SIZE, 3)) \
        .astype(np.float32)
    with PoseServer(torch_model(peaked, 1, CH), device="cpu",
                    buckets=(1, 4, 8)) as server:
        want = server.predict(x)
    with PoseServer(torch_model(peaked, 1, CH), mesh=_cpu_mesh(),
                    buckets=(1, 3, 8)) as server:
        assert server.buckets == (2, 4, 8)
        got = server.predict(x)
    np.testing.assert_array_equal(got[..., :2], want[..., :2])
    np.testing.assert_allclose(got[..., 2], want[..., 2], rtol=0,
                               atol=ATOL_CONF)


def test_make_predict_fn_over_a_mesh_equals_no_mesh(peaked):
    model = torch_model(peaked, 1, CH)
    x = torch.from_numpy(np.random.default_rng(7).uniform(
        0, 1, (3, SIZE, SIZE, 3)).astype(np.float32))
    want = steps.make_predict_fn(model)(x)
    got = steps.make_predict_fn(model, mesh=_cpu_mesh())(x)
    assert got.shape == want.shape == (3, LABEL, LABEL, 17)
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL_CONF)


def test_mesh_helpers():
    mesh = _cpu_mesh()
    assert (mesh.data_size, mesh.shape, mesh.rank, mesh.group) == (
        2, {"data": 2}, 0, None)
    assert mesh.local_devices == (torch.device("cpu"),) * 2
    batch = {"image": np.arange(6 * 2).reshape(6, 2), "kv": np.arange(6)}
    assert mesh_lib.batch_sharding(mesh, 6) == [slice(0, 3), slice(3, 6)]
    pieces = mesh_lib.shard_batch(batch, mesh)
    assert [p["kv"].tolist() for p in pieces] == [[0, 1, 2], [3, 4, 5]]
    padded, n = mesh_lib.pad_batch_to_devices(
        {"image": np.ones((3, 2), np.float32)}, 2)
    assert n == 3 and padded["image"].tolist() == [[1, 1]] * 3 + [[0, 0]]
    t, n = mesh_lib.pad_batch_to_devices(torch.ones(4, 1), 2)
    assert n == 4 and t.shape == (4, 1)
    model = torch_model(random_variables(1, CH), 1, CH)
    reps = mesh_lib.replicas(model, mesh)
    assert reps[0] is reps[1] is model
    with pytest.raises(ValueError, match="pad it first"):
        mesh_lib.batch_sharding(mesh, 3)
    with pytest.raises(ValueError, match="does not cover"):
        mesh_lib.create_mesh((3,), devices=["cpu"] * 2)
    with pytest.raises(NotImplementedError, match="mesh axes"):
        mesh_lib.create_mesh((-1, 2), ("pipe", "data"), devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="one process per device"):
        mesh_lib.create_mesh((-1, 2), ("data", "model"), devices=["cpu"] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mesh_lib.create_mesh(devices=["cuda:0", "cuda:0"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh_lib.create_mesh()
    with pytest.raises(ValueError, match="one process per device"):
        steps.make_train_step(losses.mse, Config(), mesh=mesh)
    pf = device_prefetch(iter([{"kv": np.arange(3)}]), mesh=mesh)
    assert torch.equal(next(pf)["kv"], torch.arange(3))
    pf.close()
    with pytest.raises(ValueError, match="mesh device"):
        device_prefetch(iter([]), "cuda:0", mesh=mesh)


def test_initialize_and_process_helpers(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize() is False        # no cluster: a no-op
    assert not distributed.is_initialized()
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="lacks"):
        distributed.initialize()
    monkeypatch.delenv("WORLD_SIZE")
    with pytest.raises(ValueError, match="num_processes"):
        distributed.initialize("127.0.0.1:1")
    # A named coordinator that nobody serves: raises, no quiet fallback.
    with pytest.raises(RuntimeError):
        distributed.initialize(f"127.0.0.1:{_free_port()}", 2, 1,
                               backend="gloo", timeout_s=1)
    assert not distributed.is_initialized()
    m = {"loss": np.float32(0.5), "acc": 2}
    assert distributed.aggregate_metrics(m, weight=3) == {"loss": 0.5,
                                                          "acc": 2.0}
    files = [f"f{i}" for i in range(5)]
    assert distributed.shard_files_for_process(files) == files
    assert distributed.shard_files_for_process(files, 1, 2) == ["f1", "f3"]
    assert distributed.shard_files_for_process(["a"], 1, 2,
                                               allow_replicate=True) == ["a"]
    with pytest.raises(ValueError, match="cannot feed"):
        distributed.shard_files_for_process(["a"], 1, 2)
    assert pipeline.shard_files_for_process is \
        distributed.shard_files_for_process
