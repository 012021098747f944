"""Tensor parallelism in the port (`parallel/sharding_rules.py` and the
`model_axis` seams of the train and eval steps, the Trainer and the
checkpoints), on the CPU.

One four-process gloo cluster (tests/torch_port_tp_worker.py, a ("data",
"model") mesh of 2 x 2, torchrun's environment, LAUNCH_TIMEOUT_S from the
launch) runs every multi-process case once at S2/C32, 64x64 input, 16x16
labels and a global batch of 8, the JAX tests' tiny model
(`tests/test_parallel.py`); this process computes the references
meanwhile, the JAX ones in threads:

* `leaf_spec` against JAX `_leaf_spec` for every leaf of the standard and
  the mobile S2/C32, their Adam moments and EMA copies; each rank holds
  half of every split leaf (parameter, grad, Adam moments, EMA) and the
  whole of every other;
* one step of the flax and the fused backend (standard; the fused one on
  its kernels' plain versions) and of flax (mobile), reassembled, against
  JAX's step on a (4, 2) ("data", "model") mesh with model_axis="model",
  evaluated in float64 (JAX's own float32 step lies 5.6e-4, 1.05e-3 and
  8.5e-3 from its unsharded float32 step there: ROADMAP Queue 3). The
  standard model's reference is JAX's fused step, whose float64 numbers
  are the flax step's (the two compute one function; one compile fewer).
  As in tests/test_torch_parallel.py: losses rtol RTOL_LOSS, running
  statistics within STATS_REL of each tensor's largest value, and the
  grads no further from JAX's than one port process on the whole batch
  plus ULP_FACTOR times a one-ulp control (the distance that one ulp on
  the input pixels moves that process's grads), in max |d| and in L2; and
  within ULP_FACTOR times the control of that process;
* the step equals one process's on the whole batch: the loss within
  RTOL_LOSS and, with frozen BN (the standard model with augmentation, so
  that the ranks of a model group see the rows and draws of their data
  index, and the mobile one), the grads within ULP_FACTOR times the
  one-ulp control. With train-mode BN over the 1x1 maps at the bottom of
  this tiny hourglass float32 sums in another order move the grads by
  more than one ulp on the input does (measured once: 3.0x that control
  in max |d| for the flax backend here, 0.31x at 128x128 and batch 16),
  so there the grads are held against JAX above;
* the leaves that the rule replicates hold the same bits on all four
  ranks after every step, and a split leaf the same bits on the two ranks
  of its slice;
* the fused bottleneck alone under tensor parallelism ("plain" and
  "cuda" backends): outputs, statistics and input grads are one
  process's, and the weight and BN grads are data shares of its
  channels;
* a checkpoint written under tensor parallelism is the file an unsharded
  state writes (full shapes), restores without tensor parallelism and
  with it to the same bits, a checkpoint written without it restores
  under it, and best promotion works;
* `make_eval_step(model_axis=)` gives JAX's eval losses (its (4, 2) mesh
  eval step, float64) within RTOL_LOSS;
* `Trainer(model_axis="model")` runs an epoch;
* what it does not cover raises ValueError: a backend other than gloo
  and NCCL, a device the group cannot reduce on, a model_axis without a
  mesh that has it or over an unsharded state, a state sharded twice.
"""

import os
import socket
import subprocess
import sys
import time
import types
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from single_person_pose_estimation_tpu import losses as jlosses
from single_person_pose_estimation_tpu.configs.default_config import (
    Config as JConfig,
)
from single_person_pose_estimation_tpu.models.hourglass import (
    create_hourglass_model,
)
from single_person_pose_estimation_tpu.parallel import mesh as jmesh
from single_person_pose_estimation_tpu.parallel import (
    sharding_rules as jrules,
)
from single_person_pose_estimation_tpu.training import steps as jsteps
from single_person_pose_estimation_tpu_torch import losses
from single_person_pose_estimation_tpu_torch.parallel.mesh import create_mesh
from single_person_pose_estimation_tpu_torch.parallel.sharding_rules import (
    leaf_spec,
    shard_state,
)
from single_person_pose_estimation_tpu_torch.training import steps
from single_person_pose_estimation_tpu_torch.training.checkpoint import (
    CheckpointManager,
)
from single_person_pose_estimation_tpu_torch.utils.weight_convert import (
    to_state_dict,
)
from torch_port_dp_worker import bottleneck_run as dp_bottleneck_run
from torch_port_fixtures import random_variables
from torch_port_tp_worker import (
    CH,
    DATA,
    EMA,
    LABEL,
    LR,
    MODEL,
    RUNS,
    SIZE,
    STACKS,
    new_state,
    one_step,
    snapshot,
    step_config,
)

WORLD, N = DATA * MODEL, 8
WORKER = os.path.join(os.path.dirname(__file__), "torch_port_tp_worker.py")
LAUNCH_TIMEOUT_S = 120
RTOL_LOSS = 1e-5
STATS_REL = 3e-4
ULP_FACTOR = 2.0
BNECK_REL = 1e-5        # of each tensor's largest |value|
KINDS = ("state", "grads", "exp_avg", "exp_avg_sq", "ema")


def _global_batch(seed=3):
    rng = np.random.default_rng(seed)
    return {"image": rng.uniform(0, 1, (N, SIZE, SIZE, 3)).astype(np.float32),
            "kx": rng.uniform(1, LABEL - 1, (N, 17)).astype(np.float32),
            "ky": rng.uniform(1, LABEL - 1, (N, 17)).astype(np.float32),
            "kv": rng.integers(0, 3, (N, 17)).astype(np.int32)}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_cluster(out):
    port = _free_port()
    deadline = time.monotonic() + LAUNCH_TIMEOUT_S
    procs = []
    for rank in range(WORLD):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE=str(WORLD), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), CUDA_VISIBLE_DEVICES="",
                   OMP_NUM_THREADS="1")
        log = open(os.path.join(out, f"rank{rank}.log"), "w")
        procs.append((subprocess.Popen([sys.executable, WORKER, out],
                                       env=env, stdout=log,
                                       stderr=subprocess.STDOUT), log))
    return deadline, procs


def _wait_cluster(cluster, out):
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


def _jax_cfg(b):
    cfg = step_config(b)
    return JConfig(**{f: getattr(cfg, f) for f in (
        "image_height", "image_width", "label_height", "label_width",
        "hg_num_stacks", "hg_num_channels", "batch_size")})


def _jax_state(v, dt, tx):
    cast = lambda t: jax.tree.map(lambda a: jnp.asarray(a, dt), t)
    params = cast(v["params"])
    return jsteps.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=cast(v["batch_stats"]), opt_state=tx.init(params),
        rng=jax.random.PRNGKey(0))


def jax_tp_step(batch, backend, mobile):
    """JAX's train step on a (4, 2) ("data", "model") mesh with
    model_axis="model", augmentation off, in float64: loss metrics, grads
    (Adam's first moment after one step is 0.1 g) and running statistics,
    in the port's state_dict layout."""
    v = random_variables(STACKS, CH, mobile=mobile)
    with jax.enable_x64(True):
        model = create_hourglass_model(17, STACKS, CH, mobile=mobile,
                                       compute_dtype=jnp.float64)
        tx = jsteps.make_optimizer(LR)
        mesh = jmesh.create_mesh((4, 2), ("data", "model"))
        state = jrules.shard_state(_jax_state(v, jnp.float64, tx), mesh,
                                   "model")
        step = jsteps.make_train_step(
            model, tx, jlosses.weighted_mse, _jax_cfg(N), mesh=mesh,
            augment=False, model_axis="model", example_state=state,
            model_backend=backend)
        state, m = step(state, jmesh.shard_batch(
            {k: jnp.asarray(a) for k, a in batch.items()}, mesh))
        mu = next(s.mu for s in jax.tree_util.tree_leaves(
            state.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
            if hasattr(s, "mu"))
        grads = to_state_dict({"params": jax.tree.map(
            lambda a: np.asarray(a, np.float64) / 0.1, mu)})
        stats = to_state_dict({"params": {}, "batch_stats": jax.tree.map(
            lambda a: np.asarray(a, np.float64), state.batch_stats)})
        return {k: float(x) for k, x in m.items()}, grads, stats


def jax_tp_eval(batch):
    """JAX's eval step on the (4, 2) mesh with model_axis="model", in
    float64, on the initial state."""
    v = random_variables(STACKS, CH)
    with jax.enable_x64(True):
        model = create_hourglass_model(17, STACKS, CH,
                                       compute_dtype=jnp.float64)
        mesh = jmesh.create_mesh((4, 2), ("data", "model"))
        state = jrules.shard_state(
            _jax_state(v, jnp.float64, jsteps.make_optimizer(LR)), mesh,
            "model")
        step = jsteps.make_eval_step(model, jlosses.weighted_mse,
                                     _jax_cfg(N), mesh=mesh,
                                     model_axis="model",
                                     example_state=state)
        m = step(state, jmesh.shard_batch(
            {k: jnp.asarray(a) for k, a in batch.items()}, mesh))
        return {k: float(x) for k, x in m.items()}


class _Run(types.SimpleNamespace):
    """The cluster's results and the references; a short repr, since
    pytest prints a failed test's arguments."""

    def __repr__(self):
        return f"<tensor-parallel run in {self.out}>"


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("tp"))
    batch = _global_batch()
    np.savez(os.path.join(out, "inputs.npz"), **batch)
    # A checkpoint written without tensor parallelism, after one step.
    plain, _ = one_step(None, batch, *RUNS["flax"])
    CheckpointManager(os.path.join(out, "plain")).save(1, plain, {})
    cluster = _start_cluster(out)
    try:
        with ThreadPoolExecutor(3) as pool:
            jobs = {"standard": pool.submit(jax_tp_step, batch, "fused",
                                            False),
                    "mobile": pool.submit(jax_tp_step, batch, "flax", True),
                    "eval": pool.submit(jax_tp_eval, batch)}
            ref = types.SimpleNamespace(plain=snapshot(plain))
            ref.single = {k: one_step(None, batch, *run)[1]
                          for k, run in RUNS.items()}
            ulp = dict(batch, image=np.nextafter(batch["image"],
                                                 np.float32(2)))
            ref.ulp = {k: one_step(None, ulp, *run)[1]["grads"]
                       for k, run in RUNS.items()}
            ref.bottleneck = {b: dp_bottleneck_run(b)
                              for b in ("plain", "cuda")}
            ref.jax = {k: f.result() for k, f in jobs.items()}
    finally:
        ranks = _wait_cluster(cluster, out)
    return _Run(out=out, ranks=ranks, ref=ref)


def _reassemble(ranks, run, kind="state"):
    """The full tensors of a run from the ranks of data index 0: a split
    leaf's slices side by side along dim 0, any other leaf rank 0's."""
    split = ranks[0][run]["split"]
    parts = [r[run][kind] for r in ranks if r["data_index"] == 0]
    return {n: torch.cat([p[n] for p in parts]) if n in split else t
            for n, t in parts[0].items()}


def _max_dist(a, b):
    return max((a[n].double() - b[n].double()).abs().max().item() for n in b)


def _l2_dist(a, b):
    return torch.cat([(a[n].double() - b[n].double()).flatten()
                      for n in b]).norm().item()


# ---------------------------------------------------------------------------
# The rule and the shards.
# ---------------------------------------------------------------------------

def _want(tree):
    """JAX's rule on a flax params tree, in the port's names: True where
    _leaf_spec splits the leaf over a model axis of 2."""
    flags = jax.tree.map(lambda a: np.full(np.shape(a), float(
        jrules._leaf_spec(a, "model", MODEL) != P()), np.float32), tree)
    return {n: bool(t.flatten()[0]) for n, t in to_state_dict(flags).items()}


@pytest.mark.parametrize("mobile", [False, True])
def test_leaf_spec_matches_jax_leaf_for_leaf(mobile):
    """Every parameter and running statistic, and every Adam moment and
    EMA copy, of the standard and the mobile S2/C32."""
    v = random_variables(STACKS, CH, mobile=mobile)
    jstate = _jax_state(v, jnp.float32, jsteps.make_optimizer(
        LR, ema_decay=EMA))
    leaves = lambda pick: [s for s in jax.tree_util.tree_leaves(
        jstate.opt_state, is_leaf=pick) if pick(s)]
    (adam,) = leaves(lambda x: hasattr(x, "mu"))
    (ema,) = [s["ema"] for s in leaves(lambda x: isinstance(x, dict)
                                       and "ema" in x)]
    assert jrules._leaf_spec(adam.count, "model", MODEL) == P()
    _, port = one_step(None, _global_batch(), "flax", mobile, False,
                       "batch")
    trees = {"state": {"params": jstate.params,
                       "batch_stats": jstate.batch_stats},
             "exp_avg": {"params": adam.mu}, "exp_avg_sq": {"params": adam.nu},
             "ema": {"params": ema}}
    for kind, tree in trees.items():
        want = _want(tree)
        got = {n: leaf_spec(port[kind][n], MODEL) == 0 for n in want}
        assert got == want, kind
        assert any(want.values()) and not all(want.values()), kind
    for n, t in port["state"].items():
        if n.endswith("num_batches_tracked"):
            assert leaf_spec(t, MODEL) is None
    assert leaf_spec(torch.zeros(()), MODEL) is None


def test_ranks_form_a_2x2_mesh(tp):
    for rank, res in enumerate(tp.ranks):
        assert res["rank"] == rank
        assert (res["data_index"], res["model_index"]) == divmod(rank, MODEL)
        assert res["shape"] == {"data": DATA, "model": MODEL}
    want = {n for n, t in tp.ref.single["flax"]["state"].items()
            if leaf_spec(t, MODEL) is not None}
    assert tp.ranks[0]["split"] == want
    assert tp.ranks[0]["partial"] == {
        n for n, t in tp.ref.single["flax"]["grads"].items()
        if n not in want and t.dim() == 1 and t.shape[0] % MODEL == 0}


@pytest.mark.parametrize("run", list(RUNS))
def test_each_rank_holds_half_of_every_split_leaf(tp, run):
    full = tp.ref.single[run]
    split = {n for n, t in full["state"].items()
             if leaf_spec(t, MODEL) is not None}
    for res in tp.ranks:
        assert res[run]["split"] == split
        for kind in KINDS:
            got, want = res[run][kind], full[kind]
            assert got.keys() == want.keys(), kind
            for n, t in want.items():
                share = MODEL if n in split else 1
                assert got[n].numel() * share == t.numel(), (kind, n)


@pytest.mark.parametrize("run", list(RUNS))
def test_replicated_leaves_hold_the_same_bits_on_every_rank(tp, run):
    split = tp.ranks[0][run]["split"]
    for kind in KINDS:
        first = tp.ranks[0][run][kind]
        for res in tp.ranks[1:]:
            twin = tp.ranks[res["model_index"]][run][kind]
            for n, t in res[run][kind].items():
                want = twin[n] if n in split else first[n]
                assert torch.equal(t, want), (run, kind, res["rank"], n)


# ---------------------------------------------------------------------------
# The step against JAX's (data, model) step and one process.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("run", ["flax", "fused", "mobile"])
def test_step_matches_the_jax_model_axis_step(tp, run):
    metrics, jgrads, jstats = tp.ref.jax["mobile" if run == "mobile"
                                        else "standard"]
    single, ulp = tp.ref.single[run]["grads"], tp.ref.ulp[run]
    for res in tp.ranks:
        assert res[run]["metrics"].keys() == metrics.keys()
        for k, want in metrics.items():
            np.testing.assert_allclose(res[run]["metrics"][k], want,
                                       rtol=RTOL_LOSS, err_msg=k)
    state = _reassemble(tp.ranks, run)
    for n, want in jstats.items():
        d = (state[n].double() - want).abs().max().item()
        assert d <= STATS_REL * want.abs().max().item(), (n, d)
    grads = _reassemble(tp.ranks, run, "grads")
    assert grads.keys() == jgrads.keys()
    for dist in (_max_dist, _l2_dist):
        assert dist(grads, jgrads) <= dist(single, jgrads) \
            + ULP_FACTOR * dist(ulp, single), dist.__name__


@pytest.mark.parametrize("run", list(RUNS))
def test_step_equals_one_process_on_the_whole_batch(tp, run):
    want = tp.ref.single[run]
    for res in tp.ranks:
        for k, w in want["metrics"].items():
            np.testing.assert_allclose(res[run]["metrics"][k], w,
                                       rtol=RTOL_LOSS, err_msg=k)
    if RUNS[run][3] == "frozen":
        control = _max_dist(tp.ref.ulp[run], want["grads"])
        d = _max_dist(_reassemble(tp.ranks, run, "grads"), want["grads"])
        assert d <= ULP_FACTOR * control, (d, control)


@pytest.mark.parametrize("backend", ["plain", "cuda"])
def test_fused_bottleneck_under_tensor_parallel(tp, backend):
    """One bottleneck on 2 rows a data index and half the channels a
    model index: each rank's output (every channel) and input grad are
    one process's on its rows, its statistics that process's on its
    channels, and the weight and BN grads of its channels are data shares
    that sum to that process's."""
    want = tp.ref.bottleneck[backend]
    close = lambda a, b: torch.testing.assert_close(
        a, b, rtol=0, atol=BNECK_REL * b.abs().max().item())
    local = lambda t, i: t.narrow(t.dim() - 1, i * (t.shape[-1] // MODEL),
                                  t.shape[-1] // MODEL)
    for res in tp.ranks:
        got, rows = res["bottleneck"][backend], slice(
            2 * res["data_index"], 2 * res["data_index"] + 2)
        close(got["out"], want["out"][rows])
        close(got["grads"][0], want["grads"][0][rows])
        for a, b in zip(got["stats"], want["stats"]):
            close(a, local(b, res["model_index"]))
    for m in range(MODEL):
        shares = [r["bottleneck"][backend]["grads"] for r in tp.ranks
                  if r["model_index"] == m]
        for i in range(1, 13):
            close(shares[0][i] + shares[1][i], local(want["grads"][i], m))


# ---------------------------------------------------------------------------
# Checkpoints, evaluation and the Trainer.
# ---------------------------------------------------------------------------

def _assert_snapshots_equal(a, b, kinds=("state", "exp_avg", "exp_avg_sq",
                                         "ema")):
    for kind in kinds:
        assert a[kind].keys() == b[kind].keys(), kind
        for n in b[kind]:
            assert torch.equal(a[kind][n], b[kind][n]), (kind, n)


def test_checkpoint_is_the_unsharded_file_and_restores_without_tp(tp):
    path = os.path.join(tp.out, "tp_ckpt")
    payload = torch.load(os.path.join(path, "latest", "1", "state.pt"),
                         weights_only=True)
    full = tp.ref.single["flax"]["state"]
    assert {n: t.shape for n, t in payload["model"].items()} == \
        {n: t.shape for n, t in full.items()}
    restored, _ = CheckpointManager(path).restore(new_state(seed=5))
    want = {kind: _reassemble(tp.ranks, "flax", kind)
            for kind in ("state", "exp_avg", "exp_avg_sq", "ema")}
    _assert_snapshots_equal(snapshot(restored), want)


def test_checkpoint_restores_under_tp_both_ways(tp):
    plain = tp.ref.plain
    for res in tp.ranks:
        ck = res["ckpt"]
        _assert_snapshots_equal(ck["restored"], res["flax"])
        m = res["model_index"]
        for kind in ("state", "exp_avg", "exp_avg_sq", "ema"):
            for n, t in plain[kind].items():
                want = t.narrow(0, m * (t.shape[0] // MODEL),
                                t.shape[0] // MODEL) \
                    if n in res["flax"]["split"] else t
                assert torch.equal(ck["plain"][kind][n], want), (kind, n)


def test_checkpoint_best_promotion_under_tp(tp):
    for res in tp.ranks:
        assert res["ckpt"]["promoted"] == [True, False, True]
        assert res["ckpt"]["best"]["val_loss"] == pytest.approx(0.3)
    best = CheckpointManager(os.path.join(tp.out, "tp_ckpt")).best_meta()
    assert best == {"epoch": 1, "val_loss": 0.3}


def test_eval_step_matches_the_jax_model_axis_eval(tp):
    """Each rank evaluates its data index's rows, with no collective of
    the step's own: the ranks of a model group agree to the bit, and the
    mean over the data indices (equal shares) is JAX's loss over the
    global batch."""
    want = tp.ref.jax["eval"]
    for res in tp.ranks:
        assert res["eval"] == tp.ranks[MODEL * res["data_index"]]["eval"]
    for k, w in want.items():
        got = np.mean([r["eval"][k] for r in tp.ranks[::MODEL]])
        np.testing.assert_allclose(got, w, rtol=RTOL_LOSS, err_msg=k)


def test_trainer_with_a_model_axis_runs_an_epoch(tp):
    runs = [r["trainer"] for r in tp.ranks]
    assert all(t["steps_per_epoch"] == 2 and t["step"] == 2 for t in runs)
    assert all(t["rows"] == runs[0]["rows"] for t in runs)
    assert len(runs[0]["rows"]) == 1
    assert np.isfinite(runs[0]["rows"][0]["loss"])
    assert np.isfinite(runs[0]["rows"][0]["val_loss"])
    split = runs[0]["split"]
    for res, t in zip(tp.ranks, runs):
        twin = runs[res["model_index"]]
        for kind in ("state", "exp_avg", "exp_avg_sq"):
            for n, v in t[kind].items():
                want = twin[kind][n] if n in split else runs[0][kind][n]
                assert torch.equal(v, want), (kind, res["rank"], n)


def test_what_tensor_parallelism_does_not_cover_raises(tp):
    for res in tp.ranks:
        got = res["refusals"]
        assert "tensor parallelism runs over" in got["backend"]
        assert "cannot reduce a tensor on meta" in got["device"]
        assert "shard_state" in got["unsharded"]
        assert "sharded already" in got["twice"]
    cfg = step_config(4)
    with pytest.raises(ValueError, match="requires a mesh"):
        steps.make_train_step(losses.weighted_mse, cfg, model_axis="model")
    mesh = create_mesh(devices=["cpu"])
    for make in (steps.make_train_step, steps.make_eval_step):
        with pytest.raises(ValueError, match="not in mesh axes"):
            make(losses.weighted_mse, cfg, mesh=mesh, model_axis="model")
    with pytest.raises(ValueError, match="not in mesh axes"):
        shard_state(new_state(), mesh)
