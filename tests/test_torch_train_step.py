"""One train step of the port against the JAX package's `make_train_step`,
from the same variables on the same batch, augmentation off, float32 on
the CPU: S2/C16 at 64x64 in train-mode BN with a cosine schedule and an
EMA, and S1/C16 with bn_mode="frozen" and accum_steps=2.

Compared: the total and per-stack losses; the gradients (JAX's through
Adam's first moment, mu = 0.1 g after one step); the params, the EMA and
the BN running statistics after the step. Tolerances:

* losses rtol 1e-5 (float32 sums in another order);
* frozen BN: each gradient tensor within 1e-4 of its largest |g|; params
  after Adam (lr 1e-3) within 2e-6;
* train-mode BN: every gradient within 5e-3 of the largest |g| of the
  model, and their relative L2 distance below 5e-3. The batch variance is
  E[x^2]-E[x]^2 in float32, whose cancellation turns summation-order noise
  into relative errors of 1e-5..1e-4; at the first BN of this model JAX's
  result lies 13x further from a float64 reference than PyTorch's (7.6e-5
  against 5.7e-6 on outputs of size 10), and the network carries that on
  (measured: 1.6e-3 of the largest |g|). Params and EMA within 2e-6
  wherever the JAX gradient exceeds 1e-3 of the largest |g|; elsewhere
  the gradient is cancellation noise whose sign Adam's first step
  (lr*g/(|g|+eps), ~lr*sign(g)) turns into +-lr, so there they are held
  within 2*lr. Running statistics within 3e-4 of each tensor's largest
  value (the same cancellation; measured 1.4e-4).

So the comparison stops after one step: from the second step on, the
params moved by those sign flips make the two runs differ by more than
summation noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from single_person_pose_estimation_tpu import losses as jlosses
from single_person_pose_estimation_tpu.configs.default_config import (
    Config as JConfig,
)
from single_person_pose_estimation_tpu.models.hourglass import (
    create_hourglass_model,
)
from single_person_pose_estimation_tpu.training import steps as jsteps
from single_person_pose_estimation_tpu_torch import Config
from single_person_pose_estimation_tpu_torch import losses as tlosses
from single_person_pose_estimation_tpu_torch.training import steps as tsteps
from single_person_pose_estimation_tpu_torch.utils.weight_convert import (
    load_train_state,
    to_state_dict,
)
from torch_port_fixtures import random_variables, torch_model

LR = 1e-3
RTOL_LOSS = 1e-5
GRAD_REL = 1e-4           # frozen BN, per tensor
GRAD_REL_BATCH = 5e-3     # train-mode BN, of the model's largest |g|
STATS_REL = 3e-4
ATOL_PARAMS = 2e-6
NOISE_GRAD = 1e-3
B, SIZE, LABEL = 4, 64, 16


def _cfg(stacks, cls=Config):
    return cls(image_height=SIZE, image_width=SIZE, label_height=LABEL,
               label_width=LABEL, hg_num_stacks=stacks, hg_num_channels=16,
               batch_size=B, compute_dtype="float32")


def _batch(seed=3):
    rng = np.random.default_rng(seed)
    return {"image": rng.uniform(0, 1, (B, SIZE, SIZE, 3)).astype(np.float32),
            "kx": rng.uniform(1, LABEL - 1, (B, 17)).astype(np.float32),
            "ky": rng.uniform(1, LABEL - 1, (B, 17)).astype(np.float32),
            "kv": rng.integers(0, 3, (B, 17)).astype(np.int32)}


def _jax_run(stacks, tx, n_steps, **kw):
    """JAX TrainState from random_variables, n_steps of make_train_step;
    returns (initial state, the state after each step, per-step
    metrics)."""
    v = random_variables(stacks, 16)
    model = create_hourglass_model(17, stacks, 16)
    params = jax.tree.map(jnp.asarray, v["params"])
    state = jsteps.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                              batch_stats=jax.tree.map(jnp.asarray,
                                                       v["batch_stats"]),
                              opt_state=tx.init(params),
                              rng=jax.random.PRNGKey(0))
    step = jsteps.make_train_step(model, tx, jlosses.weighted_mse,
                                  _cfg(stacks, JConfig), augment=False, **kw)
    batch = {k: jnp.asarray(a) for k, a in _batch().items()}
    # The step donates its state: keep a host copy of the initial one.
    s, state, states, metrics = state, jax.device_get(state), [], []
    for _ in range(n_steps):
        s, m = step(s, batch)
        states.append(jax.device_get(s))
        metrics.append(jax.tree.map(float, m))
    return state, states, metrics


def _torch_run(stacks, opt_fn, n_steps, init_state, **kw):
    model = torch_model(random_variables(stacks, 16), stacks, 16)
    load_train_state(model, init_state)          # the JAX TrainState itself
    state = tsteps.TrainState.create(model, opt_fn, device="cpu")
    step = tsteps.make_train_step(tlosses.weighted_mse, _cfg(stacks),
                                  augment=False, **kw)
    batch = {k: torch.from_numpy(a) for k, a in _batch().items()}
    metrics, grads = [], []
    for _ in range(n_steps):
        state, m = step(state, batch)
        metrics.append({k: v.item() for k, v in m.items()})
        grads.append({n: p.grad.clone()
                      for n, p in state.model.named_parameters()})
    return state, metrics, grads


def _opt_leaf(opt_state, name):
    for s in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda x: hasattr(x, name)):
        if hasattr(s, name):
            return getattr(s, name)
    raise KeyError(name)


def _assert_metrics(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL_LOSS,
                                   err_msg=k)


def _jax_grads(mu):
    return to_state_dict({"params": jax.tree.map(
        lambda m: np.asarray(m) / np.float32(0.1), mu)})


def _assert_grads(grads, want, per_tensor: bool):
    assert grads.keys() == want.keys()
    gmax = max(w.abs().max().item() for w in want.values())
    if per_tensor:
        for n, w in want.items():
            tol = GRAD_REL * max(w.abs().max().item(), 1e-12)
            d = (grads[n] - w).abs().max().item()
            assert d <= tol, (n, d, tol)
        return
    for n, w in want.items():
        d = (grads[n] - w).abs().max().item()
        assert d <= GRAD_REL_BATCH * gmax, (n, d, gmax)
    diff = torch.cat([(grads[n] - w).flatten() for n, w in want.items()])
    ref = torch.cat([w.flatten() for w in want.values()])
    assert diff.norm() <= GRAD_REL_BATCH * ref.norm()


def _assert_params(got, want, grads=None):
    """Params (or the EMA) within ATOL_PARAMS; where a gradient is given
    and is noise (below NOISE_GRAD of the largest), within 2*lr."""
    for n, w in want.items():
        d = (got[n] - w).abs()
        if grads is not None:
            gmax = max(g.abs().max().item() for g in grads.values())
            noise = grads[n].abs() <= NOISE_GRAD * gmax
            if noise.any():
                assert d[noise].max().item() <= 2 * LR, n
            d = d[~noise]
        assert d.numel() == 0 or d.max().item() <= ATOL_PARAMS, (
            n, d.max().item())


def _assert_model(model, params, stats, grads=None):
    want = to_state_dict({"params": params, "batch_stats": stats})
    got = model.state_dict()
    for n, w in want.items():
        if "running" in n:
            d = (got[n] - w).abs().max().item()
            assert d <= STATS_REL * w.abs().max().item(), (n, d)
    _assert_params(got, {n: w for n, w in want.items()
                         if "running" not in n}, grads)


@pytest.fixture(scope="module")
def batch_mode_runs():
    """S2, train-mode BN, cosine schedule over 10 steps (no warmup, so the
    step moves the params) and an EMA of decay 0.9; one step."""
    tx = jsteps.make_optimizer(LR, schedule="cosine", total_steps=10,
                               ema_decay=0.9)
    init, (final,), (jm,) = _jax_run(2, tx, 1)
    state, (tm,), (grads,) = _torch_run(
        2, lambda m: tsteps.make_optimizer(m, LR, schedule="cosine",
                                           total_steps=10, ema_decay=0.9),
        1, init)
    return final, jm, state, tm, grads


def test_train_step_losses_match_jax(batch_mode_runs):
    _, jm, _, tm, _ = batch_mode_runs
    assert set(tm) == {"loss", "loss/hg0", "loss/hg1"}
    _assert_metrics(tm, jm)


def test_train_step_grads_match_jax(batch_mode_runs):
    final, _, _, _, grads = batch_mode_runs
    _assert_grads(grads, _jax_grads(_opt_leaf(final.opt_state, "mu")),
                  per_tensor=False)


def test_train_step_params_stats_and_ema_match_jax(batch_mode_runs):
    final, _, state, _, _ = batch_mode_runs
    jgrads = _jax_grads(_opt_leaf(final.opt_state, "mu"))
    _assert_model(state.model, final.params, final.batch_stats, jgrads)
    _assert_params(tsteps.get_ema_params(state.optimizer), to_state_dict(
        {"params": jsteps.get_ema_params(final.opt_state)}), jgrads)
    assert state.step == 1 and state.optimizer.count == 1


def test_frozen_bn_with_accum_steps_2_matches_jax():
    """bn_mode="frozen" and accum_steps=2 in one step: frozen BN does not
    couple the examples, so the two microbatches' mean gradient is the
    whole batch's, in both packages."""
    tx = jsteps.make_optimizer(LR)
    init, (final,), jm = _jax_run(1, tx, 1, bn_mode="frozen", accum_steps=2)
    state, tm, grads = _torch_run(1, lambda m: tsteps.make_optimizer(m, LR),
                                  1, init, bn_mode="frozen", accum_steps=2)
    _assert_metrics(tm[0], jm[0])
    _assert_grads(grads[0], _jax_grads(_opt_leaf(final.opt_state, "mu")),
                  per_tensor=True)
    _assert_model(state.model, final.params, final.batch_stats)
    # Frozen BN leaves the running statistics as they were.
    for n, w in to_state_dict({"params": init.params,
                               "batch_stats": init.batch_stats}).items():
        if "running" in n:
            assert torch.equal(state.model.state_dict()[n], w), n


def test_accum_steps_chain_bn_statistics_in_order():
    """With train-mode BN, accum_steps=2 leaves the running statistics
    where two train-mode forwards of the microbatches, in order, leave
    them (the JAX package's lax.scan carries them the same way)."""
    v = random_variables(1, 16)
    images = torch.from_numpy(_batch()["image"])
    ref = torch_model(v, 1, 16)
    with torch.no_grad():
        for micro in images.chunk(2):
            ref(micro, train=True)
    state = tsteps.TrainState.create(torch_model(v, 1, 16), lambda m:
                                     tsteps.make_optimizer(m, LR),
                                     device="cpu")
    step = tsteps.make_train_step(tlosses.mse, _cfg(1), augment=False,
                                  accum_steps=2)
    step(state, {k: torch.from_numpy(a) for k, a in _batch().items()})
    want = ref.state_dict()
    for n, t in state.model.state_dict().items():
        if "running" in n:
            assert torch.equal(t, want[n]), n
    with pytest.raises(ValueError, match="divisible"):
        tsteps.make_train_step(tlosses.mse, _cfg(1), augment=False,
                               accum_steps=3)(state, _batch())


@pytest.mark.parametrize("schedule,warmup", [("cosine", 3), ("constant", 4),
                                             (None, 0)])
def test_learning_rates_match_optax(schedule, warmup):
    want = jsteps.make_lr_schedule(0.01, schedule, total_steps=10,
                                   warmup_steps=warmup)
    got = tsteps.make_lr_schedule(0.01, schedule, total_steps=10,
                                  warmup_steps=warmup)
    for i in range(10):
        w = float(want(i)) if callable(want) else want
        np.testing.assert_allclose(got(i), w, rtol=1e-6, atol=1e-9)
    if warmup:
        assert got(0) == 0.0


def test_optimizer_uses_the_schedule_count_before_the_step():
    model = torch_model(random_variables(1, 16), 1, 16)
    opt = tsteps.make_optimizer(model, 0.01, schedule="cosine",
                                total_steps=10, warmup_steps=3)
    used = []
    for _ in range(10):
        for p in opt.params.values():
            p.grad = torch.ones_like(p)
        used.append(opt.step())
    want = optax.warmup_cosine_decay_schedule(0.0, 0.01, 3, 10)
    np.testing.assert_allclose(used, [float(want(i)) for i in range(10)],
                               rtol=1e-6, atol=1e-9)


def test_adam_matches_optax_eps_outside_the_sqrt():
    """Keras' eps 1e-7 sits outside the square root and both moments are
    bias-corrected: three steps on a tiny gradient, where the placement of
    eps shows, give optax's params."""
    g = np.array([1e-7, -3e-7, 2e-6, 0.5], np.float32)
    p0 = np.array([1.0, -1.0, 0.5, 0.0], np.float32)
    tx = optax.adam(0.1, b1=0.9, b2=0.999, eps=1e-7)
    jp, js = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    lin = torch.nn.Linear(4, 1, bias=False)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(p0)[None])
    opt = tsteps.make_optimizer(lin, 0.1)
    for _ in range(3):
        u, js = tx.update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, u)
        lin.weight.grad = torch.from_numpy(g)[None].clone()
        opt.step()
    # eps inside the square root would move the first param by ~3e-5 per
    # step instead of 0.05; float32 rounding of the bias corrections on
    # steps of lr 0.1 stays below 1e-5.
    np.testing.assert_allclose(lin.weight[0].detach().numpy(),
                               np.asarray(jp), rtol=0, atol=1e-5)
    assert opt.adam.defaults["eps"] == 1e-7


def test_recalibrate_adopts_batch_statistics():
    """momentum 0 takes one batch's statistics outright, as the JAX
    package's recalibrate_batch_stats (the running-statistics
    tolerance)."""
    v = random_variables(1, 16)
    model = create_hourglass_model(17, 1, 16)
    images = _batch()["image"]
    jstate = jsteps.TrainState(
        step=jnp.zeros((), jnp.int32),
        params=jax.tree.map(jnp.asarray, v["params"]),
        batch_stats=jax.tree.map(jnp.asarray, v["batch_stats"]),
        opt_state=(), rng=jax.random.PRNGKey(0))
    want = jsteps.recalibrate_batch_stats(model, jstate, [images])
    tm = torch_model(v, 1, 16)
    state = tsteps.TrainState.create(tm, lambda m: tsteps.make_optimizer(
        m, LR), device="cpu")
    tsteps.recalibrate_batch_stats(state, [{"image": images}])
    assert tm.bn_momentum == 0.99
    got = tm.state_dict()
    for n, w in to_state_dict({"params": want.params,
                               "batch_stats": want.batch_stats}).items():
        if "running" in n:
            d = (got[n] - w).abs().max().item()
            assert d <= STATS_REL * w.abs().max().item(), (n, d)


def test_eval_step_and_predict_fn_use_running_statistics():
    v = random_variables(1, 16)
    state = tsteps.TrainState.create(
        torch_model(v, 1, 16), lambda m: tsteps.make_optimizer(m, LR),
        device="cpu")
    batch = {k: torch.from_numpy(a) for k, a in _batch().items()}
    before = {n: t.clone() for n, t in state.model.state_dict().items()}
    m = tsteps.make_eval_step(tlosses.iou, _cfg(1))(state, batch)
    pred = tsteps.make_predict_fn(state.model)(batch["image"])
    assert set(m) == {"loss", "loss/hg0"} and torch.isfinite(m["loss"])
    assert pred.shape == (B, LABEL, LABEL, 17)
    for n, t in state.model.state_dict().items():
        assert torch.equal(t, before[n]), n


def test_uint8_wire_divides_on_the_device():
    v = random_variables(1, 16)
    outs = []
    for wire in ("float32", "uint8"):
        state = tsteps.TrainState.create(
            torch_model(v, 1, 16), lambda m: tsteps.make_optimizer(m, LR),
            device="cpu")
        b = _batch()
        img = np.round(b["image"] * 255).astype(np.uint8)
        b["image"] = img if wire == "uint8" else img.astype(np.float32) / 255
        step = tsteps.make_train_step(tlosses.mse, _cfg(1), augment=False)
        _, m = step(state, {k: torch.from_numpy(a) for k, a in b.items()})
        outs.append(m["loss"].item())
    assert outs[0] == outs[1]


def test_step_validation_and_device_errors():
    with pytest.raises(ValueError, match="bn_mode"):
        tsteps.make_train_step(tlosses.mse, _cfg(1), bn_mode="bogus")
    with pytest.raises(ValueError, match="accum_steps"):
        tsteps.make_train_step(tlosses.mse, _cfg(1), accum_steps=0)
    with pytest.raises(ValueError, match="schedule"):
        tsteps.make_lr_schedule(0.1, "bogus")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tsteps.resolve_device("cuda")
