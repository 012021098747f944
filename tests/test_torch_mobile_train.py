"""Training the mobile model: one train step of the mobile S1/C16
(`model_backend="flax"`) against the JAX package's step on the same
variables, on the CPU at float32, and `model_backend="fused"` rejecting a
mobile model as the JAX package does (it supports the standard hourglass
only)."""

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
from single_person_pose_estimation_tpu.training import steps as jsteps
from single_person_pose_estimation_tpu_torch import losses as tlosses
from single_person_pose_estimation_tpu_torch.experimental import (
    fused_train as tft,
)
from single_person_pose_estimation_tpu_torch.training import steps as tsteps
from single_person_pose_estimation_tpu_torch.utils.weight_convert import (
    to_state_dict,
)
from test_torch_fused_train import (
    GRAD_REL,
    LR,
    RTOL_LOSS,
    STATS_REL,
    _assert_grads,
    _batch,
    _cfg,
    _jax64,
)
from torch_port_fixtures import images, random_variables, torch_model

NOISE_GRAD = 1e-3    # of the largest |g|: below it a gradient is noise


def _mobile_model():
    return torch_model(random_variables(1, 16, mobile=True), 1, 16,
                       mobile=True)


def test_fused_rejects_a_mobile_model():
    state = tsteps.TrainState.create(
        _mobile_model(), lambda m: tsteps.make_optimizer(m, LR),
        device="cpu")
    step = tsteps.make_train_step(tlosses.mse, _cfg(), augment=False,
                                  model_backend="fused")
    with pytest.raises(ValueError, match="non-mobile"):
        step(state, {k: torch.from_numpy(a) for k, a in _batch().items()})
    with pytest.raises(ValueError, match="non-mobile"):
        tft.fused_train_apply(_mobile_model(), torch.from_numpy(images(1)))


def test_mobile_train_step_matches_jax():
    """One train step of the mobile S1/C16 (model_backend="flax") against
    the JAX package's step on the same variables, the JAX step evaluated
    in float64 (its float32 grads lie 7.0e-3 of the largest |g| from it at
    the front conv, through the first BN's E[x^2]-E[x]^2 cancellation; the
    port's lie 1.5e-3: scripts/torch_port_f64_gaps.py): losses rtol 1e-5;
    grads (JAX's through Adam's first moment, mu = 0.1 g) within 5e-3 of
    the largest |g| and their relative L2 distance below 5e-3; running
    statistics within 3e-4 of each tensor's largest value; params within
    2e-6 where the JAX gradient exceeds 1e-3 of the largest |g|, elsewhere
    within 2*lr (there the gradient is noise, and Adam's first step moves
    a param by ~lr*sign(g)): the tolerances of
    tests/test_torch_train_step.py."""
    v = random_variables(1, 16, mobile=True)
    with jax.enable_x64(True):
        tx = jsteps.make_optimizer(LR)
        params = _jax64(v["params"])
        jstate = jsteps.TrainState(
            step=jnp.zeros((), jnp.int32), params=params,
            batch_stats=_jax64(v["batch_stats"]),
            opt_state=tx.init(params), rng=jax.random.PRNGKey(0))
        jmodel = create_hourglass_model(17, 1, 16, mobile=True,
                                        compute_dtype=jnp.float64)
        jstep = jsteps.make_train_step(jmodel, tx, jlosses.weighted_mse,
                                       _cfg(cls=JConfig), augment=False)
        batch = {k: jnp.asarray(a, jnp.float64 if a.dtype == np.float32
                                else a.dtype) for k, a in _batch().items()}
        final, jm = jstep(jstate, batch)
        final = jax.tree.map(lambda a: np.asarray(a, np.float32),
                             jax.device_get(final))
        jm = jax.tree.map(float, jm)

    model = _mobile_model()
    state = tsteps.TrainState.create(
        model, lambda m: tsteps.make_optimizer(m, LR), device="cpu")
    step = tsteps.make_train_step(tlosses.weighted_mse, _cfg(),
                                  augment=False)
    state, tm = step(state, {k: torch.from_numpy(a)
                             for k, a in _batch().items()})
    for k in jm:
        np.testing.assert_allclose(tm[k].item(), jm[k], rtol=RTOL_LOSS,
                                   err_msg=k)
    mu = [s.mu for s in jax.tree_util.tree_leaves(
        final.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
        if hasattr(s, "mu")][0]
    jgrads = to_state_dict({"params": jax.tree.map(
        lambda m: np.asarray(m) / np.float32(0.1), mu)})
    _assert_grads({n: p.grad for n, p in state.model.named_parameters()},
                  jgrads)
    want = to_state_dict({"params": final.params,
                          "batch_stats": final.batch_stats})
    got = state.model.state_dict()
    gmax = max(g.abs().max().item() for g in jgrads.values())
    for n, w in want.items():
        d = (got[n] - w).abs()
        if "running" in n:
            assert d.max().item() <= STATS_REL * w.abs().max().item(), n
            continue
        signal = jgrads[n].abs() > NOISE_GRAD * gmax
        assert d[signal].numel() == 0 or d[signal].max().item() <= 2e-6, n
        assert d.max().item() <= 2 * LR, n
