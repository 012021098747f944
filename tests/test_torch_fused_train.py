"""The port's fused train-mode forward (`experimental/fused_train.py`) and
`make_train_step(model_backend="fused")` against the JAX package, on the
CPU at float32, S1/C16 at 64x64 and batch 4, from numpy-seeded variables.

On CPU tensors the kernel backends run the kernels' plain versions;
tests/test_torch_fused_train_kernels.py holds those against the Pallas
kernels. Tolerances:

* heatmaps atol 1e-4 against JAX `fused_train_apply(kernel_backend="jnp")`;
  running statistics within 3e-4 of each tensor's largest value (the
  E[x^2]-E[x]^2 cancellation, as tests/test_torch_train_step.py);
* grads within 5e-3 of the largest |g|, and their relative L2 distance
  below 5e-3, against JAX flax autodiff of the same loss, the bound
  measured for that cancellation (ROADMAP Queue 3); the same against the
  port's default step;
* losses rtol 1e-5.

The JAX references of the fused forward and of the grads are evaluated in
float64 (`jax.enable_x64`): JAX's own float32 evaluation of them lies as
far from its float64 one as these tolerances (the cancellation above), so
it cannot tell the port's error from its own (ROADMAP Queue 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from single_person_pose_estimation_tpu import losses as jlosses
from single_person_pose_estimation_tpu.configs.default_config import (
    Config as JConfig,
)
from single_person_pose_estimation_tpu.experimental.fused_train import (
    fused_train_apply as jax_fused_train_apply,
)
from single_person_pose_estimation_tpu.models.hourglass import (
    create_hourglass_model,
)
from single_person_pose_estimation_tpu.training import steps as jsteps
from single_person_pose_estimation_tpu_torch import Config
from single_person_pose_estimation_tpu_torch import losses as tlosses
from single_person_pose_estimation_tpu_torch.experimental import (
    bottleneck_grad as tbg,
)
from single_person_pose_estimation_tpu_torch.experimental import (
    fused_train as tft,
)
from single_person_pose_estimation_tpu_torch.training import steps as tsteps
from single_person_pose_estimation_tpu_torch.utils.weight_convert import (
    to_state_dict,
)
from torch_port_fixtures import images, random_variables, torch_model

B, SIZE, LABEL = 4, 64, 16
ATOL_HM = 1e-4
STATS_REL = 3e-4
GRAD_REL = 5e-3
RTOL_LOSS = 1e-5
LR = 1e-3


def _targets(seed=4):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, (B, LABEL, LABEL, 17)).astype(np.float32)


def _cfg(stacks=1, cls=Config):
    return cls(image_height=SIZE, image_width=SIZE, label_height=LABEL,
               label_width=LABEL, hg_num_stacks=stacks, hg_num_channels=16,
               batch_size=B, compute_dtype="float32")


def _batch(seed=3):
    rng = np.random.default_rng(seed)
    return {"image": rng.uniform(0, 1, (B, SIZE, SIZE, 3)).astype(np.float32),
            "kx": rng.uniform(1, LABEL - 1, (B, 17)).astype(np.float32),
            "ky": rng.uniform(1, LABEL - 1, (B, 17)).astype(np.float32),
            "kv": rng.integers(0, 3, (B, 17)).astype(np.int32)}


def _assert_stats(model, want_stats):
    got = model.state_dict()
    for name, st in want_stats.items():
        for field, key in (("mean", "running_mean"), ("var", "running_var")):
            w = torch.from_numpy(np.asarray(st[field], np.float32))
            d = (got[f"{name}.{key}"] - w).abs().max().item()
            assert d <= STATS_REL * w.abs().max().item(), (name, field, d)


def _assert_grads(grads, want):
    assert grads.keys() == want.keys()
    gmax = max(w.abs().max().item() for w in want.values())
    for n, w in want.items():
        d = (grads[n] - w).abs().max().item()
        assert d <= GRAD_REL * gmax, (n, d, gmax)
    diff = torch.cat([(grads[n] - w).flatten() for n, w in want.items()])
    ref = torch.cat([w.flatten() for w in want.values()])
    assert diff.norm() <= GRAD_REL * ref.norm(), (diff.norm(), ref.norm())


def _jax64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


def _jax_loss_grads(model, variables, x, y):
    """Loss and grads (the port's state_dict layout) of the per-stack
    weighted MSE of a train-mode flax forward."""
    def loss(params):
        o, _ = model.apply({"params": params,
                            "batch_stats": variables["batch_stats"]}, x,
                           train=True, mutable=["batch_stats"])
        return jlosses.total_loss(jlosses.weighted_mse, y, o)

    value, g = jax.jit(jax.value_and_grad(loss))(variables["params"])
    return float(value), to_state_dict(
        {"params": jax.tree.map(lambda a: np.asarray(a, np.float32), g)})


@pytest.fixture(scope="module")
def jax_reference():
    """JAX fused_train_apply (jnp) heatmaps and running statistics, and the
    flax autodiff loss and grads of the per-stack weighted MSE, on one
    batch, evaluated in float64: at these inputs JAX's float32 result is
    itself 3.9e-5 (heatmaps) and 2.1e-3 of the largest |g| (grads) from
    its float64 one, through the E[x^2]-E[x]^2 cancellation
    (scripts/torch_port_f64_gaps.py)."""
    v = random_variables(1, 16)
    with jax.enable_x64(True):
        variables = _jax64(v)
        x, y = _jax64(images(B)), _jax64(_targets())
        outs, stats = jax_fused_train_apply(variables, x, num_stacks=1,
                                            compute_dtype=jnp.float64,
                                            kernel_backend="jnp")
        model = create_hourglass_model(17, 1, 16, compute_dtype=jnp.float64)
        loss, grads = _jax_loss_grads(model, variables, x, y)
        outs = [np.asarray(o) for o in outs]
        stats = jax.tree.map(np.asarray, stats)
    return v, outs, stats, loss, grads


@pytest.mark.parametrize("backend", ["cuda", "plain", "mixed:8-16"])
def test_fused_train_apply_matches_jax(jax_reference, backend):
    v, jouts, jstats, jloss, jgrads = jax_reference
    model = torch_model(v, 1, 16)
    outs = tft.fused_train_apply(model, torch.from_numpy(images(B)),
                                 kernel_backend=backend)
    assert len(outs) == 1 and outs[0].shape == (B, LABEL, LABEL, 17)
    np.testing.assert_allclose(outs[0].detach().numpy(), np.asarray(jouts[0]),
                               atol=ATOL_HM, rtol=0)
    _assert_stats(model, jstats)
    loss = tlosses.total_loss(tlosses.weighted_mse,
                              torch.from_numpy(_targets()), outs)
    np.testing.assert_allclose(loss.item(), jloss, rtol=RTOL_LOSS)
    loss.backward()
    _assert_grads({n: p.grad for n, p in model.named_parameters()}, jgrads)


def test_parameters_stay_parameters_and_get_grads():
    """The bottlenecks read the model's nn.Parameters as views, so every
    parameter of the model gets a gradient through autograd."""
    model = torch_model(random_variables(1, 16), 1, 16)
    outs = tft.fused_train_apply(model, torch.from_numpy(images(2)))
    outs[0].sum().backward()
    missing = [n for n, p in model.named_parameters() if p.grad is None]
    assert not missing, missing


def _step_run(backend, **kw):
    model = torch_model(random_variables(1, 16), 1, 16)
    state = tsteps.TrainState.create(
        model, lambda m: tsteps.make_optimizer(m, LR), device="cpu")
    step = tsteps.make_train_step(tlosses.weighted_mse, _cfg(),
                                  augment=False, model_backend=backend, **kw)
    state, m = step(state, {k: torch.from_numpy(a)
                            for k, a in _batch().items()})
    return state, m, {n: p.grad.clone()
                      for n, p in state.model.named_parameters()}


@pytest.fixture(scope="module")
def default_step():
    return _step_run("flax")


def test_fused_step_matches_default_step(default_step):
    """One fused step against the port's default step from the same state
    (tests/test_torch_train_step.py holds the default step against JAX)."""
    _, mx, gx = default_step
    state, mf, gf = _step_run("fused")
    assert mf.keys() == mx.keys()
    for k in mx:
        np.testing.assert_allclose(mf[k].item(), mx[k].item(),
                                   rtol=RTOL_LOSS, err_msg=k)
    _assert_grads(gf, gx)
    assert state.step == 1


def test_frozen_bn_ignores_the_backend(default_step):
    """bn_mode="frozen" runs the eval-mode forward whatever the backend:
    the same losses and grads, bit for bit, and untouched statistics."""
    runs = [_step_run(b, bn_mode="frozen") for b in ("fused", "flax")]
    (sf, mf, gf), (sx, mx, gx) = runs
    assert mf["loss"].item() == mx["loss"].item()
    for n in gx:
        assert torch.equal(gf[n], gx[n]), n
    before = torch_model(random_variables(1, 16), 1, 16).state_dict()
    for n, t in sf.model.state_dict().items():
        if "running" in n:
            assert torch.equal(t, before[n]), n


def test_fused_accum_steps_chain_bn_statistics_in_order():
    """accum_steps=2 leaves the running statistics where two fused
    train-mode forwards of the microbatches, in order, leave them."""
    v = random_variables(1, 16)
    ref = torch_model(v, 1, 16)
    with torch.no_grad():
        for micro in torch.from_numpy(_batch()["image"]).chunk(2):
            tft.fused_train_apply(ref, micro)
    state, _, _ = _step_run("fused", accum_steps=2)
    want = ref.state_dict()
    for n, t in state.model.state_dict().items():
        if "running" in n:
            assert torch.equal(t, want[n]), n


def test_mixed_backend_routes_by_level():
    """"mixed:LO-HI" takes the kernel backend for maps of LO..HI px and the
    plain one elsewhere; "auto" takes the kernels on a CUDA tensor only."""
    sel = tft._select_fn("mixed:8-16", on_cuda=False)
    cuda, plain = (tbg.make_bottleneck_train(b) for b in ("cuda", "plain"))
    assert [sel(h) is cuda for h in (4, 8, 16, 32, 64)] == \
        [False, True, True, False, False]
    assert all(sel(h) is plain for h in (4, 32, 64))
    assert tft._select_fn("auto", on_cuda=False)(64) is plain
    assert tft._select_fn("auto", on_cuda=True)(64) is cuda


def test_fused_dials_and_errors():
    model = torch_model(random_variables(1, 16), 1, 16)
    x = torch.from_numpy(images(1))
    with pytest.raises(ValueError, match="unknown bottleneck backend"):
        tft.fused_train_apply(model, x, kernel_backend="pallas")
    with pytest.raises(ValueError, match="mixed"):
        tft.fused_train_apply(model, x, kernel_backend="mixed:8")
    with pytest.raises(ValueError, match="divisible by 64"):
        tft.fused_train_apply(model, x[:, :48])
    with pytest.raises(ValueError, match="model_backend"):
        tsteps.make_train_step(tlosses.mse, _cfg(), model_backend="bogus")
