"""The model's dials in the port: the space-to-depth front
(`ops/space_to_depth.py`, `front_s2d` in the model, in `fused_apply` and
in the CLI), `remat` (True and "conv_out") and the mobile depthwise
lowerings (`mobile_depthwise` "conv", "dense", "taps"), on the CPU against
the JAX package on numpy-seeded inputs.

Tolerances:
* the fold (`space_to_depth`, `fold_front_kernel`): equal to JAX's;
* `front_conv_s2d` and its grads: within 1e-5 of the largest value of
  JAX's (the same products summed in another order);
* the model and `fused_apply` with `front_s2d` (S1/C16, 64x64): atol 1e-4
  of JAX's, the JAX tests' tolerance, and within 1e-5 of the port's own
  7x7 front;
* remat: outputs, losses and grads equal to the step without remat, and
  the running statistics bit for bit;
* dense/taps: the model's heatmaps atol 1e-4 of JAX's same lowering; the
  separable conv's grads atol 1e-4, rtol 1e-5 of JAX's (its own test's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from single_person_pose_estimation_tpu.models import hourglass as jhourglass
from single_person_pose_estimation_tpu.models.fused_inference import (
    fused_apply as jfused_apply,
)
from single_person_pose_estimation_tpu.ops import space_to_depth as js2d
from single_person_pose_estimation_tpu_torch import Config, cli, losses
from single_person_pose_estimation_tpu_torch.models.fused_inference import (
    fused_apply,
    prepare_fused,
)
from single_person_pose_estimation_tpu_torch.models.hourglass import (
    StackedHourglass,
    depthwise_conv,
)
from single_person_pose_estimation_tpu_torch.ops import space_to_depth as s2d
from single_person_pose_estimation_tpu_torch.training import steps
from torch_port_fixtures import images, random_variables, torch_model

REL_FOLD = 1e-5
ATOL_MODEL = 1e-4
ATOL_SELF = 1e-5
SIZE, LABEL = 64, 16


def _seeded(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def test_space_to_depth_and_fold_equal_jax():
    x = np.arange(2 * 4 * 6 * 3, dtype=np.float32).reshape(2, 4, 6, 3)
    np.testing.assert_array_equal(
        s2d.space_to_depth(torch.from_numpy(x)).numpy(),
        np.asarray(js2d.space_to_depth(x)))
    xc = torch.from_numpy(x).permute(0, 3, 1, 2)
    np.testing.assert_array_equal(
        s2d.space_to_depth_nchw(xc).permute(0, 2, 3, 1).numpy(),
        np.asarray(js2d.space_to_depth(x)))
    k = _seeded(0, 7, 7, 3, 64)
    np.testing.assert_array_equal(
        s2d.fold_front_kernel(torch.from_numpy(k)).numpy(),
        np.asarray(js2d.fold_front_kernel(k)))
    np.testing.assert_array_equal(
        s2d.fold_front_weight(torch.from_numpy(k).permute(3, 2, 0, 1))
        .permute(2, 3, 1, 0).numpy(), np.asarray(js2d.fold_front_kernel(k)))
    with pytest.raises(ValueError, match="not divisible"):
        s2d.space_to_depth(torch.zeros(1, 3, 4, 3))
    with pytest.raises(ValueError, match="7x7"):
        s2d.fold_front_kernel(torch.zeros(5, 5, 3, 8))


def test_front_conv_s2d_and_grads_match_jax():
    x, k, b = (_seeded(1, 2, 64, 64, 3), _seeded(2, 7, 7, 3, 64, scale=.1),
               _seeded(3, 64, scale=.1))
    loss = lambda y: (y ** 2).sum()
    want = np.asarray(js2d.front_conv_s2d(x, k, b))
    jgrads = jax.grad(lambda *a: loss(js2d.front_conv_s2d(*a)),
                      argnums=(0, 1, 2))(x, k, b)
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, k, b)]
    got = s2d.front_conv_s2d(*ts)
    loss(got).backward()
    np.testing.assert_allclose(got.detach().numpy(), want,
                               atol=REL_FOLD * np.abs(want).max())
    for t, g in zip(ts, jgrads):
        g = np.asarray(g)
        np.testing.assert_allclose(t.grad.numpy(), g,
                                   atol=REL_FOLD * np.abs(g).max())
    # ... and the stride-2 conv it replaces.
    ref = F.conv2d(F.pad(ts[0].detach().permute(0, 3, 1, 2), (2, 3, 2, 3)),
                   ts[1].detach().permute(3, 2, 0, 1), ts[2].detach(),
                   stride=2).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), ref.numpy(),
                               atol=REL_FOLD * np.abs(want).max())


@pytest.fixture(scope="module")
def s1():
    v = random_variables(1, 16)
    return v, images(2, SIZE, seed=5)


def test_model_front_s2d_same_params_same_heatmaps(s1):
    v, x = s1
    base = torch_model(v, 1, 16)
    model = StackedHourglass(num_stacks=1, num_channels=16, front_s2d=True)
    assert model.state_dict().keys() == base.state_dict().keys()
    model.load_state_dict(base.state_dict())
    with torch.no_grad():
        got = model(torch.from_numpy(x))[0].numpy()
        own = base(torch.from_numpy(x))[0].numpy()
    jm = jhourglass.StackedHourglass(num_stacks=1, num_channels=16,
                                     front_s2d=True)
    want = np.asarray(jax.jit(lambda a, b: jm.apply(a, b)[0])(v, x))
    np.testing.assert_allclose(got, want, atol=ATOL_MODEL)
    np.testing.assert_allclose(got, own, atol=ATOL_SELF)


def test_fused_apply_front_s2d_matches_jax_interpret(s1):
    v, x = s1
    want = jfused_apply(v, x, num_stacks=1, compute_dtype=jnp.float32,
                        interpret=True, front_s2d=True)
    fp = prepare_fused(torch_model(v, 1, 16))
    got = fused_apply(fp, torch.from_numpy(x), front_s2d=True)
    own = fused_apply(fp, torch.from_numpy(x))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=ATOL_MODEL)
    np.testing.assert_allclose(got[0].numpy(), own[0].numpy(),
                               atol=ATOL_SELF)


def test_cli_front_s2d_on_builds_the_dial(s1):
    v, x = s1
    cfg = Config().replace(hg_num_stacks=1, hg_num_channels=16,
                           compute_dtype="float32")
    on = cli._build_model(cfg.replace(front_s2d="on"))
    assert on.front_s2d and not cli._build_model(cfg).front_s2d
    on.load_state_dict(torch_model(v, 1, 16).state_dict())
    with torch.no_grad():
        got = on(torch.from_numpy(x))[0]
        want = torch_model(v, 1, 16)(torch.from_numpy(x))[0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL_SELF)


@pytest.mark.parametrize("remat", [True, "conv_out"])
def test_remat_step_equals_the_step_without(remat):
    """One train step of S2/C16 (train-mode BN, augmentation off): the
    losses, grads and params equal the step without remat, and the running
    statistics too, bit for bit: the recompute does not update them a
    second time."""
    v = random_variables(2, 16)
    rng = np.random.default_rng(6)
    batch = {"image": torch.from_numpy(images(4, SIZE, seed=6)),
             "kx": torch.from_numpy(rng.uniform(1, LABEL - 1, (4, 17))
                                    .astype(np.float32)),
             "ky": torch.from_numpy(rng.uniform(1, LABEL - 1, (4, 17))
                                    .astype(np.float32)),
             "kv": torch.full((4, 17), 2, dtype=torch.int32)}
    cfg = Config(image_height=SIZE, image_width=SIZE, label_height=LABEL,
                 label_width=LABEL, hg_num_stacks=2, hg_num_channels=16,
                 batch_size=4, compute_dtype="float32")
    runs = []
    for mode in (False, remat):
        model = torch_model(v, 2, 16)
        model.remat = mode
        state = steps.TrainState.create(
            model, lambda m: steps.make_optimizer(m, 1e-3), device="cpu")
        state, m = steps.make_train_step(losses.weighted_mse, cfg,
                                         augment=False)(state, batch)
        runs.append(({k: t.item() for k, t in m.items()},
                     {n: p.grad for n, p in model.named_parameters()},
                     model.state_dict()))
    (m0, g0, s0), (m1, g1, s1_) = runs
    assert m0 == m1
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
    for n in s0:
        assert torch.equal(s0[n], s1_[n]), n
    assert any("running" in n and not torch.equal(
        s0[n], torch.from_numpy(np.asarray(v["batch_stats"][
            n.split(".")[0]]["mean"]))) for n in s0 if n.endswith("mean"))


@pytest.mark.parametrize("impl", ["dense", "taps"])
def test_mobile_depthwise_matches_jax(impl):
    v = random_variables(1, 16, mobile=True)
    x = images(2, SIZE, seed=7)
    model = torch_model(v, 1, 16, mobile=True)
    model.mobile_depthwise = impl
    with torch.no_grad():
        got = model(torch.from_numpy(x))[0].numpy()
    jm = jhourglass.StackedHourglass(num_stacks=1, num_channels=16,
                                     mobile=True, mobile_depthwise=impl)
    want = jax.jit(lambda a, b: jm.apply(a, b)[0])(v, x)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL_MODEL)
    # Grads at the separable conv, as JAX's own test holds them.
    for k in (1, 3):
        xs, ct = _seeded(8, 2, 16, 16, 32), _seeded(9, 2, 16, 16, 48)
        jconv = jhourglass.SeparableConv(features=48, kernel_size=k,
                                         depthwise_impl=impl)
        jv = jconv.init(jax.random.PRNGKey(0), xs)["params"]
        jg = jax.jit(jax.grad(lambda p, a: jnp.sum(
            jconv.apply({"params": p}, a) * ct), argnums=(0, 1)))(jv, xs)
        dw = torch.from_numpy(np.asarray(jv["depthwise"]["kernel"])
                              .transpose(3, 2, 0, 1).copy()).requires_grad_()
        pw = torch.from_numpy(np.asarray(jv["pointwise"]["kernel"])
                              .transpose(3, 2, 0, 1).copy()).requires_grad_()
        pb = torch.tensor(np.asarray(jv["pointwise"]["bias"]),
                          requires_grad=True)
        xt = torch.from_numpy(xs).permute(0, 3, 1, 2).requires_grad_()
        y = F.conv2d(depthwise_conv(xt, dw, impl), pw, pb)
        (y.permute(0, 2, 3, 1) * torch.from_numpy(ct)).sum().backward()
        pairs = ((dw.grad.permute(2, 3, 1, 0), jg[0]["depthwise"]["kernel"]),
                 (pw.grad.permute(2, 3, 1, 0), jg[0]["pointwise"]["kernel"]),
                 (pb.grad, jg[0]["pointwise"]["bias"]),
                 (xt.grad.permute(0, 2, 3, 1), jg[1]))
        for got_g, want_g in pairs:
            np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g),
                                       atol=1e-4, rtol=1e-5)


def test_mobile_depthwise_same_parameters_and_bad_values_raise():
    models = [StackedHourglass(num_stacks=1, num_channels=16, mobile=True,
                               mobile_depthwise=impl)
              for impl in ("conv", "dense", "taps")]
    shapes = [{k: v.shape for k, v in m.state_dict().items()}
              for m in models]
    assert shapes[0] == shapes[1] == shapes[2]
    with pytest.raises(ValueError, match="depthwise_impl"):
        StackedHourglass(num_stacks=1, num_channels=16, mobile=True,
                         mobile_depthwise="bogus")
    with pytest.raises(ValueError, match="depthwise_impl"):
        depthwise_conv(torch.zeros(1, 4, 8, 8), torch.zeros(4, 1, 3, 3),
                       "grouped")
