"""The port's mobile (separable-conv) model against the JAX package on the
same numpy-seeded variables and inputs: the plain StackedHourglass against
flax `model.apply(..., train=False)` and the TF reference's golden mobile
fixture (atol 1e-4); `fused_apply` on a mobile model's prepared weights
with the served flags (the mobile kernels' plain versions on the CPU)
against the JAX `fused_apply(mobile=True)` with the Pallas kernels in
interpret mode (atol 1e-4) and its bfloat16 band; the predict-decode step
and `PoseServer` on a peaked fixture, keypoints equal to the JAX
package's; the weight layout and the mobile S4/256 parameter count."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from single_person_pose_estimation_tpu.evaluation import predict as jpred
from single_person_pose_estimation_tpu.models.fused_inference import (
    fused_apply as jax_fused_apply,
)
from single_person_pose_estimation_tpu.models.hourglass import (
    StackedHourglass as FlaxHourglass,
)
from single_person_pose_estimation_tpu_torch.evaluation import predict
from single_person_pose_estimation_tpu_torch.models.fused_inference import (
    forward_last_stack,
    fused_apply,
    prepare_fused,
)
from single_person_pose_estimation_tpu_torch.models.hourglass import (
    SeparableConv,
    StackedHourglass,
)
from single_person_pose_estimation_tpu_torch.ops.cuda.mobile_kernel import (
    MobileParams,
)
from single_person_pose_estimation_tpu_torch.serving import PoseServer
from single_person_pose_estimation_tpu_torch.utils.weight_convert import (
    load_variables,
    to_state_dict,
)
from torch_port_fixtures import (
    images,
    peaked_variables,
    random_variables,
    torch_model,
)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "fixtures", "golden_ref_s1c32_mobile.npz")
STACKS, CH = 2, 16
MAIN_FLAGS = dict(fuse_levels=True, pool_fuse_max_h=32, fuse_heads=True)
TOL = 1e-4
# Port bf16 (the mobile kernels' rounding points, float32 sums) against the
# JAX float32 result at mobile S2/C16, 64^2 inputs, measured on these
# inputs: stack 0 max |d| 0.0510 (mean 1.6e-3), stack 1 max |d| 0.399
# (mean 6.4e-4). The JAX package's own bf16 mobile fused path drifts as far
# from its f32 result here (0.0420 and 0.545, means 1.5e-3 and 5.4e-4):
# pixels whose pre-sigmoid sums sit near 0 swing when the inter-stack
# feedback is rounded.
BF16_MAX_BAND = 0.5
BF16_MEAN_BAND = 5e-3


@pytest.fixture(scope="module")
def case():
    v = random_variables(STACKS, CH, seed=3, mobile=True)
    x = images(2, seed=4)
    want = jax_fused_apply(v, jnp.asarray(x), num_stacks=STACKS,
                           compute_dtype=jnp.float32, interpret=True,
                           mobile=True, **MAIN_FLAGS)
    model = torch_model(v, STACKS, CH, mobile=True)
    return x, [np.asarray(w) for w in want], model


def test_mobile_model_matches_flax_f32():
    v = random_variables(1, CH, seed=7, mobile=True)
    x = images(2, seed=8)
    flax_model = FlaxHourglass(num_stacks=1, num_channels=CH, mobile=True)
    want = jax.jit(lambda v, x: flax_model.apply(v, x, train=False))(
        v, jnp.asarray(x))
    model = torch_model(v, 1, CH, mobile=True)
    assert isinstance(model.front_bottleneck_1_skip, SeparableConv)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got[0].shape == (2, 16, 16, 17) and got[0].dtype == torch.float32
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=TOL)


def test_mobile_golden_fixture_matches_reference_outputs():
    """The TF reference's mobile S1/C32 outputs, through the plain model and
    through the fused path (the mobile kernels' plain versions)."""
    data = dict(np.load(GOLDEN))
    stacks, channels, _, mobile = (int(v) for v in data["meta"])
    assert (stacks, channels, mobile) == (1, 32, 1)
    model = load_variables(StackedHourglass(num_stacks=stacks,
                                            num_channels=channels,
                                            mobile=True), data)
    x = torch.from_numpy(data["x"])
    ref = data["ref_out_0"]
    assert ref.std() > 0.01
    with torch.no_grad():
        plain = model(x)[0]
    fused = fused_apply(prepare_fused(model), x, **MAIN_FLAGS)[0]
    np.testing.assert_allclose(plain.numpy(), ref, atol=TOL)
    np.testing.assert_allclose(fused.numpy(), ref, atol=TOL)


def test_mobile_s4_256_parameter_count():
    model = StackedHourglass(num_stacks=4, num_channels=256, mobile=True)
    assert model.count_params() == 5_818_564


def test_mobile_weight_convert_layouts():
    """depthwise (k, k, 1, C) -> (C, 1, k, k), pointwise (1, 1, C, Cout) ->
    (Cout, C, 1, 1) with its bias, from the nested tree and from flat
    fixture keys alike."""
    v = random_variables(1, CH, seed=10, mobile=True)
    sd = to_state_dict(v)
    layer = "hg0_downsample_f1_conv_3x3_2"
    p = v["params"][layer]
    np.testing.assert_array_equal(
        sd[layer + ".depthwise.weight"].numpy(),
        p["depthwise"]["kernel"].transpose(3, 2, 0, 1))
    assert sd[layer + ".depthwise.weight"].shape == (CH // 2, 1, 3, 3)
    assert sd[layer + ".pointwise.weight"].shape == (CH // 2, CH // 2, 1, 1)
    np.testing.assert_array_equal(sd[layer + ".pointwise.bias"].numpy(),
                                  p["pointwise"]["bias"])
    assert layer + ".depthwise.bias" not in sd
    flat = {}
    for col in ("params", "batch_stats"):
        for name, leaves in v[col].items():
            for leaf, arr in leaves.items():
                for sub, a in (arr.items() if isinstance(arr, dict)
                               else [(None, arr)]):
                    key = f"var/{col}/{name}/{leaf}"
                    flat[key if sub is None else f"{key}/{sub}"] = a
    sd_flat = to_state_dict(flat)
    assert sd_flat.keys() == sd.keys()
    assert all(torch.equal(sd[n], sd_flat[n]) for n in sd)


def test_mobile_fused_apply_matches_jax_main_flags_f32(case):
    x, want, model = case
    fp = prepare_fused(model)
    assert fp.mobile and all(isinstance(p, MobileParams)
                             for p in fp.bnecks.values())
    got = fused_apply(fp, torch.from_numpy(x), **MAIN_FLAGS)
    assert len(got) == STACKS
    for s in range(STACKS):
        np.testing.assert_allclose(got[s].numpy(), want[s], atol=TOL,
                                   err_msg=f"stack {s}")


def test_mobile_fused_apply_bf16_band_against_jax_f32(case):
    x, want, model = case
    fp = prepare_fused(model, dtype=torch.bfloat16)
    got = fused_apply(fp, torch.from_numpy(x), **MAIN_FLAGS)
    for s in range(STACKS):
        d = np.abs(got[s].numpy() - want[s])
        assert np.isfinite(d).all(), s
        assert d.max() <= BF16_MAX_BAND, (s, d.max())
        assert d.mean() <= BF16_MEAN_BAND, (s, d.mean())


def test_mobile_fused_apply_dials(case):
    """Under mobile, fuse_bottom and fuse_front are turned off as the JAX
    package turns them off, so the result is the main path's; front_s2d
    gives the same heatmaps. Without the fusion flags the routing still
    equals the plain model."""
    x, want, model = case
    fp = prepare_fused(model)
    xt = torch.from_numpy(x)
    got = fused_apply(fp, xt, fuse_bottom=2, fuse_front=True, **MAIN_FLAGS)
    np.testing.assert_allclose(got[-1].numpy(), want[-1], atol=TOL)
    got = fused_apply(fp, xt, front_s2d=True, **MAIN_FLAGS)
    np.testing.assert_allclose(got[-1].numpy(), want[-1], atol=TOL)
    with torch.no_grad():
        plain = model(xt)[-1]
    got = fused_apply(fp, xt)[-1]
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=TOL)
    got = forward_last_stack(model, xt, use_fused=True, auto=False)
    np.testing.assert_allclose(got.numpy(), want[-1], atol=TOL)


def test_mobile_predict_decode_and_serving_match_jax():
    """The predict-decode step on the mobile fused path (plain kernel
    versions) against the JAX package's with its Pallas kernels in
    interpret mode, and PoseServer on the CPU: keypoints equal. The crops
    are bright spots on dark noise and the predict kernel non-negative
    and small (peaked_variables), so every channel's peak leads its
    runner-up by more than 1e-4 and float32 rounding cannot move an
    argmax (asserted)."""
    v = peaked_variables(1, CH, seed=10, scale=0.04, mobile=True)
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:64, 0:64]
    x = rng.uniform(0, 0.05, (2, 64, 64, 3)).astype(np.float32)
    for i, (cy, cx) in enumerate(rng.uniform(16, 48, (2, 2))):
        x[i] += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 32.0)[..., None]
    flax_model = FlaxHourglass(num_stacks=1, num_channels=CH, mobile=True)
    jfn = jpred.make_predict_decode_fn(flax_model, use_fused=True,
                                       interpret=True)
    want = np.asarray(jfn(v["params"], v["batch_stats"], jnp.asarray(x)))
    model = torch_model(v, 1, CH, mobile=True)
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        hm = forward_last_stack(model, xt, use_fused=True, auto=False)
    top2 = np.sort(hm.numpy().reshape(2, -1, 17), axis=1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() > 1e-4
    fn = predict.make_predict_decode_fn(model, use_fused=True, device="cpu")
    got = fn(model, xt).numpy()
    np.testing.assert_array_equal(got[..., :2], want[..., :2])
    np.testing.assert_allclose(got[..., 2], want[..., 2], atol=TOL)
    with PoseServer(model, device="cpu", buckets=(1, 2), use_fused=True,
                    transfer_dtype="float32") as server:
        served = server.predict(x)
    np.testing.assert_array_equal(served[..., :2], want[..., :2])
