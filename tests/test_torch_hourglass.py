"""Port StackedHourglass (plain PyTorch) against the flax model and the TF
reference outputs recorded in the golden fixture."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from single_person_pose_estimation_tpu.models.hourglass import (
    StackedHourglass as FlaxHourglass,
)
from single_person_pose_estimation_tpu_torch.models.hourglass import (
    StackedHourglass,
    create_hourglass_model,
    same_pad,
)
from single_person_pose_estimation_tpu_torch.utils.weight_convert import (
    load_variables,
    to_state_dict,
)
from torch_port_fixtures import images, random_variables, torch_model

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "fixtures", "golden_ref_s2c32.npz")


def test_plain_model_matches_flax_f32():
    v = random_variables(2, 16, seed=7)
    x = images(2, seed=8)
    want = FlaxHourglass(num_stacks=2, num_channels=16).apply(
        v, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = torch_model(v, 2, 16)(torch.from_numpy(x))
    assert len(got) == 2
    for s in range(2):
        assert got[s].shape == (2, 16, 16, 17) and got[s].dtype == torch.float32
        np.testing.assert_allclose(got[s].numpy(), np.asarray(want[s]),
                                   atol=1e-4, err_msg=f"stack {s}")


@pytest.mark.parametrize("activation", ["linear", "relu"])
def test_predict_activation_matches_flax_f32(activation):
    """`predict_activation` applied as the reference's `_activate`: S1 and
    S2 from the same flax variables (S2 also runs the inter-stack
    feedback, which reads the activated prediction), built by
    `create_hourglass_model`, against flax `model.apply`."""
    x = jnp.asarray(images(2, seed=12))
    for stacks in (1, 2):
        v = random_variables(stacks, 16, seed=11)
        want = FlaxHourglass(num_stacks=stacks, num_channels=16,
                             predict_activation=activation).apply(
            v, x, train=False)
        model = load_variables(create_hourglass_model(
            17, stacks, 16, input_shape=(64, 64, 3),
            predict_activation=activation), v)
        assert model.predict_activation == activation
        with torch.no_grad():
            got = model(torch.from_numpy(np.asarray(x)))
        for s in range(stacks):
            assert got[s].dtype == torch.float32
            np.testing.assert_allclose(got[s].numpy(), np.asarray(want[s]),
                                       atol=1e-4, err_msg=f"S{stacks} {s}")
        if activation == "linear":      # a sigmoid would bound the outputs
            assert float(got[-1].min()) < 0


def test_create_hourglass_model_defaults_and_rejects():
    m = create_hourglass_model(17, 1, 16)
    assert isinstance(m, StackedHourglass)
    assert (m.predict_activation, m.mobile, m.compute_dtype) == (
        "sigmoid", False, torch.float32)
    assert create_hourglass_model(17, 1, 16, remat="conv_out").remat == \
        "conv_out"
    with pytest.raises(ValueError, match="remat must be one of"):
        create_hourglass_model(17, 1, 16, remat="all")
    with pytest.raises(ValueError, match="unknown activation"):
        create_hourglass_model(17, 1, 16, predict_activation="tanh")


def test_golden_fixture_matches_reference_outputs():
    data = dict(np.load(GOLDEN))
    stacks, channels, size, mobile = (int(v) for v in data["meta"])
    assert (stacks, channels, size, mobile) == (2, 32, 64, 0)
    model = load_variables(StackedHourglass(num_stacks=stacks,
                                            num_channels=channels), data)
    with torch.no_grad():
        outs = model(torch.from_numpy(data["x"]))
    for s in range(stacks):
        ref = data[f"ref_out_{s}"]
        assert ref.std() > 0.01
        np.testing.assert_allclose(outs[s].numpy(), ref, atol=1e-4,
                                   err_msg=f"stack {s}")


def test_s4_256_parameter_count():
    assert StackedHourglass(num_stacks=4, num_channels=256).count_params() \
        == 13_784_260


def test_front_conv_pads_like_tf_same():
    """7x7/s2 SAME on an even input pads 2 before and 3 after; torch's
    symmetric padding=3 shifts the output by one pixel."""
    assert same_pad(64, 7, 2) == (2, 3)
    assert same_pad(63, 7, 2) == (3, 3)
    rng = np.random.default_rng(9)
    x = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    k = rng.uniform(-.2, .2, (7, 7, 3, 8)).astype(np.float32)
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    model = StackedHourglass(num_stacks=1, num_channels=16)
    conv = model.front_conv_1x1_1
    conv.weight.data = torch.from_numpy(k.transpose(3, 2, 0, 1).copy()) \
        .repeat(8, 1, 1, 1)[:64]
    conv.bias.data.zero_()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = model._conv(xt, "front_conv_1x1_1", "linear")
        sym = F.conv2d(xt, conv.weight, stride=2, padding=3)
    got = got.permute(0, 2, 3, 1).numpy()[..., :8]
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.abs(sym.permute(0, 2, 3, 1).numpy()[..., :8] - want).max() > 1e-2


def test_input_not_divisible_by_64_raises():
    model = StackedHourglass(num_stacks=1, num_channels=16)
    with pytest.raises(ValueError, match="divisible by 64"):
        model(torch.zeros(1, 96, 96, 3))


def test_unported_variants_raise():
    """Every variant of the JAX model is ported (tests/
    test_torch_space_to_depth.py holds them); values outside the JAX
    package's choices raise."""
    for kw in (dict(front_s2d=True), dict(remat=True),
               dict(remat="conv_out"), dict(mobile_depthwise="taps")):
        StackedHourglass(num_stacks=1, num_channels=16, **kw)
    for kw in (dict(remat="yes"), dict(mobile_depthwise="grouped")):
        with pytest.raises(ValueError):
            StackedHourglass(num_stacks=1, num_channels=16, **kw)


def test_weight_convert_layouts():
    """HWIO -> OIHW, BN leaves -> weight/bias/running stats, from the
    nested tree and from flat fixture keys alike."""
    v = random_variables(1, 16, seed=10)
    sd = to_state_dict(v)
    k = v["params"]["hg0_conv_1x1_predict"]["kernel"]
    np.testing.assert_array_equal(
        sd["hg0_conv_1x1_predict.weight"].numpy(), k.transpose(3, 2, 0, 1))
    bn = "hg0_downsample_f1_conv_3x3_2_bn"
    np.testing.assert_array_equal(sd[bn + ".running_var"].numpy(),
                                  v["batch_stats"][bn]["var"])
    np.testing.assert_array_equal(sd[bn + ".weight"].numpy(),
                                  v["params"][bn]["scale"])
    flat = {f"var/{col}/{layer}/{leaf}": arr
            for col in ("params", "batch_stats")
            for layer, leaves in v[col].items()
            for leaf, arr in leaves.items()}
    sd_flat = to_state_dict(flat)
    assert sd_flat.keys() == sd.keys()
    assert all(torch.equal(sd[n], sd_flat[n]) for n in sd)
