"""Port fused_apply against the JAX package's fused_apply (Pallas kernels
in interpret mode) with the main path's flags, on the same variables and
inputs; the kernels run as their plain PyTorch versions on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from single_person_pose_estimation_tpu.models.fused_inference import (
    fused_apply as jax_fused_apply,
)
from single_person_pose_estimation_tpu_torch.models import (
    fused_inference as fi,
)
from single_person_pose_estimation_tpu_torch.models.fused_inference import (
    FUSED_AUTO_MAX_INPUT,
    auto_use_fused,
    forward_last_stack,
    fused_apply,
    prepare_fused,
)
from torch_port_fixtures import images, random_variables, torch_model

STACKS, CH = 2, 16
MAIN_FLAGS = dict(fuse_levels=True, pool_fuse_max_h=32, fuse_heads=True)
# Port bf16 (storage rounding at the kernels' points, float32 sums) against
# the JAX float32 result at S2/C16, 64^2 inputs, measured on these inputs:
# stack 0 max |d| 0.0195, stack 1 max |d| 0.325 with mean |d| 1.9e-3. The
# JAX package's own bf16 fused path drifts as far from its f32 result here
# (0.0206 and 0.400): a few pixels whose pre-sigmoid sums sit near 0 swing
# when the inter-stack feedback is rounded. The band bounds both the worst
# pixel and the mean.
BF16_MAX_BAND = 0.5
BF16_MEAN_BAND = 5e-3


@pytest.fixture(scope="module")
def case():
    v = random_variables(STACKS, CH, seed=3)
    x = images(2, seed=4)
    want = jax_fused_apply(v, jnp.asarray(x), num_stacks=STACKS,
                           compute_dtype=jnp.float32, interpret=True,
                           **MAIN_FLAGS)
    model = torch_model(v, STACKS, CH)
    return v, x, [np.asarray(w) for w in want], model


def test_fused_apply_matches_jax_main_flags_f32(case):
    _, x, want, model = case
    got = fused_apply(prepare_fused(model), torch.from_numpy(x), **MAIN_FLAGS)
    assert len(got) == STACKS
    for s in range(STACKS):
        assert got[s].dtype == torch.float32
        np.testing.assert_allclose(got[s].numpy(), want[s], atol=1e-4,
                                   err_msg=f"stack {s}")


def test_fused_apply_unfused_pool_branch_matches_jax():
    """pool_fuse_max_h=8 leaves the 16 px level's pool outside the kernel
    (bottleneck + separate maxpool)."""
    v = random_variables(1, CH, seed=5)
    x = images(1, seed=6)
    flags = dict(MAIN_FLAGS, pool_fuse_max_h=8)
    want = jax_fused_apply(v, jnp.asarray(x), num_stacks=1,
                           compute_dtype=jnp.float32, interpret=True,
                           **flags)
    got = fused_apply(prepare_fused(torch_model(v, 1, CH)),
                      torch.from_numpy(x), **flags)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-4)


def test_fused_apply_bf16_band_against_jax_f32(case):
    _, x, want, model = case
    fp = prepare_fused(model, dtype=torch.bfloat16)
    got = fused_apply(fp, torch.from_numpy(x), **MAIN_FLAGS)
    for s in range(STACKS):
        d = np.abs(got[s].numpy() - want[s])
        assert np.isfinite(d).all(), s
        assert d.max() <= BF16_MAX_BAND, (s, d.max())
        assert d.mean() <= BF16_MEAN_BAND, (s, d.mean())


@pytest.mark.parametrize("flags", [{}, dict(MAIN_FLAGS, fuse_max_h=8)],
                         ids=["no_fusion", "fuse_max_h_8"])
def test_other_routings_match_plain_model(case, flags):
    """With no fusion flag the routing runs kernel #1 only, with the plain
    upsample-add and head; with fuse_max_h=8 the 16 px level runs the
    plain layers. Both must still equal the plain model."""
    _, x, _, model = case
    with torch.no_grad():
        want = model(torch.from_numpy(x))
    got = fused_apply(prepare_fused(model), torch.from_numpy(x), **flags)
    for s in range(STACKS):
        np.testing.assert_allclose(got[s].numpy(), want[s].numpy(),
                                   atol=1e-4)


def test_unported_dials_raise(case):
    """Every dial of the JAX fused_apply is ported: front_s2d gives the
    7x7 front's heatmaps (atol 1e-5, the fold reorders the sums), and a
    fuse_bottom beyond the four levels raises."""
    _, x, _, model = case
    fp = prepare_fused(model)
    xt = torch.from_numpy(x)
    want = fused_apply(fp, xt, **MAIN_FLAGS)
    got = fused_apply(fp, xt, front_s2d=True, **MAIN_FLAGS)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="fuse_bottom"):
        fused_apply(fp, xt, fuse_bottom=5)


def test_auto_policy_and_forward_last_stack(case):
    _, x, want, model = case
    assert not auto_use_fused(model, "cpu")
    model.compute_dtype = torch.bfloat16
    try:
        assert auto_use_fused(model, "cuda")
        assert not auto_use_fused(model, "cpu")
    finally:
        model.compute_dtype = torch.float32
    assert FUSED_AUTO_MAX_INPUT == 256
    got = forward_last_stack(model, torch.from_numpy(x), use_fused=True,
                             auto=False)
    np.testing.assert_allclose(got.numpy(), want[-1], atol=1e-4)


def test_size_rules_above_256_route_to_plain_and_count():
    """At a 320 px input auto mode runs the plain model, and an explicit
    use_fused=True keeps the kernels but runs the 80 px level (above
    fuse_max_h=64) through the plain layers: its downsample bottleneck and
    the up-level's two. Each is counted in plain_routes."""
    model = torch_model(random_variables(1, CH, seed=7), 1, CH)
    x = torch.from_numpy(images(1, size=320, seed=8))
    with torch.no_grad():
        want = model(x)[-1]
    fi.plain_routes.update(forward=0, level=0)
    got = forward_last_stack(model, x, use_fused=True, auto=True)
    assert fi.plain_routes == {"forward": 1, "level": 0}
    assert torch.equal(got, want)
    got = forward_last_stack(model, x, use_fused=True, auto=False)
    assert fi.plain_routes == {"forward": 1, "level": 3}
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4)
    fi.plain_routes.update(forward=0, level=0)
    forward_last_stack(model, torch.from_numpy(images(1, seed=9)),
                       use_fused=True, auto=True)
    assert fi.plain_routes == {"forward": 0, "level": 0}
