"""H-sharded inference in the port (`parallel/spatial.py`,
`parallel/spatial_model.py`), on the CPU.

The port runs one process over a mesh of [cpu] * 4 (four shards of rows
on one device, standing in for four devices); the JAX package runs its
`parallel/spatial.py` and `parallel/spatial_model.py` on its 8-device
spoofed mesh, at the geometries of tests/test_spatial.py and
tests/test_spatial_model.py. Every case holds the port against JAX and
against the port's unsharded op or model, atol ATOL at float32 (1e-5 for
a single conv, as the JAX tests hold theirs). A shard of odd height
raises for the 2x2 pooling and the stride-2 conv, and a mobile model or
a channel-sharded one raises in spatial_apply.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from single_person_pose_estimation_tpu.parallel import mesh as jmesh
from single_person_pose_estimation_tpu.parallel import spatial as jspatial
from single_person_pose_estimation_tpu.parallel.spatial_model import (
    spatial_apply as jax_spatial_apply,
)
from single_person_pose_estimation_tpu_torch.models.hourglass import same_pad
from single_person_pose_estimation_tpu_torch.parallel import spatial
from single_person_pose_estimation_tpu_torch.parallel.mesh import create_mesh
from single_person_pose_estimation_tpu_torch.parallel.spatial_model import (
    spatial_apply,
)
from torch_port_fixtures import random_variables, torch_model

ATOL = 1e-4
ATOL_CONV = 1e-5
SHARDS = 4


@pytest.fixture(scope="module")
def mesh():
    return create_mesh((SHARDS,), ("spatial",), devices=["cpu"] * SHARDS)


@pytest.fixture(scope="module")
def jax_mesh():
    return jmesh.create_mesh((8,), ("spatial",))


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _oihw(k):
    return torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _uniform(seed, lo, hi, shape):
    return np.random.default_rng(seed).uniform(lo, hi, shape) \
        .astype(np.float32)


def _run(xs, mesh):
    return _nhwc(spatial.gather_spatial(xs, mesh))


def _jax_conv(x, k, b, jax_mesh, stride=1):
    return np.asarray(jspatial.conv_spatial(
        jspatial.shard_spatial(jnp.asarray(x), jax_mesh), jnp.asarray(k),
        jnp.asarray(b), jax_mesh, "spatial", stride=stride))


def test_conv3x3_spatial_matches_jax_and_unsharded(mesh, jax_mesh):
    x = _uniform(0, -1, 1, (2, 64, 32, 8))
    k = _uniform(1, -.2, .2, (3, 3, 8, 16))
    b = _uniform(2, -.1, .1, (16,))
    got = _run(spatial.conv3x3_spatial(spatial.shard_spatial(_nchw(x), mesh),
                                       _oihw(k), torch.from_numpy(b), mesh),
               mesh)
    want = _nhwc(F.conv2d(_nchw(x), _oihw(k), torch.from_numpy(b),
                          padding=1))
    np.testing.assert_allclose(got, want, atol=ATOL_CONV)
    np.testing.assert_allclose(got, _jax_conv(x, k, b, jax_mesh),
                               atol=ATOL_CONV)


def test_conv_output_stays_sharded(mesh):
    xs = spatial.shard_spatial(torch.ones(1, 4, 64, 32), mesh)
    out = spatial.conv3x3_spatial(xs, torch.full((4, 4, 3, 3), 0.1), None,
                                  mesh)
    assert isinstance(out, list) and len(out) == SHARDS
    assert {tuple(t.shape) for t in out} == {(1, 4, 64 // SHARDS, 32)}


def test_boundary_rows_zero_padded(mesh, jax_mesh):
    """Global SAME zero padding: the first and last rows take zero halos,
    as JAX's edge shards do."""
    x, k = np.ones((1, 64, 16, 2), np.float32), np.ones((3, 3, 2, 1),
                                                         np.float32)
    got = _run(spatial.conv3x3_spatial(spatial.shard_spatial(_nchw(x), mesh),
                                       _oihw(k), torch.zeros(1), mesh), mesh)
    np.testing.assert_allclose(got, _jax_conv(x, k, np.zeros(1, np.float32),
                                              jax_mesh), atol=ATOL_CONV)
    assert got[0, 0, 5, 0] == pytest.approx(12.0)
    assert got[0, 63, 5, 0] == pytest.approx(12.0)
    assert got[0, 15, 5, 0] == got[0, 16, 5, 0] == pytest.approx(18.0)


def test_pool_and_upsample_spatial(mesh, jax_mesh):
    x = _uniform(1, 0, 1, (2, 64, 16, 4))
    pooled = spatial.maxpool2x2_spatial(spatial.shard_spatial(_nchw(x), mesh),
                                        mesh)
    jx = jspatial.shard_spatial(jnp.asarray(x), jax_mesh)
    jpooled = jspatial.maxpool2x2_spatial(jx, jax_mesh)
    np.testing.assert_array_equal(_run(pooled, mesh), np.asarray(jpooled))
    np.testing.assert_array_equal(_run(pooled, mesh),
                                  _nhwc(F.max_pool2d(_nchw(x), 2)))
    up = spatial.upsample2x_spatial(pooled, mesh)
    assert _run(up, mesh).shape == (2, 64, 16, 4)
    np.testing.assert_array_equal(
        _run(up, mesh), np.asarray(jspatial.upsample2x_spatial(jpooled,
                                                               jax_mesh)))


def test_chained_conv_pool_conv(mesh, jax_mesh):
    x = _uniform(2, -1, 1, (1, 64, 16, 4))
    k1 = _uniform(3, -.3, .3, (3, 3, 4, 8))
    k2 = _uniform(4, -.3, .3, (3, 3, 8, 8))
    zero = np.zeros(8, np.float32)
    xs = spatial.shard_spatial(_nchw(x), mesh)
    out = spatial.conv3x3_spatial(xs, _oihw(k1), torch.from_numpy(zero), mesh)
    out = spatial.maxpool2x2_spatial(out, mesh)
    out = _run(spatial.conv3x3_spatial(out, _oihw(k2), torch.from_numpy(zero),
                                       mesh), mesh)
    ref = F.conv2d(F.max_pool2d(F.conv2d(_nchw(x), _oihw(k1), padding=1), 2),
                   _oihw(k2), padding=1)
    np.testing.assert_allclose(out, _nhwc(ref), atol=ATOL_CONV)
    j = jspatial.shard_spatial(jnp.asarray(x), jax_mesh)
    j = jspatial.conv3x3_spatial(j, jnp.asarray(k1), jnp.asarray(zero),
                                 jax_mesh)
    j = jspatial.maxpool2x2_spatial(j, jax_mesh)
    j = jspatial.conv3x3_spatial(j, jnp.asarray(k2), jnp.asarray(zero),
                                 jax_mesh)
    np.testing.assert_allclose(out, np.asarray(j), atol=ATOL_CONV)


def test_conv7x7_stride2_spatial(mesh, jax_mesh):
    """The front's 7x7/s2: a halo of 3 and a window that starts a row into
    it, TF SAME padding (2 before, 3 after)."""
    x = _uniform(0, -1, 1, (2, 128, 128, 3))
    k = _uniform(1, -.2, .2, (7, 7, 3, 8))
    b = _uniform(2, -.1, .1, (8,))
    got = _run(spatial.conv_spatial(spatial.shard_spatial(_nchw(x), mesh),
                                    _oihw(k), torch.from_numpy(b), mesh,
                                    stride=2), mesh)
    pad = [p for n in (128, 128) for p in same_pad(n, 7, 2)]
    want = _nhwc(F.conv2d(F.pad(_nchw(x), pad), _oihw(k),
                          torch.from_numpy(b), stride=2))
    assert got.shape == want.shape == (2, 64, 64, 8)
    np.testing.assert_allclose(got, want, atol=ATOL_CONV)
    np.testing.assert_allclose(got, _jax_conv(x, k, b, jax_mesh, stride=2),
                               atol=ATOL_CONV)


def test_odd_local_heights_raise(mesh):
    xs = spatial.shard_spatial(torch.ones(1, 2, 4 * SHARDS - SHARDS, 8), mesh)
    assert {t.shape[2] for t in xs} == {3}
    with pytest.raises(ValueError, match="even"):
        spatial.maxpool2x2_spatial(xs, mesh)
    with pytest.raises(ValueError, match="stride"):
        spatial.conv_spatial(xs, torch.ones(2, 2, 7, 7), None, mesh, stride=2)
    with pytest.raises(ValueError, match="do not split"):
        spatial.shard_spatial(torch.ones(1, 2, 10, 8), mesh)
    with pytest.raises(ValueError, match="not in mesh axes"):
        spatial.shard_spatial(torch.ones(1, 2, 8, 8),
                              create_mesh(devices=["cpu"] * 2))


@pytest.mark.parametrize("stacks, size, batch, gather_h", [
    (1, 512, 1, 64),    # sharded above 64 rows, one map below
    (2, 256, 2, 32),    # re-sharded on the way up, the feedback path
])
def test_spatial_apply_matches_jax_and_the_unsharded_model(
        mesh, jax_mesh, stacks, size, batch, gather_h):
    v = random_variables(stacks, 16, seed=stacks)
    x = _uniform(stacks, 0, 1, (batch, size, size, 3))
    got = spatial_apply(v, torch.from_numpy(x), mesh, num_stacks=stacks,
                        gather_h=gather_h)
    model = torch_model(v, stacks, 16)
    with torch.no_grad():
        want = model(torch.from_numpy(x))
    jv = jax.tree.map(jnp.asarray, v)
    jgot = jax_spatial_apply(jv, jnp.asarray(x), jax_mesh, num_stacks=stacks,
                             gather_h=gather_h)
    assert len(got) == len(want) == len(jgot) == stacks
    for g, w, j in zip(got, want, jgot):
        assert g.shape == w.shape == (batch, size // 4, size // 4, 17)
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=ATOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=ATOL)
    # The model itself gives the same maps as its variables.
    for g, m in zip(got, spatial_apply(model, torch.from_numpy(x), mesh,
                                       num_stacks=stacks, gather_h=gather_h)):
        torch.testing.assert_close(m, g, rtol=0, atol=0)


def test_spatial_apply_rejects_what_it_does_not_cover(mesh):
    x = torch.zeros(1, 64, 64, 3)
    with pytest.raises(ValueError, match="mobile"):
        spatial_apply(random_variables(1, 16, mobile=True), x, mesh)
    with pytest.raises(ValueError, match="standard model"):
        spatial_apply(torch_model(random_variables(1, 16, mobile=True), 1, 16,
                                  mobile=True), x, mesh)
    with pytest.raises(ValueError, match="num_stacks"):
        spatial_apply(random_variables(1, 16), x, mesh, num_stacks=2)
    with pytest.raises(ValueError, match="divisible by 64"):
        spatial_apply(random_variables(1, 16), torch.zeros(1, 96, 64, 3),
                      mesh, num_stacks=1)
