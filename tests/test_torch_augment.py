"""The port's augmentation against the JAX package's `ops/augment.py`.

Torch cannot reproduce JAX's random stream, so each JAX function is run on
a key and the port's counterpart is given the draws JAX made from it: the
keypoint transform, the gather warp, the photometric jitter and the whole
`augment_batch` (gather backend) agree within atol 1e-5 (float32 sums and
transcendental functions may round apart by an ulp, and the min-max
renormalisation can scale that by a few). The port's own draws are held to
the reference's distributions as `tests/test_augment_stats.py` holds
JAX's, on fewer samples (N = 4096)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from single_person_pose_estimation_tpu.ops import augment as jaug
from single_person_pose_estimation_tpu_torch.ops import augment as taug

ATOL = 1e-5
B, H, K = 4, 32, 17


def _t(a):
    return torch.from_numpy(np.array(a))


def _photo_draws(keys):
    """The four photometric draws augment_photometric makes from each key:
    (delta, contrast, saturation, hue), each (B,)."""

    def photo(k):
        k1, k2, k3, k4 = jax.random.split(k, 4)
        u = lambda kk, lo, hi: jax.random.uniform(kk, (), minval=lo,
                                                  maxval=hi)
        return (u(k1, -0.2, 0.2), u(k2, 0.5, 2.0), u(k3, 0.75, 1.25),
                u(k4, -0.1, 0.1))

    return tuple(map(_t, jax.vmap(photo)(keys)))


def _jax_draws(key, b):
    """The draws JAX's augment_batch makes from `key`, as the port's
    AugmentDraws."""
    k_geo, k_photo = jax.random.split(key)
    s, theta, flip = jax.vmap(lambda k: jaug._affine_params(
        k, 0.75, 1.25, 30.0))(jax.random.split(k_geo, b))
    return taug.AugmentDraws(_t(s), _t(theta), _t(flip),
                             *_photo_draws(jax.random.split(k_photo, b)))


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 1, (B, H, H, 3)).astype(np.float32)
    kx = rng.uniform(-2, 66, (B, K)).astype(np.float32)
    ky = rng.uniform(-2, 66, (B, K)).astype(np.float32)
    kv = rng.integers(0, 3, (B, K)).astype(np.int32)
    return images, kx, ky, kv


@pytest.fixture(scope="module")
def draws():
    return _jax_draws(jax.random.PRNGKey(11), B)


def test_keypoints_match_jax(batch, draws):
    _, kx, ky, kv = batch
    perm = jaug._flip_permutation(K, jaug.DEFAULT_FLIP_PAIRS)
    want = jax.vmap(lambda x, y, v, s, th, fl: jaug._transform_keypoints(
        x, y, v, s, th, fl, 64, perm))(
        kx, ky, kv, *(jnp.asarray(d.numpy()) for d in draws[:3]))
    got = taug._transform_keypoints(
        *map(torch.from_numpy, (kx, ky, kv)), draws.s, draws.theta,
        draws.flip, 64, taug._flip_permutation(K, taug.DEFAULT_FLIP_PAIRS))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=ATOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=ATOL)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    invisible = got[2].numpy() <= 0
    assert invisible.any() and not got[0].numpy()[invisible].any()


def test_gather_warp_matches_jax(batch, draws):
    images = batch[0]
    want = jax.vmap(jaug._warp_image)(
        images, *(jnp.asarray(d.numpy()) for d in draws[:3]))
    got = taug._warp_image(torch.from_numpy(images), draws.s, draws.theta,
                           draws.flip)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_photometric_matches_jax(batch):
    images = batch[0]
    keys = jax.random.split(jax.random.PRNGKey(5), B)
    want = jax.vmap(jaug.augment_photometric)(keys, images)
    got = taug.augment_photometric(torch.from_numpy(images),
                                   *_photo_draws(keys))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert got.amin().item() == 0.0 and abs(got.amax().item() - 1) < 1e-6


def test_hsv_round_trip_matches_jax(batch):
    rgb = batch[0]
    hsv = taug.rgb_to_hsv(torch.from_numpy(rgb))
    np.testing.assert_allclose(hsv.numpy(), np.asarray(jaug.rgb_to_hsv(rgb)),
                               atol=ATOL)
    np.testing.assert_allclose(taug.hsv_to_rgb(hsv).numpy(),
                               np.asarray(jaug.hsv_to_rgb(
                                   jnp.asarray(hsv.numpy()))), atol=ATOL)


def test_augment_batch_matches_jax_given_its_draws(batch, draws):
    images, kx, ky, kv = batch
    key = jax.random.PRNGKey(11)
    want = jaug.augment_batch(key, images, kx, ky, kv,
                              geometric_backend="gather")
    got = taug.augment_batch_with_draws(
        *map(torch.from_numpy, (images, kx, ky, kv)), draws,
        geometric_backend="gather")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


def test_matmul2pass_backend_warps_like_gather(batch, draws):
    """The two-pass warp differs from one bilinear resample only by the
    second pass's smoothing: its mean |difference| stays small."""
    images = torch.from_numpy(batch[0])
    two = taug.augment_geometric_with_draws(
        images, *map(torch.from_numpy, batch[1:]), draws,
        geometric_backend="matmul2pass")[0]
    one = taug._warp_image(images, draws.s, draws.theta, draws.flip)
    assert two.shape == one.shape
    assert (two - one).abs().mean().item() < 0.05


def test_unknown_backend_and_bad_flip_pairs_raise(batch):
    gen = torch.Generator().manual_seed(0)
    args = [torch.from_numpy(a) for a in batch]
    with pytest.raises(ValueError, match="geometric_backend"):
        taug.augment_batch(gen, *args, geometric_backend="bogus")
    with pytest.raises(ValueError, match="flip_pairs"):
        taug.augment_batch(gen, *args, flip_pairs=((0, 40),))
    assert taug.resolve_backend("auto", "cpu") == "gather"
    assert taug.resolve_backend("auto", "cuda") == "matmul2pass"


N = 4096
_KS_BOUND = float(np.sqrt(np.log(2 / 1e-6) / (2 * N)))


def _ks_uniform(samples, lo, hi):
    x = np.sort((samples - lo) / (hi - lo))
    n = len(x)
    return max(np.max(np.arange(1, n + 1) / n - x),
               np.max(x - np.arange(0, n) / n))


@pytest.mark.parametrize("field,lo,hi", [
    ("s", 0.75, 1.25), ("theta", -np.pi / 6, np.pi / 6),
    ("delta", -0.2, 0.2), ("contrast", 0.5, 2.0),
    ("saturation", 0.75, 1.25), ("hue", -0.1, 0.1)])
def test_port_draws_are_uniform_over_the_reference_ranges(field, lo, hi):
    gen = torch.Generator().manual_seed(20260819)
    v = getattr(taug.draw_augment_params(gen, N), field).double().numpy()
    assert v.min() >= lo - 1e-6 and v.max() <= hi + 1e-6
    assert _ks_uniform(v, lo, hi) < _KS_BOUND


def test_port_flip_probability_half_and_draws_independent():
    gen = torch.Generator().manual_seed(3)
    d = taug.draw_augment_params(gen, N)
    assert abs(d.flip.double().mean().item() - 0.5) < 6 * 0.5 / np.sqrt(N)
    # Independent fields: no strong correlation between any two.
    m = np.corrcoef(np.stack([getattr(d, f).double().numpy() for f in
                              ("s", "theta", "delta", "contrast",
                               "saturation", "hue")]))
    assert np.abs(m - np.eye(6)).max() < 0.1
    # The same seed reproduces the same draws.
    again = taug.draw_augment_params(torch.Generator().manual_seed(3), N)
    assert torch.equal(d.theta, again.theta)
