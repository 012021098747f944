"""The mobile kernels' plain PyTorch versions (#8-#10) against the JAX
Pallas kernels they port (`ops/pallas/mobile_kernel.py`), run in interpret
mode on the CPU at float32 (atol 1e-5), on the same numpy-seeded operands;
and the wrappers' routing: a CPU tensor takes the plain version and leaves
the launch counters at 0, and a tensor off the CPU without a card raises.

The kernels themselves run only on a card: `chip_smoke.py` and
`test_torch_cuda_kernels.py` hold them against these plain versions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from single_person_pose_estimation_tpu.ops.pallas import mobile_kernel as jmk
from single_person_pose_estimation_tpu_torch.ops import cuda as tcuda
from single_person_pose_estimation_tpu_torch.ops.cuda import (
    mobile_kernel as tmk,
)

C, CM = 32, 16
ATOL = 1e-5


def _args(rng):
    """The `mobile_bneck_params` tuple as float32 numpy: dw1 (C,), pw1,
    b1, dw2 (3, 3, Cm), pw2, b2, dw3 (Cm,), pw3, b3, a1, c1, a2, c2, a3,
    c3. Positive b1 and c1 make t1 at a zero x nonzero, so a kernel that
    pads x instead of t1 at the image border would show."""
    u = lambda lo, hi, *s: rng.uniform(lo, hi, s).astype(np.float32)
    return [u(.5, 1.5, C), u(-.2, .2, C, CM), u(.1, .3, CM),
            u(-.5, .5, 3, 3, CM), u(-.2, .2, CM, CM), u(-.1, .1, CM),
            u(.5, 1.5, CM), u(-.2, .2, CM, C), u(-.1, .1, C),
            u(.5, 1.5, CM), u(.1, .4, CM), u(.5, 1.5, CM), u(-.3, .3, CM),
            u(.5, 1.5, C), u(-.3, .3, C)]


def _pack(args, dtype=torch.float32):
    return tmk.MobileParams.pack(*map(torch.from_numpy, args), dtype=dtype)


def _x(rng, b, h):
    return rng.uniform(-1, 1, (b, h, h, C)).astype(np.float32)


@pytest.mark.parametrize("h", [16, 4, 1])
def test_mobile_bottleneck_plain_matches_pallas(h):
    rng = np.random.default_rng(50 + h)
    x, args = _x(rng, 2, h), _args(rng)
    want = np.asarray(jmk.fused_bottleneck_mobile(
        jnp.asarray(x), *map(jnp.asarray, args), interpret=True))
    got = tmk.fused_bottleneck_mobile(torch.from_numpy(x), _pack(args))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("h", [8, 2])
def test_mobile_bottleneck_pool_plain_matches_pallas(h):
    rng = np.random.default_rng(60 + h)
    x, args = _x(rng, 2, h), _args(rng)
    want_out, want_pool = jmk.fused_bottleneck_mobile_pool(
        jnp.asarray(x), *map(jnp.asarray, args), interpret=True)
    out, pooled = tmk.fused_bottleneck_mobile_pool(torch.from_numpy(x),
                                                   _pack(args))
    assert pooled.shape == (2, h // 2, h // 2, C)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=ATOL)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(want_pool),
                               atol=ATOL)


@pytest.mark.parametrize("h", [16, 2])
def test_mobile_uplevel_plain_matches_pallas(h):
    rng = np.random.default_rng(70 + h)
    feat, ulo = _x(rng, 2, h), _x(rng, 2, h // 2)
    sa, ma = _args(rng), _args(rng)
    want = np.asarray(jmk.fused_uplevel_mobile(
        jnp.asarray(feat), jnp.asarray(ulo), tuple(map(jnp.asarray, sa)),
        tuple(map(jnp.asarray, ma)), interpret=True))
    got = tmk.fused_uplevel_mobile(torch.from_numpy(feat),
                                   torch.from_numpy(ulo), _pack(sa), _pack(ma))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_pack_folds_like_prep_operands():
    """MobileParams.pack is the TPU module's _prep_operands: the 1x1
    depthwise scales folded into the pointwise weights in float32 and
    rounded once to the storage dtype, the 3x3 taps kept in float32."""
    args = _args(np.random.default_rng(80))
    w1, d2, w2, w3, b, a, c = jmk._prep_operands(
        tuple(map(jnp.asarray, args)), C, CM, jnp.bfloat16)
    p = _pack(args, torch.bfloat16)
    for got, want in ((p.w1, w1), (p.w2, w2), (p.w3, w3)):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))
    assert p.d2.dtype == torch.float32
    np.testing.assert_array_equal(p.d2.numpy(), np.asarray(d2))
    stages = [s.numpy() for s in p.stages()]
    for i, tab in enumerate((b, a, c)):
        tab = np.asarray(tab)
        for stage in range(3):
            n = C if stage == 2 else CM
            np.testing.assert_array_equal(stages[3 * stage + i],
                                          tab[stage, :n])


def test_cpu_tensors_leave_mobile_counters_at_zero():
    tcuda.reset_launch_counts()
    rng = np.random.default_rng(81)
    p = _pack(_args(rng))
    x8 = torch.from_numpy(_x(rng, 1, 8))
    tmk.fused_bottleneck_mobile(x8, p)
    tmk.fused_bottleneck_mobile_pool(x8, p)
    tmk.fused_uplevel_mobile(x8, torch.from_numpy(_x(rng, 1, 4)), p, p)
    assert tcuda.launch_counts() == dict.fromkeys(tcuda.KERNEL_WRAPPERS, 0)


@pytest.mark.parametrize("c,cm", [(32, 8), (24, 12), (2048, 1024)])
def test_mobile_rejects_unsupported_channels(c, cm):
    """Only Cm = C/2 with C a multiple of 16 up to 1024 is accepted, so the
    kernel never runs with channel groups its threads do not cover."""
    z = torch.zeros
    p = tmk.MobileParams.pack(z(c), z(c, cm), z(cm), z(3, 3, cm), z(cm, cm),
                              z(cm), z(cm), z(cm, c), z(c),
                              *[torch.ones(n) for n in (cm, cm, cm, cm, c, c)],
                              dtype=torch.float32)
    with pytest.raises(ValueError, match="Cm = C/2"):
        tmk.fused_bottleneck_mobile(torch.zeros(1, 2, 2, c), p)


def test_mobile_rejects_misshapen_operands():
    """Every operand passed to the kernel as a pointer has the shape,
    layout and dtype the kernel reads."""
    p = _pack(_args(np.random.default_rng(83)))
    x = torch.zeros(1, 4, 4, C)
    bad = [dict(w2=p.w2[:, :-1]), dict(w3=p.w3.t().contiguous().t()),
           dict(d2=p.d2[:8]), dict(vec=p.vec[:-1])]
    for kw in bad:
        q = tmk.MobileParams(**{**p.__dict__, **kw})
        with pytest.raises(ValueError, match="contiguous"):
            tmk.fused_bottleneck_mobile(x, q)
    q = tmk.MobileParams(**{**p.__dict__, "d2": p.d2.double()})
    with pytest.raises(TypeError, match="float32"):
        tmk.fused_bottleneck_mobile(x, q)


def test_mobile_kernel_off_the_cpu_without_a_card_raises():
    """No silent plain fallback: a tensor that is not on the CPU takes the
    kernel path, which raises on a host without a card."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the kernels run in "
                    "test_torch_cuda_kernels.py")
    tcuda.reset_launch_counts()
    rng = np.random.default_rng(82)
    p = _pack(_args(rng))
    meta = tmk.MobileParams(*(t.to("meta") for t in (p.w1, p.d2, p.w2, p.w3,
                                                      p.vec)))
    x = torch.from_numpy(_x(rng, 1, 8))
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        tmk.fused_bottleneck_mobile(x.to("meta"), meta)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        tmk.fused_uplevel_mobile(x.to("meta"),
                                 torch.zeros(1, 4, 4, C, device="meta"),
                                 meta, meta)
    assert tcuda.launch_counts() == dict.fromkeys(tcuda.KERNEL_WRAPPERS, 0)
