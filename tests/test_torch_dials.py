"""The fused front and fused subtree dials and the row-blocked bottleneck:
the plain PyTorch versions of #5 (`fused_bottleneck_rows`), #6
(`fused_bottleneck_convskip`) and #7 (`fused_subtree`) against the JAX
Pallas kernels they port, run in interpret mode on the CPU, and the port's
`fused_apply` with `fuse_front` and `fuse_bottom` against the JAX
package's, on the same variables and inputs.

float32: atol 1e-5 for the kernels, 1e-4 for `fused_apply` (as
tests/test_torch_fused_inference.py). bfloat16: the rounding points
matter. #6 adds skip + t3 and #7 adds dshort + up in the STORAGE dtype,
each operand rounded first; an add in float32 passes every float32 check.
On these inputs the plain versions equal the Pallas kernels in every
element at bf16 but one (share 1.0 for #5 and #7, 0.99994 for #6 at
16 px, where one element lies one ulp apart: the float32 sums differ in
order). The test asks for a share of at least BF16_EQUAL_SHARE and every
element within one bf16 ulp; a negative control that adds in float32
instead leaves 0.84-0.86 of #6's elements and 0.70-0.86 of #7's equal
(measured on these inputs), and must miss that share.

The kernels themselves run only on a card (`chip_smoke.py` and
`test_torch_cuda_kernels.py`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from single_person_pose_estimation_tpu.models.fused_inference import (
    fused_apply as jax_fused_apply,
)
from single_person_pose_estimation_tpu.ops.pallas import (
    bottleneck_kernel as jbk,
    bottom_kernel as jbt,
)
from single_person_pose_estimation_tpu_torch.models.fused_inference import (
    fused_apply,
    prepare_fused,
)
from single_person_pose_estimation_tpu_torch.ops import cuda as tcuda
from single_person_pose_estimation_tpu_torch.ops.cuda import (
    bottleneck_kernel as tbk,
    bottom_kernel as tbt,
)
from torch_port_fixtures import images, random_variables, torch_model

C, CM = 32, 16
ATOL = 1e-5
BF16_EQUAL_SHARE = 0.99
BF16_ULP = 2.0 ** -7           # one bf16 ulp at |v| in [1, 2)
MAIN_FLAGS = dict(fuse_levels=True, pool_fuse_max_h=32, fuse_heads=True)
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _bneck_args(rng, cin=C, c=C):
    """w1, b1, w2, b2, w3, b3, a1, c1, a2, c2, a3, c3 as float32 numpy.
    Positive b1 and c1 make t1 at a zero x nonzero, so a kernel that pads x
    instead of t1 at the image border would show."""
    cm = c // 2
    u = lambda lo, hi, *s: rng.uniform(lo, hi, s).astype(np.float32)
    return [u(-.2, .2, cin, cm), u(.1, .3, cm), u(-.2, .2, 3, 3, cm, cm),
            u(-.1, .1, cm), u(-.2, .2, cm, c), u(-.1, .1, c),
            u(.5, 1.5, cm), u(.1, .4, cm), u(.5, 1.5, cm), u(-.3, .3, cm),
            u(.5, 1.5, c), u(-.3, .3, c)]


def _x(rng, b, h, c=C):
    return rng.uniform(-1, 1, (b, h, h, c)).astype(np.float32)


def _hold(got, want, dtype, control=None):
    """float32: within ATOL. bfloat16: at least BF16_EQUAL_SHARE of the
    elements bit-equal and all within one ulp; `control` (the same
    function with a float32 add) must miss the share."""
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=ATOL)
        return
    share = float((got == want).mean())
    assert share >= BF16_EQUAL_SHARE, share
    assert (np.abs(got - want)
            <= BF16_ULP * np.maximum(1.0, np.abs(want))).all()
    if control is not None:
        c_share = float((control.float().numpy() == want).mean())
        assert c_share < BF16_EQUAL_SHARE, c_share


# ---------------------------------------------------------------------------
# #6: fused_bottleneck_convskip at 16 -> 32 channels, Cm 16.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h", [16, 4, 1])
def test_convskip_plain_matches_pallas(h, dtype):
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(50 + h)
    x = _x(rng, 2, h, C // 2)
    ws = rng.uniform(-.3, .3, (C // 2, C)).astype(np.float32)
    bs = rng.uniform(-.1, .1, C).astype(np.float32)
    args = _bneck_args(rng, C // 2, C)
    want = jbk.fused_bottleneck_convskip(
        jnp.asarray(x, jdt), jnp.asarray(ws), jnp.asarray(bs),
        *map(jnp.asarray, args), interpret=True).astype(jnp.float32)
    p = tbk.ConvSkipParams.pack(*map(torch.from_numpy, [ws, bs, *args]),
                                dtype=tdt)
    xt = torch.from_numpy(x).to(tdt)
    got = tbk.fused_bottleneck_convskip(xt, p)
    assert got.dtype == tdt and got.shape == (2, h, h, C)
    # The negative control: skip + t3 added in float32, rounded once.
    skip = torch.relu(xt.float() @ p.ws.float() + p.bs)
    control = (skip + tbk._bneck_t3(xt, p)[1]).to(tdt)
    _hold(got, want, dtype, control)


# ---------------------------------------------------------------------------
# #7: fused_subtree on the smallest inputs each depth's walk allows.
# ---------------------------------------------------------------------------

def _flax_bottleneck(rng, name, params, stats):
    """One identity-skip bottleneck's flax variables (C -> C, Cm = C/2),
    with positive b1 and BN shift on t1 (see _bneck_args)."""
    u = lambda lo, hi, *s: rng.uniform(lo, hi, s).astype(np.float32)
    params[name + "_conv_1x1_1"] = {"kernel": u(-.2, .2, 1, 1, C, CM),
                                    "bias": u(.1, .3, CM)}
    params[name + "_conv_3x3_2"] = {"kernel": u(-.2, .2, 3, 3, CM, CM),
                                    "bias": u(-.1, .1, CM)}
    params[name + "_conv_1x1_3"] = {"kernel": u(-.2, .2, 1, 1, CM, C),
                                    "bias": u(-.1, .1, C)}
    for bn, n, lo in (("_conv_1x1_1_bn", CM, .1), ("_conv_3x3_2_bn", CM, -.3),
                      ("_conv_1x1_3_bn", C, -.3)):
        params[name + bn] = {"scale": u(.5, 1.5, n), "bias": u(lo, .4, n)}
        stats[name + bn] = {"mean": u(-.3, 0, n), "var": u(.5, 1.5, n)}


def _port_bottleneck(params, stats, name, dtype):
    def aff(bn):
        return tbk.bn_affine(*(torch.from_numpy(d[name + bn][k])
                               for d, k in ((params, "scale"),
                                            (params, "bias"),
                                            (stats, "mean"), (stats, "var"))))

    def get(layer, leaf):
        return torch.from_numpy(params[name + layer][leaf])

    return tbk.BottleneckParams.pack(
        get("_conv_1x1_1", "kernel")[0, 0], get("_conv_1x1_1", "bias"),
        get("_conv_3x3_2", "kernel"), get("_conv_3x3_2", "bias"),
        get("_conv_1x1_3", "kernel")[0, 0], get("_conv_1x1_3", "bias"),
        *aff("_conv_1x1_1_bn"), *aff("_conv_3x3_2_bn"),
        *aff("_conv_1x1_3_bn"), dtype=dtype)


def _subtree_f32_add(x, sp, depth):
    """The walk with dshort + up added in float32 (dshort unrounded): the
    negative control of the storage-dtype add."""
    def upadd(f, inner, p):
        ff, t3 = tbk._bneck_t3(f, p)
        return (ff + t3 + tbk.upsample2x(inner).float()).to(f.dtype)

    return tbt.subtree_walk(x, sp, depth, tbk.fused_bottleneck_plain, upadd)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_subtree_plain_matches_pallas(depth, dtype):
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(60 + depth)
    params, stats = {}, {}
    for s in tbt.bneck_order(depth):
        _flax_bottleneck(rng, "hg1_" + s, params, stats)
    h = 1 << depth                   # the walk's bottom level is 1 px
    x = _x(rng, 2, h)
    want = jbt.fused_subtree(
        jnp.asarray(x, jdt), *jbt.pack_subtree_params(
            params, stats, "hg1", jbk.bn_affine, depth),
        depth=depth, interpret=True).astype(jnp.float32)
    bnecks = {"hg1_" + s: _port_bottleneck(params, stats, "hg1_" + s, tdt)
              for s in tbt.bneck_order(depth)}
    sp = tbt.SubtreeParams.pack(bnecks, "hg1", depth)
    assert sp.w1s.shape == (3 * depth + 3, C, CM)
    assert sp.vecs.shape == (3 * depth + 3, 6 * CM + 3 * C)
    xt = torch.from_numpy(x).to(tdt)
    got = (tbt.fused_bottom(xt, sp) if depth == 1
           else tbt.fused_subtree(xt, sp, depth))
    _hold(got, want, dtype, _subtree_f32_add(xt, sp, depth))


@pytest.mark.parametrize("depth", [0, 1, 2, 3, 4])
def test_bneck_order_matches_jax(depth):
    assert tbt.bneck_order(depth) == jbt.bneck_order(depth)
    assert len(tbt.bneck_order(depth)) == 3 * depth + 3


def test_subtree_rejects_what_the_walk_cannot_run():
    rng = np.random.default_rng(70)
    p = tbk.BottleneckParams.pack(*map(torch.from_numpy, _bneck_args(rng)),
                                  dtype=torch.float32)
    sp = tbt.SubtreeParams(*(torch.stack([getattr(p, k)] * 6)
                             for k in ("w1", "w2", "w3", "vec")))
    x = torch.from_numpy(_x(rng, 1, 4))
    with pytest.raises(ValueError, match="depth must be"):
        tbt.bneck_order(5)
    with pytest.raises(ValueError, match="weight sets"):
        tbt.fused_subtree(x, sp, 2)
    with pytest.raises(ValueError, match="divides by 2"):
        tbt.fused_subtree(torch.from_numpy(_x(rng, 1, 3)), sp, 1)


# ---------------------------------------------------------------------------
# #5: fused_bottleneck_rows at H=16.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hb", [4, 8, 16])
def test_rows_plain_matches_pallas(hb, dtype):
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(80 + hb)
    x, args = _x(rng, 2, 16), _bneck_args(rng)
    want = jbk.fused_bottleneck_rows(jnp.asarray(x, jdt),
                                     *map(jnp.asarray, args), interpret=True,
                                     hb=hb).astype(jnp.float32)
    p = tbk.BottleneckParams.pack(*map(torch.from_numpy, args), dtype=tdt)
    got = tbk.fused_bottleneck_rows(torch.from_numpy(x).to(tdt), p, hb=hb)
    _hold(got, want, dtype)


def test_rows_rejects_a_strip_that_does_not_divide_h():
    rng = np.random.default_rng(90)
    p = tbk.BottleneckParams.pack(*map(torch.from_numpy, _bneck_args(rng)),
                                  dtype=torch.float32)
    x = torch.from_numpy(_x(rng, 1, 12))
    with pytest.raises(ValueError, match="must divide"):
        tbk.fused_bottleneck_rows(x, p, hb=8)
    assert tbk.fused_bottleneck_rows(x, p, hb=64).shape == x.shape  # HB = H
    assert tbk.fused_bottleneck_rows(x, p, hb=6).shape == x.shape


# ---------------------------------------------------------------------------
# fused_apply with the dials against the JAX package's.
# ---------------------------------------------------------------------------

# (flags, stacks): S1 keeps JAX's interpret-mode tracing short; the S2
# cases also run the second stack's subtree weights and the inter-stack
# feedback.
DIALS = {"front": (dict(fuse_front=True), 1),
         "bottom1": (dict(fuse_bottom=1), 1),
         "bottom2": (dict(fuse_bottom=2), 1),
         "bottom3": (dict(fuse_bottom=3), 2),
         "front_bottom3": (dict(fuse_front=True, fuse_bottom=3), 2)}


@pytest.fixture(scope="module")
def dial_case():
    """S1 and S2 at C32 (front_bottleneck_2 at 16 channels, the smallest
    the kernels take) on 64 px crops; JAX outputs computed once per
    dial."""
    v = {s: random_variables(s, C, seed=3) for s in (1, 2)}
    x = images(2, seed=4)
    fps = {s: prepare_fused(torch_model(v[s], s, C)) for s in (1, 2)}
    cache = {}

    def want(dial):
        flags, stacks = DIALS[dial]
        if dial not in cache:
            cache[dial] = [np.asarray(o) for o in jax_fused_apply(
                v[stacks], jnp.asarray(x), num_stacks=stacks,
                compute_dtype=jnp.float32, interpret=True, **MAIN_FLAGS,
                **flags)]
        return cache[dial]

    return x, fps, want


@pytest.mark.parametrize("dial", DIALS)
def test_fused_apply_dials_match_jax_f32(dial_case, dial):
    x, fps, want = dial_case
    flags, stacks = DIALS[dial]
    fp = fps[stacks]
    got = fused_apply(fp, torch.from_numpy(x), **MAIN_FLAGS, **flags)
    assert len(got) == stacks
    for s in range(stacks):
        assert got[s].dtype == torch.float32
        np.testing.assert_allclose(got[s].numpy(), want(dial)[s], atol=1e-4,
                                   err_msg=f"{dial} stack {s}")
    if flags.get("fuse_bottom"):
        assert (stacks - 1, flags["fuse_bottom"]) in fp.subtrees


def test_cpu_tensors_leave_launch_counters_at_zero(dial_case):
    x, fps, _ = dial_case
    fp = fps[2]
    tcuda.reset_launch_counts()
    fused_apply(fp, torch.from_numpy(x), **MAIN_FLAGS, fuse_front=True,
                fuse_bottom=2)
    rng = np.random.default_rng(91)
    p = tbk.BottleneckParams.pack(*map(torch.from_numpy, _bneck_args(rng)),
                                  dtype=torch.float32)
    tbk.fused_bottleneck_rows(torch.from_numpy(_x(rng, 1, 8)), p, hb=4)
    assert tcuda.launch_counts() == dict.fromkeys(tcuda.KERNEL_WRAPPERS, 0)
    with pytest.raises(ValueError, match="fuse_bottom"):
        fused_apply(fp, torch.from_numpy(x), fuse_bottom=5)
