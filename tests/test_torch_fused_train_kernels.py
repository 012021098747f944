"""The plain versions of the six train-unit kernels (#14a-f, the port's
`ops/cuda/bottleneck_train_kernel.py`) against the JAX package's Pallas
kernels in interpret mode, and the port's `make_bottleneck_train` against
JAX's, on the same numpy-seeded inputs at float32 on the CPU.

Tolerances: activations atol 1e-5; sums, dW and db within 1e-5 of the
largest |value| of that output (float32 sums in another order). The
bottleneck: out and stats at tests/test_bottleneck_grad.py's 1e-5, grads
at its 5e-4 (atol and rtol) for the kernel backends and 2e-4 for the
plain one.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from single_person_pose_estimation_tpu.experimental import (
    bottleneck_grad as jbg,
)
from single_person_pose_estimation_tpu.experimental import (
    bottleneck_train_kernel as jk,
)
from single_person_pose_estimation_tpu_torch.experimental import (
    bottleneck_grad as tbg,
)
from single_person_pose_estimation_tpu_torch.ops.cuda import (
    bottleneck_train_kernel as tk,
)

SHAPES = [(2, 8, 8, 32), (1, 4, 12, 16)]
ATOL_ACT = 1e-5
REL_RED = 1e-5
ORDER = ("x", "w1", "b1", "w2", "b2", "w3", "b3",
         "g1", "be1", "g2", "be2", "g3", "be3")


def _inputs(shape, seed=0):
    """Operands of every unit of one bottleneck, numpy float32."""
    B, H, W, C = shape
    cm = C // 2
    rng = np.random.default_rng(seed)
    f = lambda *s, lo=-1.0, hi=1.0: rng.uniform(lo, hi, s).astype(np.float32)
    relu = lambda c: np.maximum(f(B, H, W, c), 0)
    k = lambda c: np.stack([f(c, lo=.5, hi=1.5), f(c, lo=-.1, hi=.1),
                            f(c, lo=-.1, hi=.1)])
    aff = lambda c: np.stack([f(c, lo=.5, hi=1.5), f(c, lo=-.3, hi=.3)])
    return dict(
        x=f(B, H, W, C), g=f(B, H, W, C), dz1=f(B, H, W, cm),
        dz2=f(B, H, W, cm), a1=relu(cm), a2=relu(cm), a3=relu(C),
        w1=f(C, cm, lo=-.3, hi=.3), w2=f(3, 3, cm, cm, lo=-.2, hi=.2),
        w3=f(cm, C, lo=-.3, hi=.3), b1=f(cm, lo=-.1, hi=.1),
        b2=f(cm, lo=-.1, hi=.1), b3=f(C, lo=-.1, hi=.1), aff1=aff(cm),
        aff2=aff(cm), k1=k(cm), k2=k(cm), k3=k(C))


def _hold(got, want, kinds):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want) == len(kinds)
    for i, (g, w, kind) in enumerate(zip(got, want, kinds)):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, (i, g.shape, w.shape)
        atol = ATOL_ACT if kind == "act" else \
            REL_RED * max(np.abs(w).max(), 1e-30)
        np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=str(i))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("affine", [False, True])
def test_conv1x1_relu_stats_matches_pallas(shape, affine):
    p = _inputs(shape)
    if affine:          # unit 3: Cm -> C after BN2
        args = (p["a2"], p["w3"], p["b3"], p["aff2"][0], p["aff2"][1])
    else:               # unit 1: the raw skip tensor
        args = (p["x"], p["w1"], p["b1"])
    want = jk.conv1x1_relu_stats(*map(jnp.asarray, args), interpret=True)
    _hold(tk.conv1x1_relu_stats(*_t(*args)), want, ("act", "red"))


@pytest.mark.parametrize("shape", SHAPES)
def test_conv3x3_relu_stats_matches_pallas(shape):
    p = _inputs(shape, 1)
    args = (p["a1"], p["w2"], p["b2"], p["aff1"][0], p["aff1"][1])
    want = jk.conv3x3_relu_stats(*map(jnp.asarray, args), interpret=True)
    _hold(tk.conv3x3_relu_stats(*_t(*args)), want, ("act", "red"))


@pytest.mark.parametrize("shape", SHAPES)
def test_bn_bwd_reduce_matches_pallas(shape):
    p = _inputs(shape, 2)
    want = jk.bn_bwd_reduce(jnp.asarray(p["g"]), jnp.asarray(p["a3"]),
                            interpret=True)
    _hold(tk.bn_bwd_reduce(*_t(p["g"], p["a3"])), want, ("red",))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("affine_cin,reduce_next",
                         [(True, True), (True, False), (False, True)])
def test_unit1x1_bwd_matches_pallas(shape, affine_cin, reduce_next):
    p = _inputs(shape, 3)
    args = (p["g"], p["a3"], p["a2"], p["w3"], p["k3"], p["aff2"])
    kw = dict(affine_cin=affine_cin, reduce_next=reduce_next)
    want = jk.unit1x1_bwd(*map(jnp.asarray, args), interpret=True, **kw)
    _hold(tk.unit1x1_bwd(*_t(*args), **kw), want,
          ("act", "red", "red", "red"))


@pytest.mark.parametrize("shape", SHAPES)
def test_unit3x3_bwd_matches_pallas(shape):
    p = _inputs(shape, 4)
    args = (p["dz2"], p["a2"], p["a1"], p["w2"], p["k2"], p["aff1"])
    want = jk.unit3x3_bwd(*map(jnp.asarray, args), interpret=True)
    _hold(tk.unit3x3_bwd(*_t(*args)), want, ("act", "red", "red", "red"))


@pytest.mark.parametrize("shape", SHAPES)
def test_unit1_bwd_matches_pallas(shape):
    p = _inputs(shape, 5)
    args = (p["dz1"], p["a1"], p["x"], p["g"], p["w1"], p["k1"])
    want = jk.unit1_bwd(*map(jnp.asarray, args), interpret=True)
    _hold(tk.unit1_bwd(*_t(*args)), want, ("act", "red", "red"))


def _bottleneck_args(shape, seed):
    B, H, W, C = shape
    cm = C // 2
    rng = np.random.default_rng(seed)
    n = lambda *s, sc=0.1: (rng.standard_normal(s) * sc).astype(np.float32)
    args = dict(x=n(B, H, W, C, sc=.5), w1=n(C, cm), b1=n(cm),
                w2=n(3, 3, cm, cm), b2=n(cm), w3=n(cm, C), b3=n(C),
                g1=1 + n(cm), be1=n(cm), g2=1 + n(cm), be2=n(cm),
                g3=1 + n(C), be3=n(C))
    return [args[k] for k in ORDER], n(B, H, W, C, sc=1.0)


def _port_run(backend, vals, cot):
    leaves = [torch.from_numpy(v).requires_grad_() for v in vals]
    out, stats = tbg.make_bottleneck_train(backend)(*leaves)
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach(), stats, [t.grad for t in leaves]


def _jax_run(f, vals, cot):
    def loss(args):
        out, _ = f(*args)
        return jnp.sum(out * cot)

    args = [jnp.asarray(v) for v in vals]
    out, stats = jax.jit(f)(*args)
    return out, stats, jax.jit(jax.grad(loss))(args)


@pytest.fixture(scope="module")
def jax_references():
    """For each shape: JAX make_bottleneck_train("pallas", interpret=True)
    and JAX autodiff of bottleneck_train_fwd, on the same inputs."""
    refs = {}
    for shape in SHAPES:
        vals, cot = _bottleneck_args(shape, 7)
        pallas = _jax_run(jbg.make_bottleneck_train("pallas", interpret=True),
                          vals, cot)
        auto = _jax_run(lambda *a: jbg.bottleneck_train_fwd(*a)[:2], vals,
                        cot)
        refs[shape] = (vals, cot, pallas, auto)
    return refs


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("backend", ["cuda", "plain", "cuda_fwd", "cuda_bwd"])
def test_bottleneck_matches_jax(jax_references, shape, backend):
    """Out, stats and all 13 grads of the port's autograd function (every
    backend; on CPU tensors the kernel backends run the kernels' plain
    versions) against JAX's Pallas custom_vjp and JAX autodiff."""
    vals, cot, pallas, auto = jax_references[shape]
    out, stats, grads = _port_run(backend, vals, cot)
    tol = 2e-4 if backend == "plain" else 5e-4
    for ref in (pallas, auto):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref[0]),
                                   atol=1e-5, rtol=1e-5)
        for s, w in zip(stats, ref[1]):
            assert not s.requires_grad
            np.testing.assert_allclose(s.numpy(), np.asarray(w), atol=1e-5,
                                       rtol=1e-5)
        for name, g, w in zip(ORDER, grads, ref[2]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol,
                                       rtol=tol, err_msg=name)


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="unknown bottleneck backend"):
        tbg.make_bottleneck_train("pallas")


def test_kernel_wrappers_check_their_operands():
    p = _inputs((1, 4, 4, 32), 6)
    x = torch.from_numpy(p["x"])
    with pytest.raises(ValueError, match="contiguous"):
        tk.conv1x1_relu_stats(x.transpose(1, 2), torch.from_numpy(p["w1"]),
                              torch.from_numpy(p["b1"]))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tk.bn_bwd_reduce(x.double(), x.double())
    with pytest.raises(TypeError, match="disagree"):
        tk.bn_bwd_reduce(x, x[:, :2])
    with pytest.raises(ValueError, match="one shape"):
        tk.bn_bwd_reduce(x, x[..., :16].contiguous())
    with pytest.raises(ValueError, match="does not fit"):
        tk.conv1x1_relu_stats(x, torch.from_numpy(p["w3"]),
                              torch.from_numpy(p["b3"]))


def test_dw_slices_bound_the_workspace():
    """The weight-gradient split at the 64 px level of batch 64: the 3x3
    unit's partials stay within DW_WORKSPACE floats and the slices cover
    every row."""
    rows = 64 * 64 * 64
    for length in (9 * 128 * 128 + 128, 256 * 128 + 128, 128 * 256 + 256):
        slices, per = tk.dw_slices(rows, length)
        assert slices * length <= tk.DW_WORKSPACE
        assert slices * per >= rows > (slices - 1) * per and per % 32 == 0
    assert tk.dw_slices(10, 100) == (1, 32)


def test_sums_of_rounded_bf16_activations():
    """At bfloat16 the stats sum the ROUNDED activation, as the Pallas
    kernel does (its a32 is a.astype(f32) after the cast)."""
    p = _inputs((1, 4, 4, 32), 8)
    x = torch.from_numpy(p["x"]).bfloat16()
    a, sums = tk.conv1x1_relu_stats(x, torch.from_numpy(p["w1"]),
                                    torch.from_numpy(p["b1"]))
    assert a.dtype == torch.bfloat16 and sums.dtype == torch.float32
    a32 = a.float().reshape(-1, a.shape[-1])
    torch.testing.assert_close(sums, torch.stack([a32.sum(0),
                                                  (a32 * a32).sum(0)]))
    want = jk.conv1x1_relu_stats(jnp.asarray(p["x"], jnp.bfloat16),
                                 jnp.asarray(p["w1"]), jnp.asarray(p["b1"]),
                                 interpret=True)
    np.testing.assert_allclose(a.float().numpy(),
                               np.asarray(want[0], np.float32), atol=1.6e-2,
                               rtol=1.6e-2)


@pytest.mark.parametrize("affine", [False, True])
def test_conv1x1_relu_stats_bf16_matches_pallas(affine):
    """The bf16 contract that the tensor-core #14a is held to on the card:
    z = round(x*scale + shift) rounded to bf16 before the product (unit 3)
    or z = x (unit 1), a rounded after the f32 bias and ReLU, the stats
    over the rounded a; at 105 rows, which leave a ragged last row tile
    of the kernel. Against the Pallas kernel in interpret mode at bf16,
    within two bf16 ulps (1.6e-2 relative, as the test above) for a and
    REL_RED of the largest |value| for the sums of the rounded a."""
    p = _inputs((3, 5, 7, 32), 9)
    if affine:
        args = (p["a2"], p["w3"], p["b3"], p["aff2"][0], p["aff2"][1])
    else:
        args = (p["x"], p["w1"], p["b1"])
    x, *rest = args
    a, sums = tk.conv1x1_relu_stats(torch.from_numpy(x).bfloat16(),
                                    *_t(*rest))
    want = jk.conv1x1_relu_stats(jnp.asarray(x, jnp.bfloat16),
                                 *map(jnp.asarray, rest), interpret=True)
    assert a.dtype == torch.bfloat16 and sums.dtype == torch.float32
    np.testing.assert_allclose(a.float().numpy(),
                               np.asarray(want[0], np.float32), atol=1.6e-2,
                               rtol=1.6e-2)
    a32 = a.float().reshape(-1, a.shape[-1])
    torch.testing.assert_close(sums, torch.stack([a32.sum(0),
                                                  (a32 * a32).sum(0)]))
    w = np.asarray(want[1])
    np.testing.assert_allclose(sums.numpy(), w, rtol=0,
                               atol=REL_RED * np.abs(w).max())
