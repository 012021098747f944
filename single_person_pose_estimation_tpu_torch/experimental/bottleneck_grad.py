"""Training-mode hourglass bottleneck with a hand-derived backward pass.

The counterpart of the JAX package's `experimental/bottleneck_grad.py`.
Forward (identity skip, train-mode BN with flax's semantics: float32
stats, variance E[x^2]-E[x]^2 clamped at 0, normalize in float32, cast to
the compute dtype):

    y1 = x @ W1 + b1;  a1 = relu(y1);  z1 = gamma1*(a1-mu1)*s1 + beta1
    y2 = conv3x3(z1, W2) + b2;  a2 = relu(y2);  z2 = BN2(a2)
    y3 = z2 @ W3 + b3;  a3 = relu(y3);  z3 = BN3(a3)
    out = x + z3                                   (s_i = rsqrt(var_i + eps))

Backward per unit, given dz, n = B*H*W: dbeta = sum(dz), dgamma =
sum(dz*xhat), da = gamma*s*(dz - dbeta/n - xhat*dgamma/n), dy = da*(y>0),
dW = in^T dy, db = sum(dy), din = dy W^T; dx = g + din1. The residuals are
the post-ReLU activations (x, a1, a2, a3): the ReLU mask and xhat derive
from them.

`make_bottleneck_train(backend)` wraps a forward and a backward in a
`torch.autograd.Function`. The backends, with the JAX package's names:

    port        JAX            forward   backward
    "plain"     "jnp"          plain     plain
    "cuda"      "pallas"       kernels   kernels
    "cuda_fwd"  "pallas_fwd"   kernels   plain
    "cuda_bwd"  "pallas_bwd"   plain     kernels

The plain forward computes each conv in the compute dtype with the bias
added in that dtype, as flax does; the plain backward leaves the 3x3
grads to one library conv-grad call, as the JAX package leaves them to
XLA's conv-grad emitters. The kernel wiring (`*_cuda`) runs the six
kernels of `ops/cuda/bottleneck_train_kernel.py`; on CPU tensors those
wrappers run their plain versions. Layout is NHWC; weights (C, Cm),
(3, 3, Cm, Cm), (Cm, C).

Under tensor parallelism (`tp`, parallel/sharding_rules.py) each unit's
weight holds this rank's output channels: (C, Cm/m), (3, 3, Cm, Cm/m),
(Cm, C/m), with the BN leaves of those channels. Each unit computes its
channels from the whole input, its BN normalizes them, and the channels
are gathered before the next unit; in the backward each unit's input
gradient is this rank's share and is summed over the model group. The
kernel wiring gathers the post-ReLU activation with the BN folded as an
affine, which the next unit's prologue applies, and keeps the kernels'
contracts: unit1x1_bwd runs without its next-unit sums (they would sum a
share) and bn_bwd_reduce takes them once the share is summed; unit3x3_bwd
takes input and output channels of one width, so it runs on the unit's
weight gathered over the model group (every output channel, redundantly
on each rank) and each rank keeps its channels of dW and db.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import Tuple

import torch
import torch.nn.functional as F

from single_person_pose_estimation_tpu_torch.models.hourglass import (
    global_moments,
)
from single_person_pose_estimation_tpu_torch.ops.cuda import (
    bottleneck_train_kernel as ker,
)
from single_person_pose_estimation_tpu_torch.parallel.distributed import (
    all_reduce_sum,
)

_BN_EPS = 1e-3
BACKENDS = ("plain", "cuda", "cuda_fwd", "cuda_bwd")


# ---------------------------------------------------------------------------
# Forward pieces (plain; flax semantics).
# ---------------------------------------------------------------------------

def _bn_stats(a: torch.Tensor, group=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Float32 batch mean and variance E[a^2]-E[a]^2, clamped at 0 (over
    every rank's rows with a group)."""
    a32 = a.float()
    if group is not None:
        return global_moments(a32, (0, 1, 2), group)
    mu = a32.mean(dim=(0, 1, 2))
    mu2 = (a32 * a32).mean(dim=(0, 1, 2))
    return mu, torch.clamp(mu2 - mu * mu, min=0.0)


def _bn_apply(a, mu, var, gamma, beta, out_dtype):
    s = torch.rsqrt(var + _BN_EPS)
    return ((a.float() - mu) * (s * gamma) + beta).to(out_dtype)


def _conv1x1(x, w, b):
    return x @ w.to(x.dtype) + b.to(x.dtype)


def _conv3x3(x, w, b):
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype).permute(3, 2, 0, 1),
                 padding=1).permute(0, 2, 3, 1)
    return y + b.to(x.dtype)


def _tp_ops(tp):
    """(gather, local, total) over the last (channel) dim of the model
    group: every rank's channels side by side, this rank's channels (a
    contiguous copy), the sum of every rank's share; the identity
    without tensor parallelism."""
    if tp is None:
        same = lambda t: t
        return same, same, same
    return (lambda t: tp.gather_(t, -1),
            lambda t: tp.local(t, -1).contiguous(),
            lambda t: tp.sum_(t.contiguous()))


def bottleneck_train_fwd(x, w1, b1, w2, b2, w3, b3,
                         g1, be1, g2, be2, g3, be3, group=None, tp=None):
    """Returns (out, (mu1, var1, mu2, var2, mu3, var3), (x, a1, a2, a3));
    under tensor parallelism the statistics and a1..a3 are this rank's
    channels."""
    dt = x.dtype
    gather = _tp_ops(tp)[0]
    a1 = torch.relu(_conv1x1(x, w1, b1))
    mu1, var1 = _bn_stats(a1, group)
    z1 = gather(_bn_apply(a1, mu1, var1, g1, be1, dt))
    a2 = torch.relu(_conv3x3(z1, w2, b2))
    mu2, var2 = _bn_stats(a2, group)
    z2 = gather(_bn_apply(a2, mu2, var2, g2, be2, dt))
    a3 = torch.relu(_conv1x1(z2, w3, b3))
    mu3, var3 = _bn_stats(a3, group)
    z3 = gather(_bn_apply(a3, mu3, var3, g3, be3, dt))
    return x + z3, (mu1, var1, mu2, var2, mu3, var3), (x, a1, a2, a3)


def _stats_from_sums(sums, n):
    """(2, C) float32 [sum, sum of squares] -> (mu, var)."""
    mu = sums[0] / n
    return mu, torch.clamp(sums[1] / n - mu * mu, min=0.0)


def _global_sums(sums, n, group):
    """(sums, n) over every rank of `group`: one all_reduce of the
    float32 sums with the row count; as they are without a group."""
    if group is None:
        return sums, n
    tot = all_reduce_sum(torch.cat([sums.reshape(-1),
                                    sums.new_full((1,), n)]), group)
    return tot[:-1].view_as(sums), tot[-1]


def _fold_affine(mu, var, gamma, beta):
    """Train-mode BN as a per-channel affine: bn(a) = a*scale + shift."""
    scale = torch.rsqrt(var + _BN_EPS) * gamma
    return scale, beta - mu * scale


def bottleneck_train_fwd_cuda(x, w1, b1, w2, b2, w3, b3,
                              g1, be1, g2, be2, g3, be3, group=None,
                              tp=None):
    """The contract of bottleneck_train_fwd, each conv->relu unit one
    kernel with the previous BN folded into its prologue and its batch
    sums in its epilogue. With a group, each unit's sums are all-reduced
    between the kernel that makes them and the one that folds them. Under
    tensor parallelism a1 and a2, the next units' inputs, are gathered
    with their folded BN (so the residuals hold every channel of them)."""
    B, H, W, _ = x.shape
    n = B * H * W
    gather = _tp_ops(tp)[0]
    a1, sums1 = ker.conv1x1_relu_stats(x, w1, b1)
    mu1, var1 = _stats_from_sums(*_global_sums(sums1, n, group))
    a1, aff1 = gather(a1), gather(torch.stack(_fold_affine(mu1, var1, g1,
                                                           be1)))
    a2, sums2 = ker.conv3x3_relu_stats(a1, w2, b2, aff1[0], aff1[1])
    mu2, var2 = _stats_from_sums(*_global_sums(sums2, n, group))
    a2, aff2 = gather(a2), gather(torch.stack(_fold_affine(mu2, var2, g2,
                                                           be2)))
    a3, sums3 = ker.conv1x1_relu_stats(a2, w3, b3, aff2[0], aff2[1])
    mu3, var3 = _stats_from_sums(*_global_sums(sums3, n, group))
    sc3, sh3 = _fold_affine(mu3, var3, g3, be3)
    out = x + gather((a3.float() * sc3 + sh3).to(x.dtype))
    return out, (mu1, var1, mu2, var2, mu3, var3), (x, a1, a2, a3)


# ---------------------------------------------------------------------------
# Backward (plain).
# ---------------------------------------------------------------------------

def _unit_bwd(dz, a, mu, var, gamma, group=None):
    """(dy, dgamma, dbeta) of one conv->relu->BN unit from its saved
    post-ReLU activation a; dy in a's dtype. With a group, dy takes the
    sums over every rank and dgamma/dbeta stay this rank's (see
    _unit_consts)."""
    n = dz.shape[0] * dz.shape[1] * dz.shape[2]
    s = torch.rsqrt(var + _BN_EPS)
    xhat = (a.float() - mu) * s
    dz32 = dz.float()
    dbeta = dz32.sum(dim=(0, 1, 2))
    dgamma = (dz32 * xhat).sum(dim=(0, 1, 2))
    sums, n = _global_sums(torch.stack([dbeta, dgamma]), n, group)
    da = (gamma * s) * (dz32 - sums[0] / n - xhat * (sums[1] / n))
    return torch.where(a > 0, da, 0.0).to(a.dtype), dgamma, dbeta


def _conv1x1_grads(x, dy, w, out_dtype):
    """dW = x^T dy over the rows (float32 products of the compute-dtype
    operands) and din = dy W^T (float32 sums rounded once)."""
    xf = x.reshape(-1, x.shape[-1])
    dyf = dy.reshape(-1, dy.shape[-1]).to(x.dtype)
    dw = xf.float().T @ dyf.float()
    db = dyf.float().sum(0)
    din = dyf @ w.to(x.dtype).T
    return dw, db, din.reshape(*x.shape[:3], -1).to(out_dtype)


def _conv3x3_grads(x, dy, w, out_dtype):
    """The 3x3 SAME conv's grads by one library conv-grad call."""
    dyc = dy.to(x.dtype).permute(0, 3, 1, 2)
    din, dw, _ = torch.ops.aten.convolution_backward(
        dyc, x.permute(0, 3, 1, 2), w.to(x.dtype).permute(3, 2, 0, 1),
        None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1, [True, True, False])
    db = dy.reshape(-1, dy.shape[-1]).float().sum(0)
    return (dw.permute(2, 3, 1, 0).float(), db,
            din.permute(0, 2, 3, 1).to(out_dtype))


def bottleneck_train_bwd(res, g, group=None, tp=None):
    """Grads of the 13 inputs (x, w1, b1, w2, b2, w3, b3, g1, be1, g2, be2,
    g3, be3) from the residuals and the output cotangent g."""
    (x, a1, a2, a3, mu1, var1, mu2, var2, mu3, var3,
     w1, w2, w3, g1, be1, g2, be2, g3, be3) = res
    dt = x.dtype
    gather, local, total = _tp_ops(tp)
    dy3, dg3, dbe3 = _unit_bwd(local(g), a3, mu3, var3, g3, group)
    z2 = gather(_bn_apply(a2, mu2, var2, g2, be2, dt))
    dw3, db3, dz2 = _conv1x1_grads(z2, dy3, w3, dt)
    dy2, dg2, dbe2 = _unit_bwd(local(total(dz2)), a2, mu2, var2, g2, group)
    z1 = gather(_bn_apply(a1, mu1, var1, g1, be1, dt))
    dw2, db2, dz1 = _conv3x3_grads(z1, dy2, w2, dt)
    dy1, dg1, dbe1 = _unit_bwd(local(total(dz1)), a1, mu1, var1, g1, group)
    dw1, db1, din = _conv1x1_grads(x, dy1, w1, dt)
    dx = (g.float() + total(din).float()).to(dt)
    return (dx, dw1, db1, dw2, db2, dw3, db3,
            dg1, dbe1, dg2, dbe2, dg3, dbe3)


def _bwd_consts(r0, r1, mu, var, gamma, n):
    """(K1, K2, K3) rows of da = K1*dz + K2*a + K3, and (dgamma, dbeta),
    from the reductions r0 = sum(dz), r1 = sum(dz*a)."""
    s = torch.rsqrt(var + _BN_EPS)
    dbeta = r0
    dgamma = s * (r1 - mu * r0)
    k1 = gamma * s
    k2 = -gamma * s * s * dgamma / n
    k3 = -k1 * dbeta / n + gamma * s * s * mu * dgamma / n
    return torch.stack([k1, k2, k3]), dgamma, dbeta


def _unit_consts(sums, mu, var, gamma, n, group):
    """_bwd_consts of one unit from this rank's (2, C) reductions. With a
    group the input gradient's constants K take the sums over every rank,
    but dgamma/dbeta stay this rank's share: the step's flat all-reduce
    of the gradients sums the shares, where global sums here would give
    each rank the whole sum and the mean over ranks W times the true
    gradient (nn.SyncBatchNorm splits its backward the same way)."""
    k, dgamma, dbeta = _bwd_consts(sums[0], sums[1], mu, var, gamma, n)
    if group is not None:
        gsums, gn = _global_sums(sums, n, group)
        k = _bwd_consts(gsums[0], gsums[1], mu, var, gamma, gn)[0]
    return k, dgamma, dbeta


def bottleneck_train_bwd_cuda(res, g, group=None, tp=None):
    """The contract of bottleneck_train_bwd on the kernels: one reduction
    and three unit backwards, each folding the next unit's reductions into
    its epilogue; with a group, each unit's reductions are all-reduced
    between the kernel that makes them and the one that uses them. Under
    tensor parallelism (module docstring) a1 and a2 hold every channel;
    unit 3's input gradient is summed over the model group before
    bn_bwd_reduce takes unit 2's reductions, unit 2 runs on its gathered
    weight, and unit 1's input gradient, with the skip's g counted on one
    rank, is summed over the model group."""
    (x, a1, a2, a3, mu1, var1, mu2, var2, mu3, var3,
     w1, w2, w3, g1, be1, g2, be2, g3, be3) = res
    B, H, W, _ = x.shape
    n = B * H * W
    gather, local, total = _tp_ops(tp)
    gl = local(g)
    sums3 = ker.bn_bwd_reduce(gl, a3)
    k3c, dg3, dbe3 = _unit_consts(sums3, mu3, var3, g3, n, group)
    aff2 = gather(torch.stack(_fold_affine(mu2, var2, g2, be2)))
    dz2, dw3, db3, sums2 = ker.unit1x1_bwd(gl, a3, a2, w3, k3c, aff2,
                                           reduce_next=tp is None)
    if tp is not None:
        dz2 = total(dz2)
        sums2 = ker.bn_bwd_reduce(local(dz2), local(a2))
    k2c, dg2, dbe2 = _unit_consts(sums2, mu2, var2, g2, n, group)
    aff1 = gather(torch.stack(_fold_affine(mu1, var1, g1, be1)))
    dz1, dw2, db2, sums1 = ker.unit3x3_bwd(dz2, a2, a1, gather(w2.to(x.dtype)),
                                           gather(k2c), aff1)
    dw2, db2, sums1 = local(dw2), local(db2), local(sums1)
    k1c, dg1, dbe1 = _unit_consts(sums1, mu1, var1, g1, n, group)
    dx, dw1, db1 = ker.unit1_bwd(local(dz1), local(a1), x,
                                 g if tp is None else tp.on_first(g), w1, k1c)
    return (total(dx), dw1, db1[0], dw2, db2[0], dw3, db3[0],
            dg1, dbe1, dg2, dbe2, dg3, dbe3)


# ---------------------------------------------------------------------------
# The autograd wiring.
# ---------------------------------------------------------------------------

class _BottleneckTrain(torch.autograd.Function):
    """out, mu1, var1, mu2, var2, mu3, var3 = f(fwd, bwd, x, w1, ..., be3);
    the stats carry no gradient."""

    @staticmethod
    def forward(ctx, fwd, bwd, *args):
        out, stats, residuals = fwd(*args)
        ctx.bwd = bwd
        ctx.save_for_backward(*residuals, *stats, args[1], args[3], args[5],
                              *args[7:])
        ctx.mark_non_differentiable(*stats)
        return (out, *stats)

    @staticmethod
    def backward(ctx, g, *_):
        grads = ctx.bwd(ctx.saved_tensors, g.contiguous())
        return (None, None, *grads)


def make_bottleneck_train(backend: str = "plain", group=None, tp=None):
    """The train-mode bottleneck as a differentiable function:
    f(x, w1, b1, w2, b2, w3, b3, g1, be1, g2, be2, g3, be3) -> (out,
    (mu1, var1, mu2, var2, mu3, var3)), differentiable in all 13 inputs.
    backend: "plain", "cuda", "cuda_fwd" or "cuda_bwd" (module docstring);
    unknown names raise. With a process `group` (data parallel) the BN
    statistics are those of every rank's rows together, and so are the
    reductions of the input gradient; the BN parameters' gradients are
    this rank's share. With `tp` (tensor parallel) the weights and BN
    leaves are this rank's channels (module docstring), and so are the
    statistics."""
    # A TensorParallel compares by identity: keyed on it, the cache would
    # keep every sharded state's group alive.
    if tp is None:
        return _make_bottleneck_train(backend, group)
    return _bottleneck_fn(backend, group, tp)


@lru_cache(maxsize=None)
def _make_bottleneck_train(backend: str, group):
    return _bottleneck_fn(backend, group, None)


def _bottleneck_fn(backend: str, group, tp):
    if backend not in BACKENDS:
        raise ValueError(f"unknown bottleneck backend: {backend!r}; use one "
                         f"of {BACKENDS}")
    fwd = bottleneck_train_fwd_cuda if backend in ("cuda", "cuda_fwd") \
        else bottleneck_train_fwd
    bwd = bottleneck_train_bwd_cuda if backend in ("cuda", "cuda_bwd") \
        else bottleneck_train_bwd
    if group is not None or tp is not None:
        fwd = partial(fwd, group=group, tp=tp)
        bwd = partial(bwd, group=group, tp=tp)

    def f(*args):
        out, *stats = _BottleneckTrain.apply(fwd, bwd, *args)
        return out, tuple(stats)

    return f
