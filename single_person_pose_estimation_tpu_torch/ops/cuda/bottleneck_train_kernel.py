"""Train-mode bottleneck units, forward and backward, as hand-written CUDA
kernels (`model_backend="fused"`).

Replaces the six TPU kernels of
`single_person_pose_estimation_tpu/experimental/bottleneck_train_kernel.py`,
each wrapper with the JAX function's name and contract:

  conv1x1_relu_stats  a = relu((x*scale + shift) @ W + b), the affine
                      optional, plus (2, Cout) f32 [sum a, sum a^2]
  conv3x3_relu_stats  the same with a 3x3 SAME conv (zero padding of the
                      normalized input)
  bn_bwd_reduce       (2, C) f32 [sum dz, sum dz*a]
  unit1x1_bwd         dy = mask(K1*dz + K2*a + K3); din = dy @ W^T;
                      dW = cin'^T dy (cin' = cin re-normalized by `aff`);
                      db = sum dy; next sums [sum din, sum din*cin]
  unit3x3_bwd         the same for the 3x3 unit
  unit1_bwd           unit 1 and the skip: dx = g + dy @ W1^T, dW, db

The kernels are `csrc/bottleneck_train.cu`; its source note says what
bounds them on the H100 and how they are laid out. The TPU kernels carry
their sums and dW/db across a sequential grid; here every block writes
float32 partials to a workspace that the wrapper allocates with
`torch.empty`, and a second launch adds them in a fixed order, so two runs
give the same bits. Launches per call (each counted on the wrapper's
`launches`): conv1x1_relu_stats, conv3x3_relu_stats, bn_bwd_reduce 2;
unit1x1_bwd 4 (3 without reduce_next); unit3x3_bwd 4; unit1_bwd 3.
Workspace at B=64, 64 px, C=256, Cm=128: the row kernels' partials are
at most 1,024 x 2C floats (2 MB); the weight gradients are split over
row slices so that their partials stay under 32 MiB (the 3x3 unit: 56
slices of 9*128*128 + 128 floats, 33 MB).

Rounding follows the TPU kernels: the prologue z = round(x*scale + shift)
in float32; bias added in float32, then ReLU, then one rounding; the
stats sum the rounded a; dy is rounded to the compute dtype before both
products and db; din is rounded before the next sums, which read the RAW
cin; dx = round(g + round(din)).

Layout is NHWC as in the JAX package; weights (Cin, Cout) and (3, 3, Cin,
Cout). Each wrapper runs the plain PyTorch version (`*_plain`) for a
tensor on the CPU and the kernel for a CUDA tensor; there is no fallback
from one to the other.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from single_person_pose_estimation_tpu_torch.ops.cuda import build
from single_person_pose_estimation_tpu_torch.ops.cuda.bottleneck_kernel import (
    _DTYPES,
    _require_cuda,
)

MAX_PARTS = 1024          # csrc/bottleneck_train.cu kMaxParts
DW_WORKSPACE = 8 << 20    # floats of a weight gradient's partials (32 MiB)
DW_MIN_ROWS = 2048        # rows of one weight-gradient slice, at least
PRO_NONE, PRO_AFFINE, PRO_DY = 0, 1, 2
EPI_RELU_STATS, EPI_DIN, EPI_DIN_SUMS, EPI_DIN_SKIP = 0, 1, 2, 3


# ---------------------------------------------------------------------------
# Plain PyTorch versions: the same arithmetic and rounding points.
# ---------------------------------------------------------------------------

def _affine(x, scale, shift):
    return (x.float() * scale + shift).to(x.dtype)


def _dy(dz, a, k):
    """(a > 0) ? K1*dz + K2*a + K3 : 0, rounded to a's dtype."""
    a32 = a.float()
    da = k[0] * dz.float() + k[1] * a32 + k[2]
    return torch.where(a32 > 0, da, 0.0).to(a.dtype)


def _sums(u, v=None):
    """(2, C) float32 [sum u, sum u*v] (v = u: the sum of squares)."""
    u32 = u.float().reshape(-1, u.shape[-1])
    v32 = u32 if v is None else v.float().reshape(-1, v.shape[-1])
    return torch.stack([u32.sum(0), (u32 * v32).sum(0)])


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def conv1x1_relu_stats_plain(x, w, b, scale=None, shift=None):
    z = x if scale is None else _affine(x, scale, shift)
    a = torch.relu(z.float() @ w.to(x.dtype).float() + b).to(x.dtype)
    return a, _sums(a)


def conv3x3_relu_stats_plain(x, w, b, scale, shift):
    z = _affine(x, scale, shift)
    y = F.conv2d(_nchw(z.float()), w.to(x.dtype).float().permute(3, 2, 0, 1),
                 padding=1)
    a = torch.relu(_nhwc(y) + b).to(x.dtype)
    return a, _sums(a)


def bn_bwd_reduce_plain(dz, a):
    return _sums(dz, a)


def _mm_t(u, v):
    """u^T v over the flattened rows, float32: (Cu, Cv)."""
    return u.float().reshape(-1, u.shape[-1]).T @ \
        v.float().reshape(-1, v.shape[-1])


def unit1x1_bwd_plain(dz, a, cin, w, k, aff=None, affine_cin=True,
                      reduce_next=True):
    dt = a.dtype
    dy = _dy(dz, a, k)
    z = _affine(cin, aff[0], aff[1]) if affine_cin else cin
    dw = _mm_t(z, dy)
    din = (dy.float() @ w.to(dt).float().T).to(dt)
    db = dy.float().reshape(-1, dy.shape[-1]).sum(0)[None]
    sums = _sums(din, cin) if reduce_next else torch.zeros(
        2, cin.shape[-1], dtype=torch.float32, device=cin.device)
    return din, dw, db, sums


def unit3x3_bwd_plain(dz, a, cin, w, k, aff):
    dt = a.dtype
    B, H, W, C = dz.shape
    dy = _dy(dz, a, k)
    z = F.pad(_affine(cin, aff[0], aff[1]), (0, 0, 1, 1, 1, 1))
    dw = torch.stack([torch.stack([_mm_t(z[:, p:p + H, q:q + W], dy)
                                   for q in range(3)]) for p in range(3)])
    # din = sum over taps of shift(dy) @ W[2-p, 2-q]^T: a SAME conv of dy
    # with the flipped, transposed kernel.
    wt = w.to(dt).float().flip(0, 1).permute(2, 3, 0, 1)
    din = _nhwc(F.conv2d(_nchw(dy.float()), wt, padding=1)).to(dt)
    db = dy.float().reshape(-1, C).sum(0)[None]
    return din, dw, db, _sums(din, cin)


def unit1_bwd_plain(dz, a, x, g, w, k):
    dt = a.dtype
    dy = _dy(dz, a, k)
    din = (dy.float() @ w.to(dt).float().T).to(dt)
    dx = (g.float() + din.float()).to(dt)
    db = dy.float().reshape(-1, dy.shape[-1]).sum(0)[None]
    return dx, _mm_t(x, dy), db


# ---------------------------------------------------------------------------
# Kernel launch.
# ---------------------------------------------------------------------------

def _check(*acts, channels=()):
    """Contiguous NHWC activations of one float dtype and one (B, H, W), on
    one device (their channel counts may differ); for the kernels, channel counts that are multiples of 16,
    at most 1024 (the plain versions take any)."""
    x = acts[0]
    for t in acts:
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"expected contiguous NHWC tensors, got shape "
                             f"{tuple(t.shape)} contiguous="
                             f"{t.is_contiguous()}")
        if t.dtype != x.dtype or t.device != x.device \
                or t.shape[:3] != x.shape[:3]:
            raise TypeError(f"operands disagree: {tuple(t.shape)} {t.dtype} "
                            f"{t.device} vs {tuple(x.shape)} {x.dtype} "
                            f"{x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"storage dtype must be float32 or bfloat16, got "
                        f"{x.dtype}")
    for c in (*channels, *(t.shape[-1] for t in acts)):
        if x.device.type != "cpu" and (c % 16 or c > 1024):
            raise ValueError(f"channels must be a multiple of 16 (<= 1024), "
                             f"got {c}")


def _same_shape(*ts):
    if any(t.shape != ts[0].shape for t in ts):
        raise ValueError(f"expected one shape, got "
                         f"{[tuple(t.shape) for t in ts]}")


def _vec(v, n, device):
    """A float32 per-channel operand, contiguous, on the device."""
    v = torch.as_tensor(v).to(device=device, dtype=torch.float32)
    if v.numel() != n:
        raise ValueError(f"expected {n} values, got {tuple(v.shape)}")
    return v.reshape(-1).contiguous()


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _launch_unit(ks, pro, epi, x, a, pv, w, bias, aux, n):
    """One unit kernel (and its finalize when the epilogue sums); returns
    (out (B, H, W, n), sums (2, n) or None)."""
    _require_cuda(x)
    B, H, W, K = x.shape
    out = torch.empty((B, H, W, n), dtype=x.dtype, device=x.device)
    sums_needed = epi in (EPI_RELU_STATS, EPI_DIN_SUMS)
    ws = torch.empty((MAX_PARTS, 2 * n), dtype=torch.float32,
                     device=x.device) if sums_needed else None
    sums = torch.empty((2, n), dtype=torch.float32,
                       device=x.device) if sums_needed else None
    ptr = lambda t: t.data_ptr() if t is not None else None
    err = build.lib().spe_train_unit(
        int(x.dtype == torch.bfloat16), ks, pro, epi, x.data_ptr(), ptr(a),
        ptr(pv), w.data_ptr(), ptr(bias), ptr(aux), out.data_ptr(), ptr(ws),
        ptr(sums), B, H, W, K, n, _stream(x))
    build.check(err, "train unit kernel")
    return out, sums


def dw_slices(rows: int, length: int):
    """(slices, rows per slice) of a weight gradient over `rows` rows whose
    partials are `length` floats each: enough slices to fill the card,
    few enough that the partials stay within DW_WORKSPACE floats."""
    cap = max(1, DW_WORKSPACE // length)
    slices = max(1, min(-(-rows // DW_MIN_ROWS), cap))
    per = -(-rows // slices)
    per = -(-per // 32) * 32
    return -(-rows // per), per


def _launch_dw(ks, dz, a, k, cin, aff):
    """dW (ks, ks, Ci, Co) and db (1, Co), float32, of one unit."""
    B, H, W, Co = dz.shape
    Ci = cin.shape[-1]
    length = ks * ks * Ci * Co + Co
    slices, per = dw_slices(B * H * W, length)
    ws = torch.empty((slices, length), dtype=torch.float32, device=dz.device)
    out = torch.empty(length, dtype=torch.float32, device=dz.device)
    err = build.lib().spe_train_dw(
        int(dz.dtype == torch.bfloat16), ks, int(aff is not None),
        dz.data_ptr(), a.data_ptr(), k.data_ptr(), cin.data_ptr(),
        aff.data_ptr() if aff is not None else None, ws.data_ptr(),
        out.data_ptr(), B, H, W, Ci, Co, slices, per, _stream(dz))
    build.check(err, "train dW kernel")
    return (out[:-Co].view(ks, ks, Ci, Co), out[-Co:].view(1, Co))


def _weight(w, shape, dt):
    if tuple(w.shape) != shape:
        raise ValueError(f"weight must be {shape}, got {tuple(w.shape)}")
    return w.to(dt)


def conv1x1_relu_stats(x, w, b, scale=None, shift=None):
    """x (B, H, W, Cin), w (Cin, Cout) -> (a (B, H, W, Cout), sums (2, Cout)
    float32). scale/shift: the previous BN folded per input channel (None
    for the bottleneck's first unit). 2 launches."""
    Cin, Cout = w.shape
    _check(x, channels=(Cout,))
    if x.shape[-1] != Cin:
        raise ValueError(f"x {tuple(x.shape)} does not fit w {tuple(w.shape)}")
    if x.device.type == "cpu":
        return conv1x1_relu_stats_plain(x, w, b, scale, shift)
    pv = None if scale is None else torch.cat(
        [_vec(scale, Cin, x.device), _vec(shift, Cin, x.device)])
    a, sums = _launch_unit(1, PRO_NONE if pv is None else PRO_AFFINE,
                           EPI_RELU_STATS, x, None, pv,
                           w.to(x.dtype).contiguous(),
                           _vec(b, Cout, x.device), None, Cout)
    conv1x1_relu_stats.launches += 2
    return a, sums


def conv3x3_relu_stats(x, w, b, scale, shift):
    """x (B, H, W, Cin), w (3, 3, Cin, Cout) -> (a, sums (2, Cout) float32).
    2 launches."""
    Cin, Cout = w.shape[2:]
    _check(x, channels=(Cout,))
    if x.device.type == "cpu":
        return conv3x3_relu_stats_plain(x, w, b, scale, shift)
    w = _weight(w, (3, 3, x.shape[-1], Cout), x.dtype).contiguous()
    pv = torch.cat([_vec(scale, Cin, x.device), _vec(shift, Cin, x.device)])
    a, sums = _launch_unit(3, PRO_AFFINE, EPI_RELU_STATS, x, None, pv, w,
                           _vec(b, Cout, x.device), None, Cout)
    conv3x3_relu_stats.launches += 2
    return a, sums


def bn_bwd_reduce(dz, a):
    """(2, C) float32 [sum dz, sum dz*a] over batch and space. 2 launches."""
    _check(dz, a)
    _same_shape(dz, a)
    if dz.device.type == "cpu":
        return bn_bwd_reduce_plain(dz, a)
    _require_cuda(dz)
    B, H, W, C = dz.shape
    ws = torch.empty((MAX_PARTS, 2 * C), dtype=torch.float32,
                     device=dz.device)
    sums = torch.empty((2, C), dtype=torch.float32, device=dz.device)
    err = build.lib().spe_train_reduce(
        int(dz.dtype == torch.bfloat16), dz.data_ptr(), a.data_ptr(),
        ws.data_ptr(), sums.data_ptr(), B * H * W, C, _stream(dz))
    build.check(err, "train reduce kernel")
    bn_bwd_reduce.launches += 2
    return sums


def unit1x1_bwd(dz, a, cin, w, k, aff=None, affine_cin=True,
                reduce_next=True):
    """Backward of a 1x1 unit: (dz_prev (B, H, W, Cm), dw (Cm, C), db (1,
    C), sums_prev (2, Cm)), the last three float32. dz, a (B, H, W, C);
    cin (B, H, W, Cm) the conv input's saved form, re-normalized by aff
    (2, Cm) when affine_cin; w (Cm, C); k (3, C) the K1/K2/K3 rows.
    sums_prev is zero unless reduce_next. 4 launches (3 without
    reduce_next)."""
    _check(dz, a, cin)
    _same_shape(dz, a)
    if dz.device.type == "cpu":
        return unit1x1_bwd_plain(dz, a, cin, w, k, aff, affine_cin,
                                 reduce_next)
    C, Cm = dz.shape[-1], cin.shape[-1]
    w = _weight(w, (Cm, C), dz.dtype)
    kv = _vec(k, 3 * C, dz.device)
    affv = _vec(aff, 2 * Cm, dz.device) if affine_cin else None
    epi = EPI_DIN_SUMS if reduce_next else EPI_DIN
    din, sums = _launch_unit(1, PRO_DY, epi, dz, a, kv, w.T.contiguous(),
                             None, cin if reduce_next else None, Cm)
    dw, db = _launch_dw(1, dz, a, kv, cin, affv)
    unit1x1_bwd.launches += 4 if reduce_next else 3
    if sums is None:
        sums = torch.zeros((2, Cm), dtype=torch.float32, device=dz.device)
    return din, dw[0, 0], db, sums


def unit3x3_bwd(dz, a, cin, w, k, aff):
    """Backward of the 3x3 unit: (dz_prev, dw (3, 3, C, C), db (1, C),
    sums_prev (2, C)). dz, a, cin (B, H, W, C); w (3, 3, C, C); k (3, C);
    aff (2, C) the previous unit's BN affine. 4 launches."""
    _check(dz, a, cin)
    _same_shape(dz, a, cin)
    if dz.device.type == "cpu":
        return unit3x3_bwd_plain(dz, a, cin, w, k, aff)
    C = dz.shape[-1]
    w = _weight(w, (3, 3, C, C), dz.dtype)
    kv = _vec(k, 3 * C, dz.device)
    # din is the SAME conv of dy with the kernel flipped in space and
    # transposed in channels: Wk[p, q, o, i] = W[2-p, 2-q, i, o].
    wk = w.flip(0, 1).transpose(2, 3).contiguous()
    din, sums = _launch_unit(3, PRO_DY, EPI_DIN_SUMS, dz, a, kv, wk, None,
                             cin, C)
    dw, db = _launch_dw(3, dz, a, kv, cin, _vec(aff, 2 * C, dz.device))
    unit3x3_bwd.launches += 4
    return din, dw, db, sums


def unit1_bwd(dz, a, x, g, w, k):
    """Backward of unit 1 and the skip: (dx (B, H, W, C), dw (C, Cm), db
    (1, Cm)). dz, a (B, H, W, Cm); x, g (B, H, W, C); w (C, Cm). 3
    launches."""
    _check(dz, a, x, g)
    _same_shape(dz, a)
    _same_shape(x, g)
    if dz.device.type == "cpu":
        return unit1_bwd_plain(dz, a, x, g, w, k)
    Cm, C = dz.shape[-1], x.shape[-1]
    w = _weight(w, (C, Cm), dz.dtype)
    kv = _vec(k, 3 * Cm, dz.device)
    dx, _ = _launch_unit(1, PRO_DY, EPI_DIN_SKIP, dz, a, kv,
                         w.T.contiguous(), None, g, C)
    dw, db = _launch_dw(1, dz, a, kv, x, None)
    unit1_bwd.launches += 3
    return dx, dw[0, 0], db


for _fn in (conv1x1_relu_stats, conv3x3_relu_stats, bn_bwd_reduce,
            unit1x1_bwd, unit3x3_bwd, unit1_bwd):
    _fn.launches = 0
del _fn
