"""Fused hourglass head and inter-stack glue (inference), as a CUDA kernel.

Per stack (reference hourglass.py:71-93):

    head = bn(relu(u @ Wh + bh))        1x1, C -> C
    pred = sigmoid(head @ Wp + bp)      1x1, C -> K, float32
    h2   = head @ W2 + b2               1x1, C -> C   (not on the last stack)
    hm   = pred @ W3 + b3               1x1, K -> C   (not on the last stack)
    y'   = h2 + hm + y

Replaces `single_person_pose_estimation_tpu/ops/pallas/head_kernel.py`
`fused_head`. The kernels are in `csrc/head.cu`: in bfloat16 the products
run on the tensor cores with the plan of `head_tc_plan`, in float32 as FMA
on the CUDA cores with the rows of `head_fma_plan`. Rounding follows the
TPU kernel: head rounds to the storage dtype, pred is cast to it before the
K -> C product, and h2 and hm round before h2 + hm + y, which rounds after
each add. The last stack has no y input and no y' output.

`fused_head.launches` counts kernel launches.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from single_person_pose_estimation_tpu_torch.ops.cuda import build
from single_person_pose_estimation_tpu_torch.ops.cuda.bottleneck_kernel import (
    _DTYPES,
    SMEM_LIMIT,
    _require_cuda,
    _widest,
)

HEAD_NP = 32              # pred columns of the padded Wp, and W3's rows
HEAD_FMA_ROWS = (64, 32, 16, 8)   # float32 rows a block, tried widest first
HEAD_TC_ROWS = (64, 32, 16)       # bfloat16 rows a block, tried widest first
HEAD_TC_CK = 64           # widest input-channel chunk of a ring stage
HEAD_TC_NT = 128          # widest output-channel chunk of a ring stage
HEAD_TC_STAGES = 4        # ring stages, at most


@dataclass
class HeadParams:
    """One stack's head weights, laid out once for the kernel.

    wh (C, C); wpT (K, C), the prediction conv transposed, and wpp (C,
    NP), the prediction conv with zero columns up to NP = K rounded up to
    HEAD_NP (the tensor-core kernel's B operand); vec float32 [bh, a, c,
    b2, b3] (C each) then bp (K). Mid stacks also hold w2 (C, C) and w3p
    (NP, C): W3 with zero rows up to NP (the FMA kernel reads the first K
    rounded up to 4).
    """

    wh: torch.Tensor
    wpT: torch.Tensor
    vec: torch.Tensor
    wpp: Optional[torch.Tensor] = None
    w2: Optional[torch.Tensor] = None
    w3p: Optional[torch.Tensor] = None

    @property
    def last(self) -> bool:
        return self.w2 is None

    @classmethod
    def pack(cls, wh, bh, a, c, wp, bp, w2=None, b2=None, w3=None, b3=None,
             *, dtype, device=None):
        f32 = dict(dtype=torch.float32, device=device)
        st = dict(dtype=dtype, device=device)
        wh = torch.as_tensor(wh).to(**st).contiguous()
        C = wh.shape[0]
        wp = torch.as_tensor(wp).to(**st)
        K = wp.shape[1]
        zeros = torch.zeros(C, **f32)
        b2 = zeros if b2 is None else torch.as_tensor(b2).to(**f32)
        b3 = zeros if b3 is None else torch.as_tensor(b3).to(**f32)
        vec = torch.cat([torch.as_tensor(v).reshape(-1).to(**f32)
                         for v in (bh, a, c, b2, b3, bp)])
        n_p = -(-K // HEAD_NP) * HEAD_NP
        wpp = torch.zeros((C, n_p), **st)
        wpp[:, :K] = wp
        p = cls(wh, wp.t().contiguous(), vec.contiguous(), wpp)
        if w2 is not None:
            p.w2 = torch.as_tensor(w2).to(**st).contiguous()
            p.w3p = torch.zeros((n_p, C), **st)
            p.w3p[:K] = torch.as_tensor(w3).to(**st)
        return p

    def vectors(self):
        """(bh, a, c, b2, b3) over C and bp over K."""
        C = self.wh.shape[0]
        return self.vec[:5 * C].view(5, C).unbind(0) + (self.vec[5 * C:],)


def fused_head_plain(u, y, p: HeadParams):
    dt = u.dtype
    bh, a, c, b2, b3, bp = p.vectors()
    head = (torch.relu(u.float() @ p.wh.float() + bh) * a + c).to(dt)
    pred = torch.sigmoid(head.float() @ p.wpT.float().t() + bp)
    if p.last:
        return pred, None
    K = p.wpT.shape[0]
    h2 = (head.float() @ p.w2.float() + b2).to(dt)
    hm = (pred.to(dt).float() @ p.w3p[:K].float() + b3).to(dt)
    s = (h2.float() + hm.float()).to(dt)
    return pred, (s.float() + y.float()).to(dt)


def head_fma_plan(C, K):
    """The rows a block of the float32 FMA head (csrc/head.cu head_kernel)
    takes: the first of HEAD_FMA_ROWS whose u, head and rounded pred (K
    rounded up to 4) fit one block's shared memory; 64 up to C=432 at
    K=17, 16 at C=1024. Returns {"rows", "smem"}; a ValueError where none
    fits."""
    kp = -(-K // 4) * 4
    for rows in HEAD_FMA_ROWS:
        smem = (2 * rows * C + rows * kp) * 4
        if smem <= SMEM_LIMIT:
            return dict(rows=rows, smem=smem)
    raise ValueError(f"no float32 head block of {HEAD_FMA_ROWS} rows fits "
                     f"{SMEM_LIMIT} bytes at C={C}, K={K}")


def _head_tc_smem(rows, C, K, ck, nt, nst):
    """Bytes of shared memory of one block (csrc/head.cu head_tc_smem):
    the u tile (rows of C + 8 bf16), which the float32 pred rows (padded
    to 16 bytes) and the rounded pred (rows of HEAD_NP + 8) replace after
    phase 1; the head tile (rows of C + 8); nst ring stages of ck x (nt +
    8)."""
    pred = -(-rows * K * 4 // 16) * 16 + rows * (HEAD_NP + 8) * 2
    reg_u = max(rows * (C + 8) * 2, pred)
    return reg_u + rows * (C + 8) * 2 + nst * ck * (nt + 8) * 2


def head_tc_plan(M, C, K, rows=None, ck=None, blocks=2):
    """The plan of the bf16 head on the tensor cores (csrc/head.cu
    head_tc_kernel), which the wrapper passes to the kernel as integers,
    for M = B*H*W pixel rows:

    rows, a block's flat pixel rows: the first of HEAD_TC_ROWS (or `rows`)
    whose block fits with two ring stages; ck, the input chunk of a stage:
    the widest multiple of 16 up to HEAD_TC_CK (or `ck`), at least 32,
    that divides C; nt, the output chunk: the widest multiple of 32 up to
    HEAD_TC_NT that divides C; nst, the most ring stages, up to
    HEAD_TC_STAGES, with which `blocks` blocks (2, or 1) fit an SM, else
    with which one does; smem, the block's bytes; stages, the ring's slices
    a block of a mid stack streams (Wh, Wp, then W2 and W3 per column
    group); blocks_m, the grid: M / rows rounded up, the last block's rows
    past M masked.

    The bf16 contract, a ValueError outside it: C a multiple of 32 up to
    1024 and 1 <= K <= HEAD_NP."""
    if C % 32 or not 0 < C <= 1024 or not 1 <= K <= HEAD_NP:
        raise ValueError(f"the bfloat16 head takes C a multiple of 32 (<= "
                         f"1024) and 1 <= K <= {HEAD_NP}, got C={C}, K={K}")
    ck = _widest(C, ck or HEAD_TC_CK)
    if ck < HEAD_NP:
        raise ValueError(f"the bfloat16 head's input chunk must be at least "
                         f"{HEAD_NP}, got {ck}")
    nt = next(d for d in range(HEAD_TC_NT, 0, -32) if C % d == 0)
    rows = next((r for r in ((rows,) if rows else HEAD_TC_ROWS)
                 if _head_tc_smem(r, C, K, ck, nt, 2) <= SMEM_LIMIT), None)
    if rows is None:
        raise ValueError(f"no bfloat16 head block fits {SMEM_LIMIT} bytes "
                         f"at C={C}")
    smem = lambda n: _head_tc_smem(rows, C, K, ck, nt, n)
    limits = ((SMEM_LIMIT // 2 - 1024,) if blocks == 2 else ()) \
        + (SMEM_LIMIT,)
    nst = next(n for limit in limits for n in range(HEAD_TC_STAGES, 1, -1)
               if smem(n) <= limit)
    k1 = C // ck
    return dict(rows=rows, ck=ck, nt=nt, nst=nst, smem=smem(nst),
                stages=(C // nt) * k1 + k1 + (C // nt) * (k1 + 1),
                blocks_m=-(-M // rows))


def fused_head(u, y, p: HeadParams):
    """u (B, H, W, C) decoder output; y (B, H, W, C) stack input (None on
    the last stack). Returns (pred (B, H, W, K) float32, y' or None)."""
    if u.dim() != 4 or not u.is_contiguous() or u.dtype not in _DTYPES:
        raise ValueError(f"u must be contiguous NHWC float32/bfloat16, got "
                         f"{tuple(u.shape)} {u.dtype}")
    C = u.shape[-1]
    # The FMA kernel spreads C/4 channel groups over its 256 threads.
    if C != p.wh.shape[0] or C % 16 or C > 1024 or p.wh.dtype != u.dtype \
            or p.wh.device != u.device or p.vec.device != u.device:
        raise ValueError(f"u {tuple(u.shape)} {u.dtype} on {u.device} does "
                         f"not fit wh {tuple(p.wh.shape)} {p.wh.dtype} on "
                         f"{p.wh.device}")
    if not p.last and (y is None or y.shape != u.shape or y.dtype != u.dtype
                       or not y.is_contiguous()):
        raise ValueError("a mid-stack head needs y shaped and typed as u")
    if u.device.type == "cpu":
        return fused_head_plain(u, y, p)
    B, H, W, _ = u.shape
    pred = torch.empty((B, H, W, p.wpT.shape[0]), dtype=torch.float32,
                       device=u.device)
    ynext = None if p.last else torch.empty_like(u)
    launch_head(u, y, p, pred, ynext)
    fused_head.launches += 1
    return pred, ynext


def launch_head(u, y, p: HeadParams, pred, ynext, plan=None):
    """Launch csrc/head.cu on u's current stream (no sync): the
    tensor-core kernel for bfloat16 (with `plan`, by default
    `head_tc_plan`'s), the FMA kernel for float32."""
    _require_cuda(u)
    B, H, W, C = u.shape
    M, K = B * H * W, p.wpT.shape[0]
    stream = torch.cuda.current_stream(u.device).cuda_stream
    mid = int(not p.last)
    glue = ((None, None, None) if p.last else
            (y.data_ptr(), p.w2.data_ptr(), p.w3p.data_ptr()))
    out = None if p.last else ynext.data_ptr()
    if u.dtype == torch.bfloat16:
        plan = plan or head_tc_plan(M, C, K)
        err = build.lib().spe_head_tc(
            mid, u.data_ptr(), glue[0], p.wh.data_ptr(), p.wpp.data_ptr(),
            glue[1], glue[2], p.vec.data_ptr(), pred.data_ptr(), out, M, C,
            K, plan["rows"], plan["ck"], plan["nt"], plan["nst"],
            plan["smem"], stream)
    else:
        err = build.lib().spe_head(
            mid, 0, u.data_ptr(), glue[0], p.wh.data_ptr(),
            p.wpT.data_ptr(), glue[1], glue[2], p.vec.data_ptr(),
            pred.data_ptr(), out, M, C, K, head_fma_plan(C, K)["rows"],
            stream)
    build.check(err, "head kernel")


fused_head.launches = 0
