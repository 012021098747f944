"""An hourglass subtree (its innermost levels) in one CUDA launch.

    depth 1: the 8 px level (input 8x8 at a 256 px crop) and the bottom
             block: 6 bottlenecks, 1 pool, 1 upsample-add
    depth 2: + the 16 px level: 9 bottlenecks, 2 pools, 2 upsample-adds
    depth 3: + the 32 px level: 12 bottlenecks, 3 pools, 3 upsample-adds

x is the input of the innermost `depth` levels (the pooled map the outer
levels hand down); the output is the decoder output at the same size. Each
bottleneck is the identity-skip one of `bottleneck_kernel`, rounded once
from float32 (round(x + t3)); the pools are exact; `dshort + up` is added
in the storage dtype.

Replaces `single_person_pose_estimation_tpu/ops/pallas/bottom_kernel.py`
`fused_subtree` and `fused_bottom` (depth 1). The kernel is
`csrc/bottom.cu`: one block walks one image through `bneck_order`, tile
by tile, with the level maps in a workspace this wrapper allocates; its
source note says what bounds it on the H100 and why the TPU kernel's
all-in-VMEM blocking does not carry over. In bfloat16 each bottleneck of
the walk runs the tensor-core body of `csrc/bottleneck_tc.cuh` on the tiles
of `bneck_tc_plan`, as the separate launches of `bottleneck_kernel` do, so
the walk gives their bits; in float32 the FMA body, on the tiles of
`fma_tile_plan`.

For a tensor on the CPU the wrapper runs the plain PyTorch version; for a
CUDA tensor it launches the kernel or raises. `fused_subtree.launches`
counts launches, one per call.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from single_person_pose_estimation_tpu_torch.ops.cuda import build
from single_person_pose_estimation_tpu_torch.ops.cuda.bottleneck_kernel import (
    MODE_PLAIN_POOL,
    BottleneckParams,
    _check,
    _require_cuda,
    bneck_tc_plan,
    bottleneck_upadd_plain,
    fma_tile_plan,
    fused_bottleneck_plain,
    maxpool2x2,
)

# Innermost-first level names (relative to the hourglass): depth d covers
# LEVELS[:d], as in the JAX package's walk.
LEVELS = ("f8", "f4", "f2", "f1")


def bneck_order(depth: int):
    """The bottlenecks of a depth-d subtree in the order the walk runs
    them, so the packed index equals the execution index (the JAX
    package's `bneck_order`)."""
    def walk(d):
        if d == 0:
            return ["downsample_f8_1", "downsample_f8_2", "downsample_f8_3"]
        lvl = LEVELS[d - 1]
        return ([f"downsample_{lvl}"] + walk(d - 1)
                + [f"upsample_{lvl}_short", f"upsample_{lvl}_merged"])
    _check_depth(depth)
    return walk(depth)


def _check_depth(depth):
    if not 0 <= depth <= len(LEVELS):
        raise ValueError(f"subtree depth must be 0..{len(LEVELS)}, got "
                         f"{depth}")


@dataclass
class SubtreeParams:
    """The weight sets of one subtree, stacked in `bneck_order`: w1s (nb, C,
    Cm), w2s (nb, 3, 3, Cm, Cm), w3s (nb, Cm, C) in the storage dtype and
    vecs (nb, 6*Cm + 3*C) float32, nb = 3*depth + 3."""

    w1s: torch.Tensor
    w2s: torch.Tensor
    w3s: torch.Tensor
    vecs: torch.Tensor

    @classmethod
    def pack(cls, bnecks, stack_name: str, depth: int):
        """From the `BottleneckParams` of one stack (keyed
        f"{stack_name}_{suffix}", as `prepare_fused` holds them)."""
        ps = [bnecks[f"{stack_name}_{s}"] for s in bneck_order(depth)]
        return cls(*(torch.stack([getattr(p, k) for p in ps]).contiguous()
                     for k in ("w1", "w2", "w3", "vec")))

    def bneck(self, i) -> BottleneckParams:
        return BottleneckParams(self.w1s[i], self.w2s[i], self.w3s[i],
                                self.vecs[i])


def subtree_walk(x, sp: SubtreeParams, depth: int, bneck, upadd):
    """The TPU kernel's walk over `bneck_order`, from its two steps:
    `bneck(v, p)`, one bottleneck, and `upadd(f, inner, p)`, the
    bottleneck of f plus up2x(inner); the pools are exact."""
    order = iter(range(3 * depth + 3))

    def walk(v, d):
        if d == 0:
            for _ in range(3):
                v = bneck(v, sp.bneck(next(order)))
            return v
        f = bneck(v, sp.bneck(next(order)))
        inner = walk(maxpool2x2(f), d - 1)
        s = upadd(f, inner, sp.bneck(next(order)))
        return bneck(s, sp.bneck(next(order)))

    return walk(x, depth)


def fused_subtree_plain(x, sp: SubtreeParams, depth: int):
    """The walk composed of the plain bottleneck and up-add, with the TPU
    kernel's rounding points."""
    return subtree_walk(x, sp, depth, fused_bottleneck_plain,
                        bottleneck_upadd_plain)


def _check_subtree(x, sp: SubtreeParams, depth: int):
    _check_depth(depth)
    nb = 3 * depth + 3
    if sp.w1s.shape[0] != nb or sp.vecs.shape[0] != nb:
        raise ValueError(f"depth {depth} takes {nb} weight sets, got "
                         f"{sp.w1s.shape[0]}")
    B, H, W = x.shape[:3]
    if H != W or H % (1 << depth):
        raise ValueError(f"a depth-{depth} subtree takes a square map whose "
                         f"side divides by {1 << depth}; got {H}x{W}")
    _check(x, sp.bneck(0))


def fused_subtree(x, sp: SubtreeParams, depth: int):
    """x (B, H, H, C), the subtree's input level -> (B, H, H, C), the
    decoder output of the innermost `depth` levels, in one launch.

    Bound by its operations (at B=128 in bf16: 0.0132, 0.0556 and 0.2249
    ms at depths 1-3); one block walks one image, so B blocks share the
    card's 132 SMs, and the level maps go through a workspace of
    `spe_subtree_ws_elems` values per image allocated here."""
    _check_subtree(x, sp, depth)
    if x.device.type == "cpu":
        return fused_subtree_plain(x, sp, depth)
    _require_cuda(x)
    B, H, _, C = x.shape
    Cm = sp.w1s.shape[-1]
    lib = build.lib()
    per_image = lib.spe_subtree_ws_elems(H, C, depth)
    ws = torch.empty(B * per_image, dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    args = (x.data_ptr(), sp.w1s.data_ptr(), sp.w2s.data_ptr(),
            sp.w3s.data_ptr(), sp.vecs.data_ptr(), out.data_ptr(),
            ws.data_ptr(), B, H, C, Cm, depth, per_image)
    if x.dtype == torch.bfloat16:
        plan = bneck_tc_plan(B, H, H, C, Cm, MODE_PLAIN_POOL, blocks=1)
        err = lib.spe_subtree_tc(*args, plan["tsh"], plan["tsw"], plan["ck"],
                                 plan["nt"], plan["nst"], plan["smem"],
                                 stream)
    else:
        err = lib.spe_subtree(0, *args, fma_tile_plan("bneck", C, Cm)["ts"],
                              stream)
    build.check(err, "subtree kernel")
    fused_subtree.launches += 1
    return out


def fused_bottom(x, sp: SubtreeParams):
    """The depth-1 subtree: the 8 px level and the bottom block."""
    return fused_subtree(x, sp, 1)


fused_subtree.launches = 0
