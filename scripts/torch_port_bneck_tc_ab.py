#!/usr/bin/env python3
"""Which plans of the bf16 tensor-core kernels run fastest on this card?

    python3 scripts/torch_port_bneck_tc_ab.py

Times, at the main path's shapes (bf16, B=128, C=256), each plan of

* PLANS, the standard bottleneck body of `csrc/bottleneck_tc.cuh`
  (`bneck_tc_plan`'s overrides: tile, input chunk, blocks an SM): #1 at
  64 px, #2 at 32 px and #3's first launch at 64 px;
* the same PLANS for the mobile body (`mobile_tc_plan`): #8 at 64 px, #9
  at 32 px and #10's first launch at 64 px;
* HEAD_PLANS, the head of `csrc/head.cu` (`head_tc_plan`'s overrides: rows
  a block, input chunk, blocks an SM): #4 mid and last stack at 64 px;
* CONVSKIP_PLANS, the conv-skip bottleneck on the same body
  (`convskip_tc_plan`'s overrides: ring stages, input chunk, blocks an SM,
  tile): #6 at 64 px, 128 -> 256 (the skip parked in out between its
  product and phase 3's epilogue; the only design built),

each plan in turn, four rounds alternating in order, with CUDA events
(median ms of the rounds). Every plan must give the bits of its kernel's
default plan: each body sums every output element in the same order
whatever the tile, the rows and the chunk, so a plan that differs is a
fault. Prints one line per plan and shape with the card's name and power
limit, and exits 1 if any plan's bits differ.
"""

from __future__ import annotations

import os
import statistics
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 128
# (label, bneck_tc_plan / mobile_tc_plan overrides)
PLANS = (("8x8 ck64 2 blocks (default)", {}),
         ("8x8 ck32 2 blocks", dict(ck=32)),
         ("8x8 ck64 1 block", dict(blocks=1)),
         ("8x16 ck64 1 block", dict(tile=(8, 16))),
         ("8x16 ck32 1 block", dict(tile=(8, 16), ck=32)))
# (label, head_tc_plan overrides)
HEAD_PLANS = (("64 rows ck64 2 blocks (default)", {}),
              ("64 rows ck32 2 blocks", dict(ck=32)),
              ("32 rows ck64 2 blocks", dict(rows=32)),
              ("64 rows ck64 1 block", dict(blocks=1)),
              ("32 rows ck32 2 blocks", dict(rows=32, ck=32)))
# (label, convskip_tc_plan overrides)
CONVSKIP_PLANS = (("8x8 ck64 2 blocks 3 stages (default)", {}),
                  ("8x8 ck64 2 blocks 2 stages", dict(nst=2)),
                  ("8x8 ck32 2 blocks", dict(ck=32)),
                  ("8x8 ck64 1 block", dict(blocks=1)),
                  ("8x16 ck64 1 block", dict(tile=(8, 16))))


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_port_bneck_tc_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke
    from single_person_pose_estimation_tpu_torch.ops.cuda import (
        bottleneck_kernel as bk,
        head_kernel as hk,
        mobile_kernel as mk,
    )

    chip_smoke.phase_build()
    card = chip_smoke.card_line()
    rng = np.random.default_rng(5)
    dt = torch.bfloat16
    p = chip_smoke.bneck_params(rng, dt, "cuda")
    mp = chip_smoke.mobile_params(rng, dt, "cuda")
    hmid = chip_smoke.head_params(rng, False, dt, "cuda")
    hlast = chip_smoke.head_params(rng, True, dt, "cuda")
    x64 = chip_smoke.nhwc(rng, B, 64, dt, "cuda")
    x32 = chip_smoke.nhwc(rng, B, 32, dt, "cuda")
    u32 = chip_smoke.nhwc(rng, B, 32, dt, "cuda")
    C, Cm = p.w1.shape
    K = hmid.wpT.shape[0]
    cp = chip_smoke.convskip_params(rng, dt, "cuda")
    xc = chip_smoke.nhwc(rng, B, 64, dt, "cuda", Cm)

    def body(mobile):
        planner, launch, params = ((mk.mobile_tc_plan, mk.launch_mobile, mp)
                                   if mobile else
                                   (bk.bneck_tc_plan, bk.launch_bottleneck, p))

        def call(mode, x, over):
            b, h, w, _ = x.shape
            plan = planner(b, h, w, C, Cm, mode, **over)
            out = torch.empty_like(x)
            pooled = (torch.empty((b, h // 2, w // 2, C), dtype=dt,
                                  device="cuda")
                      if mode == bk.MODE_POOL else None)
            launch(mode, x, params, out, pooled=pooled,
                   u_lo=u32 if mode == bk.MODE_UPADD else None, plan=plan)
            return out, pooled

        def planned(mode, x, over):
            return planner(B, *x.shape[1:3], C, Cm, mode, **over)

        return call, planned

    def head_call(last, x, over):
        hp = hlast if last else hmid
        plan = hk.head_tc_plan(x.shape[0] * 64 * 64, C, K, **over)
        pred = torch.empty((*x.shape[:3], K), dtype=torch.float32,
                           device="cuda")
        ynext = None if last else torch.empty_like(x)
        hk.launch_head(x, None if last else x, hp, pred, ynext, plan=plan)
        return pred, ynext

    def head_planned(last, x, over):
        return hk.head_tc_plan(B * 64 * 64, C, K, **over)

    def convskip_call(_, x, over):
        plan = bk.convskip_tc_plan(*x.shape, C, Cm, **over)
        out = torch.empty((*x.shape[:3], C), dtype=dt, device="cuda")
        bk.launch_convskip(x, cp, out, plan=plan)
        return (out,)

    def convskip_planned(_, x, over):
        return bk.convskip_tc_plan(*x.shape, C, Cm, **over)

    bcall, bplanned = body(False)
    mcall, mplanned = body(True)
    # (kernel, plans, [(shape label, mode, x)], call, planned)
    groups = (
        ("bottleneck", PLANS,
         (("#1 kPlain 64 px", bk.MODE_PLAIN, x64),
          ("#2 kPool 32 px", bk.MODE_POOL, x32),
          ("#3 kUpAdd 64 px", bk.MODE_UPADD, x64)), bcall, bplanned),
        ("mobile", PLANS,
         (("#8 kMobPlain 64 px", mk.MODE_PLAIN, x64),
          ("#9 kMobPool 32 px", mk.MODE_POOL, x32),
          ("#10 kMobUpAdd 64 px", mk.MODE_UPADD, x64)), mcall, mplanned),
        ("head", HEAD_PLANS,
         (("#4 mid 64 px", False, x64), ("#4 last 64 px", True, x64)),
         head_call, head_planned),
        ("convskip", CONVSKIP_PLANS,
         (("#6 64 px 128->256", None, xc),), convskip_call, convskip_planned),
    )
    differ = 0
    times = {}
    for kernel, plans, shapes, call, planned in groups:
        for label, over in plans:
            for shape, mode, x in shapes:
                same = all(a is None or torch.equal(a, b) for a, b in zip(
                    call(mode, x, over), call(mode, x, {})))
                differ += not same
                print(f"{kernel} {label} {shape}: plan "
                      f"{planned(mode, x, over)}; bits of the default plan "
                      f"{same}")
                times[(kernel, label, shape)] = []
    with torch.inference_mode():
        for r in range(4):
            for kernel, plans, shapes, call, _ in groups:
                for label, over in (plans if r % 2 == 0 else plans[::-1]):
                    for shape, mode, x in shapes:
                        times[(kernel, label, shape)].append(
                            chip_smoke.cuda_ms(
                                lambda: call(mode, x, over), iters=5))
    for (kernel, label, shape), ts in times.items():
        print(f"ab {kernel} {shape} {label}: {statistics.median(ts):.4f} ms "
              f"(median of {len(ts)}: {', '.join(f'{t:.4f}' for t in ts)}) "
              f"[{card}]")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
