#!/usr/bin/env python3
"""Which plan of the bf16 bottleneck body runs fastest on this card?

    python3 scripts/torch_port_bneck_tc_ab.py

Times the tensor-core body of `csrc/bottleneck_tc.cuh` under each plan of
PLANS (tile, input chunk, blocks an SM: `bneck_tc_plan`'s overrides) at
the main path's shapes, bf16, B=128, C=256: #1 at 64 px, #2 at 32 px and
#3 at 64 px, each plan in turn, four rounds alternating in order, with
CUDA events (median ms of the rounds). Every plan must give the bits of
the default plan: the body sums each output element in the same order
whatever the tile and the chunk, so a plan that differs is a fault. Prints
one line per plan and shape with the card's name and power limit, and
exits 1 if any plan's bits differ.
"""

from __future__ import annotations

import os
import statistics
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 128
# (label, bneck_tc_plan overrides)
PLANS = (("8x8 ck64 2 blocks (default)", {}),
         ("8x8 ck32 2 blocks", dict(ck=32)),
         ("8x8 ck64 1 block", dict(blocks=1)),
         ("8x16 ck64 1 block", dict(tile=(8, 16))),
         ("8x16 ck32 1 block", dict(tile=(8, 16), ck=32)))


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
    )

    chip_smoke.phase_build()
    card = chip_smoke.card_line()
    rng = np.random.default_rng(5)
    dt = torch.bfloat16
    p = chip_smoke.bneck_params(rng, dt, "cuda")
    x64 = chip_smoke.nhwc(rng, B, 64, dt, "cuda")
    x32 = chip_smoke.nhwc(rng, B, 32, dt, "cuda")
    u32 = chip_smoke.nhwc(rng, B, 32, dt, "cuda")
    C, Cm = p.w1.shape

    def call(mode, x, over):
        b, h, w, _ = x.shape
        plan = bk.bneck_tc_plan(b, h, w, C, Cm, mode, **over)
        out = torch.empty_like(x)
        pooled = (torch.empty((b, h // 2, w // 2, C), dtype=dt,
                              device="cuda") if mode == bk.MODE_POOL else None)
        bk.launch_bottleneck(mode, x, p, out, pooled=pooled,
                             u_lo=u32 if mode == bk.MODE_UPADD else None,
                             plan=plan)
        return out, pooled

    shapes = (("#1 kPlain 64 px", bk.MODE_PLAIN, x64),
              ("#2 kPool 32 px", bk.MODE_POOL, x32),
              ("#3 kUpAdd 64 px", bk.MODE_UPADD, x64))
    differ = 0
    for label, over in PLANS:
        for shape, mode, x in shapes:
            plan = bk.bneck_tc_plan(B, *x.shape[1:3], C, Cm, mode, **over)
            same = all(a is None or torch.equal(a, b) for a, b in zip(
                call(mode, x, over), call(mode, x, {})))
            differ += not same
            print(f"{label} {shape}: plan {plan}; bits of the default plan "
                  f"{same}")
    times = {(lab, s): [] for lab, _ in PLANS for s, _, _ in shapes}
    with torch.inference_mode():
        for r in range(4):
            order = PLANS if r % 2 == 0 else PLANS[::-1]
            for label, over in order:
                for shape, mode, x in shapes:
                    times[(label, shape)].append(chip_smoke.cuda_ms(
                        lambda: call(mode, x, over), iters=5))
    for (label, shape), ts in times.items():
        print(f"ab {shape} {label}: {statistics.median(ts):.4f} ms (median "
              f"of {len(ts)}: {', '.join(f'{t:.4f}' for t in ts)}) [{card}]")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
