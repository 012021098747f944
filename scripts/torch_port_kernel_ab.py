#!/usr/bin/env python3
"""How long do the conv-skip bottleneck (#6) and the warp resample (#11)
take here and in another checkout, on one card, in the same call?

    python3 scripts/torch_port_kernel_ab.py OTHER_CHECKOUT

Runs four processes in turn, other, this, this, other, each in its own
checkout with its own kernels (a checkout builds them once), and each
times, with `chip_smoke`'s helpers of its checkout:

* #6 `fused_bottleneck_convskip` in bfloat16 at the `fuse_front` shape
  (B=128, 64 px, 128 -> 256): CUDA events over back-to-back calls
  (`cuda_ms`) and the device time alone (`kernel_device_ms`);
* #11 `resample_last_axis`, float32, both passes of the training warp at
  batch 64, 256x256x3 (`warp_inputs` seed 8, `warp_passes`): the device
  time as its calls come, and after a 128 MB write that scrubs the 50 MB
  L2 before each call (the buffer written 16 times first, as
  `chip_smoke.l2_scrub` says why).

Prints each process's readings and, per checkout, the median of its two
processes, with the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_TIME = """
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
import chip_smoke as c
from single_person_pose_estimation_tpu_torch.ops.cuda import (
    bottleneck_kernel as bk, warp_kernel as wk)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
c.phase_build()
rng = np.random.default_rng(31)
dt = torch.bfloat16
xs = c.nhwc(rng, c.B_TIME, 64, dt, "cuda", c.C // 2)
cp = c.convskip_params(rng, dt, "cuda")
six = lambda: bk.fused_bottleneck_convskip(xs, cp)
out = {}
with torch.inference_mode():
    out["#6 ms"] = c.cuda_ms(six, iters=5)
    out["#6 device ms"] = c.kernel_device_ms(six, "#6")
imgs, theta, scale, flip = c.warp_inputs(np.random.default_rng(8), "cuda")
scrub = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
for _ in range(16):  # as chip_smoke.l2_scrub, which older checkouts lack
    scrub.zero_()
for i, (x, p) in enumerate(c.warp_passes(imgs, theta, scale, flip)):
    k = lambda: wk.resample_last_axis(x, *p)
    out[f"#11 pass {i + 1} device ms"] = c.kernel_device_ms(k, "#11")
    out[f"#11 pass {i + 1} device ms, L2 scrubbed"] = c.kernel_device_ms(
        k, "#11", before=scrub.zero_)
print("RESULT " + json.dumps(out))
"""


def run(root: str) -> dict:
    res = subprocess.run([sys.executable, "-c", _TIME, os.path.abspath(root)],
                         cwd=root, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{root}: rc {res.returncode}\n{res.stdout}\n"
                           f"{res.stderr}")
    line = next(ln for ln in res.stdout.splitlines()
                if ln.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def main(argv):
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("torch_port_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke

    card = chip_smoke.card_line()
    roots = {"other": argv[1], "this": HERE}
    readings = {"other": [], "this": []}
    for side in ("other", "this", "this", "other"):
        r = run(roots[side])
        readings[side].append(r)
        print(f"{side} ({os.path.abspath(roots[side])}): "
              + ", ".join(f"{k} {v:.4f}" for k, v in r.items())
              + f" [{card}]", flush=True)
    for side, rs in readings.items():
        print(f"median {side}: " + ", ".join(
            f"{k} {statistics.median(r[k] for r in rs):.4f}" for k in rs[0])
            + f" [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
