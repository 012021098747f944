#!/usr/bin/env python3
"""How long do the conv-skip bottleneck (#6), the warp resample (#11), the
heatmap render (#12) and the decode (#13) take here and in another
checkout, on one card, in the same call?

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
  `chip_smoke.l2_scrub` says why);
* #12 `render_heatmaps_batch` at the train step's (64, 64, 64, 17),
  sigma 1 (`keypoint_inputs` seed 8): the device time as its calls come
  and after an L2 scrub; as `chip_smoke.py` first read it (torch.profiler
  over 5 back-to-back calls, the kernel records' durations summed and
  divided by 5), with the number of records the profiler kept; and, as a
  yardstick of the write rate for the same 17.8 MB, `zero_()` of a
  tensor of that shape (not the same function);
* #13 `decode_batch` on `decode_inputs` (seed 11) at 64x64x17: the
  device time with the maps in L2 (back to back, as a served step finds
  them) at B=1, 16 and 128, and at B=128 after an L2 scrub; and, as a
  yardstick of the read rate for the same 35.65 MB, `maps.sum()` (not
  the same function);
* the host's time a call (`host_ms`: the wall clock around each call
  alone, the median of 200, the stream drained every 20 calls outside
  the timing) of #12 and of #13 at B=1 and 128; and of one served step
  at B=1, `PoseServer._step` on S4/256 (`chip_smoke.build_s4`, buckets
  (1,)), beside that step's wall time with the device drained
  (`step_wall_ms`, the median of 50): where the two are close, the step
  is bound by the host.

Each scrub is timed two ways: 128 MB written before each call (as
`chip_smoke.l2_scrub`, which leaves the L2 full of dirty lines whose
write-back the timed kernel pays for) and 128 MB read (which leaves it
clean).

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
import json, statistics, sys, time
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
clean = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
for _ in range(16):
    clean.zero_()
clean.sum()
for i, (x, p) in enumerate(c.warp_passes(imgs, theta, scale, flip)):
    k = lambda: wk.resample_last_axis(x, *p)
    out[f"#11 pass {i + 1} device ms"] = c.kernel_device_ms(k, "#11")
    out[f"#11 pass {i + 1} device ms, L2 scrubbed"] = c.kernel_device_ms(
        k, "#11", before=scrub.zero_)
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, schedule
from single_person_pose_estimation_tpu_torch.ops.cuda import (
    decode_kernel as dk, heatmap_kernel as hk)
kx, ky, kv = c.keypoint_inputs(np.random.default_rng(8), "cuda")
twelve = lambda: hk.render_heatmaps_batch(kx, ky, kv)
out["#12 device ms"] = c.kernel_device_ms(twelve, "#12")
out["#12 device ms, L2 scrubbed"] = c.kernel_device_ms(
    twelve, "#12", before=scrub.zero_)
out["#12 device ms, L2 scrubbed clean"] = c.kernel_device_ms(
    twelve, "#12", before=clean.sum)
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
             schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
    twelve()
    torch.cuda.synchronize()
    prof.step()
    for _ in range(5):
        twelve()
    torch.cuda.synchronize()
    prof.step()
durs = [(e.time_range.end - e.time_range.start) / 1e3 for e in prof.events()
        if e.device_type == DeviceType.CUDA and "heatmap_kernel" in e.name]
out["#12 profiler ms a call (records summed / 5)"] = sum(durs) / 5
out["#12 profiler records of 5 calls"] = len(durs)
out["#12 profiler ms a record"] = sum(durs) / max(len(durs), 1)
zeros = torch.empty((c.B_TRAIN, 64, 64, c.K), device="cuda")
maps = torch.from_numpy(c.decode_inputs(np.random.default_rng(11),
                                        c.B_TIME)).cuda()
for b in (1, 16, c.B_TIME):
    part = maps[:b]
    out[f"#13 B={b} device ms"] = c.kernel_device_ms(
        lambda: dk.decode_batch(part), "#13")
out[f"#13 B={c.B_TIME} device ms, L2 scrubbed"] = c.kernel_device_ms(
    lambda: dk.decode_batch(maps), "#13", before=scrub.zero_)
out[f"#13 B={c.B_TIME} device ms, L2 scrubbed clean"] = c.kernel_device_ms(
    lambda: dk.decode_batch(maps), "#13", before=clean.sum)
for label, fn in (("maps.sum()", maps.sum), ("zero_() of #12's output",
                                              zeros.zero_)):
    out[f"{label} device ms"] = c.kernel_device_ms(fn, label)
    out[f"{label} device ms, L2 scrubbed"] = c.kernel_device_ms(
        fn, label, before=scrub.zero_)
    out[f"{label} device ms, L2 scrubbed clean"] = c.kernel_device_ms(
        fn, label, before=clean.sum)


def host_ms(fn, calls=200):
    fn()
    torch.cuda.synchronize()
    times = []
    for i in range(calls):
        if i % 20 == 0:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return 1e3 * statistics.median(times)


def step_wall_ms(fn, calls=50):
    times = []
    for _ in range(calls + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(times[1:])


out["#12 host ms a call"] = host_ms(twelve)
for b in (1, c.B_TIME):
    part = maps[:b]
    out[f"#13 B={b} host ms a call"] = host_ms(
        lambda: dk.decode_batch(part))
from single_person_pose_estimation_tpu_torch.serving import PoseServer
server = PoseServer(c.build_s4(), device="cuda", buckets=(1,),
                    use_fused="auto")
try:
    server.warmup()
    wire = torch.zeros((1, 256, 256, 3))
    step = lambda: server._step(wire)
    out["served B=1 step host ms"] = host_ms(step, calls=50)
    out["served B=1 step wall ms"] = step_wall_ms(step)
finally:
    server.close()
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
