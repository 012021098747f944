#!/usr/bin/env python3
"""Are the port's inference kernels and its warp bit-equal between two
checkouts?

    python3 scripts/torch_port_bits_ab.py OTHER_CHECKOUT

Runs, in this checkout and in OTHER_CHECKOUT, each in its own process that
builds its own kernels, on one NVIDIA card, float32 (TF32 off) and
bfloat16, batch 8:

* `chip_smoke.kernel_cases` (seed 0: #1 at 64 and 4 px, #2 at 32, 16 and
  8 px, #3 at 64-8 px, #4 mid and last);
* `chip_smoke.mobile_kernel_cases` (seed 20: #8 at 64 and 4 px, #9 at 32,
  16 and 8 px, #10 at 64-8 px);
* the main-shape cases of `chip_smoke.dial_kernel_cases` (seed 30, those
  whose label names no batch or width: #6 at 64 px, #7 at depths 1-3, #5
  at 128 px), which both checkouts draw first;
* each of `chip_smoke.BNECK_EDGES` (#1-#3 at their contract's edges) on
  its own, drawn from seed 100 + its index, so that two checkouts whose
  lists share a prefix draw its edges alike;
* the warp resample #11, float32: both passes of `chip_smoke.warp_passes`
  on `chip_smoke.warp_inputs` (seed 4, batch 64, 256x256x3), pass 2 on
  pass 1's output;
* the heatmap render #12 on `chip_smoke.keypoint_inputs` (seed 4, the
  train step's (64, 64, 64, 17), sigma 1) and at HEAT_EDGES, keypoints
  drawn here with numpy (seed 200 + the edge's index);
* the decode #13, legacy and corrected, on `chip_smoke.decode_inputs`
  (seed 11, batch 128, 64x64x17) and its first image and first 16, and
  at DECODE_EDGES, maps drawn here (seed 300 + the edge's index: uniform,
  quantized to quarters for ties, a flat image and a border peak).

It prints, for every output both checkouts wrote, whether they wrote the
same bits, and exits 1 if any differs, except the bfloat16 outputs of
the kernels named in MAY_DIFFER (set it to a kernel whose bf16 design a
change moves on purpose; empty, every output must match), for which it
prints how far they moved: max |d|, and the share of values that differ;
it lists the outputs only one checkout wrote. Both checkouts must draw
the same inputs, so those case functions
must draw alike in both. Use it to show that a change of the kernels left
the results it does not mean to move as they were.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAY_DIFFER = ()

# (B, H, W, K, sigma) and (B, H, W, K): the edge cases of chip_smoke's
# HEATMAP_EDGES and DECODE_EDGES that the other checkout's kernels take too.
HEAT_EDGES = ((1, 32, 32, 1, 2.0), (1, 32, 32, 17, 2.0), (3, 40, 33, 17, 1.0),
              (2, 48, 64, 17, 1.0), (1, 16, 16, 4099, 1.0),
              (2, 96, 96, 3, 40.0))
DECODE_EDGES = ((3, 64, 64, 17), (128, 64, 64, 1), (16, 64, 64, 16),
                (3, 32, 48, 33), (16, 16, 40, 17), (3, 15, 15, 17),
                (1, 64, 64, 543), (16, 8, 8, 543), (3, 15, 15, 543),
                (3, 16, 16, 544))

_DUMP = (f"HEAT_EDGES, DECODE_EDGES = {HEAT_EDGES!r}, {DECODE_EDGES!r}\n"
         + """
import sys
root, path = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)
import numpy as np
import torch
import chip_smoke
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
chip_smoke.phase_build()
outs = {}
groups = ((chip_smoke.kernel_cases, 0), (chip_smoke.mobile_kernel_cases, 20),
          (chip_smoke.dial_kernel_cases, 30))
for dtype in (torch.float32, torch.bfloat16):
    for make, seed in groups:
        cases = make(np.random.default_rng(seed), dtype, "cuda",
                     chip_smoke.B_CHECK)
        for label, _, kern, *_ in cases:
            if " B=" in label:
                continue
            got = kern()
            got = got if isinstance(got, tuple) else (got,)
            for i, g in enumerate(got):
                if g is not None:
                    outs[f"{label} {str(dtype)[6:]} out{i}"] = g.cpu()
    edges = tuple(chip_smoke.BNECK_EDGES)
    for k, edge in enumerate(edges):
        chip_smoke.BNECK_EDGES = (edge,)
        for label, _, kern, *_ in chip_smoke.bneck_edge_cases(
                np.random.default_rng(100 + k), dtype, "cuda"):
            got = kern()
            got = got if isinstance(got, tuple) else (got,)
            for i, g in enumerate(got):
                outs[f"{label} {str(dtype)[6:]} out{i}"] = g.cpu()
    chip_smoke.BNECK_EDGES = edges
from single_person_pose_estimation_tpu_torch.ops.cuda import warp_kernel as wk
warp = chip_smoke.warp_inputs(np.random.default_rng(4), "cuda")
for i, (x, p) in enumerate(chip_smoke.warp_passes(*warp)):
    outs[f"resample_last_axis pass {i + 1} float32 out0"] = \
        wk.resample_last_axis(x, *p).cpu()
from single_person_pose_estimation_tpu_torch.ops.cuda import (
    decode_kernel as dk, heatmap_kernel as hk)
kps = chip_smoke.keypoint_inputs(np.random.default_rng(4), "cuda")
outs["render_heatmaps_batch (64, 64, 64, 17) float32 out0"] = \
    hk.render_heatmaps_batch(*kps).cpu()
for i, (b, h, w, k, sigma) in enumerate(HEAT_EDGES):
    r = np.random.default_rng(200 + i)
    kx = r.uniform(-3, w + 3, (b, k)).astype(np.float32)
    ky = r.uniform(-3, h + 3, (b, k)).astype(np.float32)
    kv = r.integers(0, 3, (b, k)).astype(np.int32)
    got = hk.render_heatmaps_batch(
        *(torch.from_numpy(a).cuda() for a in (kx, ky, kv)), h, w, sigma)
    outs[f"render_heatmaps_batch {(b, h, w, k)} sigma {sigma} float32 "
         "out0"] = got.cpu()
maps = torch.from_numpy(chip_smoke.decode_inputs(
    np.random.default_rng(11), 128)).cuda()
cases = {f"B={n} 64x64x17": maps[:n] for n in (1, 16, 128)}
for i, (b, h, w, k) in enumerate(DECODE_EDGES):
    r = np.random.default_rng(300 + i)
    hm = r.uniform(0, 1, (b, h, w, k)).astype(np.float32)
    hm[b // 2:] = np.round(hm[b // 2:] * 4) / 4
    hm[0] = 0.25
    hm[-1, 0, w - 1] = 2.0
    cases[f"B={b} {h}x{w}x{k}"] = torch.from_numpy(hm).cuda()
for label, hm in cases.items():
    for legacy in (True, False):
        mode = "legacy" if legacy else "corrected"
        outs[f"decode_batch {label} {mode} float32 out0"] = \
            dk.decode_batch(hm, legacy=legacy).cpu()
torch.cuda.synchronize()
torch.save(outs, path)
""")


def dump(root: str, path: str):
    subprocess.run([sys.executable, "-c", _DUMP, os.path.abspath(root),
                    path], check=True, cwd=root)


def main(argv):
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("torch_port_bits_ab: no CUDA device", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as tmp:
        mine, other = (os.path.join(tmp, n) for n in ("mine.pt", "other.pt"))
        dump(HERE, mine)
        dump(argv[1], other)
        a, b = torch.load(mine), torch.load(other)
    for key in sorted(a.keys() ^ b.keys()):
        print(f"{key}: written by {'this' if key in a else 'the other'} "
              f"checkout only")
    differ = held = 0
    for key in (k for k in a if k in b):
        same = torch.equal(a[key], b[key])
        if " bfloat16 " in key and key.split("@")[0] in MAY_DIFFER:
            d = (a[key].float() - b[key].float()).abs()
            print(f"{key}: {'bit-equal' if same else 'moved'}, max |d| "
                  f"{d.max().item():.6g}, {(d > 0).float().mean().item():.6f}"
                  f" of the values differ (may differ: {MAY_DIFFER})")
            continue
        held += 1
        differ += not same
        print(f"{key}: {'bit-equal' if same else 'DIFFERS'}")
    print(f"{held - differ} of {held} outputs that must match bit-equal "
          f"between {HERE} and {os.path.abspath(argv[1])}")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
