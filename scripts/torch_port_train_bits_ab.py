#!/usr/bin/env python3
"""Are the train-unit kernels' results unchanged between two checkouts?

    python3 scripts/torch_port_train_bits_ab.py OTHER_CHECKOUT

Runs `chip_smoke.train_unit_cases` (seed 0; batch 8 and 64; every level
from 64 px down to 4 px; float32 with TF32 off, and bfloat16) in this
checkout and in OTHER_CHECKOUT, each in its own process that builds its own
kernels, on one NVIDIA card. Every float32 output of #14a-f, and every
bfloat16 output of #14b-f, must be bit-equal between the two; for the
bfloat16 outputs of the 1x1 forward unit #14a (conv1x1_relu_stats),
whose body may differ, it prints the largest |d|. Exits 1 if an output
that must be bit-equal differs.
Both checkouts must draw the same inputs, so `train_unit_cases` must be
the same in both. Use it to show that a change to
`csrc/bottleneck_train.cu` left the other units' results as they were.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAY_DIFFER = ("conv1x1_relu_stats",)

_DUMP = """
import hashlib, sys
root, path = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)
import numpy as np
import torch
import chip_smoke
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
chip_smoke.phase_build()
outs = {}
for b in (chip_smoke.B_CHECK, chip_smoke.B_TRAIN):
    for dtype in (torch.float32, torch.bfloat16):
        cases = chip_smoke.train_unit_cases(np.random.default_rng(0), dtype,
                                            "cuda", b)
        for label, name, kern, _, _ in cases:
            got = kern()
            got = got if isinstance(got, tuple) else (got,)
            for i, g in enumerate(got):
                key = f"{label} B={b} {str(dtype)[6:]} out{i}"
                g = g.float().cpu()  # bf16 -> f32 is exact
                if dtype == torch.bfloat16 and name in %r:
                    outs[key] = g
                else:
                    outs[key] = (tuple(g.shape), hashlib.sha256(
                        g.contiguous().numpy().tobytes()).hexdigest())
        torch.cuda.empty_cache()
torch.save(outs, path)
""" % (MAY_DIFFER,)


def dump(root: str, path: str):
    subprocess.run([sys.executable, "-c", _DUMP, os.path.abspath(root),
                    path], check=True, cwd=root)


def main(argv):
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("torch_port_train_bits_ab: no CUDA device", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as tmp:
        mine, other = (os.path.join(tmp, n) for n in ("mine.pt", "other.pt"))
        dump(HERE, mine)
        dump(argv[1], other)
        a, b = torch.load(mine), torch.load(other)
    if a.keys() != b.keys():
        print(f"the checkouts ran other cases: {sorted(a)} vs {sorted(b)}")
        return 1
    differ = held = 0
    for key in a:
        if isinstance(a[key], torch.Tensor):
            d = (a[key] - b[key]).abs().max().item()
            print(f"{key}: max |d| {d:.6g} (may differ: {MAY_DIFFER})")
            continue
        held += 1
        same = a[key] == b[key]
        differ += not same
        print(f"{key}: {'bit-equal' if same else 'DIFFERS'}")
    print(f"{held - differ} of {held} outputs that must match bit-equal "
          f"between {HERE} and {os.path.abspath(argv[1])}")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
