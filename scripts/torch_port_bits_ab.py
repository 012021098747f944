#!/usr/bin/env python3
"""Are the port's inference kernels bit-equal between two checkouts?

    python3 scripts/torch_port_bits_ab.py OTHER_CHECKOUT

Runs `chip_smoke.kernel_cases` (seed 0, batch 8: #1 at 64 and 4 px, #2 at
32, 16 and 8 px, #3 at 64-8 px, #4 mid and last; float32 with TF32 off,
and bfloat16) in this checkout and in OTHER_CHECKOUT, each in its own
process that builds its own kernels, on one NVIDIA card. It prints, for
every output, whether the two checkouts wrote the same bits, and exits 1
if any differs, except the bfloat16 outputs of MAY_DIFFER (#1-#3, whose
bf16 body moved from FMA to the tensor cores), for which it prints how
far they moved: max |d|, and the share of values that differ. Both
checkouts must draw the same inputs, so `kernel_cases` must be the same
in both. Use it to show that a refactor of `csrc/bottleneck.cu` left the
kernels' results as they were.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAY_DIFFER = ("fused_bottleneck", "fused_bottleneck_pool", "fused_uplevel")

_DUMP = """
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
for dtype in (torch.float32, torch.bfloat16):
    cases = chip_smoke.kernel_cases(np.random.default_rng(0), dtype, "cuda",
                                    chip_smoke.B_CHECK)
    for label, _, kern, _ in cases:
        got = kern()
        got = got if isinstance(got, tuple) else (got,)
        for i, g in enumerate(got):
            if g is not None:
                outs[f"{label} {str(dtype)[6:]} out{i}"] = g.cpu()
torch.cuda.synchronize()
torch.save(outs, path)
"""


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
    if a.keys() != b.keys():
        print(f"the checkouts ran other cases: {sorted(a)} vs {sorted(b)}")
        return 1
    differ = held = 0
    for key in a:
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
