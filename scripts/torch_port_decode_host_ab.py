#!/usr/bin/env python3
"""How much host time does a decode (#13) call take, here and in another
checkout, measured in one process?

    python3 scripts/torch_port_decode_host_ab.py OTHER_CHECKOUT

Loads both checkouts' kernel libraries into this process (the other's
`ops/cuda/build.py` builds and loads its own; the two libraries are
separate `ctypes` handles) and times on one card, at B=1 and 128 on
64x64x17 float32 maps, the host's time of one call of:

* `spe_decode` of each library, called through ctypes with the
  arguments its wrapper passes: the other's nine (maps, out, B, H, W, K,
  threshold, legacy, stream) where its entry point takes nine, else, like
  this one's, those and this checkout's `decode_geometry` launch;
* this checkout's whole wrapper `decode_batch`, and its parts: the
  plan's lookup, `torch.empty` of the output, and the current stream's
  handle as the wrapper takes it (`_stream_ptr`) and through
  `torch.cuda.current_stream(device).cuda_stream`.

Each reading is the median over 50 calls of the wall clock around the
call alone (the stream drained every 10 calls, outside the timing); the
readings take turns over 20 rounds, and the script prints each one's
median and quartiles over the rounds, with the card's name and power
limit. Host times on a shared host spread from one process to the next,
so compare the two checkouts only within one run of this script.
"""

from __future__ import annotations

import importlib.util
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join("single_person_pose_estimation_tpu_torch", "ops", "cuda",
                     "build.py")
H = W = 64
K = 17


def host_ms(fn, calls=50):
    import torch

    times = []
    for i in range(calls):
        if i % 10 == 0:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return 1e3 * statistics.median(times)


def main(argv):
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_port_decode_host_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke
    from single_person_pose_estimation_tpu_torch.ops.cuda import (
        bottleneck_kernel as bk,
        build,
        decode_kernel as dk,
    )

    spec = importlib.util.spec_from_file_location(
        "spe_other_build", os.path.join(os.path.abspath(argv[1]), BUILD))
    other = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(other)
    olib, tlib = other.lib(), build.lib()
    nine = len(other._SIGNATURES["spe_decode"]) == 9
    card = chip_smoke.card_line()
    dev = torch.device("cuda")
    maps = torch.from_numpy(chip_smoke.decode_inputs(
        np.random.default_rng(11), 128)).cuda()
    out = torch.empty((128, K, 3), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    thr = float(np.float32(1e-6))
    readings = {}
    for b in (1, 128):
        part = maps[:b]
        hp, op = part.data_ptr(), out.data_ptr()
        args = dk.decode_geometry(b, H, W, K, True)["args"]
        oargs = () if nine else args
        want = dk.decode_batch_plain(part)
        for name, lib, extra in (("other", olib, oargs), ("this", tlib, args)):
            err = lib.spe_decode(hp, op, b, H, W, K, thr, 1, *extra, stream)
            build.check(err, f"{name} decode")
            if not torch.equal(out[:b], want):
                raise AssertionError(f"{name}'s spe_decode is wrong at B={b}")
        cases = {
            f"other spe_decode B={b}": lambda: olib.spe_decode(
                hp, op, b, H, W, K, thr, 1, *oargs, stream),
            f"this spe_decode B={b}": lambda: tlib.spe_decode(
                hp, op, b, H, W, K, thr, 1, *args, stream),
            f"this decode_batch B={b}": lambda: dk.decode_batch(part),
            f"this decode_geometry B={b}": lambda: dk.decode_geometry(
                b, H, W, K, True),
            f"torch.empty B={b}": lambda: torch.empty((b, K, 3), device=dev),
            "current_stream": lambda: torch.cuda.current_stream(
                maps.device).cuda_stream,
            "_stream_ptr": lambda: bk._stream_ptr(maps.device),
        }
        for fn in cases.values():
            fn()
        for _ in range(20):
            for name, fn in cases.items():
                readings.setdefault(name, []).append(host_ms(fn))
    for name, rs in readings.items():
        q1, med, q3 = statistics.quantiles(rs, n=4)
        print(f"{name}: host ms a call median {med:.4f} (quartiles "
              f"{q1:.4f}, {q3:.4f}) over {len(rs)} rounds [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
