#!/usr/bin/env python3
"""Where the time goes inside the bf16 1x1 kernels.

    python3 scripts/torch_port_unit1_phases.py

Builds a copy of `csrc/bottleneck_train.cu` whose `unit1_tc_kernel` and
`dw1_tc_kernel` read `clock64()` around each phase of their main loop, and
runs them on one NVIDIA card at the fused step's 64 px shapes (B=64,
C=256, Cm=128, bf16): #14a's forward of unit 1 (256 -> 128) and of unit 3
(128 -> 256, with the affine), #14d's din with the next sums and its dW,
#14f's dx and its dW. For each it prints the device time (CUDA events
behind a sleep kernel, as `chip_smoke.kernel_device_ms`) and, averaged
over every warp of the launch, the cycles spent in each phase and their
share of the warp's whole loop:

  forward, din, dx: waiting for the stage's copies, the prologue (z or
           dy; none for unit 1's z = x), the stage barrier and the next
           stage's copies, the tensor-core products, the epilogue;
  dW:      waiting for the stage's copies, the prologues, the barrier and
           the next stage's copies, the tensor-core products.

The clock reads cost a little themselves, so the instrumented kernels run
slightly slower than the real ones (both times are printed).

It also builds a second copy whose `unit1_tc_kernel` walks its work items
chunk by chunk (all row tiles of output chunk 0, then of chunk 1) instead
of tile by tile, and times both orders on #14a's unit 3 and #14f's dx,
whose N / NT = 2 chunks read each input tile twice: in the kernel's order
the two reads of a tile come from two blocks of one wave, in the other
half a launch apart, long after the tile has left the 50 MB L2. The
difference is what the L2 saves the kernel's order.

The copies are built under `_build/phases/` and `_build/order/`
(gitignored) and the checkout's kernels are left as they are. It asserts
that each marker it edits is found once in the source: a change to those
loops must update the markers here.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLOTS = 6  # per warp: five phases and the whole loop

_DIN_PHASES = ("wait", "prologue", "barrier+issue", "mma", "epilogue")
_DW_PHASES = ("wait", "prologue", "barrier+issue", "mma")


def _store(names):
    idx = ("((size_t)(blockIdx.y * gridDim.x + blockIdx.x) * 8 + "
           "(threadIdx.x >> 5)) * 6")
    body = " ".join(f"g_phases[{idx} + {i}] = {n};"
                    for i, n in enumerate(names))
    return f"  if ((threadIdx.x & 31) == 0) {{ {body} }}\n"


_DIN_EDITS = (
    ("  float acc[2][kTcNt8][4];\n  for (int s = 0; s < nstage; ++s) {\n"
     "    const int t = blockIdx.x + (s / nkc) * gridDim.x, kc = s % nkc;",
     "  float acc[2][kTcNt8][4];\n"
     "  long long p0 = 0, p1 = 0, p2 = 0, p3 = 0, p4 = 0, c4 = 0, "
     "c00 = clock64();\n  for (int s = 0; s < nstage; ++s) {\n"
     "    const int t = blockIdx.x + (s / nkc) * gridDim.x, kc = s % nkc;"),
    ("    mma::cp_async_wait_n(NST - 2);  // this thread's copies of stage s\n"
     "    bf16* ds = slot(s);\n    if (PRO != kProNone && mlim) {",
     "    const long long c0 = clock64();\n"
     "    mma::cp_async_wait_n(NST - 2);\n"
     "    const long long c1 = clock64(); p0 += c1 - c0;\n"
     "    bf16* ds = slot(s);\n    if (PRO != kProNone && mlim) {"),
    ("    // Stage s's dy or z (the B operand, the aux tile) are visible; every\n",
     "    const long long c2 = clock64(); p1 += c2 - c1;\n"),
    ("    issue(s + NST - 1);\n    const bf16* wb",
     "    issue(s + NST - 1);\n"
     "    const long long c3 = clock64(); p2 += c3 - c2;\n    const bf16* wb"),
    ("    if (kc != nkc - 1) continue;\n",
     "    c4 = clock64(); p3 += c4 - c3;\n    if (kc != nkc - 1) continue;\n"),
    ("  }\n  if (!kSums) return;\n",
     "    p4 += clock64() - c4;\n  }\n"
     + _store(("p0", "p1", "p2", "p3", "p4", "clock64() - c00"))
     + "  if (!kSums) return;\n"),
)

_DW_EDITS = (
    ("  for (int s = 0; s < nstage; ++s) {\n"
     "    mma::cp_async_wait_n(NST - 2);  // this thread's copies of stage s\n",
     "  long long p0 = 0, p1 = 0, p2 = 0, p3 = 0, c00 = clock64();\n"
     "  for (int s = 0; s < nstage; ++s) {\n"
     "    const long long c0 = clock64();\n"
     "    mma::cp_async_wait_n(NST - 2);\n"
     "    const long long c1 = clock64(); p0 += c1 - c0;\n"),
    ("    // Stage s's dy and z are visible; every warp is done with stage s - 1,\n",
     "    const long long c2 = clock64(); p1 += c2 - c1;\n"),
    ("    issue(s + NST - 1);\n    const bf16* ds = slot(s);\n",
     "    issue(s + NST - 1);\n"
     "    const long long c3 = clock64(); p2 += c3 - c2;\n"
     "    const bf16* ds = slot(s);\n"),
    ("      }\n    }\n  }\n  float* dst = part + (size_t)blockIdx.y * L;\n",
     "      }\n    }\n    p3 += clock64() - c3;\n  }\n"
     + _store(("p0", "p1", "p2", "p3", "0", "clock64() - c00"))
     + "  float* dst = part + (size_t)blockIdx.y * L;\n"),
)


# Work item t as output chunk t / ntiles of row tile t % ntiles.
_ORDER_EDITS = (
    ("  const int nwork = (R + kTcM - 1) / kTcM * nch;\n",
     "  const int nwork = (R + kTcM - 1) / kTcM * nch;\n"
     "  const int ntl = (R + kTcM - 1) / kTcM;\n"),
    ("const int row0 = t / nch * kTcM, col0 = t % nch * NT + wc0;",
     "const int row0 = t % ntl * kTcM, col0 = t / ntl * NT + wc0;"),
    ("    const int nc = t % nch;\n", "    const int nc = t / ntl;\n"),
    ("    const int row0 = t / nch * kTcM;\n",
     "    const int row0 = t % ntl * kTcM;\n"),
)
_UNIT1 = ("unit1_tc_kernel(const bf16*", "// The 1x1 weight gradient dW")
_LAUNCH = "template <int PRO, int EPI>\ncudaError_t launch_unit1_tc"


def _edit(text, start, end, edits):
    a, b = text.index(start), text.index(end)
    body = text[a:b]
    for old, new in edits:
        if body.count(old) != 1:
            raise AssertionError(f"phase marker not found once: {old!r}")
        body = body.replace(old, new)
    return text[:a] + body + text[b:]


def instrumented_source(src: str) -> str:
    src = _edit(src, *_UNIT1, _DIN_EDITS)
    src = _edit(src, _UNIT1[1], _LAUNCH, _DW_EDITS)
    src = src.replace("namespace spe {\nnamespace train {",
                      "namespace spe {\nnamespace train {\n"
                      f"__device__ long long g_phases[1024 * 8 * {SLOTS}];", 1)
    size = f"sizeof(long long) * 1024 * 8 * {SLOTS}"
    return src + (
        '\nextern "C" int spe_read_phases(long long* host) {\n'
        f"  return (int)cudaMemcpyFromSymbol(host, spe::train::g_phases, {size});\n"
        '}\nextern "C" int spe_clear_phases() {\n'
        "  void* p = nullptr;\n"
        "  cudaError_t err = cudaGetSymbolAddress(&p, spe::train::g_phases);\n"
        f"  return (int)(err != cudaSuccess ? err : cudaMemset(p, 0, {size}));\n}}\n")


def chunk_major_source(src: str) -> str:
    return _edit(src, *_UNIT1, _ORDER_EDITS)


def build_copies():
    """The instrumented copy and the chunk-major copy, compiled together:
    (phases library, order library)."""
    from single_person_pose_estimation_tpu_torch.ops.cuda import build

    src = (build.CSRC / "bottleneck_train.cu").read_text()
    jobs = []
    for name, text in (("phases", instrumented_source(src)),
                       ("order", chunk_major_source(src))):
        out = build.BUILD_DIR / name
        out.mkdir(parents=True, exist_ok=True)
        for h in build.CSRC.glob("*.cuh"):
            shutil.copy(h, out)
        (out / "bottleneck_train.cu").write_text(text)
        lib = out / f"lib{name}.so"
        jobs.append((lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-I", str(out),
             "-o", str(lib), str(out / "bottleneck_train.cu")])))
    handles = []
    for lib, proc in jobs:
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for {lib}")
        handle = ctypes.CDLL(str(lib))
        for name in ("spe_train_unit1_tc", "spe_train_unit1_fwd_tc",
                     "spe_train_dw1_tc"):
            fn = getattr(handle, name)
            fn.argtypes = build._SIGNATURES[name]
            fn.restype = ctypes.c_int
        handles.append(handle)
    handles[0].spe_read_phases.argtypes = [ctypes.c_void_p]
    return handles


def main() -> int:
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("torch_port_unit1_phases: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from single_person_pose_estimation_tpu_torch.ops.cuda import (
        bottleneck_train_kernel as tk,
    )

    card = cs.card_line()
    lib, order = build_copies()
    real = tk.build.lib()
    b, h, bf = cs.B_TRAIN, 64, torch.bfloat16
    p = cs.train_unit_inputs(np.random.default_rng(31), bf, "cuda", b, h)
    rows, stream = b * h * h, tk._stream(p["g"])
    host = np.zeros(1024 * 8 * SLOTS, np.int64)

    def din(which, epi, dz, a, k, w, aux, n):
        K = dz.shape[-1]
        pl = tk.unit1_plan(b, h, h, K, n, epi)
        kv = tk._vec(k, 3 * K, "cuda")
        wt = w.to(bf).T.contiguous()
        out = torch.empty((b, h, h, n), dtype=bf, device="cuda")
        ws = torch.empty((tk.MAX_PARTS, 2 * n), device="cuda")
        sums = torch.empty((2, n), device="cuda")
        return lambda: which.spe_train_unit1_tc(
            epi, dz.data_ptr(), a.data_ptr(), kv.data_ptr(), wt.data_ptr(),
            aux.data_ptr(), out.data_ptr(), ws.data_ptr(), sums.data_ptr(),
            rows, K, n, pl["ck"], pl["nt"], pl["nst"], pl["na"],
            int(pl["wres"]), pl["smem"], stream), pl["work"]

    def fwd(which, x, w, bias, aff, n):
        K = x.shape[-1]
        pl = tk.unit1_plan(b, h, h, K, n, tk.EPI_RELU_STATS)
        pv = None if aff is None else tk._vec(aff, 2 * K, "cuda")
        wb = w.to(bf).contiguous()
        bv = tk._vec(bias, n, "cuda")
        out = torch.empty((b, h, h, n), dtype=bf, device="cuda")
        ws = torch.empty((tk.MAX_PARTS, 2 * n), device="cuda")
        sums = torch.empty((2, n), device="cuda")
        return lambda: which.spe_train_unit1_fwd_tc(
            int(aff is not None), x.data_ptr(),
            0 if pv is None else pv.data_ptr(), wb.data_ptr(),
            bv.data_ptr(), out.data_ptr(), ws.data_ptr(), sums.data_ptr(),
            rows, K, n, pl["ck"], pl["nt"], pl["nst"], int(pl["wres"]),
            pl["smem"], stream), pl["work"]

    def dw(which, dz, a, k, cin, aff):
        Co, Ci = dz.shape[-1], cin.shape[-1]
        pl = tk.dw1_plan(b, h, h, Ci, Co)
        kv = tk._vec(k, 3 * Co, "cuda")
        affv = None if aff is None else tk._vec(aff, 2 * Ci, "cuda")
        out = torch.empty(pl["length"], device="cuda")
        ws = torch.empty(pl["workspace"], device="cuda")
        return lambda: which.spe_train_dw1_tc(
            int(aff is not None), dz.data_ptr(), a.data_ptr(), kv.data_ptr(),
            cin.data_ptr(), 0 if affv is None else affv.data_ptr(),
            ws.data_ptr(), out.data_ptr(), rows, Ci, Co, pl["ti"], pl["to"],
            pl["slices"], pl["per"], pl["nst"], pl["smem"],
            stream), pl["ctiles"] * pl["slices"]

    unit3 = lambda L: fwd(L, p["a2"], p["w3"], p["b3"], p["aff2"], cs.C)
    dx = lambda L: din(L, tk.EPI_DIN_SKIP, p["dz1"], p["a1"], p["k1"],
                       p["w1"], p["g"], cs.C)
    cases = (
        ("#14a unit 1 (unit1_tc_kernel<0, 0, true>)", _DIN_PHASES,
         lambda L: fwd(L, p["x"], p["w1"], p["b1"], None, cs.CM)),
        ("#14a unit 3 (unit1_tc_kernel<1, 0, true>)", _DIN_PHASES, unit3),
        ("#14d din (unit1_tc_kernel<2, 2, true>)", _DIN_PHASES,
         lambda L: din(L, tk.EPI_DIN_SUMS, p["g"], p["a3"], p["k3"],
                       p["w3"], p["a2"], cs.CM)),
        ("#14d dW (dw1_tc_kernel<true, true>)", _DW_PHASES,
         lambda L: dw(L, p["g"], p["a3"], p["k3"], p["a2"], p["aff2"])),
        ("#14f dx (unit1_tc_kernel<2, 3, true>)", _DIN_PHASES, dx),
        ("#14f dW (dw1_tc_kernel<false, true>)", _DW_PHASES,
         lambda L: dw(L, p["dz1"], p["a1"], p["k1"], p["x"], None)),
    )
    for label, phases, make in cases:
        fn, _ = make(real)
        ms = cs.kernel_device_ms(lambda: tk.build.check(fn(), label), label)
        fn, blocks = make(lib)
        tk.build.check(lib.spe_clear_phases(), "clear")
        ms_i = cs.kernel_device_ms(lambda: tk.build.check(fn(), label), label)
        tk.build.check(lib.spe_read_phases(host.ctypes.data), "read")
        per = host.reshape(1024, 8, SLOTS)[:min(blocks, 1024)]
        per = per.reshape(-1, SLOTS).astype(np.float64)
        per = per[per[:, 5] > 0]                 # warps that ran the loop
        whole = per[:, 5].mean()
        shares = ", ".join(f"{name} {per[:, i].mean():.0f} "
                           f"({per[:, i].mean() / whole:.1%})"
                           for i, name in enumerate(phases))
        print(f"{label} bf16 B={b} {h} px: device {ms:.4f} ms "
              f"(instrumented {ms_i:.4f} ms); cycles per warp {whole:.0f}: "
              f"{shares} [{card}]")
    # The two orders of work items, in turns: the kernel's, chunk-major,
    # chunk-major, the kernel's; each a median of kernel_device_ms.
    for label, make in (("#14a unit 3", unit3), ("#14f dx", dx)):
        fns = {"tile-major": make(real)[0], "chunk-major": make(order)[0]}
        ms = {k: [] for k in fns}
        for k in ("tile-major", "chunk-major", "chunk-major", "tile-major"):
            ms[k].append(cs.kernel_device_ms(
                lambda f=fns[k]: tk.build.check(f(), label), label))
        t, c = (float(np.mean(ms[k])) for k in ("tile-major", "chunk-major"))
        print(f"{label} bf16 B={b} {h} px, two output chunks per row tile: "
              f"device {t:.4f} ms in the kernel's tile-major order "
              f"{[round(v, 4) for v in ms['tile-major']]}, {c:.4f} ms "
              f"chunk-major {[round(v, 4) for v in ms['chunk-major']]}; "
              f"the L2 saves {c - t:.4f} ms ({(c - t) / c:.1%}) [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
