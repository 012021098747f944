"""Build and load the port's CUDA kernels.

`nvcc` compiles every `csrc/*.cu` of this package for `sm_90a` (Hopper) at
first use, one `nvcc` process per source, all started together, and links
the objects into one shared library with a plain C interface that `ctypes`
loads. No PyTorch header is included, so a build takes seconds. The
library goes into `_build/` beside the package sources (listed in
`.gitignore`) under a name that hashes the sources, so an edited kernel is
rebuilt and a finished build is reused. No source is compiled with
fast-math: the training kernels promise results within an ulp or two of
their plain versions.

Nothing here runs at import: the CPU tests import every module, and a CPU
host has neither `nvcc` nor a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_lib = None
_lock = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # mode, bf16, x, w1, w2, w3, vec, out, pooled, ulo, B, H, W, C, Cm, ts,
    # stream
    "spe_bottleneck": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                       _I, _I, _I, _I, _I, _I, _P],
    # mode, x, w1, w2, w3, vec, out, pooled, ulo, B, H, W, C, Cm, tsh, tsw,
    # ck, nt, nst, smem, stream
    "spe_bottleneck_tc": [_I] + [_P] * 8 + [_I] * 11 + [_P],
    # bf16, x, ws, w1, w2, w3, vec, out, B, H, W, Cin, C, Cm, ts, stream
    "spe_convskip": [_I] + [_P] * 7 + [_I] * 7 + [_P],
    # x, ws, w1, w2, w3, vec, out, B, H, W, Cin, C, Cm, tsh, tsw, ck, nt,
    # nst, smem, stream
    "spe_convskip_tc": [_P] * 7 + [_I] * 12 + [_P],
    # bf16, x, w1s, w2s, w3s, vecs, out, ws, B, H, C, Cm, depth, ws_image,
    # ts, stream
    "spe_subtree": [_I] + [_P] * 7 + [_I] * 5 + [ctypes.c_longlong, _I, _P],
    # x, w1s, w2s, w3s, vecs, out, ws, B, H, C, Cm, depth, ws_image, tsh,
    # tsw, ck, nt, nst, smem, stream
    "spe_subtree_tc": [_P] * 7 + [_I] * 5 + [ctypes.c_longlong] + [_I] * 6
                      + [_P],
    # mid, bf16, u, y, wh, wpT, w2, w3p, vec, pred, ynext, M, C, K, rows,
    # stream
    "spe_head": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                 _I, _I, _I, _I, _P],
    # mid, u, y, wh, wpp, w2, w3p, vec, pred, ynext, M, C, K, rows, ck, nt,
    # nst, smem, stream
    "spe_head_tc": [_I] + [_P] * 9 + [_I] * 8 + [_P],
    # kx, ky, kv, out, B, H, W, K, radius, 2 sigma^2, chunk, chunks, vec,
    # stream
    "spe_heatmap": [_P] * 4 + [_I] * 5 + [ctypes.c_float] + [_I] * 3 + [_P],
    # img, params, out, B, C, L, K, tx, gx, gy, stream
    "spe_resample": [_P, _P, _P] + [_I] * 7 + [_P],
    # mode, bf16, x, ulo, w1, d2, w2, w3, vec, out, pooled, B, H, W, C, Cm,
    # ts, stream
    "spe_mobile": [_I, _I] + [_P] * 9 + [_I] * 6 + [_P],
    # mode, x, ulo, w1, d2, w2, w3, vec, out, pooled, B, H, W, C, Cm, tsh,
    # tsw, ck, nt, nst, smem, stream
    "spe_mobile_tc": [_I] + [_P] * 9 + [_I] * 11 + [_P],
    # heatmaps, out, B, H, W, K, threshold, legacy, vec, lanes, groups,
    # cluster, smem, stream
    "spe_decode": [_P, _P, _I, _I, _I, _I, ctypes.c_float] + [_I] * 6
                  + [_P],
    # bf16, ks, pro, epi, x, a, pv, w, bias, aux, out, ws, sums, B, H, W, K,
    # N, stream
    "spe_train_unit": [_I] * 4 + [_P] * 9 + [_I] * 5 + [_P],
    # bf16, dz, a, ws, sums, R, C, stream
    "spe_train_reduce": [_I, _P, _P, _P, _P, _I, _I, _P],
    # bf16, ks, aff, dz, a, k, cin, aff, ws, out, B, H, W, Ci, Co, slices,
    # rows, stream
    "spe_train_dw": [_I] * 3 + [_P] * 7 + [_I] * 7 + [_P],
    # pro, x, a, pv, w, bias, aux, out, ws, sums, B, H, W, K, N, ni, th,
    # tw, ck, nt, nst, smem, stream
    "spe_train_unit3_tc": [_I] + [_P] * 9 + [_I] * 12 + [_P],
    # dz, a, kv, cin, aff, ws, out, B, H, W, Ci, Co, ni, th, tw, ti, to,
    # slices, per, smem, stream
    "spe_train_dw3_tc": [_P] * 7 + [_I] * 13 + [_P],
    # epi, dz, a, kv, w, aux, out, ws, sums, R, K, N, ck, nt, nst, na,
    # wres, smem, stream
    "spe_train_unit1_tc": [_I] + [_P] * 8 + [_I] * 9 + [_P],
    # pro, x, pv, w, bias, out, ws, sums, R, K, N, ck, nt, nst, wres, smem,
    # stream
    "spe_train_unit1_fwd_tc": [_I] + [_P] * 7 + [_I] * 8 + [_P],
    # aff, dz, a, kv, cin, affv, ws, out, R, Ci, Co, ti, to, slices, per,
    # nst, smem, stream
    "spe_train_dw1_tc": [_I] + [_P] * 7 + [_I] * 9 + [_P],
}


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libspe_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the kernels if no library for these sources exists yet.
    Returns the library's path; raises with nvcc's output on failure."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{f.stem}.o" for f in cu]
    cmds = [[_nvcc(), *NVCC_FLAGS, *(["-Xptxas=-v"] if verbose else []),
             "-I", str(CSRC), "-c", "-o", str(o), str(f)]
            for f, o in zip(cu, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        for cmd, p, text in zip(cmds, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                                   f"{' '.join(cmd)}\n{text}")
            if verbose:
                print(text)
        link = [_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp),
                *map(str, objs)]
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{' '.join(link)}\n{res.stdout}\n"
                               f"{res.stderr}")
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.spe_subtree_ws_elems.argtypes = [_I, _I, _I]
            handle.spe_subtree_ws_elems.restype = ctypes.c_longlong
            handle.spe_error_string.argtypes = [_I]
            handle.spe_error_string.restype = ctypes.c_char_p
            _lib = handle
        return _lib


def check(err: int, what: str):
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = lib().spe_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} at launch: {msg}")
