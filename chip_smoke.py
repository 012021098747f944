#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths through its nineteen hand-written CUDA kernels and
checks every phase: single-crop inference with the S4/256 model served
by `PoseServer` (four kernels and the decode kernel), the same forward
with the `fuse_front` and `fuse_bottom` dials (the conv-skip and subtree
kernels) and the row-blocked bottleneck at 128 px, the same with the
mobile S4/256 model (the three mobile kernels, the head kernel and the
decode kernel), evaluation from TFRecords by `predict_ds` (standard and
mobile), S4/256 training by `Trainer` (the warp and heatmap kernels), and
S4/256 training with `model_backend="fused"` (the six train-unit kernels),
and then the entry points a user calls: the CLI's train, resume, eval,
serve (over a glob and over HTTP) and export, the two-stage demo and the
profiler, data parallel over a mesh (evaluation, serving, training in
two processes over gloo, and the CLI's training over NCCL), tensor
parallelism over channels in two processes, and H-sharded inference at
1024x1024 over two devices. It imports
nothing of JAX or of the JAX package. Phases, each raising on
failure:

1. card: require CUDA; print the card's name and power limit (nvidia-smi);
2. build: compile the kernels from `single_person_pose_estimation_tpu_torch/
   csrc` with nvcc and print the build time;
3. kernels: each kernel against its plain PyTorch version at the main
   path's shapes (batch 8), #1-#3 at the bf16 body's contract edges
   (BNECK_EDGES) and the head, mid and last, at HEAD_EDGES (batch 11 at
   12 px; 32, 64, 512 and 1024 channels; 4 px), in float32 and bfloat16,
   each run twice for the same bits; then decode_kernel:
   the decode kernel against its plain version at batch 128, 64x64x17
   float32, legacy and corrected, on random, peaked, tied and border maps
   and on S4/256 bf16 heatmaps (kernel path and plain model), and at
   DECODE_EDGES (batch 1, 3, 16 and 128; K = 1, 16, 17, 33, 543 and 544;
   non-square maps, H*W*K not a multiple of 4, a base off 16 bytes,
   blocks of 543 threads and 86,880 bytes of shared memory, alone and in
   clusters of 4), exactly, each run twice for the same bits;
4. golden: the fused path with kernels at float32 against the TF reference
   outputs in `tests/fixtures/golden_ref_s2c32.npz`;
5. slice: S4/256 from `init_variables(seed=0)`, served by
   `PoseServer(device="cuda")` in bfloat16; launch counters must equal the
   launches the served forwards and decodes imply; then the kernel path
   against the plain model at batch 8, as it is and on a copy whose last
   predict conv is scaled so that no heatmap value saturates
   (`scaled_readings`: f32 within TOL_F32, the North star's 1e-4, and
   TOL_S4_F32_MEAN, bf16 within S4_BF16_FACTOR times the plain bf16
   model's distance from plain f32);
6. times: S4/256 forward img/s at batch 128 with the kernels and with the
   plain model, and each kernel's time (per call and on the device alone)
   beside its plain version's and the plain cuDNN bf16 model's own block
   at the same shape (the library yardstick: for #1-#3 its bottlenecks,
   for #4 its mid-stack head);
7. trace: torch.profiler over 3 forwards of each path at batch 128: device
   busy time, span and idle share, the device time of each kernel, and
   the device ms per forward of #1-#4 over every shape (no bf16 FMA
   bottleneck or head may run);
7'. dial_kernels: the conv-skip bottleneck (#6) at 64 px, 128 -> 256
   channels, the subtree (#7) at depths 1, 2 and 3 (8, 16 and 32 px
   inputs) and the row-blocked bottleneck (#5) at 128 px, C=256, batch 8,
   #6 at CONVSKIP_EDGES (batch 11, a ragged 12 px map, 4 px, Cin/C from
   32/64 to 512/1024, 1024/1024 and 48/32) and #7 at 512 and 1024
   channels, against their plain versions in float32 and bfloat16, each
   run twice for the same bits (#7 in bfloat16 as SUBTREE_ULP_FACTOR
   says);
   dial_slice: S4/256 bf16 at batch 128 through `fused_apply` with the
   main flags plus `fuse_front`, and plus `fuse_bottom` = 1, 2 and 3, with
   exact launch counts (`dial_want`) and finite heatmaps, then at float32
   and batch 8 each dial's last stack against the main flags' kernel path,
   and the `fuse_front` path on the unsaturated copy (`scaled_readings`);
   dial_times: the forward's img/s with each dial (median of 10,
   alternating), the `fuse_front` forward traced once (no bf16 FMA body,
   whole launches a forward, #6's device ms a forward), #5-#7 beside their
   plain versions, bounds and the plain bf16 model's own blocks (#6
   front_bottleneck_3, #7 its walk; #5 at 128 px against the plain bf16
   bottleneck, cuDNN convs, in turns);
7''. spatial: `parallel/spatial_model.spatial_apply` of S4/256 at
   1024x1024 with its large maps split by rows over [cuda:0, cuda:0]
   against the plain forward, on a copy whose last predict conv is scaled
   so that no heatmap saturates: f32 within 1e-4 on every stack, bf16
   within SP_BF16_FACTOR of the plain bf16 control; its ms beside the
   plain forward's; no kernel launch (it runs cuDNN's convs, as JAX's
   runs no Pallas kernel);
7'''. s2d_remat: the model's dials on S4/256: `front_s2d` on the kernel
   path (#1-#4, with `fuse_front` also #6; exact launches) and on the
   plain model at B=128 bf16, within S4_BF16_FACTOR of the plain bf16
   control, the f32 front's output within 1e-5 (relative L2); `remat`
   True and "conv_out" in an f32 train step at B=16 against remat=False
   (loss within 1e-6, grads within the one-ulp control, running
   statistics bit for bit), with each mode's peak memory and step ms;
   `mobile_depthwise` "dense"/"taps" against "conv" on the plain mobile
   model; the weight import's TensorFlow gap is logged;
7a. mobile_kernels: the mobile kernels (#8-#10) against their plain
   versions at batch 8, C=256, at every level the mobile path runs them:
   #8 at 64 and 4 px, #9 at 32, 16 and 8 px, #10 at 64, 32, 16 and 8 px,
   and at MOBILE_EDGES (batch 11; 32, 64, 512 and 1024 channels; 4 and 12
   px; the up-add at 8 px), float32 and bfloat16, each run twice for the
   same bits;
7b. mobile_golden: the fused mobile path with the kernels at float32
   against `tests/fixtures/golden_ref_s1c32_mobile.npz`;
7c. mobile_slice: mobile S4/256 from `init_variables(seed=0, mobile=True)`
   (5,818,564 parameters) served by `PoseServer(device="cuda")` in
   bfloat16, with launch counts equal to what the forwards imply; then the
   kernel path against the plain mobile model on a copy whose last predict
   conv is scaled so that no heatmap value saturates (`scaled_readings`);
7d. mobile_times: mobile S4/256 forward img/s at batch 128 with the kernels
   and with the plain mobile model, the device idle share of 3 forwards of
   each, the device ms per forward of #8-#10 and #4 (no bf16 FMA mobile or
   head body may run), and each mobile kernel's time beside its plain
   version's and the plain mobile model's own block (the library
   yardstick);
8. eval: a synthetic COCO split of 1,024 person crops at 256x256 (and 256
   training crops) written to TFRecords by the port's ETL and read back by
   its native reader; an S4/256 checkpoint restored with
   `load_model_from_checkpoint`, BN recalibrated over 2 training batches
   from the records; `predict_ds` plain and with flip-TTA at batch 128
   with exact launch counts, predictions equal to those of the plain
   decode, keypoints finite and inside their boxes, the record fields
   exact, 10 finite OKS stats and one PCK per label;
9. eval_times: records-to-predictions img/s (median of 3), its split
   (host parse, forward, decode), the device idle share of one pass, and
   the decode kernel beside its plain version at batch 128 (maps in L2
   and after an L2 scrub), and at batch 1 and 16 (in L2, as a served
   step finds them);
9a. mobile_eval: one `predict_ds` pass of mobile S4/256 over the same
   records, with exact launch counts and predictions equal to those of
   the plain decode;
10. train_kernels: the warp kernel (both passes, bit for bit) and the
   heatmap kernel against their plain versions at batch 64, 256x256x3 and
   64x64x17, f32,
   with flips, scales that push samples off the edge, and keypoints on the
   border, negative and invisible; the heatmap kernel also at
   HEATMAP_EDGES (batch 1, K = 1, 16, 17 at 32 px and sigma 2, W*K not a
   multiple of 4, non-square, rows of 9,100 floats, 4,099 keypoints, a
   window of 96 px),
   each run twice for the same bits;
11. train: S4/256, bf16 compute and f32 params from `init_variables(seed=0)`,
   trained by `Trainer` for 2 epochs of 3 steps at batch 64 on synthetic
   crops with augmentation, then resumed by a new `Trainer` for 1 epoch;
   the launch counts must equal what the steps imply, every loss must be
   finite and the restored state must equal the saved one; then 20 steps
   on one fixed batch without augmentation must bring the loss down;
12. train_times: train-step img/s at batch 64 and its split (augment,
   targets, fwd+bwd+Adam), a torch.profiler trace of two train steps
   (busy, span, idle share, top kernels), the warp on each backend, and
   each training kernel beside its plain version (per call, and on the
   device alone, as it comes and after an L2 scrub that writes and one
   that reads), and `zero_()` of the heatmap kernel's output;
13. fused_train_kernels: the six train-unit kernels (#14a-f) against their
   plain versions at batch 8 and 64, C=256, Cm=128, at every level (64,
   32, 16, 8, 4 px), float32 and bfloat16, each run twice for the same
   bits; at 64 px the cuda bottleneck backend against the plain one
   (forward, backward on the same residuals, and end to end through
   autograd); then the 3x3 units (#14b, #14e) and the 1x1 units (#14a,
   #14d, #14f), in bfloat16 on the tensor cores, at the contract's edges,
   UNIT3_EDGES and UNIT1_EDGES;
14. fused_train: S4/256 bf16 at batch 64 through
   `make_train_step(model_backend="fused")`, 3 augmented steps with finite
   losses and exact launch counts (per step 120/60/60/60/60/60 calls of
   #14a-f times each wrapper's launches per call, 2 warp, 1 heatmap, every
   other kernel 0); 20 steps on one fixed batch must bring the loss down;
   at float32 and batch 16 one fused step against one default step from
   the same state (loss, grads, running statistics);
15. fused_train_times: the fused step against the default step (median of
   5 runs of 2 steps, alternating), the fused step's device busy time and
   idle share with the per-step time of the 3x3 forward, din and dW
   kernels and of the 1x1 forward (both forms), din, dx and dW kernels
   (and no bfloat16 FMA unit body in the trace), and #14a-f at the 64 px
   shapes of batch 64 beside their plain versions, bounds and a library
   yardstick the port never calls;
16. cli_train: the entry points a user calls, through `cli.main` with
   `--set` overrides and `--device cuda`, on S4/256 bf16 at batch 64:
   `gen-records` over a new `eval_dataset`, `train` for one epoch (4
   augmented steps, 16 valid steps) and `resume` to epoch 2, with exact
   launch counts of the warp and heatmap kernels, checkpoints [1, 2] and a
   best, and the Trainer's meta;
17. cli_eval: `cli eval --latest --save-path` (no --report) with exact
   launch counts of #1-#4 and #13, its predictions equal to an in-process
   `predict_ds` on the same checkpoint;
18. cli_serve: `cli serve --images GLOB` (8 images, one bucket of 16)
   equal to an in-process `PoseServer`; then `python -m ...cli serve
   --http 0` as a child process: 8 concurrent JPEG POSTs and one raw
   float32 POST equal to the in-process `HttpPoseService`'s answers,
   /stats counting 9 served (its p50/p99 printed), exit code 0 after
   SIGINT;
19. cli_export: `cli export --artifact --savedmodel`: the artifact's
   predict equal to the plain model, the `torch.export` program at batch
   8 and 3 (EXPORT_BATCHES) within S4_BF16_FACTOR of the plain bf16 model's distance from
   plain f32;
20. demo: `Demo.detect` with a stub detector (three boxes on a 480x640
   image, one partly outside): crops within TOL_CROP of `crop_and_resize`
   on the CPU, keypoints equal to `forward_last_stack` plus the decode on
   its own crops, one forward's launches; `webcam.run_on_video` over a
   short synthetic video where matplotlib, which its overlay needs, is
   installed (the card's machine has none; the CPU tests run it);
21. profiling: one served batch inside `utils/profiling.trace` and an
   `annotate("serve")` span; the Chrome trace must hold the span and the
   kernels of #1-#4 and #13;
22. dp_eval (after mobile_eval, on its records): `predict_ds` over a mesh
   of two replicas on cuda:0 (`parallel.mesh.create_mesh`), 64 rows a
   replica, with exact launch counts and predictions equal to the pass
   without a mesh;
23. dp_serve: `PoseServer` over the same mesh (buckets rounded up to
   multiples of 2) against `PoseServer(device="cuda")` on 128 crops, one
   step of 128 each: the same keypoints, exact launch counts;
24. dp_train (after fused_train_times): two child processes (`python3
   chip_smoke.py --dp-child train DIR`, torchrun's environment) on cuda:0
   over gloo, S4/256 through `make_train_step(mesh=)`: at f32 one step of
   each backend at a global batch of 16 against one process on the
   concatenated batch (loss; grads and running statistics within
   ULP_FACTOR of the larger of a one-ulp and a batch-order control); at
   bf16 on a global batch of 64, 3 steps of each backend on the batch as
   it is (a falling loss) and 3 augmented, the same bits on both ranks
   after every step; exact launches per rank;
24'. tp_train (after dp_train): two child processes (`--dp-child tp`) on
   cuda:0 over gloo, a ("data", "model") mesh of 1 x 2, S4/256 sharded by
   `parallel/sharding_rules.shard_state`: at f32 one step of each backend
   at dp_train's batch of 16 against dp_train's one process (loss; the
   reassembled grads and running statistics within ULP_FACTOR of the
   larger control); at bf16 TP_FIXED_STEPS steps of each backend at
   batch 8 on the batch as it is (a falling loss), then
   TP_AUGMENTED_STEPS augmented, the
   replicated leaves the same bits on both ranks after every step; the
   ranks' checkpoint restored unsharded bit for bit; exact launches per
   rank (`tp_fused_want`);
24''. pipeline (after tp_train): the GPipe pipeline of S4/256 over a
   ("pipe",) mesh of [cuda:0] * 4: the eval forward at B=32, M=4 against
   the sequential plain forward (f32 within 1e-4 on the same
   microbatches, bf16 within S4_BF16_FACTOR of the plain bf16 control); 3
   bf16 train steps at B=16, M=4 with augmentation (#11 twice and #12
   once a step, exact; a falling loss); one f32 step at M=1 against
   dp_train's one process (grads and statistics within ULP_FACTOR of its
   controls); the merged variables through CheckpointManager into a
   StackedHourglass, every tensor equal; two child processes (`--dp-child
   pp`) over a ("data", "pipe") mesh of 2 x 2 on cuda:0, one f32 step at
   B=8 against one process; pipelined and sequential ms (readings);
25. dp_nccl (after cli_train, on its records): `cli train --data-parallel`
   for 2 steps in a child process that joined a process group of one over
   NCCL, with exact launch counts and a checkpoint.
Every child process has DP_CHILD_TIMEOUT; one that fails or hangs fails
its phase.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import copy
import importlib.util
import itertools
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
B_CHECK = 8      # batch of the per-kernel checks
B_TIME = 128      # batch of the timings
C, CM, K = 256, 128, 17
S4_PARAMS = 13_784_260
S4_MOBILE_PARAMS = 5_818_564
# Tolerances. f32 with TF32 off: the kernel and the plain version differ
# only in the order of float32 sums over <= 9*128 terms of size ~1, so
# 1e-4 is ~100x the expected error. bf16: both sum in float32, but one
# ulp of bf16 (2^-8 relative) flips where a float32 sum lands on a
# rounding boundary, and a flipped t1/t2 value propagates through the
# next product; 1.6e-2 * max(1, |plain|) is two bf16 ulps at the output's
# scale. pred is float32 after a sigmoid (slope <= 1/4) of a sum over
# rounded head values: 1e-2.
TOL_F32 = 1e-4
TOL_BF16_REL = 1.6e-2
TOL_PRED_BF16 = 1e-2
TOL_GOLDEN = 1e-4
TOL_S4_F32_MAX = 1e-2     # see phase_slice
TOL_S4_F32_MEAN = 1e-5
S4_BF16_FACTOR = 2.0      # of the plain bf16 control; see phase_slice

REPLACES = {
    "fused_bottleneck":
        "single_person_pose_estimation_tpu/ops/pallas/bottleneck_kernel.py:101",
    "fused_bottleneck_pool":
        "single_person_pose_estimation_tpu/ops/pallas/bottleneck_kernel.py:292",
    "fused_uplevel":
        "single_person_pose_estimation_tpu/ops/pallas/uplevel_kernel.py:82",
    "fused_head":
        "single_person_pose_estimation_tpu/ops/pallas/head_kernel.py:76",
    "resample_last_axis":
        "single_person_pose_estimation_tpu/ops/pallas/warp_kernel.py:78",
    "render_heatmaps_batch":
        "single_person_pose_estimation_tpu/experimental/heatmap_kernel.py:61",
    "decode_batch":
        "single_person_pose_estimation_tpu/experimental/decode_kernel.py:104",
    "fused_bottleneck_mobile":
        "single_person_pose_estimation_tpu/ops/pallas/mobile_kernel.py:124",
    "fused_bottleneck_mobile_pool":
        "single_person_pose_estimation_tpu/ops/pallas/mobile_kernel.py:154",
    "fused_uplevel_mobile":
        "single_person_pose_estimation_tpu/ops/pallas/mobile_kernel.py:189",
    **{name: "single_person_pose_estimation_tpu/experimental/"
             f"bottleneck_train_kernel.py:{line}"
       for name, line in (("conv1x1_relu_stats", 72),
                          ("conv3x3_relu_stats", 144),
                          ("bn_bwd_reduce", 219), ("unit1x1_bwd", 286),
                          ("unit3x3_bwd", 373), ("unit1_bwd", 433))},
    "fused_bottleneck_convskip":
        "single_person_pose_estimation_tpu/ops/pallas/bottleneck_kernel.py:383",
    "fused_subtree":
        "single_person_pose_estimation_tpu/ops/pallas/bottom_kernel.py:119",
    "fused_bottleneck_rows":
        "single_person_pose_estimation_tpu/ops/pallas/bottleneck_kernel.py:196",
}
SOURCES = {
    "fused_bottleneck": "single_person_pose_estimation_tpu_torch/csrc/bottleneck.cu",
    "fused_bottleneck_pool": "single_person_pose_estimation_tpu_torch/csrc/bottleneck.cu",
    "fused_uplevel": "single_person_pose_estimation_tpu_torch/csrc/bottleneck.cu",
    "fused_head": "single_person_pose_estimation_tpu_torch/csrc/head.cu",
    "resample_last_axis": "single_person_pose_estimation_tpu_torch/csrc/warp.cu",
    "render_heatmaps_batch":
        "single_person_pose_estimation_tpu_torch/csrc/heatmap.cu",
    "decode_batch": "single_person_pose_estimation_tpu_torch/csrc/decode.cu",
    **dict.fromkeys(("fused_bottleneck_mobile", "fused_bottleneck_mobile_pool",
                     "fused_uplevel_mobile"),
                    "single_person_pose_estimation_tpu_torch/csrc/mobile.cu"),
    **dict.fromkeys(("conv1x1_relu_stats", "conv3x3_relu_stats",
                     "bn_bwd_reduce", "unit1x1_bwd", "unit3x3_bwd",
                     "unit1_bwd"),
                    "single_person_pose_estimation_tpu_torch/csrc/"
                    "bottleneck_train.cu"),
    "fused_bottleneck_convskip":
        "single_person_pose_estimation_tpu_torch/csrc/bottleneck.cu",
    "fused_subtree": "single_person_pose_estimation_tpu_torch/csrc/bottom.cu",
    "fused_bottleneck_rows":
        "single_person_pose_estimation_tpu_torch/csrc/bottleneck.cu",
}


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=10, warmup=2):
    """Mean device time of fn() in ms over `iters` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# Kernel inputs, made with numpy from a seed.
# ---------------------------------------------------------------------------

def bneck_params(rng, dtype, device, c=C):
    from single_person_pose_estimation_tpu_torch.ops.cuda.bottleneck_kernel import (
        BottleneckParams,
        bn_affine,
    )
    import torch

    def u(lo, hi, *shape):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32))

    cm = c // 2
    lim1, lim2 = np.sqrt(6 / (c + cm)), np.sqrt(6 / (18 * cm))
    affs = [bn_affine(u(.5, 1.5, n), u(-.3, .3, n), u(-.5, .5, n),
                      u(.5, 1.5, n)) for n in (cm, cm, c)]
    return BottleneckParams.pack(
        u(-lim1, lim1, c, cm), u(-.1, .1, cm), u(-lim2, lim2, 3, 3, cm, cm),
        u(-.1, .1, cm), u(-lim1, lim1, cm, c), u(-.1, .1, c),
        *affs[0], *affs[1], *affs[2], dtype=dtype, device=device)


def head_params(rng, last, dtype, device, c=C):
    from single_person_pose_estimation_tpu_torch.ops.cuda.head_kernel import (
        HeadParams,
    )
    import torch

    def u(lo, hi, *shape):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32))

    lim = np.sqrt(6 / (2 * c))
    glue = {} if last else dict(w2=u(-lim, lim, c, c), b2=u(-.1, .1, c),
                                w3=u(-.3, .3, K, c), b3=u(-.1, .1, c))
    return HeadParams.pack(u(-lim, lim, c, c), u(-.1, .1, c), u(.5, 1.5, c),
                           u(-.3, .3, c), u(-.2, .2, c, K), u(-.1, .1, K),
                           **glue, dtype=dtype, device=device)


def nhwc(rng, b, h, dtype, device, c=C):
    import torch

    x = rng.uniform(-1, 1, (b, h, h, c)).astype(np.float32)
    return torch.from_numpy(x).to(device=device, dtype=dtype)


def kernel_cases(rng, dtype, device, b):
    """(name, kernel call, plain call) at every main-path shape."""
    from single_person_pose_estimation_tpu_torch.ops.cuda import (
        bottleneck_kernel as bk,
        head_kernel as hk,
        uplevel_kernel as uk,
    )

    cases = []
    for h in (64, 4):
        x, p = nhwc(rng, b, h, dtype, device), bneck_params(rng, dtype, device)
        cases.append((f"fused_bottleneck@{h}", "fused_bottleneck",
                      lambda x=x, p=p: bk.fused_bottleneck(x, p),
                      lambda x=x, p=p: bk.fused_bottleneck_plain(x, p)))
    for h in (32, 16, 8):
        x, p = nhwc(rng, b, h, dtype, device), bneck_params(rng, dtype, device)
        cases.append((f"fused_bottleneck_pool@{h}", "fused_bottleneck_pool",
                      lambda x=x, p=p: bk.fused_bottleneck_pool(x, p),
                      lambda x=x, p=p: bk.fused_bottleneck_pool_plain(x, p)))
    for h in (64, 32, 16, 8):
        f, lo = nhwc(rng, b, h, dtype, device), nhwc(rng, b, h // 2, dtype,
                                                      device)
        ps = bneck_params(rng, dtype, device)
        pm = bneck_params(rng, dtype, device)
        cases.append((f"fused_uplevel@{h}", "fused_uplevel",
                      lambda f=f, lo=lo, ps=ps, pm=pm:
                          uk.fused_uplevel(f, lo, ps, pm),
                      lambda f=f, lo=lo, ps=ps, pm=pm:
                          uk.fused_uplevel_plain(f, lo, ps, pm)))
    for last in (False, True):
        u, y = nhwc(rng, b, 64, dtype, device), nhwc(rng, b, 64, dtype, device)
        p = head_params(rng, last, dtype, device)
        yy = None if last else y
        cases.append((f"fused_head@64{'_last' if last else '_mid'}",
                      "fused_head",
                      lambda u=u, yy=yy, p=p: hk.fused_head(u, yy, p),
                      lambda u=u, yy=yy, p=p: hk.fused_head_plain(u, yy, p)))
    return cases


# The bf16 body's contract edges (csrc/bottleneck_tc.cuh), beside the main
# shapes: (kernel, batch, side, channels). A batch of 11; C = 32 (Cm = 16:
# the narrowest output chunk, warps 4 x 2), 64 and 512 (two output chunks
# in phases 1-2, one block an SM); 4 px maps (one 4 x 4 tile, half the
# warps idle in phases 2-3); 12 px (a ragged last tile, pooled); kUpAdd at
# 8 px; C = 512 and 1024 in float32 too, where the FMA body's tile
# (fma_tile_plan) is 4 x 4 (an 8 x 8 tile's 600 bytes a channel exceed a
# block's shared memory above C=384) and, at 1024, the tensor-core tile 4 x
# 8.
BNECK_EDGES = (("fused_bottleneck", 11, 4, C), ("fused_bottleneck", 2, 16, 32),
               ("fused_bottleneck_pool", 2, 16, 64),
               ("fused_bottleneck_pool", 2, 12, 64),
               ("fused_bottleneck_pool", 11, 8, 512),
               ("fused_uplevel", 2, 8, C), ("fused_uplevel", 2, 16, 512),
               ("fused_bottleneck", 2, 12, 512),
               ("fused_bottleneck", 2, 8, 1024),
               ("fused_bottleneck_pool", 2, 8, 1024),
               ("fused_uplevel", 2, 8, 1024))
# The head's edges, mid and last stack: (batch, side, channels). A batch of
# 11 at 12 px (1,584 rows, a ragged last block); C = 32 and 64 (output
# chunks of 32 and 64 on the tensor cores), 512 and 1024 (32 and 16 rows a
# block of the FMA head, 64 and 32 of the tensor-core head); 4 px.
HEAD_EDGES = ((11, 12, C), (2, 16, 32), (2, 16, 64), (2, 8, 512),
              (2, 8, 1024), (2, 4, C))
# The mobile body's edges, as BNECK_EDGES: batch 11; C = 32, 64, 512 and
# 1024; 4 and 12 px; the up-add at 8 px.
MOBILE_EDGES = (("fused_bottleneck_mobile", 11, 4, C),
                ("fused_bottleneck_mobile", 2, 16, 32),
                ("fused_bottleneck_mobile", 2, 12, 64),
                ("fused_bottleneck_mobile_pool", 2, 16, 64),
                ("fused_bottleneck_mobile_pool", 2, 12, 64),
                ("fused_bottleneck_mobile_pool", 11, 8, 512),
                ("fused_uplevel_mobile", 2, 8, C),
                ("fused_uplevel_mobile", 2, 16, 512),
                ("fused_bottleneck_mobile", 2, 8, 1024),
                ("fused_bottleneck_mobile_pool", 2, 8, 1024),
                ("fused_uplevel_mobile", 2, 8, 1024))


def bneck_edge_cases(rng, dtype, device, b=None):
    """(name, kernel call, plain call) of #1-#3 at BNECK_EDGES (each edge
    names its own batch; b is unused)."""
    from single_person_pose_estimation_tpu_torch.ops.cuda import (
        bottleneck_kernel as bk,
        uplevel_kernel as uk,
    )

    cases = []
    for name, nb, h, c in BNECK_EDGES:
        x, p = nhwc(rng, nb, h, dtype, device, c), bneck_params(
            rng, dtype, device, c)
        label = f"{name}@{h} B={nb} C={c}"
        if name == "fused_uplevel":
            lo, pm = nhwc(rng, nb, h // 2, dtype, device, c), bneck_params(
                rng, dtype, device, c)
            cases.append((label, name,
                          lambda x=x, lo=lo, p=p, pm=pm:
                              uk.fused_uplevel(x, lo, p, pm),
                          lambda x=x, lo=lo, p=p, pm=pm:
                              uk.fused_uplevel_plain(x, lo, p, pm)))
        else:
            kern, plain = ((bk.fused_bottleneck, bk.fused_bottleneck_plain)
                           if name == "fused_bottleneck" else
                           (bk.fused_bottleneck_pool,
                            bk.fused_bottleneck_pool_plain))
            cases.append((label, name, lambda x=x, p=p, k=kern: k(x, p),
                          lambda x=x, p=p, f=plain: f(x, p)))
    return cases


def head_edge_cases(rng, dtype, device, b=None):
    """(name, kernel call, plain call) of #4, mid and last, at HEAD_EDGES
    (b is unused)."""
    from single_person_pose_estimation_tpu_torch.ops.cuda import (
        head_kernel as hk,
    )

    cases = []
    for nb, h, c in HEAD_EDGES:
        for last in (False, True):
            u = nhwc(rng, nb, h, dtype, device, c)
            y = None if last else nhwc(rng, nb, h, dtype, device, c)
            p = head_params(rng, last, dtype, device, c)
            cases.append((f"fused_head@{h}{'_last' if last else '_mid'} "
                          f"B={nb} C={c}", "fused_head",
                          lambda u=u, y=y, p=p: hk.fused_head(u, y, p),
                          lambda u=u, y=y, p=p: hk.fused_head_plain(u, y, p)))
    return cases


def main_kernel_cases(rng, dtype, device, b):
    """kernel_cases, then the bf16 body's edges and the head's (same draws
    for the main shapes as kernel_cases alone)."""
    return (kernel_cases(rng, dtype, device, b)
            + bneck_edge_cases(rng, dtype, device)
            + head_edge_cases(rng, dtype, device))


def mobile_params(rng, dtype, device, c=C):
    """One mobile bottleneck's operands (MobileParams) from the seed: 1x1
    depthwise scales around 1, 3x3 taps, glorot-sized pointwise weights."""
    from single_person_pose_estimation_tpu_torch.ops.cuda.bottleneck_kernel import (
        bn_affine,
    )
    from single_person_pose_estimation_tpu_torch.ops.cuda.mobile_kernel import (
        MobileParams,
    )
    import torch

    def u(lo, hi, *shape):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32))

    cm = c // 2
    lim1, lim2 = np.sqrt(6 / (c + cm)), np.sqrt(6 / (2 * cm))
    affs = [bn_affine(u(.5, 1.5, n), u(-.3, .3, n), u(-.5, .5, n),
                      u(.5, 1.5, n)) for n in (cm, cm, c)]
    return MobileParams.pack(
        u(.5, 1.5, c), u(-lim1, lim1, c, cm), u(-.1, .1, cm),
        u(-.3, .3, 3, 3, cm), u(-lim2, lim2, cm, cm), u(-.1, .1, cm),
        u(.5, 1.5, cm), u(-lim1, lim1, cm, c), u(-.1, .1, c),
        *affs[0], *affs[1], *affs[2], dtype=dtype, device=device)


def mobile_kernel_cases(rng, dtype, device, b):
    """(name, kernel call, plain call) of #8-#10 at every mobile main-path
    shape, the 4 px and 8 px levels (a tile that is the whole map, its
    halo all padding) among them."""
    from single_person_pose_estimation_tpu_torch.ops.cuda import (
        mobile_kernel as mk,
    )

    cases = []
    for h in (64, 4):
        x, p = nhwc(rng, b, h, dtype, device), mobile_params(rng, dtype, device)
        cases.append((f"fused_bottleneck_mobile@{h}", "fused_bottleneck_mobile",
                      lambda x=x, p=p: mk.fused_bottleneck_mobile(x, p),
                      lambda x=x, p=p: mk.fused_bottleneck_mobile_plain(x, p)))
    for h in (32, 16, 8):
        x, p = nhwc(rng, b, h, dtype, device), mobile_params(rng, dtype, device)
        cases.append((f"fused_bottleneck_mobile_pool@{h}",
                      "fused_bottleneck_mobile_pool",
                      lambda x=x, p=p: mk.fused_bottleneck_mobile_pool(x, p),
                      lambda x=x, p=p:
                          mk.fused_bottleneck_mobile_pool_plain(x, p)))
    for h in (64, 32, 16, 8):
        f, lo = nhwc(rng, b, h, dtype, device), nhwc(rng, b, h // 2, dtype,
                                                      device)
        ps = mobile_params(rng, dtype, device)
        pm = mobile_params(rng, dtype, device)
        cases.append((f"fused_uplevel_mobile@{h}", "fused_uplevel_mobile",
                      lambda f=f, lo=lo, ps=ps, pm=pm:
                          mk.fused_uplevel_mobile(f, lo, ps, pm),
                      lambda f=f, lo=lo, ps=ps, pm=pm:
                          mk.fused_uplevel_mobile_plain(f, lo, ps, pm)))
    return cases


def mobile_edge_cases(rng, dtype, device, b=None):
    """(name, kernel call, plain call) of #8-#10 at MOBILE_EDGES (each
    edge names its own batch; b is unused)."""
    from single_person_pose_estimation_tpu_torch.ops.cuda import (
        mobile_kernel as mk,
    )

    cases = []
    for name, nb, h, c in MOBILE_EDGES:
        x, p = nhwc(rng, nb, h, dtype, device, c), mobile_params(
            rng, dtype, device, c)
        label = f"{name}@{h} B={nb} C={c}"
        if name == "fused_uplevel_mobile":
            lo, pm = nhwc(rng, nb, h // 2, dtype, device, c), mobile_params(
                rng, dtype, device, c)
            cases.append((label, name,
                          lambda x=x, lo=lo, p=p, pm=pm:
                              mk.fused_uplevel_mobile(x, lo, p, pm),
                          lambda x=x, lo=lo, p=p, pm=pm:
                              mk.fused_uplevel_mobile_plain(x, lo, p, pm)))
        else:
            kern, plain = ((mk.fused_bottleneck_mobile,
                            mk.fused_bottleneck_mobile_plain)
                           if name == "fused_bottleneck_mobile" else
                           (mk.fused_bottleneck_mobile_pool,
                            mk.fused_bottleneck_mobile_pool_plain))
            cases.append((label, name, lambda x=x, p=p, k=kern: k(x, p),
                          lambda x=x, p=p, f=plain: f(x, p)))
    return cases


def mobile_main_cases(rng, dtype, device, b):
    """mobile_kernel_cases, then the mobile body's edges (same draws for
    the main shapes as mobile_kernel_cases alone)."""
    return (mobile_kernel_cases(rng, dtype, device, b)
            + mobile_edge_cases(rng, dtype, device))


def max_err(got, want, dtype):
    """(max |d|, passes) for one output under this dtype's tolerance."""
    import torch

    g, w = got.float(), want.float()
    d = (g - w).abs()
    if not torch.isfinite(g).all():
        return float("inf"), False
    if dtype == torch.float32:
        return d.max().item(), bool(d.max().item() <= TOL_F32)
    if want.dtype == torch.float32:      # pred: float32 out of a bf16 run
        return d.max().item(), bool(d.max().item() <= TOL_PRED_BF16)
    bound = TOL_BF16_REL * torch.clamp(w.abs(), min=1.0)
    return d.max().item(), bool((d <= bound).all().item())


def phase_kernels(report, make_cases=kernel_cases, seed=0, twice=False):
    """Each case's kernel against its plain version, f32 and bf16, by
    `max_err` or by the case's own hold (a fifth element); with `twice`,
    the kernel runs again and must give the same bits."""
    import torch

    rng = np.random.default_rng(seed)
    failures = []
    for dtype in (torch.float32, torch.bfloat16):
        for label, name, kern, plain, *hold in make_cases(rng, dtype, "cuda",
                                                          B_CHECK):
            hold = hold[0] if hold else max_err
            got, want = kern(), plain()
            again = kern() if twice else got
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            again = again if isinstance(again, tuple) else (again,)
            if not all(g is a or torch.equal(g, a)
                       for g, a in zip(got, again)):
                failures.append(f"{label} {dtype}: a rerun gave other bits")
            for i, (g, w) in enumerate(zip(got, want)):
                if w is None:
                    continue
                if g.shape != w.shape or g.dtype != w.dtype:
                    failures.append(f"{label} out{i}: {g.shape}/{g.dtype} vs "
                                    f"{w.shape}/{w.dtype}")
                    continue
                err, ok = hold(g, w, dtype)
                key = "max_abs_err_f32" if dtype == torch.float32 else \
                    "max_abs_err"
                ent = report.setdefault(name, {})
                ent[key] = max(ent.get(key, 0.0), err)
                log(f"kernel {label} {str(dtype)[6:]} out{i}: max|d| = "
                    f"{err:.3e} {'ok' if ok else 'FAIL'}")
                if not ok:
                    failures.append(f"{label} {dtype} out{i}: {err}")
    if failures:
        raise AssertionError("kernels disagree with their plain versions: "
                             + "; ".join(failures))


def phase_build():
    from single_person_pose_estimation_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    path = build.build(verbose=True)
    build.lib()
    log(f"build: {path.name} in {time.perf_counter() - t0:.1f} s")


MAIN_FLAGS = dict(fuse_levels=True, pool_fuse_max_h=32, fuse_heads=True)
# Launches of each kernel per S4 forward: per stack 4 bottlenecks (f1 and
# the three bottom blocks), 3 pooled bottlenecks (f2, f4, f8), 4 up-levels
# of two launches each, 1 head.
PER_FORWARD = {"fused_bottleneck": 16, "fused_bottleneck_pool": 12,
               "fused_uplevel": 32, "fused_head": 4}
# Per mobile S4 forward: per stack 4 mobile bottlenecks, 3 pooled ones, 4
# up-levels of two launches each, 1 head (the standard head kernel).
MOBILE_PER_FORWARD = {"fused_bottleneck_mobile": 16,
                      "fused_bottleneck_mobile_pool": 12,
                      "fused_uplevel_mobile": 32, "fused_head": 4}
MOBILE_KERNELS = ("fused_bottleneck_mobile", "fused_bottleneck_mobile_pool",
                  "fused_uplevel_mobile")


def phase_golden():
    import torch

    from single_person_pose_estimation_tpu_torch.models.fused_inference import (
        fused_apply,
        prepare_fused,
    )
    from single_person_pose_estimation_tpu_torch.models.hourglass import (
        StackedHourglass,
    )
    from single_person_pose_estimation_tpu_torch.ops import cuda as kernels
    from single_person_pose_estimation_tpu_torch.utils.weight_convert import (
        load_variables,
    )

    data = dict(np.load(os.path.join(ROOT, "tests", "fixtures",
                                     "golden_ref_s2c32.npz")))
    stacks, channels, _, _ = (int(v) for v in data["meta"])
    model = load_variables(StackedHourglass(num_stacks=stacks,
                                            num_channels=channels), data)
    fp = prepare_fused(model.to("cuda"), dtype=torch.float32)
    kernels.reset_launch_counts()
    outs = fused_apply(fp, torch.from_numpy(data["x"]).cuda(), **MAIN_FLAGS)
    torch.cuda.synchronize()
    counts = {n: c for n, c in kernels.launch_counts().items()
              if n in PER_FORWARD}
    for s in range(stacks):
        err = (outs[s].cpu() - torch.from_numpy(data[f"ref_out_{s}"])).abs()
        log(f"golden stack {s}: max|d| vs TF reference = "
            f"{err.max().item():.3e} (tol {TOL_GOLDEN})")
        if not err.max().item() <= TOL_GOLDEN:
            raise AssertionError(f"golden stack {s}: {err.max().item()}")
    log(f"golden launches: {counts}")
    if not all(counts.values()):
        raise AssertionError(f"a kernel did not launch on the golden run: "
                             f"{counts}")


def build_s4(seed=0):
    import torch

    from single_person_pose_estimation_tpu_torch.models.hourglass import (
        StackedHourglass,
    )
    from single_person_pose_estimation_tpu_torch.utils.weight_convert import (
        init_variables,
        load_variables,
    )

    model = StackedHourglass(num_stacks=4, num_channels=C,
                             compute_dtype=torch.bfloat16)
    load_variables(model, init_variables(4, C, seed=seed))
    n = model.count_params()
    if n != S4_PARAMS:
        raise AssertionError(f"S4/256 has {n} parameters, not {S4_PARAMS}")
    return model


def phase_slice(report, model):
    import torch

    from single_person_pose_estimation_tpu_torch.models import (
        fused_inference as fi,
    )
    from single_person_pose_estimation_tpu_torch.models.fused_inference import (
        fused_apply,
        prepare_fused,
    )
    from single_person_pose_estimation_tpu_torch.ops import cuda as kernels
    from single_person_pose_estimation_tpu_torch.serving import PoseServer

    rng = np.random.default_rng(1)
    imgs = rng.uniform(0, 1, (80, 256, 256, 3)).astype(np.float32)
    server = PoseServer(model, device="cuda", buckets=(1, 8, 32, 128),
                        use_fused="auto", max_wait_s=0.005)
    try:
        if not server.use_fused:
            raise AssertionError('use_fused="auto" did not pick the kernels')
        server.warmup()
        torch.cuda.synchronize()
        steps0 = server.stats()["steps"]
        kernels.reset_launch_counts()
        fi.plain_routes.update(forward=0, level=0)
        t0 = time.perf_counter()
        futs = [server.submit(im) for im in imgs[:16]]
        singles = [f.result(timeout=600) for f in futs]
        batch = server.predict(imgs[16:])
        elapsed = time.perf_counter() - t0
        torch.cuda.synchronize()
        all_counts = kernels.launch_counts()
        counts = {n: all_counts[n] for n in (*PER_FORWARD, "decode_batch")}
        routes = dict(fi.plain_routes)
        stats = server.stats()
    finally:
        server.close()
    if any(routes.values()):
        raise AssertionError(f"served work left the kernels: {routes}")
    answers = np.concatenate([np.stack(singles), batch])
    if answers.shape != (80, K, 3) or not np.isfinite(answers).all():
        raise AssertionError(f"bad answers: {answers.shape}")
    xy = answers[..., :2]
    if xy.min() < 0 or xy.max() >= 64:
        raise AssertionError(f"keypoints outside the 64x64 map: "
                             f"[{xy.min()}, {xy.max()}]")
    forwards = stats["steps"] - steps0
    log(f"slice: {len(answers)} requests in {forwards} forwards, "
        f"{elapsed:.2f} s, stats {stats}")
    # One decode launch per served step, after its forward.
    want = {**{n: v * forwards for n, v in PER_FORWARD.items()},
            "decode_batch": forwards}
    log(f"slice launches: {all_counts} expected {want}")
    if counts != want or any(all_counts[n] for n in (
            *TRAIN_KERNELS, *MOBILE_KERNELS, *FUSED_KERNELS,
            *DIAL_KERNELS)):
        raise AssertionError(f"launch counts {all_counts} != {want}")
    for name in PER_FORWARD:
        report.setdefault(name, {})["launches"] = counts[name]

    # One batch through the kernel path and the plain model on the card, in
    # bf16 and (TF32 off) in float32.
    x = torch.from_numpy(imgs[:8]).cuda()
    with torch.inference_mode():
        fused = fused_apply(server._replicas[0][1], x, **MAIN_FLAGS)[-1]
        plain = model(x)[-1]
        model.compute_dtype = torch.float32
        try:
            plain32 = model(x)[-1]
            fused32 = fused_apply(prepare_fused(model), x, **MAIN_FLAGS)[-1]
        finally:
            model.compute_dtype = torch.bfloat16
    if not torch.isfinite(fused).all() or not torch.isfinite(fused32).all():
        raise AssertionError("non-finite heatmaps on the kernel path")
    for label, a, b in (("kernels bf16 vs plain bf16", fused, plain),
                        ("kernels bf16 vs plain f32", fused, plain32),
                        ("plain bf16 vs plain f32", plain, plain32),
                        ("kernels f32 vs plain f32", fused32, plain32)):
        d = (a - b).abs()
        log(f"slice heatmaps (batch 8), {label}: max|d| = "
            f"{d.max().item():.3e}, mean|d| = {d.mean().item():.3e}")
    # At f32 (TF32 off) the kernel path and the plain model differ only in
    # the order of float32 sums. The random-init S4/256 grows its
    # activations through four stacks of residual sums, so a few pixels
    # whose large pre-sigmoid sums lie near 0 move by up to ~3e-3 (measured
    # on the H100); the mean stays at float32 rounding.
    d = (fused32 - plain32).abs()
    if not (d.max().item() <= TOL_S4_F32_MAX
            and d.mean().item() <= TOL_S4_F32_MEAN):
        raise AssertionError(f"S4/256 f32 kernels vs plain model: max "
                             f"{d.max().item()}, mean {d.mean().item()}")

    # The same batch on an unsaturated copy, held as scaled_readings says.
    scaled_readings(model, x, "slice")


def phase_times(report, model, card):
    import torch

    from single_person_pose_estimation_tpu_torch.models.fused_inference import (
        fused_apply,
        prepare_fused,
    )

    rng = np.random.default_rng(2)
    fp = prepare_fused(model)
    x = torch.from_numpy(rng.uniform(0, 1, (B_TIME, 256, 256, 3))
                         .astype(np.float32)).cuda()
    runs = {"kernels": lambda: fused_apply(fp, x, **MAIN_FLAGS)[-1],
            "plain": lambda: model(x)[-1]}
    times = {k: [] for k in runs}
    with torch.inference_mode():
        for fn in runs.values():
            fn()
        for i in range(10):
            for name in (("plain", "kernels") if i % 2 else
                         ("kernels", "plain")):
                times[name].append(cuda_ms(runs[name], iters=1, warmup=0))
    for name, ts in times.items():
        med = statistics.median(ts)
        log(f"times S4/256 bf16 forward B={B_TIME} {name}: median "
            f"{med:.2f} ms over {len(ts)} runs = {B_TIME / med * 1e3:.1f} "
            f"img/s [{card}]")
        report.setdefault("_forward", {})[name] = B_TIME / med * 1e3

    from single_person_pose_estimation_tpu_torch.ops.cuda import (
        bottleneck_kernel as bk,
        head_kernel as hk,
        uplevel_kernel as uk,
    )

    from single_person_pose_estimation_tpu_torch.models import (
        fused_inference as fi,
    )

    dt = torch.bfloat16
    p = bneck_params(rng, dt, "cuda")
    p2 = bneck_params(rng, dt, "cuda")
    x64 = nhwc(rng, B_TIME, 64, dt, "cuda")
    x32 = nhwc(rng, B_TIME, 32, dt, "cuda")
    hp = head_params(rng, False, dt, "cuda")
    # Library yardsticks, never called by the port: the plain cuDNN bf16
    # bottleneck of the model (fi._bottleneck_plain) at the same shape; for
    # #2 followed by the 2x2 maxpool, for #3 two of them around the
    # upsample-add; for #4 the model's mid-stack head (fi._head_plain: the
    # 1x1 convs, BN, sigmoid, the next-stack convs and the adds).
    bneck = lambda v, n: fi._bottleneck_plain(fp, v, f"hg0_{n}", C)
    library = {
        "fused_bottleneck": lambda: bneck(x64, "downsample_f1"),
        "fused_bottleneck_pool": lambda: fi.maxpool2x2(
            bneck(x32, "downsample_f2")),
        "fused_uplevel": lambda: bneck(
            bneck(x64, "upsample_f1_short") + fi.upsample2x(x32),
            "upsample_f1_merged"),
        "fused_head": lambda: fi._head_plain(fp, x64, x64, "hg0", False),
    }
    cases = {
        "fused_bottleneck": ("64x64", lambda: bk.fused_bottleneck(x64, p),
                             lambda: bk.fused_bottleneck_plain(x64, p)),
        "fused_bottleneck_pool": (
            "32x32", lambda: bk.fused_bottleneck_pool(x32, p),
            lambda: bk.fused_bottleneck_pool_plain(x32, p)),
        "fused_uplevel": (
            "64x64", lambda: uk.fused_uplevel(x64, x32, p, p2),
            lambda: uk.fused_uplevel_plain(x64, x32, p, p2)),
        "fused_head": ("64x64 mid", lambda: hk.fused_head(x64, x64, hp),
                       lambda: hk.fused_head_plain(x64, x64, hp)),
    }
    with torch.inference_mode():
        for name, (shape, kern, plain) in cases.items():
            ms = cuda_ms(kern, iters=5)
            plain_ms = cuda_ms(plain, iters=5)
            device_ms = kernel_device_ms(kern, name)
            lib_ms = (cuda_ms(library[name], iters=5) if name in library
                      else None)
            report.setdefault(name, {}).update(ms=ms, plain_ms=plain_ms,
                                               device_ms=device_ms,
                                               library_ms=lib_ms)
            log(f"times {name} bf16 B={B_TIME} {shape}: kernel {ms:.3f} ms "
                f"({device_ms:.3f} ms on the device), plain {plain_ms:.3f} "
                f"ms, library "
                f"{'none' if lib_ms is None else f'{lib_ms:.3f} ms'} "
                f"[{card}]")


def kernel_device_ms(fn, name, calls=9, before=None):
    """Device time of one call of a kernel wrapper: the median over
    `calls` calls, each bracketed by CUDA events, queued while a sleep
    kernel holds the stream, so the device runs them back to back and no
    host time falls inside a bracket. `before` (optional) runs ahead of
    each bracket, outside it.

    Not torch.profiler: on the H100 its sessions now and then recorded no
    device activity at all for the µs-long kernels, even on retry."""
    import torch

    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(calls)]
    torch.cuda._sleep(100_000_000)      # ~50 ms at the H100's clock
    for start, end in pairs:
        if before is not None:
            before()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    ms = statistics.median(s.elapsed_time(e) for s, e in pairs)
    if not ms > 0:
        raise AssertionError(f"no device time measured for {name}")
    return ms


def l2_scrub(clean=False):
    """A `before` for kernel_device_ms that evicts the 50 MB L2 by writing
    128 MB (or, `clean`, by reading them). The buffer is written 16 times
    here first: on the H100 the first writes of a freshly allocated buffer
    left the kernel timed right after them up to 9x slower for several
    calls (PERF.md, #11). Writing leaves the L2 full of dirty lines, whose
    write-back the kernel timed next pays for as its own traffic evicts
    them (up to 50 MB more through HBM); reading leaves it clean."""
    import torch

    buf = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    for _ in range(16):
        buf.zero_()
    if clean:
        buf.sum()
    torch.cuda.synchronize()
    return buf.sum if clean else buf.zero_


def device_trace(fn, calls=3, attempts=3):
    """Device activity of `calls` back-to-back calls of fn under
    torch.profiler, after one profiled warm-up call that is discarded.
    Returns per call: (span ms, busy ms, {kernel: [ms, launches]}), the
    five longest idle gaps of the whole window as (ms, ms from its start),
    and every device event of the window as (start us, end us, name) in
    time order.

    A profiler session now and then delivers no device records at all
    (seen on the H100 for windows of µs-long kernels, which is why
    kernel_device_ms does not use it); such a session is traced again, up
    to `attempts` times, and then it fails."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            prof.step()
        # Device kernels, copies and memsets; the step markers the profiler
        # puts on the device timeline span the whole step and are left out.
        evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith("ProfilerStep")]
        if evs:
            break
        log("trace: the profiler recorded no device activity; tracing "
            "again")
    else:
        raise AssertionError("torch.profiler recorded no device activity")
    ivs = sorted((e.time_range.start, e.time_range.end) for e in evs)
    busy, reach = 0.0, ivs[0][0]        # union of the intervals, in us
    gaps = []
    for s, e in ivs:
        if s > reach:
            gaps.append(((s - reach) / 1e3, (reach - ivs[0][0]) / 1e3))
        if e > reach:
            busy += e - max(s, reach)
            reach = e
    per = {}
    for e in evs:
        ent = per.setdefault(e.name[:100], [0.0, 0])
        ent[0] += (e.time_range.end - e.time_range.start) / 1e3 / calls
        ent[1] += 1 / calls
    return ((reach - ivs[0][0]) / 1e3 / calls, busy / 1e3 / calls, per,
            sorted(gaps, reverse=True)[:5],
            sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in evs))


def phase_trace(report, model, card):
    import torch

    from single_person_pose_estimation_tpu_torch.models.fused_inference import (
        fused_apply,
        prepare_fused,
    )

    fp = prepare_fused(model)
    x = torch.from_numpy(np.random.default_rng(3).uniform(
        0, 1, (B_TIME, 256, 256, 3)).astype(np.float32)).cuda()
    runs = {"kernels": lambda: fused_apply(fp, x, **MAIN_FLAGS)[-1],
            "plain": lambda: model(x)[-1]}
    with torch.inference_mode():
        for name, fn in runs.items():
            span, busy, per, _, evs = device_trace(fn)
            log(f"trace S4/256 bf16 B={B_TIME} {name}: device span "
                f"{span:.2f} ms/forward, busy {busy:.2f} ms, idle share "
                f"{1 - busy / span:.4f} [{card}]")
            top = sorted(per.items(), key=lambda kv: -kv[1][0])[:10]
            for kname, (ms, n) in top:
                log(f"  {ms:9.3f} ms/forward {ms / busy:6.1%} x{n:6.1f}  "
                    f"{kname}")
            if name != "kernels":
                continue
            fma = {e[2][:60] for e in evs
                   if BF16_FMA_BNECK in e[2] or BF16_FMA_HEAD in e[2]}
            if fma:
                raise AssertionError(f"the bf16 forward ran an FMA body: "
                                     f"{fma}")
            per_kernel, launches = forward_device_ms(evs)
            if launches != PER_FORWARD:
                raise AssertionError(f"the trace attributes {launches} "
                                     f"launches a forward, not "
                                     f"{PER_FORWARD}")
            for kname, ms in per_kernel.items():
                report.setdefault(kname, {})["forward_device_ms"] = ms
                log(f"trace {kname}: {ms:.3f} device ms per forward over "
                    f"its {launches[kname]} launches, every shape [{card}]")


# The bf16 bodies' kernel names in a trace (csrc/bottleneck.cu,
# csrc/mobile.cu, csrc/head.cu), and the FMA bodies' bf16 instantiations,
# which no bf16 path may run.
TC_BNECK = "bneck_tc_kernel<"
TC_MOBILE = "mobile_tc_kernel<"
TC_HEAD = "head_tc_kernel<"
TC_CONVSKIP = "convskip_tc_kernel<"
BF16_FMA_BNECK = "bottleneck_kernel<__nv_bfloat16"
BF16_FMA_HEAD = "head_kernel<__nv_bfloat16"
BF16_FMA_MOBILE = "mobile_kernel<__nv_bfloat16"
BF16_FMA_CONVSKIP = "convskip_kernel<__nv_bfloat16"


def forward_device_ms(evs, calls=3, per_forward=PER_FORWARD, tc=TC_BNECK):
    """Device ms and launches per forward of #1-#4 (or, with the mobile
    `per_forward` and `tc`, #8-#10 and #4) from the trace's events of
    `calls` forwards, summed over every shape: a <1> launch of the body
    (bneck_tc_kernel, or mobile_tc_kernel whose kPlainPool is mode 3) is
    the pooled bottleneck's, <2> is the up-level's first launch and the <0>
    launch right after it the up-level's second, every other <0> launch the
    plain bottleneck's; `head_tc_kernel` is #4's."""
    plain, pool, uplevel, head = per_forward
    ms, n = dict.fromkeys(per_forward, 0.0), dict.fromkeys(per_forward, 0)
    prev = None
    for start, end, name in evs:
        if TC_HEAD in name:
            owner = head
        elif tc in name:
            mode = name.split(tc)[1][0]
            owner = (pool if mode in "13" else
                     uplevel if "2" in (mode, prev) else plain)
            prev = mode
        else:
            continue
        ms[owner] += (end - start) / 1e3 / calls
        n[owner] += 1
    return ms, {k: v // calls for k, v in n.items()}


# ---------------------------------------------------------------------------
# The mobile (separable-conv) model: kernels #8-#10 and the head kernel.
# ---------------------------------------------------------------------------

def phase_mobile_golden():
    import torch

    from single_person_pose_estimation_tpu_torch.models.fused_inference import (
        fused_apply,
        prepare_fused,
    )
    from single_person_pose_estimation_tpu_torch.models.hourglass import (
        StackedHourglass,
    )
    from single_person_pose_estimation_tpu_torch.ops import cuda as kernels
    from single_person_pose_estimation_tpu_torch.utils.weight_convert import (
        load_variables,
    )

    data = dict(np.load(os.path.join(ROOT, "tests", "fixtures",
                                     "golden_ref_s1c32_mobile.npz")))
    stacks, channels, _, mobile = (int(v) for v in data["meta"])
    model = load_variables(StackedHourglass(num_stacks=stacks,
                                            num_channels=channels,
                                            mobile=bool(mobile)), data)
    fp = prepare_fused(model.to("cuda"), dtype=torch.float32)
    kernels.reset_launch_counts()
    outs = fused_apply(fp, torch.from_numpy(data["x"]).cuda(), **MAIN_FLAGS)
    torch.cuda.synchronize()
    counts = {n: c for n, c in kernels.launch_counts().items()
              if n in MOBILE_PER_FORWARD}
    for s in range(stacks):
        err = (outs[s].cpu() - torch.from_numpy(data[f"ref_out_{s}"])).abs()
        log(f"mobile_golden stack {s}: max|d| vs TF reference = "
            f"{err.max().item():.3e} (tol {TOL_GOLDEN})")
        if not err.max().item() <= TOL_GOLDEN:
            raise AssertionError(f"mobile golden stack {s}: "
                                 f"{err.max().item()}")
    log(f"mobile_golden launches: {counts}")
    if not all(counts.values()):
        raise AssertionError(f"a kernel did not launch on the mobile golden "
                             f"run: {counts}")


def build_s4_mobile(seed=0):
    import torch

    from single_person_pose_estimation_tpu_torch.models.hourglass import (
        StackedHourglass,
    )
    from single_person_pose_estimation_tpu_torch.utils.weight_convert import (
        init_variables,
        load_variables,
    )

    model = StackedHourglass(num_stacks=4, num_channels=C,
                             compute_dtype=torch.bfloat16, mobile=True)
    load_variables(model, init_variables(4, C, seed=seed, mobile=True))
    n = model.count_params()
    if n != S4_MOBILE_PARAMS:
        raise AssertionError(f"mobile S4/256 has {n} parameters, not "
                             f"{S4_MOBILE_PARAMS}")
    return model


def phase_mobile_slice(report, model):
    """Mobile S4/256 served by PoseServer on the card: 40 requests."""
    import torch

    from single_person_pose_estimation_tpu_torch.models import (
        fused_inference as fi,
    )
    from single_person_pose_estimation_tpu_torch.ops import cuda as kernels
    from single_person_pose_estimation_tpu_torch.serving import PoseServer

    rng = np.random.default_rng(21)
    imgs = rng.uniform(0, 1, (40, 256, 256, 3)).astype(np.float32)
    server = PoseServer(model, device="cuda", buckets=(1, 8, 32),
                        use_fused="auto", max_wait_s=0.005)
    try:
        if not server.use_fused:
            raise AssertionError('use_fused="auto" did not pick the kernels')
        server.warmup()
        torch.cuda.synchronize()
        steps0 = server.stats()["steps"]
        kernels.reset_launch_counts()
        fi.plain_routes.update(forward=0, level=0)
        t0 = time.perf_counter()
        futs = [server.submit(im) for im in imgs[:8]]
        singles = [f.result(timeout=600) for f in futs]
        batch = server.predict(imgs[8:])
        elapsed = time.perf_counter() - t0
        torch.cuda.synchronize()
        all_counts = kernels.launch_counts()
        routes = dict(fi.plain_routes)
        stats = server.stats()
    finally:
        server.close()
    if any(routes.values()):
        raise AssertionError(f"served mobile work left the kernels: {routes}")
    answers = np.concatenate([np.stack(singles), batch])
    if answers.shape != (40, K, 3) or not np.isfinite(answers).all():
        raise AssertionError(f"bad mobile answers: {answers.shape}")
    xy = answers[..., :2]
    if xy.min() < 0 or xy.max() >= 64:
        raise AssertionError(f"mobile keypoints outside the 64x64 map: "
                             f"[{xy.min()}, {xy.max()}]")
    forwards = stats["steps"] - steps0
    log(f"mobile_slice: {len(answers)} requests in {forwards} forwards, "
        f"{elapsed:.2f} s, stats {stats}")
    want = dict.fromkeys(all_counts, 0)
    want.update({n: v * forwards for n, v in MOBILE_PER_FORWARD.items()},
                decode_batch=forwards)
    log(f"mobile_slice launches: {all_counts} expected {want}")
    if all_counts != want:
        raise AssertionError(f"mobile launch counts {all_counts} != {want}")
    for name in MOBILE_KERNELS:
        report.setdefault(name, {})["launches"] = all_counts[name]

    # The kernel path against the plain mobile model, on an unsaturated
    # copy, held as scaled_readings says.
    scaled_readings(model, torch.from_numpy(imgs[:8]).cuda(), "mobile_slice")


def scaled_readings(model, x, label, flags=MAIN_FLAGS):
    """The kernel path against the plain model on an unsaturated copy.

    A random S4/256 saturates 99.8% of its last-stack sigmoids to exactly
    0 or 1, which hides what the kernels compute. So the kernel path is
    held against the plain model on a deep copy whose last predict conv
    is scaled by 4 / max|z| (z: the plain f32 last-stack logits) to bring
    every pre-sigmoid value into [-4, 4]: the heatmaps then carry the
    relative error of the whole stream. At least 99% of the plain f32
    heatmap values must lie strictly between 0 and 1. Logs the four
    readings (kernels bf16 and plain bf16 against each other and against
    plain f32, kernels f32 against plain f32) and holds two bounds: the f32
    kernel path within TOL_F32 (the North star's 1e-4) in max|d| and
    TOL_S4_F32_MEAN in mean|d| of plain f32; the bf16 kernel path, in
    max|d| and in mean|d| from plain f32, within S4_BF16_FACTOR times the
    plain bf16 model's own distance from plain f32 in the same run (the
    plain bf16 model is the control). `flags`: the kernel path's
    fused_apply flags. Returns {reading: (max, mean)}."""
    import torch

    from single_person_pose_estimation_tpu_torch.models.fused_inference import (
        fused_apply,
        prepare_fused,
    )

    peaked, z, k = unsaturated_copy(model, x)
    with torch.inference_mode():
        plain32 = peaked(x)[-1]
        fused32 = fused_apply(prepare_fused(peaked), x, **flags)[-1]
        peaked.compute_dtype = torch.bfloat16
        plain = peaked(x)[-1]
        fused = fused_apply(prepare_fused(peaked), x, **flags)[-1]
    del peaked
    if not torch.isfinite(fused).all() or not torch.isfinite(fused32).all():
        raise AssertionError(f"{label}: non-finite heatmaps on the kernel "
                             f"path")
    open_share = ((plain32 > 0) & (plain32 < 1)).float().mean().item()
    log(f"{label}: last-stack logits max|z| = {z.abs().max().item():.4g}"
        f", std {z.std().item():.4g}; predict conv scaled by {k:.4g}; "
        f"{open_share:.4f} of the plain f32 heatmap values lie strictly "
        f"between 0 and 1, range [{plain32.min().item():.4f}, "
        f"{plain32.max().item():.4f}]")
    if not open_share >= 0.99:
        raise AssertionError(f"{label}: the scaled heatmaps still "
                             f"saturate: {open_share:.4f} open")
    readings = {}
    for name, a, b in (("kernels bf16 vs plain bf16", fused, plain),
                       ("kernels bf16 vs plain f32", fused, plain32),
                       ("plain bf16 vs plain f32", plain, plain32),
                       ("kernels f32 vs plain f32", fused32, plain32)):
        d = (a - b).abs()
        readings[name] = (d.max().item(), d.mean().item())
        log(f"{label} heatmaps (batch {x.shape[0]}, scaled predict), "
            f"{name}: max|d| = {readings[name][0]:.3e}, mean|d| = "
            f"{readings[name][1]:.3e}")
    top, mean = readings["kernels f32 vs plain f32"]
    kern = readings["kernels bf16 vs plain f32"]
    ctrl = readings["plain bf16 vs plain f32"]
    bf16_ok = all(k <= S4_BF16_FACTOR * c for k, c in zip(kern, ctrl))
    log(f"{label}: f32 kernels within the North star's {TOL_F32:g}: "
        f"{top <= TOL_F32}; bf16 kernels vs plain f32 (max {kern[0]:.3e}, "
        f"mean {kern[1]:.3e}) within {S4_BF16_FACTOR:g}x plain bf16 vs "
        f"plain f32 (max {ctrl[0]:.3e}, mean {ctrl[1]:.3e}): {bf16_ok}")
    if not (top <= TOL_F32 and mean <= TOL_S4_F32_MEAN):
        raise AssertionError(f"{label}: f32 kernels vs plain model on the "
                             f"scaled copy: max {top}, mean {mean}")
    if not bf16_ok:
        raise AssertionError(f"{label}: bf16 kernels on the scaled copy: "
                             f"{kern} against the control {ctrl}")
    return readings


def unsaturated_copy(model, x):
    """(an f32 deep copy of `model` whose last predict conv is scaled by
    4 / max|z|, z: its last-stack logits on x; z; the factor), as
    scaled_readings describes."""
    import torch

    peaked = copy.deepcopy(model)
    peaked.compute_dtype = torch.float32
    with torch.inference_mode():
        z = predict_logits(peaked, x)
    pred = getattr(peaked, f"hg{peaked.num_stacks - 1}_conv_1x1_predict")
    k = 4.0 / z.abs().max().item()
    with torch.no_grad():
        pred.weight.mul_(k)
        pred.bias.mul_(k)
    return peaked, z, k


def predict_logits(model, x):
    """The plain model's last-stack heatmaps before the sigmoid."""
    name = f"hg{model.num_stacks - 1}_conv_1x1_predict"
    conv, seen = model._conv, []

    def spy(y, layer, activation="relu", **bn):
        if layer == name:
            seen.append(conv(y, layer, "linear").float())
        return conv(y, layer, activation, **bn)

    model._conv = spy
    try:
        model(x)
    finally:
        del model._conv
    return seen[0]


def phase_mobile_times(report, model, card):
    """Mobile S4/256 forward img/s (kernels and plain model, alternating),
    the device idle share of 3 forwards of each, the device ms per forward
    of #8-#10 and #4 from the kernels' trace (no bf16 FMA mobile or head
    body may run), and #8-#10 each beside its plain version and the plain
    mobile model's own block at the same shape (the library yardstick)."""
    import torch

    from single_person_pose_estimation_tpu_torch.models import (
        fused_inference as fi,
    )
    from single_person_pose_estimation_tpu_torch.models.fused_inference import (
        fused_apply,
        prepare_fused,
    )
    from single_person_pose_estimation_tpu_torch.ops.cuda import (
        mobile_kernel as mk,
    )

    rng = np.random.default_rng(22)
    fp = prepare_fused(model)
    x = torch.from_numpy(rng.uniform(0, 1, (B_TIME, 256, 256, 3))
                         .astype(np.float32)).cuda()
    runs = {"kernels": lambda: fused_apply(fp, x, **MAIN_FLAGS)[-1],
            "plain": lambda: model(x)[-1]}
    times = {k: [] for k in runs}
    with torch.inference_mode():
        for fn in runs.values():
            fn()
        for i in range(10):
            for name in (("plain", "kernels") if i % 2 else
                         ("kernels", "plain")):
                times[name].append(cuda_ms(runs[name], iters=1, warmup=0))
        for name, ts in times.items():
            med = statistics.median(ts)
            log(f"mobile_times mobile S4/256 bf16 forward B={B_TIME} {name}: "
                f"median {med:.2f} ms over {len(ts)} runs = "
                f"{B_TIME / med * 1e3:.1f} img/s [{card}]")
            report.setdefault("_mobile_forward", {})[name] = \
                B_TIME / med * 1e3
        for name, fn in runs.items():
            span, busy, per, _, evs = device_trace(fn)
            log(f"trace mobile S4/256 bf16 B={B_TIME} {name}: device span "
                f"{span:.2f} ms/forward, busy {busy:.2f} ms, idle share "
                f"{1 - busy / span:.4f} [{card}]")
            top = sorted(per.items(), key=lambda kv: -kv[1][0])[:8]
            for kname, (ms, n) in top:
                log(f"  {ms:9.3f} ms/forward {ms / busy:6.1%} x{n:6.1f}  "
                    f"{kname}")
            if name != "kernels":
                continue
            fma = {e[2][:60] for e in evs
                   if BF16_FMA_MOBILE in e[2] or BF16_FMA_HEAD in e[2]}
            if fma:
                raise AssertionError(f"the bf16 mobile forward ran an FMA "
                                     f"body: {fma}")
            per_kernel, launches = forward_device_ms(
                evs, per_forward=MOBILE_PER_FORWARD, tc=TC_MOBILE)
            if launches != MOBILE_PER_FORWARD:
                raise AssertionError(f"the mobile trace attributes "
                                     f"{launches} launches a forward, not "
                                     f"{MOBILE_PER_FORWARD}")
            for kname, ms in per_kernel.items():
                key = "mobile_forward_device_ms" if kname == "fused_head" \
                    else "forward_device_ms"
                report.setdefault(kname, {})[key] = ms
                log(f"trace mobile {kname}: {ms:.3f} device ms per forward "
                    f"over its {launches[kname]} launches, every shape "
                    f"[{card}]")

    dt = torch.bfloat16
    p = mobile_params(rng, dt, "cuda")
    p2 = mobile_params(rng, dt, "cuda")
    x64 = nhwc(rng, B_TIME, 64, dt, "cuda")
    x32 = nhwc(rng, B_TIME, 32, dt, "cuda")
    # Library yardsticks, never called by the port: the plain mobile
    # model's own bottleneck (fi._bottleneck_plain: separable cuDNN convs,
    # BN and the adds) at the same shape; for #9 followed by the 2x2
    # maxpool, for #10 two of them around the upsample-add.
    bneck = lambda v, n: fi._bottleneck_plain(fp, v, f"hg0_{n}", C)
    cases = {
        "fused_bottleneck_mobile": (
            "64x64", lambda: mk.fused_bottleneck_mobile(x64, p),
            lambda: mk.fused_bottleneck_mobile_plain(x64, p),
            lambda: bneck(x64, "downsample_f1")),
        "fused_bottleneck_mobile_pool": (
            "32x32", lambda: mk.fused_bottleneck_mobile_pool(x32, p),
            lambda: mk.fused_bottleneck_mobile_pool_plain(x32, p),
            lambda: fi.maxpool2x2(bneck(x32, "downsample_f2"))),
        "fused_uplevel_mobile": (
            "64x64", lambda: mk.fused_uplevel_mobile(x64, x32, p, p2),
            lambda: mk.fused_uplevel_mobile_plain(x64, x32, p, p2),
            lambda: bneck(bneck(x64, "upsample_f1_short")
                          + fi.upsample2x(x32), "upsample_f1_merged")),
    }
    bounds = mobile_bounds()
    with torch.inference_mode():
        for name, (shape, kern, plain, lib) in cases.items():
            ms = cuda_ms(kern, iters=5)
            plain_ms = cuda_ms(plain, iters=5)
            device_ms = kernel_device_ms(kern, name)
            lib_ms = cuda_ms(lib, iters=5)
            bms, by = bounds[name]
            report.setdefault(name, {}).update(
                ms=ms, plain_ms=plain_ms, device_ms=device_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms)
            log(f"times {name} bf16 B={B_TIME} {shape}: kernel {ms:.3f} ms "
                f"({device_ms:.3f} ms on the device), plain {plain_ms:.3f} "
                f"ms, library {lib_ms:.3f} ms, bound {bms:.4f} ms ({by}) "
                f"[{card}]")


def phase_mobile_eval(report, cfg, val, card):
    """One predict_ds pass of mobile S4/256 over phase 8's records, with
    exact launch counts, predictions equal to the plain decode's."""
    from single_person_pose_estimation_tpu_torch.data import pipeline
    from single_person_pose_estimation_tpu_torch.evaluation import (
        predict,
    )
    from single_person_pose_estimation_tpu_torch.models import (
        fused_inference as fi,
    )
    from single_person_pose_estimation_tpu_torch.ops import cuda as kernels
    from single_person_pose_estimation_tpu_torch.ops.cuda import (
        decode_kernel as dk,
    )

    model = build_s4_mobile(seed=3).to("cuda")

    def one_pass():
        with pipeline.DatasetBuilder(cfg) as b:
            t0 = time.perf_counter()
            preds = predict.predict_ds(model, None, b.get_ds_prediction(),
                                       save_path=None)
            return preds, time.perf_counter() - t0

    one_pass()
    kernels.reset_launch_counts()
    fi.plain_routes.update(forward=0, level=0)
    preds, elapsed = one_pass()
    counts = kernels.launch_counts()
    routes = dict(fi.plain_routes)
    forwards = N_EVAL // B_TIME
    want = dict.fromkeys(counts, 0)
    want.update({k: v * forwards for k, v in MOBILE_PER_FORWARD.items()},
                decode_batch=forwards)
    log(f"mobile_eval: {len(preds)} predictions in {elapsed:.2f} s = "
        f"{N_EVAL / elapsed:.1f} img/s; launches {counts} expected {want}; "
        f"plain routes {routes} [{card}]")
    if counts != want or any(routes.values()):
        raise AssertionError(f"mobile eval: launches {counts} != {want} or "
                             f"plain routes {routes}")
    predict.decode_batch = dk.decode_batch_plain
    try:
        plain, plain_s = one_pass()
    finally:
        predict.decode_batch = dk.decode_batch
    if plain != preds:
        bad = sum(p != q for p, q in zip(plain, preds))
        raise AssertionError(f"mobile eval: {bad} predictions differ from "
                             f"the plain decode's")
    log(f"mobile_eval: the pass with the plain decode took {plain_s:.2f} s; "
        f"predictions equal")
    check_predictions(preds, val, "mobile")
    report["_mobile_eval"] = N_EVAL / elapsed
    del model


# ---------------------------------------------------------------------------
# Evaluation from records: the decode kernel (#13) and predict_ds.
# ---------------------------------------------------------------------------

HM = 64                   # heatmap side at 256 px input
N_EVAL, N_EVAL_TRAIN = 1024, 256
EVAL_SIDE = 300           # source images; each holds one 256 px crop
BBOX = 205.0              # int(205 * 1.25) = 256: the crop needs no resize
DECODE_OPS = 1            # one compare per heatmap element for the bound
SERVED_DECODE_BATCHES = (1, 16)   # PoseServer buckets timed beside B=128
EVAL_ROOT = os.path.join(ROOT, "temp", "chip_smoke_eval")


def decode_inputs(rng, b, size=HM):
    """(b, size, size, K) float32 maps that cycle through random maps,
    single peaks with a runner-up neighbour (on borders and corners too),
    tied maxima and neighbours, flat and quantized maps, and all-negative
    maps (below the threshold)."""
    s = size - 1
    hm = rng.uniform(0, 1, (b, size, size, K)).astype(np.float32)
    spots = [(0, 0), (0, s), (s, 0), (s, s), (0, 30), (s, 9), (17, 0),
             (41, s), (32, 32), (3, 60)]
    for i in range(b):
        kind = i % 6
        if kind == 1:
            hm[i] *= 0.2
            for k in range(K):
                py, px = spots[(i + k) % len(spots)]
                py, px = min(py, s), min(px, s)
                hm[i, py, px, k] = 0.9
                ny = min(max(py + k % 3 - 1, 0), s)
                nx = min(max(px + (k // 3) % 3 - 1, 0), s)
                if (ny, nx) != (py, px):
                    hm[i, ny, nx, k] = 0.6
        elif kind == 2:
            hm[i] = 0.1
            hm[i, 4, 4] = hm[i, s - 2, 2] = 0.8
            hm[i, 4, 5] = hm[i, 5, 4] = 0.5
        elif kind == 3:
            hm[i] = np.round(hm[i] * 4) / 4
        elif kind == 4:
            hm[i] = 0.3 if i % 12 == 4 else 0.0
            hm[i, 0, 1, ::2] = 0.7
        elif kind == 5:
            hm[i] = -hm[i]
    return hm


def s4_heatmaps(model, n=B_TIME, seed=10):
    """S4/256 bf16 last-stack heatmaps of n random crops, from the kernel
    path and from the plain model: sigmoids of bf16 values, with many
    exact ties."""
    import torch

    from single_person_pose_estimation_tpu_torch.models.fused_inference import (
        fused_apply,
        prepare_fused,
    )

    x = torch.from_numpy(np.random.default_rng(seed).uniform(
        0, 1, (n, 256, 256, 3)).astype(np.float32)).cuda()
    with torch.inference_mode():
        fused = fused_apply(prepare_fused(model), x, **MAIN_FLAGS)[-1]
        plain = model(x)[-1]
    return {"S4/256 kernel path": fused.float(),
            "S4/256 plain model": plain.float()}


# (B, H, W, K) of the decode's edge cases: the served buckets 1 and 16,
# an odd batch, B=128 at one keypoint, K = 16 (one pixel a 16-byte row),
# 33 on a non-square map, a wide map (y = idx // H passes H), and
# H*W*K = 3825, not a multiple of 4 (4-byte loads); K = 543, odd, so a
# row is 4 * 543 floats read by blocks of 543 lanes with 86,880 bytes of
# shared memory (past the 48 KB a launch gets without asking), one
# image in a cluster of 4 at B=1 and at B=16 on an 8x8 map, and with
# 4-byte loads at 15x15 (one 543-float row, 21,720 bytes); K = 544, the
# wrapper's K_MAX. decode_edge_cases adds a 64x64x17 batch whose base
# lies 4 bytes off 16 (4-byte loads too).
DECODE_EDGES = ((1, 64, 64, K), (3, 64, 64, K), (16, 64, 64, K),
                (128, 64, 64, 1), (16, 64, 64, 16), (3, 32, 48, 33),
                (16, 16, 40, K), (3, 15, 15, K), (1, 64, 64, 543),
                (16, 8, 8, 543), (3, 15, 15, 543), (3, 16, 16, 544))


def decode_edge_maps(rng, b, h, w, k):
    """(b, h, w, k) float32 maps, one kind an image: random, a peak on a
    border or corner with runner-up neighbours, tied maxima, flat,
    quantized, the maximum in the last pixel, all negative, all -inf."""
    hm = rng.uniform(0, 1, (b, h, w, k)).astype(np.float32)
    spots = [(0, 0), (0, w - 1), (h - 1, 0), (h - 1, w - 1), (h // 2, 0),
             (0, w // 2), (h // 2, w // 2)]
    for i in range(b):
        kind = i % 8
        if kind == 1:
            hm[i] *= 0.2
            for c in range(k):
                py, px = spots[(i + c) % len(spots)]
                hm[i, py, px, c] = 0.9
                hm[i, min(py + 1, h - 1), max(px - 1, 0), c] = 0.6
                hm[i, py, min(px + 1, w - 1), c] = 0.6
        elif kind == 2:
            hm[i] = 0.1
            hm[i, h // 3, w // 3] = hm[i, h - 1, w // 2] = 0.8
        elif kind == 3:
            hm[i] = 0.3
        elif kind == 4:
            hm[i] = np.round(hm[i] * 4) / 4
        elif kind == 5:
            hm[i, h - 1, w - 1] = 2.0
        elif kind == 6:
            hm[i] = -hm[i]
        elif kind == 7:
            hm[i] = -np.inf
    return hm


def decode_edge_cases(rng):
    """{label: (B, H, W, K) CUDA maps} of DECODE_EDGES and the batch off
    16 bytes."""
    import torch

    cases = {}
    for b, h, w, k in DECODE_EDGES:
        cases[f"edge B={b} {h}x{w}x{k}"] = torch.from_numpy(
            decode_edge_maps(rng, b, h, w, k)).cuda()
    maps = torch.from_numpy(decode_edge_maps(rng, 3, HM, HM, K)).cuda()
    buf = torch.empty(maps.numel() + 1, device="cuda")
    off = buf[1:].view(maps.shape)
    off.copy_(maps)
    cases[f"edge B=3 {HM}x{HM}x{K}, base 4 bytes off 16"] = off
    return cases


def phase_decode_kernel(report, model):
    import torch

    from single_person_pose_estimation_tpu_torch.ops.cuda import (
        decode_kernel as dk,
    )

    rng = np.random.default_rng(11)
    cases = {"synthetic": torch.from_numpy(decode_inputs(rng, B_TIME)).cuda(),
             **s4_heatmaps(model), **decode_edge_cases(rng)}
    failures = []
    for label, hm in cases.items():
        flat = hm.reshape(hm.shape[0], -1, hm.shape[-1])
        ties = int((flat == flat.amax(1, keepdim=True)).sum().item()
                   - flat.shape[0] * flat.shape[-1])
        for legacy in (True, False):
            got = dk.decode_batch(hm, legacy=legacy)
            again = dk.decode_batch(hm, legacy=legacy)
            want = dk.decode_batch_plain(hm, legacy=legacy)
            torch.cuda.synchronize()
            err = (got - want).abs().nan_to_num().max().item()
            ok = got.shape == want.shape == (hm.shape[0], hm.shape[-1], 3) \
                and torch.equal(got, want) and torch.equal(got, again)
            mode = "legacy" if legacy else "corrected"
            log(f"kernel decode_batch {label} {tuple(hm.shape)} f32 {mode}: "
                f"max|d| = {err:.3e}, {ties} tied maxima beyond the first "
                f"{'ok' if ok else 'FAIL'}")
            ent = report.setdefault("decode_batch", {})
            ent["max_abs_err"] = max(ent.get("max_abs_err", 0.0), err)
            if not ok:
                failures.append(f"{label} {mode}: {err}")
    if failures:
        raise AssertionError("the decode kernel disagrees with its plain "
                             "version: " + "; ".join(failures))


def eval_dataset(root):
    """A COCO-format dataset of single-person images under `root`: val and
    train splits of 300x300 JPEGs, one person each, whose square crop is
    exactly 256 px. Coordinates are multiples of 1/8, so every stored
    float is exact and the ground truth round-trips exactly. Returns the
    config and {ann_id: annotation} of the val split."""
    from single_person_pose_estimation_tpu_torch import Config
    from single_person_pose_estimation_tpu_torch.data.images import (
        encode_jpeg,
    )

    rng = np.random.default_rng(12)
    noise = rng.normal(0, 12, (EVAL_SIDE, EVAL_SIDE, 3)).astype(np.float32)
    val = {}
    for split, n in (("val2017", N_EVAL), ("train2017", N_EVAL_TRAIN)):
        img_dir = os.path.join(root, "images", split)
        os.makedirs(img_dir, exist_ok=True)
        os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
        images, anns = [], []
        for i in range(n):
            # Smooth colour fields plus noise: a few tens of KB per JPEG.
            base = rng.uniform(0, 255, (6, 6, 3)).astype(np.float32)
            img = np.kron(base, np.ones((50, 50, 1), np.float32))
            img += np.roll(noise, int(rng.integers(EVAL_SIDE)), axis=0)
            x0, y0 = (rng.integers(240, 560, 2) / 8).tolist()
            sq0 = (x0 + BBOX / 2 - BBOX * 1.25 / 2,
                   y0 + BBOX / 2 - BBOX * 1.25 / 2)
            kps = []
            for k in range(K):
                kx = sq0[0] + rng.integers(8, 1016) / 4
                ky = sq0[1] + rng.integers(8, 1016) / 4
                v = int(rng.choice([0, 1, 2], p=[0.2, 0.2, 0.6]))
                if v:
                    cx, cy = int(kx), int(ky)
                    img[cy - 3:cy + 3, cx - 3:cx + 3] = 255.0
                kps += [kx, ky, v]
            name = f"{i:012d}.jpg"
            with open(os.path.join(img_dir, name), "wb") as f:
                f.write(encode_jpeg(np.clip(img, 0, 255).astype(np.uint8)))
            images.append({"id": i + 1, "file_name": name,
                           "width": EVAL_SIDE, "height": EVAL_SIDE})
            ann = {"id": 10_000 + i, "image_id": i + 1, "category_id": 1,
                   "iscrowd": 0, "bbox": [x0, y0, BBOX, BBOX],
                   "area": BBOX * BBOX,
                   "num_keypoints": sum(v > 0 for v in kps[2::3]),
                   "keypoints": kps}
            anns.append(ann)
            if split == "val2017":
                val[ann["id"]] = ann
        with open(os.path.join(root, "annotations",
                               f"person_keypoints_{split}.json"), "w") as f:
            json.dump({"images": images, "annotations": anns,
                       "categories": []}, f)
    cfg = Config(dataset_dir=root, batch_size=B_TIME, min_num_keypoints=1,
                 num_examples_per_record=128, compute_dtype="bfloat16",
                 temporary_dir=os.path.join(root, "run"), seed=0)
    return cfg, val


def eval_model(cfg, seed):
    """Save S4/256 (init_variables(seed=0)) as a checkpoint the way the
    Trainer does, and restore it into a model from another seed with
    load_model_from_checkpoint."""
    import torch

    from single_person_pose_estimation_tpu_torch.training import (
        steps as steps_lib,
    )
    from single_person_pose_estimation_tpu_torch.training.checkpoint import (
        CheckpointManager,
    )
    from single_person_pose_estimation_tpu_torch.utils.model_utils import (
        load_model_from_checkpoint,
    )

    saved = steps_lib.TrainState.create(
        build_s4(), lambda m: steps_lib.make_optimizer(m, 2.5e-4),
        device="cuda")
    CheckpointManager(cfg.checkpoints_path).save(
        1, saved, {"epoch": 1, "lr_schedule": None, "warmup_steps": 0})
    state, _ = load_model_from_checkpoint(build_s4(seed=seed),
                                          cfg.checkpoints_path)
    want = saved.model.state_dict()
    diff = [k for k, v in state.model.state_dict().items()
            if not torch.equal(v, want[k])]
    if diff:
        raise AssertionError(f"restored weights differ: {diff[:5]}")
    return state


def phase_eval(report):
    """Records -> predictions -> OKS and PCK on S4/256 at B=128."""
    import torch

    from single_person_pose_estimation_tpu_torch.configs.default_config import (
        COCO_KEYPOINT_LABELS,
    )
    from single_person_pose_estimation_tpu_torch.data import (
        coco,
        pipeline,
        tfrecord,
    )
    from single_person_pose_estimation_tpu_torch.evaluation import (
        predict,
    )
    from single_person_pose_estimation_tpu_torch.evaluation.oks import (
        eval_oks,
    )
    from single_person_pose_estimation_tpu_torch.evaluation.pck import (
        eval_pck,
    )
    from single_person_pose_estimation_tpu_torch.models import (
        fused_inference as fi,
    )
    from single_person_pose_estimation_tpu_torch.ops import cuda as kernels
    from single_person_pose_estimation_tpu_torch.ops.cuda import (
        decode_kernel as dk,
    )
    from single_person_pose_estimation_tpu_torch.training.steps import (
        recalibrate_batch_stats,
    )

    shutil.rmtree(EVAL_ROOT, ignore_errors=True)
    t0 = time.perf_counter()
    cfg, val = eval_dataset(EVAL_ROOT)
    t1 = time.perf_counter()
    coco.gen_trainval_records(cfg)
    t2 = time.perf_counter()
    if not tfrecord.native_available():
        raise AssertionError("the native TFRecord reader is not in use")
    log(f"eval: wrote {N_EVAL} + {N_EVAL_TRAIN} source images in "
        f"{t1 - t0:.1f} s, their records in {t2 - t1:.1f} s; native "
        f"reader {tfrecord.library_path().name}")
    state = eval_model(cfg, seed=1)
    builder = pipeline.DatasetBuilder(cfg)
    if builder.num_valid_examples != N_EVAL:
        raise AssertionError(f"{builder.num_valid_examples} val records")
    train_it, _ = builder.build_datasets()
    n = 2            # cmd_eval --recalibrate-batches 2
    recalibrate_batch_stats(state, (next(train_it) for _ in range(n)),
                            momentum=1.0 - 1.0 / n)
    builder.close()
    torch.cuda.synchronize()

    runs = {}
    for flip in (False, True):
        with pipeline.DatasetBuilder(cfg) as b:
            kernels.reset_launch_counts()
            fi.plain_routes.update(forward=0, level=0)
            t0 = time.perf_counter()
            preds = predict.predict_ds(state.model, state,
                                       b.get_ds_prediction(),
                                       save_path=None, flip_test=flip)
            elapsed = time.perf_counter() - t0
            counts = kernels.launch_counts()
            routes = dict(fi.plain_routes)
        forwards = (N_EVAL // B_TIME) * (2 if flip else 1)
        want = {**{k: v * forwards for k, v in PER_FORWARD.items()},
                "decode_batch": N_EVAL // B_TIME,
                **{k: 0 for k in (*TRAIN_KERNELS, *MOBILE_KERNELS,
                                  *FUSED_KERNELS, *DIAL_KERNELS)}}
        label = "flip-TTA" if flip else "plain"
        log(f"eval {label}: {len(preds)} predictions in {elapsed:.2f} s; "
            f"launches {counts} expected {want}; plain routes {routes}")
        if counts != want or any(routes.values()):
            raise AssertionError(f"eval {label}: launches {counts} != "
                                 f"{want} or plain routes {routes}")
        ent = report.setdefault("decode_batch", {})
        ent["launches"] = ent.get("launches", 0) + counts["decode_batch"]
        # The same pass with the plain decode: the kernel path's heatmaps
        # are deterministic, so the predictions must be equal.
        predict.decode_batch = dk.decode_batch_plain
        try:
            with pipeline.DatasetBuilder(cfg) as b:
                plain = predict.predict_ds(state.model, state,
                                           b.get_ds_prediction(),
                                           save_path=None, flip_test=flip)
        finally:
            predict.decode_batch = dk.decode_batch
        if plain != preds:
            bad = sum(p != q for p, q in zip(plain, preds))
            raise AssertionError(f"eval {label}: {bad} predictions differ "
                                 f"from the plain decode's")
        check_predictions(preds, val, label)
        runs[label] = preds

    gt = os.path.join(cfg.dataset_dir, "annotations",
                      "person_keypoints_val2017.json")
    for label, preds in runs.items():
        stats = eval_oks(preds, gt, verbose=False)
        pck = eval_pck(preds, COCO_KEYPOINT_LABELS, verbose=False)
        log(f"eval {label}: OKS stats {np.round(stats, 4).tolist()}; PCK "
            f"mean {np.mean(pck):.4f} over {len(pck)} labels")
        if stats.shape != (10,) or not np.isfinite(stats).all() \
                or len(pck) != K or not np.isfinite(pck).all():
            raise AssertionError(f"eval {label}: OKS {stats}, PCK {pck}")
    del state
    return cfg, val


def check_predictions(preds, val, label):
    """Every keypoint finite and inside its crop box; ids, visibilities,
    GT keypoints and the original bbox exactly as annotated."""
    if sorted(p["ann_id"] for p in preds) != sorted(val):
        raise AssertionError(f"eval {label}: the predictions' ids differ "
                             f"from the annotations'")
    for p in preds:
        ann = val[p["ann_id"]]
        side = int(BBOX * 1.25)
        sq0 = [c + BBOX / 2 - BBOX * 1.25 / 2 for c in ann["bbox"][:2]]
        xs, ys = np.asarray(p["xs/pred"]), np.asarray(p["ys/pred"])
        inside = (np.isfinite(xs).all() and np.isfinite(ys).all()
                  and (xs >= sq0[0]).all() and (xs < sq0[0] + side).all()
                  and (ys >= sq0[1]).all() and (ys < sq0[1] + side).all())
        kx, ky, kv = (ann["keypoints"][i::3] for i in range(3))
        gt_x = [x if v else sq0[0] for x, v in zip(kx, kv)]
        gt_y = [y if v else sq0[1] for y, v in zip(ky, kv)]
        if not inside or p["image_id"] != ann["image_id"] \
                or p["original_bbox"] != ann["bbox"] or p["vs"] != kv \
                or p["xs/gt"] != gt_x or p["ys/gt"] != gt_y \
                or len(p["confs"]) != K:
            raise AssertionError(f"eval {label}: prediction of annotation "
                                 f"{p['ann_id']} is off: {p}")


def phase_eval_times(report, cfg, card):
    """Records-to-predictions img/s and its split; the decode kernel
    beside its plain version and beside argmax alone."""
    import torch

    from single_person_pose_estimation_tpu_torch.data import (
        pipeline,
        tfrecord,
    )
    from single_person_pose_estimation_tpu_torch.evaluation import (
        predict,
    )
    from single_person_pose_estimation_tpu_torch.models.fused_inference import (
        forward_last_stack,
        prepare_fused,
    )
    from single_person_pose_estimation_tpu_torch.ops.cuda import (
        decode_kernel as dk,
    )

    model = build_s4().to("cuda")

    def one_pass(flip):
        with pipeline.DatasetBuilder(cfg) as b:
            return predict.predict_ds(model, None, b.get_ds_prediction(),
                                      save_path=None, flip_test=flip)

    for flip in (False, True):
        one_pass(flip)
    times = {False: [], True: []}
    for i in range(3):
        for flip in ((False, True) if i % 2 == 0 else (True, False)):
            t0 = time.perf_counter()
            one_pass(flip)
            times[flip].append(time.perf_counter() - t0)
    for flip, ts in times.items():
        med = statistics.median(ts)
        label = "flip-TTA" if flip else "plain"
        log(f"eval_times S4/256 bf16 B={B_TIME} records -> predictions "
            f"({label}): median {med:.3f} s over {len(ts)} runs of "
            f"{N_EVAL} = {N_EVAL / med:.1f} img/s "
            f"(runs {[round(t, 3) for t in ts]}) [{card}]")
        report.setdefault("_eval", {})[label] = N_EVAL / med

    # The split. Host: parse one batch of records on one thread (the
    # builder spreads it over its decode threads).
    path = sorted(os.listdir(cfg.valid_tfrecords_dir))[0]
    records = list(tfrecord.iter_records(
        os.path.join(cfg.valid_tfrecords_dir, path)))[:B_TIME]
    t0 = time.perf_counter()
    batch = [pipeline._parse_prediction_example(r, cfg) for r in records]
    parse_s = time.perf_counter() - t0
    images = np.stack([im for im, _ in batch])
    workers = cfg.host_workers or max(1, min(4, (os.cpu_count() or 1) - 1))
    log(f"eval_times host parse of {len(records)} records (decode JPEG, "
        f"resize, meta) on one thread: {parse_s * 1e3:.1f} ms, "
        f"{parse_s / len(records) * 1e3:.3f} ms per record; the builder "
        f"runs {workers} decode threads [{card}]")
    x = torch.from_numpy(images).cuda()
    fp = prepare_fused(model)
    with torch.inference_mode():
        fwd = lambda: forward_last_stack(model, x, use_fused=True, auto=True,
                                         prepared=fp)
        fwd_ms = cuda_ms(fwd, iters=3)
        hm = fwd()
        prep_ms = cuda_ms(lambda: prepare_fused(model), iters=1)
    span, busy, per, gaps, _ = device_trace(lambda: one_pass(False), calls=1)
    log(f"eval_times S4/256 bf16 B={B_TIME} forward (kernels): "
        f"{fwd_ms:.2f} ms per batch; prepare_fused (BN folding, once per "
        f"predict_ds call) {prep_ms:.2f} ms; one plain pass under the "
        f"profiler: device span {span:.1f} ms, busy {busy:.1f} ms, idle "
        f"share {1 - busy / span:.4f} [{card}]")
    log("  longest idle gaps (ms, at ms into the pass): "
        + ", ".join(f"{g:.1f} at {at:.1f}" for g, at in gaps))
    for kname, (kms, n) in sorted(per.items(), key=lambda kv: -kv[1][0])[:8]:
        log(f"  {kms:9.3f} ms/pass {kms / busy:6.1%} x{n:6.1f}  {kname}")

    flat = hm.reshape(hm.shape[0], -1, K)
    kern = lambda: dk.decode_batch(hm)
    ms = cuda_ms(kern, iters=20)
    # Straight from the forward, and back to back here, the 35.65 MB of
    # maps sit in the 50 MB L2; after a 128 MB write they come from HBM.
    device_ms = kernel_device_ms(kern, "decode_batch")
    cold_ms = kernel_device_ms(kern, "decode_batch", before=l2_scrub())
    clean_ms = kernel_device_ms(kern, "decode_batch",
                                before=l2_scrub(clean=True))
    plain_ms = cuda_ms(lambda: dk.decode_batch_plain(hm), iters=20)
    argmax_ms = cuda_ms(lambda: flat.argmax(1), iters=20)
    n = hm.numel()
    bms, by = bound(DECODE_OPS * n, 4 * n + 4 * 3 * B_TIME * K, PEAK_F32)
    # The served buckets 1 and 16 find their maps in L2, straight from the
    # forward.
    served = {}
    for b in SERVED_DECODE_BATCHES:
        part = hm[:b]
        served[f"device_ms_b{b}"] = kernel_device_ms(
            lambda: dk.decode_batch(part), f"decode_batch B={b}")
    report.setdefault("decode_batch", {}).update(
        ms=ms, device_ms=device_ms, device_ms_cold_l2=cold_ms,
        device_ms_cold_l2_clean=clean_ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=None, argmax_ms=argmax_ms, **served)
    log(f"times decode_batch f32 B={B_TIME} {tuple(hm.shape)}: kernel "
        f"{ms:.4f} ms per call ({device_ms:.4f} ms on the device with the "
        f"maps in L2, {cold_ms:.4f} ms after an L2 scrub that writes, "
        f"{clean_ms:.4f} after one that reads; device/bound "
        f"{device_ms / bms:.2f}, after a scrub {cold_ms / bms:.2f} and "
        f"{clean_ms / bms:.2f}), plain "
        f"{plain_ms:.4f} ms, bound {bms:.4f} ms ({by}); flat.argmax(1) "
        f"alone (the argmax part only, not the same function) "
        f"{argmax_ms:.4f} ms; on the device with the maps in L2 at "
        + ", ".join(f"B={b} {served[f'device_ms_b{b}']:.4f} ms"
                    for b in SERVED_DECODE_BATCHES) + f" [{card}]")
    del model


# ---------------------------------------------------------------------------
# Training: the warp (#11) and heatmap (#12) kernels and the S4/256 trainer.
# ---------------------------------------------------------------------------

TRAIN_KERNELS = ("resample_last_axis", "render_heatmaps_batch")
B_TRAIN = 64        # the train step's batch
IMG = 256
# #11 and #12 run the plain version's float32 operations in the same order
# with every operation rounded (no FMA contraction, expf without fast-math),
# so they should agree bit for bit or within an ulp of expf: 1e-6. #11 has
# no expf, so it is held bit for bit (TOL_RESAMPLE).
TOL_TRAIN_KERNELS = 1e-6
TOL_RESAMPLE = 0.0
# Bounds: the card's peaks (NVIDIA H100 SXM data sheet, dense): bf16 tensor
# cores 989 TFLOP/s, float32 outside the tensor cores 67 TFLOP/s, HBM
# 3.35 TB/s.
PEAK_BF16, PEAK_F32, HBM = 989e12, 67e12, 3.35e12
# Operations per output element counted for the bound: #11 forms pos (3),
# two weights (3 each), two products and a sum (3); #12 two compares per
# coordinate and the validity test, and in the window d2 (3), the
# division and exp.
OPS_RESAMPLE = 12
TRAIN_STEPS_PER_EPOCH, TRAIN_EPOCHS, RESUME_EPOCHS = 3, 2, 1


def bound(flops, nbytes, peak):
    """(ms, 'operations' or 'bytes'): the least time the card could take."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def subtree_bound(depth, b=B_TIME, e=2):
    """#7 at `depth` (bf16): the 3*depth+3 bottlenecks of the levels from
    its input side 4 << depth down to the 4 px bottom, the input map read
    and the output map written once, each weight set read once."""
    macs = C * CM + 9 * CM * CM + CM * C          # one bottleneck, a pixel
    top = 4 << depth
    pixels = sum(3 * b * (top >> k) ** 2 for k in range(depth + 1))
    return bound(2 * macs * pixels,
                 2 * b * top * top * C * e + (3 * depth + 3) * macs * e,
                 PEAK_BF16)


def inference_bounds():
    """Bounds of #1-#7 at phase_times' and phase_dial_times' shapes (bf16,
    B=128), counting each input (activations and weights) read once and
    each output written once: #5 a 128 px map at C=256; #6
    front_bottleneck_3 at 64 px, 128 -> 256 channels with a 1x1 conv skip;
    #7 at depth 2 (the 16, 8 and 4 px levels; subtree_bound gives each
    depth)."""
    b, e = B_TIME, 2
    w_bneck = (C * CM + 9 * CM * CM + CM * C) * e
    f_bneck = lambda h: 2 * b * h * h * (C * CM + 9 * CM * CM + CM * C)
    act = lambda h, c=C: b * h * h * c * e
    m = b * 64 * 64
    half = C // 2                                   # #6: 128 -> 256
    macs6 = half * C + half * half + 9 * half * half + half * C
    return {
        "fused_bottleneck_rows": bound(f_bneck(128), 2 * act(128) + w_bneck,
                                       PEAK_BF16),
        "fused_bottleneck_convskip": bound(
            2 * macs6 * b * 64 * 64, act(64, half) + act(64) + macs6 * e,
            PEAK_BF16),
        "fused_subtree": subtree_bound(2),
        "fused_bottleneck": bound(f_bneck(64), 2 * act(64) + w_bneck,
                                  PEAK_BF16),
        "fused_bottleneck_pool": bound(
            f_bneck(32), 2 * act(32) + act(16) + w_bneck, PEAK_BF16),
        "fused_uplevel": bound(2 * f_bneck(64),
                               2 * act(64) + act(32) + 2 * w_bneck,
                               PEAK_BF16),
        "fused_head": bound(2 * m * (C * C + C * K + C * C + K * C),
                            3 * act(64) + m * K * 4
                            + (2 * C * C + 2 * K * C) * e, PEAK_BF16),
    }


def mobile_bounds():
    """Bounds of #8-#10 at phase_mobile_times' shapes (bf16, B=128): per
    pixel three pointwise products and 9 depthwise taps (2 operations per
    multiply-add), each input read once and each output written once."""
    b, e = B_TIME, 2
    w_mob = (C * CM + CM * CM + CM * C) * e + 9 * CM * 4 + (6 * CM + 3 * C) * 4
    f_mob = lambda h: 2 * b * h * h * (C * CM + CM * CM + CM * C + 9 * CM)
    act = lambda h: b * h * h * C * e
    return {
        "fused_bottleneck_mobile": bound(f_mob(64), 2 * act(64) + w_mob,
                                         PEAK_BF16),
        "fused_bottleneck_mobile_pool": bound(
            f_mob(32), 2 * act(32) + act(16) + w_mob, PEAK_BF16),
        "fused_uplevel_mobile": bound(2 * f_mob(64),
                                      2 * act(64) + act(32) + 2 * w_mob,
                                      PEAK_BF16),
    }


def warp_inputs(rng, device):
    """B_TRAIN images and draws that cover flips, scales that push samples
    off the edge (0.5-1.6) and the full rotation range."""
    import torch

    imgs = torch.from_numpy(rng.uniform(0, 1, (B_TRAIN, IMG, IMG, 3))
                            .astype(np.float32)).to(device)
    theta = torch.from_numpy(rng.uniform(-np.pi / 6, np.pi / 6, B_TRAIN)
                             .astype(np.float32)).to(device)
    scale = torch.from_numpy(rng.uniform(0.5, 1.6, B_TRAIN)
                             .astype(np.float32)).to(device)
    flip = torch.arange(B_TRAIN, device=device) % 2 == 1
    return imgs, theta, scale, flip


def keypoint_inputs(rng, device):
    """(B_TRAIN, K) keypoints with border (0, 63, 64), negative, fractional
    and invisible cases among uniform ones."""
    import torch

    kx = rng.uniform(-3, 67, (B_TRAIN, K)).astype(np.float32)
    ky = rng.uniform(-3, 67, (B_TRAIN, K)).astype(np.float32)
    kx[:, :6] = [0.0, 0.5, 63.0, 63.9, 64.0, -0.7]
    ky[:, 6:12] = [0.0, 0.5, 63.0, 63.9, 64.0, -0.7]
    kv = rng.integers(0, 3, (B_TRAIN, K)).astype(np.int32)
    return tuple(torch.from_numpy(a).to(device) for a in (kx, ky, kv))


# (B, H, W, K, sigma) of the heatmap kernel's edge cases: batch 1 at K =
# 1, 16 and 17 and sigma 2 (radius 6); W*K = 561, not a multiple of 4
# (4-byte stores); a non-square map; rows of 9,100 floats (one row a
# block); 4,099 keypoints; sigma 40 on 96 px (radius 96, every row of the
# map in some window).
HEATMAP_EDGES = ((1, 32, 32, 1, 2.0), (1, 32, 32, 16, 2.0),
                 (1, 32, 32, K, 2.0), (3, 40, 33, K, 1.0),
                 (2, 48, 64, K, 1.0), (2, 6, 13, 700, 2.0),
                 (1, 16, 16, 4099, 1.0), (2, 96, 96, 3, 40.0))


def heatmap_edge_cases(rng, device):
    """[(label, (kx, ky, kv), H, W, sigma)] of HEATMAP_EDGES: keypoints
    uniform over the map and 3 px beyond, the border, negative and
    fractional cases in the first image, about a third invisible."""
    import torch

    cases = []
    for b, h, w, k, sigma in HEATMAP_EDGES:
        kx = rng.uniform(-3, w + 3, (b, k)).astype(np.float32)
        ky = rng.uniform(-3, h + 3, (b, k)).astype(np.float32)
        kx[0, :6] = [0.0, 0.5, w - 1.0, w - 0.1, float(w), -0.7][:k]
        ky[0, :6] = [2.0, h - 1.0, 0.5, h - 0.1, -0.7, float(h)][:k]
        kx[:, 0] = np.clip(kx[:, 0], 1.0, w - 1.0)
        ky[:, 0] = np.clip(ky[:, 0], 1.0, h - 1.0)
        kv = rng.integers(0, 3, (b, k)).astype(np.int32)
        kv[:, 0] = 2
        cases.append((f"B={b} {h}x{w}x{k} sigma {sigma}",
                      tuple(torch.from_numpy(a).to(device)
                            for a in (kx, ky, kv)), h, w, sigma))
    return cases


def warp_passes(imgs, theta, scale, flip):
    """The two resample passes of one warp at the main path's shapes:
    [(input (B, C, L, K), (slope, line_coef, line_const))] each; pass 2's
    input comes from the kernel's pass 1."""
    from single_person_pose_estimation_tpu_torch.ops.cuda import (
        warp_kernel as wk,
    )

    p1, p2 = wk.warp_pass_params(theta, scale, flip, IMG)
    x1 = imgs.permute(0, 3, 1, 2).contiguous()
    x2 = wk.resample_last_axis(x1, *p1).transpose(2, 3).contiguous()
    return [(x1, p1), (x2, p2)]


def phase_train_kernels(report):
    import torch

    from single_person_pose_estimation_tpu_torch.ops.cuda import (
        heatmap_kernel as hk,
        warp_kernel as wk,
    )

    rng = np.random.default_rng(4)
    failures = []
    imgs, theta, scale, flip = warp_inputs(rng, "cuda")
    for i, (x, p) in enumerate(warp_passes(imgs, theta, scale, flip)):
        got, want = wk.resample_last_axis(x, *p), \
            wk.resample_last_axis_plain(x, *p)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        zero = (want == 0).float().mean().item()
        ok = got.shape == want.shape and torch.isfinite(got).all().item() \
            and err <= TOL_RESAMPLE
        log(f"kernel resample_last_axis pass {i + 1} {tuple(x.shape)} f32: "
            f"max|d| = {err:.3e}, zero-filled share {zero:.3f} "
            f"{'ok' if ok else 'FAIL'}")
        ent = report.setdefault("resample_last_axis", {})
        ent["max_abs_err"] = max(ent.get("max_abs_err", 0.0), err)
        if not ok:
            failures.append(f"resample pass {i + 1}: {err}")
    kx, ky, kv = keypoint_inputs(rng, "cuda")
    cases = [(f"B={B_TRAIN} 64x64x{K} sigma 1.0", (kx, ky, kv), 64, 64,
              1.0)] + heatmap_edge_cases(rng, "cuda")
    for label, kps, h, w, sigma in cases:
        got = hk.render_heatmaps_batch(*kps, h, w, sigma)
        again = hk.render_heatmaps_batch(*kps, h, w, sigma)
        want = hk.render_heatmaps_batch_plain(*kps, h, w, sigma)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        peaks = int((want == 1.0).sum().item())
        ok = got.shape == want.shape == (kps[0].shape[0], h, w,
                                         kps[0].shape[1]) \
            and err <= TOL_TRAIN_KERNELS and torch.equal(got, again) \
            and torch.equal(got > 0, want > 0) and peaks > 0
        log(f"kernel render_heatmaps_batch {label} f32: max|d| = {err:.3e}, "
            f"{peaks} peaks rendered, same bits on a rerun "
            f"{'ok' if ok else 'FAIL'}")
        ent = report.setdefault("render_heatmaps_batch", {})
        ent["max_abs_err"] = max(ent.get("max_abs_err", 0.0), err)
        if not ok:
            failures.append(f"heatmap {label}: {err}")
    if failures:
        raise AssertionError("training kernels disagree with their plain "
                             "versions: " + "; ".join(failures))


def train_config(root, stacks=4):
    from single_person_pose_estimation_tpu_torch import Config

    return Config(hg_num_stacks=stacks, hg_num_channels=C,
                  batch_size=B_TRAIN, compute_dtype="bfloat16",
                  temporary_dir=root, augment_backend="auto", seed=0)


def build_s4_train(seed=0, stacks=4):
    import torch

    from single_person_pose_estimation_tpu_torch.models.hourglass import (
        StackedHourglass,
    )
    from single_person_pose_estimation_tpu_torch.utils.weight_convert import (
        init_variables,
        load_variables,
    )

    model = StackedHourglass(num_stacks=stacks, num_channels=C,
                             compute_dtype=torch.bfloat16)
    return load_variables(model, init_variables(stacks, C, seed=seed))


def phase_train(report):
    """S4/256 bf16 (f32 params) trained by `Trainer` on synthetic crops with
    augmentation, then resumed in a new Trainer; a fixed batch without
    augmentation must lose loss over 20 steps."""
    import torch

    from single_person_pose_estimation_tpu_torch import losses
    from single_person_pose_estimation_tpu_torch.data.in_memory import (
        ArrayDatasetBuilder,
        synthetic_crops,
    )
    from single_person_pose_estimation_tpu_torch.ops import cuda as kernels
    from single_person_pose_estimation_tpu_torch.training import (
        steps as steps_lib,
    )
    from single_person_pose_estimation_tpu_torch.training.trainer import (
        Trainer,
    )

    root = os.path.join(ROOT, "temp", "chip_smoke_train")
    shutil.rmtree(root, ignore_errors=True)
    cfg = train_config(root)
    builder = ArrayDatasetBuilder(
        synthetic_crops(TRAIN_STEPS_PER_EPOCH * B_TRAIN, IMG, seed=5),
        synthetic_crops(B_TRAIN, IMG, seed=6), B_TRAIN, seed=0)
    try:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        trainer = Trainer(build_s4_train(), builder, TRAIN_EPOCHS, 2.5e-4,
                          "weighted_mse", cfg, augment=True, device="cuda")
        if trainer.state.model.count_params() != S4_PARAMS:
            raise AssertionError("the trained model is not S4/256")
        trainer.train()
        saved = snapshot(trainer.state)
        rows = list(trainer.logger.rows)
        trainer.close()
        resumed = Trainer(build_s4_train(seed=1), builder, RESUME_EPOCHS,
                          2.5e-4, "weighted_mse", cfg, augment=True,
                          device="cuda")
        resumed.resume_training()
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        counts = kernels.launch_counts()
        rows += resumed.logger.rows
        resumed.close()
        # The restore alone, into a third fresh state, against the saved one.
        check = Trainer(build_s4_train(seed=2), builder, 1, 2.5e-4,
                        "weighted_mse", cfg, device="cuda")
        check.ckpt.restore(check.state, epoch=TRAIN_EPOCHS)
        diffs = compare_snapshots(saved, snapshot(check.state))
        check.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    steps = (TRAIN_EPOCHS + RESUME_EPOCHS) * TRAIN_STEPS_PER_EPOCH
    evals = TRAIN_EPOCHS + RESUME_EPOCHS
    want = {"resample_last_axis": 2 * steps,
            "render_heatmaps_batch": steps + evals}
    log(f"train: S4/256 bf16 B={B_TRAIN}, {steps} train steps and {evals} "
        f"eval steps in {elapsed:.1f} s; launches {counts} expected {want}")
    for r in rows:
        log(f"train epoch: loss {r['loss']:.5f} val_loss {r['val_loss']:.5f}")
    got = {n: counts[n] for n in TRAIN_KERNELS}
    if got != want or any(counts[n] for n in (*PER_FORWARD, *MOBILE_KERNELS,
                                              *FUSED_KERNELS, *DIAL_KERNELS,
                                              "decode_batch")):
        raise AssertionError(f"train launch counts {counts} != {want}")
    for n in TRAIN_KERNELS:
        report.setdefault(n, {})["launches"] = counts[n]
    if len(rows) != steps // TRAIN_STEPS_PER_EPOCH or not all(
            np.isfinite(v) for r in rows for v in r.values()):
        raise AssertionError(f"non-finite or missing epoch losses: {rows}")
    log(f"train resume: restored state vs saved: {diffs}")
    if any(diffs.values()):
        raise AssertionError(f"restored state differs from the saved one: "
                             f"{diffs}")

    # One fixed batch, no augmentation: the loss must go down.
    state = steps_lib.TrainState.create(
        build_s4_train(), lambda m: steps_lib.make_optimizer(m, 1e-3),
        seed=0, device="cuda")
    step = steps_lib.make_train_step(losses.weighted_mse, cfg, augment=False)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in synthetic_crops(B_TRAIN, IMG, seed=7).items()}
    losses = []
    for _ in range(20):
        state, m = step(state, batch)
        losses.append(m["loss"])
    losses = torch.stack(losses).tolist()
    log("train fixed batch, 20 steps: loss " + " ".join(
        f"{v:.4f}" for v in losses))
    if not (np.isfinite(losses).all()
            and np.mean(losses[-5:]) < 0.95 * losses[0]):
        raise AssertionError(f"the fixed-batch loss did not go down: "
                             f"{losses}")
    del state


def snapshot(state):
    """What a checkpoint must bring back: params, BN statistics, Adam
    moments, schedule count, step and generator state, on the host."""
    opt = state.optimizer.state_dict()
    moments = {f"{i}.{k}": v.detach().cpu().clone()
               for i, st in opt["adam"]["state"].items()
               for k, v in st.items()}
    return {"model": {k: v.detach().cpu().clone()
                      for k, v in state.model.state_dict().items()},
            "adam": moments, "count": opt["count"], "step": state.step,
            "generator": state.generator.get_state().clone()}


def compare_snapshots(a, b):
    """Number of differing entries per part (0 everywhere means equal)."""
    import torch

    def tensors(x, y):
        if x.keys() != y.keys():
            return len(x.keys() ^ y.keys()) or 1
        return sum(not torch.equal(x[k], y[k]) for k in x)

    return {"model": tensors(a["model"], b["model"]),
            "adam": tensors(a["adam"], b["adam"]),
            "count": int(a["count"] != b["count"]),
            "step": int(a["step"] != b["step"]),
            "generator": int(not torch.equal(a["generator"],
                                             b["generator"]))}


def phase_train_times(report, card):
    """The train step at B=64 and its split; the warp on each backend; each
    training kernel beside its plain version."""
    import torch
    import torch.nn.functional as F

    from single_person_pose_estimation_tpu_torch import losses
    from single_person_pose_estimation_tpu_torch.data.in_memory import (
        synthetic_crops,
    )
    from single_person_pose_estimation_tpu_torch.ops import augment as aug
    from single_person_pose_estimation_tpu_torch.ops.cuda import (
        heatmap_kernel as hk,
        warp_kernel as wk,
    )
    from single_person_pose_estimation_tpu_torch.training import (
        steps as steps_lib,
    )

    rng = np.random.default_rng(8)
    cfg = train_config(os.path.join(ROOT, "temp"))
    loss_fn = losses.weighted_mse
    state = steps_lib.TrainState.create(
        build_s4_train(), lambda m: steps_lib.make_optimizer(m, 2.5e-4),
        seed=0, device="cuda")
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in synthetic_crops(B_TRAIN, IMG, seed=9).items()}
    step = steps_lib.make_train_step(loss_fn, cfg, augment=True)
    imgs, kx, ky, kv = batch["image"], batch["kx"], batch["ky"], batch["kv"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    target = lambda: hk.render_heatmaps_batch(
        kx, ky, kv, cfg.label_height, cfg.label_width, cfg.hm_sigma)
    hms = target()

    def fwd_bwd_adam():
        state.optimizer.zero_grad()
        total, _ = steps_lib.forward_loss(state.model, loss_fn, imgs, hms)
        total.backward()
        state.optimizer.step()

    def augment(backend):
        return lambda: aug.augment_batch(gen, imgs, kx, ky, kv,
                                         geometric_backend=backend)

    split = {"step": lambda: step(state, batch),
             "augment (matmul2pass kernel)": augment("matmul2pass"),
             "augment (gather)": augment("gather"),
             "targets (heatmap kernel)": target,
             "fwd+bwd+Adam": fwd_bwd_adam}
    times = {name: [] for name in split}
    for fn in split.values():
        fn()
    for i in range(5):
        names = list(split) if i % 2 == 0 else list(reversed(split))
        for name in names:
            times[name].append(cuda_ms(split[name], iters=2, warmup=0))
    med = {n: statistics.median(ts) for n, ts in times.items()}
    for name, ms in med.items():
        log(f"train_times S4/256 bf16 B={B_TRAIN} {name}: median {ms:.3f} ms "
            f"over {len(times[name])} runs [{card}]")
    log(f"train_times S4/256 bf16 B={B_TRAIN} train step: "
        f"{B_TRAIN / med['step'] * 1e3:.1f} img/s [{card}]")
    span, busy, per, _, _ = device_trace(lambda: step(state, batch), calls=2)
    log(f"trace S4/256 bf16 B={B_TRAIN} train step: device span "
        f"{span:.2f} ms/step, busy {busy:.2f} ms, idle share "
        f"{1 - busy / span:.4f} [{card}]")
    for kname, (ms, n) in sorted(per.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"  {ms:9.3f} ms/step {ms / busy:6.1%} x{n:6.1f}  {kname}")
    del state

    # The warp alone on each backend, and one resample launch beside its
    # plain version and beside F.grid_sample (a single-pass bilinear warp,
    # a reference only: not the same function).
    wimgs, theta, scale, flip = warp_inputs(rng, "cuda")
    (x1, p1), _ = warp_passes(wimgs, theta, scale, flip)
    grid = torch.rand(B_TRAIN, IMG, IMG, 2, device="cuda") * 2 - 1
    nchw = wimgs.permute(0, 3, 1, 2).contiguous()
    kx, ky, kv = keypoint_inputs(rng, "cuda")
    warp_cases = {
        "warp matmul2pass (2 kernel launches + permutes)":
            lambda: wk.affine_warp_batch(wimgs, theta, scale, flip),
        "warp gather": lambda: aug._warp_image(wimgs, scale, theta, flip),
        "F.grid_sample bilinear, zeros (reference)":
            lambda: F.grid_sample(nchw, grid, mode="bilinear",
                                  padding_mode="zeros", align_corners=True),
    }
    for name, fn in warp_cases.items():
        log(f"train_times {name} B={B_TRAIN} {IMG}x{IMG}x3 f32: "
            f"{cuda_ms(fn, iters=10):.3f} ms [{card}]")
    n_out = x1.numel()
    kern_cases = {
        "resample_last_axis": (
            lambda: wk.resample_last_axis(x1, *p1),
            lambda: wk.resample_last_axis_plain(x1, *p1),
            bound(OPS_RESAMPLE * n_out, 2 * 4 * n_out, PEAK_F32)),
        "render_heatmaps_batch": (
            lambda: hk.render_heatmaps_batch(kx, ky, kv),
            lambda: hk.render_heatmaps_batch_plain(kx, ky, kv),
            heatmap_bound(kx, ky, kv)),
    }
    # Back to back, part of #11's 50.3 MB input can sit in the 50 MB L2;
    # after a 128 MB write it comes from HBM.
    scrub, clean = l2_scrub(), l2_scrub(clean=True)
    for name, (kern, plain, (bms, by)) in kern_cases.items():
        ms, plain_ms = cuda_ms(kern, iters=20), cuda_ms(plain, iters=20)
        # The events above time back-to-back wrapper calls, host work
        # included; kernel_device_ms the device's time alone.
        device_ms = kernel_device_ms(kern, name)
        cold_ms = kernel_device_ms(kern, name, before=scrub)
        clean_ms = kernel_device_ms(kern, name, before=clean)
        report.setdefault(name, {}).update(
            ms=ms, device_ms=device_ms, device_ms_cold_l2=cold_ms,
            device_ms_cold_l2_clean=clean_ms, plain_ms=plain_ms,
            bound_ms=bms, bound_by=by, library_ms=None)
        log(f"times {name} f32 B={B_TRAIN}: kernel {ms:.4f} ms per call "
            f"({device_ms:.4f} ms on the device, {cold_ms:.4f} ms after an "
            f"L2 scrub that writes, {clean_ms:.4f} after one that reads), "
            f"plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({by}; "
            f"device/bound {device_ms / bms:.2f}, after a scrub "
            f"{cold_ms / bms:.2f} and {clean_ms / bms:.2f}) [{card}]")
    # The card's own fill of #12's output, for the same 17.8 MB of writes
    # (a yardstick of the write rate, not the same function).
    zeros = torch.empty((B_TRAIN, 64, 64, K), device="cuda")
    log(f"times zero_() of render_heatmaps_batch's output f32 B={B_TRAIN}: "
        f"{kernel_device_ms(zeros.zero_, 'zero_'):.4f} ms on the device, "
        f"{kernel_device_ms(zeros.zero_, 'zero_', before=scrub):.4f} after "
        f"an L2 scrub that writes [{card}]")
    del scrub, clean, zeros


def heatmap_bound(kx, ky, kv, height=64, width=64, sigma=1.0):
    """#12's bound for these keypoints: the float32 output written once and
    the keypoints read once; per element 5 compares, and for the elements
    this data puts in a valid window d2, a division and an exp (counted
    as 5)."""
    import torch

    xi, yi = torch.trunc(kx).int(), torch.trunc(ky).int()
    valid = (xi > 0) & (xi < width) & (yi > 0) & (yi < height) & (kv > 0)
    r = int(3 * sigma)
    span = lambda c, n: (torch.clamp(c + r, max=n - 1)
                         - torch.clamp(c - r, min=0) + 1)
    in_window = int((valid * span(xi, width) * span(yi, height)).sum())
    n = kx.numel() * height * width
    return bound(5 * n + 5 * in_window, 4 * n + 12 * kx.numel(), PEAK_F32)


# ---------------------------------------------------------------------------
# Fused training: the six train-unit kernels (#14a-f) and the fused step.
# ---------------------------------------------------------------------------

FUSED_KERNELS = ("conv1x1_relu_stats", "conv3x3_relu_stats", "bn_bwd_reduce",
                 "unit1x1_bwd", "unit3x3_bwd", "unit1_bwd")
LEVELS = (64, 32, 16, 8, 4)
# Launches per call (see ops/cuda/bottleneck_train_kernel.py) and calls per
# bottleneck: 2 conv1x1 (units 1 and 3), one of each other function. The
# forward units and bn_bwd_reduce always launch their finalize kernel, a
# grid of one block included; a bf16 weight gradient skips its finalize
# only when its plan takes one row slice, which no level of the fused step
# at batch 64 does (tests/test_torch_tc_plan.py).
LAUNCHES_PER_CALL = {"conv1x1_relu_stats": 2, "conv3x3_relu_stats": 2,
                     "bn_bwd_reduce": 2, "unit1x1_bwd": 4, "unit3x3_bwd": 4,
                     "unit1_bwd": 3}
CALLS_PER_BNECK = {"conv1x1_relu_stats": 2, "conv3x3_relu_stats": 1,
                   "bn_bwd_reduce": 1, "unit1x1_bwd": 1, "unit3x3_bwd": 1,
                   "unit1_bwd": 1}
BNECKS_PER_STEP = 60          # 15 identity-skip bottlenecks x 4 stacks
# Tolerances of the train units. f32 (TF32 off): the kernels and the plain
# versions compute the same float32 products and round at the same points
# (the prologues bit for bit); only the order of the sums differs, over up
# to 9*256 terms for an activation (1e-5 * max(1, |v|)) and up to 262,144
# rows for a reduction (1e-4 of the output's largest |value|). bf16: one
# ulp (2^-8) flips where a float32 sum lands on a rounding boundary, and a
# flipped activation moves the reductions over it: every output, the
# reductions too, within PR 1's 1.6e-2 * max(1, |v|) element by element.
TOL_UNIT_ACT_F32 = 1e-5
TOL_UNIT_RED_F32 = 1e-4
TOL_UNIT_BF16 = 1.6e-2
TOL_FUSED_GRAD = 5e-3        # of the largest |g| (ROADMAP Queue 3)
TOL_FUSED_LOSS = 1e-5        # relative
TOL_FUSED_STATS = 1e-4       # of each running statistic's largest value
TOL_BACKEND_GRAD = 1e-4      # cuda vs plain bottleneck grads, f32, per tensor


def train_unit_inputs(rng, dtype, device, b, h):
    """One bottleneck's operands for the six units at C=256, Cm=128."""
    import torch

    def u(lo, hi, *shape, dt=torch.float32):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32)) \
            .to(device=device, dtype=dt)

    act = lambda c: u(-1, 1, b, h, h, c, dt=dtype)
    relu = lambda c: torch.relu(act(c))
    lim1, lim2 = np.sqrt(6 / (C + CM)), np.sqrt(6 / (18 * CM))
    kk = lambda c: torch.stack([u(.5, 1.5, c), u(-.1, .1, c), u(-.1, .1, c)])
    aff = lambda c: torch.stack([u(.5, 1.5, c), u(-.3, .3, c)])
    return dict(
        x=act(C), g=act(C), dz1=act(CM), dz2=act(CM),
        a1=relu(CM), a2=relu(CM), a3=relu(C),
        w1=u(-lim1, lim1, C, CM), w2=u(-lim2, lim2, 3, 3, CM, CM),
        w3=u(-lim1, lim1, CM, C), b1=u(-.1, .1, CM), b2=u(-.1, .1, CM),
        b3=u(-.1, .1, C), aff1=aff(CM), aff2=aff(CM), k1=kk(CM), k2=kk(CM),
        k3=kk(C))


def train_unit_cases(rng, dtype, device, b, levels=LEVELS):
    """(label, name, kernel call, plain call, output kinds) of #14a-f at
    every level of the path; kinds "act" (an activation in the compute
    dtype) or "red" (a float32 reduction: sums, dW, db)."""
    from single_person_pose_estimation_tpu_torch.ops.cuda import (
        bottleneck_train_kernel as tk,
    )

    cases = []
    for h in levels:
        p = train_unit_inputs(rng, dtype, device, b, h)
        calls = {
            "conv1x1_relu_stats@unit1": (
                "conv1x1_relu_stats", (p["x"], p["w1"], p["b1"]), {},
                ("act", "red")),
            "conv1x1_relu_stats@unit3": (
                "conv1x1_relu_stats", (p["a2"], p["w3"], p["b3"],
                                       *p["aff2"]), {}, ("act", "red")),
            "conv3x3_relu_stats": (
                "conv3x3_relu_stats", (p["a1"], p["w2"], p["b2"],
                                       *p["aff1"]), {}, ("act", "red")),
            "bn_bwd_reduce": ("bn_bwd_reduce", (p["g"], p["a3"]), {},
                              ("red",)),
            "unit1x1_bwd": ("unit1x1_bwd", (p["g"], p["a3"], p["a2"],
                                            p["w3"], p["k3"], p["aff2"]), {},
                            ("act", "red", "red", "red")),
            "unit3x3_bwd": ("unit3x3_bwd", (p["dz2"], p["a2"], p["a1"],
                                            p["w2"], p["k2"], p["aff1"]), {},
                            ("act", "red", "red", "red")),
            "unit1_bwd": ("unit1_bwd", (p["dz1"], p["a1"], p["x"], p["g"],
                                        p["w1"], p["k1"]), {},
                          ("act", "red", "red")),
        }
        if h == levels[0]:
            calls["unit1x1_bwd@no_next"] = (
                "unit1x1_bwd", (p["g"], p["a3"], p["a2"], p["w3"], p["k3"],
                                p["aff2"]),
                dict(reduce_next=False), ("act", "red", "red", "red"))
        for label, (name, args, kw, kinds) in calls.items():
            kern, plain = getattr(tk, name), getattr(tk, name + "_plain")
            cases.append((f"{label}@{h}", name,
                          lambda k=kern, a=args, kw=kw: k(*a, **kw),
                          lambda f=plain, a=args, kw=kw: f(*a, **kw), kinds))
    return cases


def tp_unit_cases(rng, dtype, device, b, m, levels=LEVELS):
    """(label, name, kernel call, plain call, output kinds) of #14a-d and
    #14f at every level at the shapes that a model axis of m ranks gives
    them (experimental/bottleneck_grad.py under tensor parallelism; #14e
    runs on its gathered weight there, so train_unit_cases' shapes hold
    it): unit 1's forward C -> Cm/m; the 3x3 forward Cm -> Cm/m; unit
    3's forward Cm -> C/m with the affine; bn_bwd_reduce on C/m and on
    Cm/m channels; unit1x1_bwd without the next sums on w3 (Cm, C/m);
    unit1_bwd on w1 (C, Cm/m). Operands as train_unit_inputs draws them."""
    import torch

    from single_person_pose_estimation_tpu_torch.ops.cuda import (
        bottleneck_train_kernel as tk,
    )

    def u(lo, hi, *shape, dt=torch.float32):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32)) \
            .to(device=device, dtype=dt)

    cl, cml = C // m, CM // m
    lim1, lim2 = np.sqrt(6 / (C + CM)), np.sqrt(6 / (18 * CM))
    kk = lambda c: torch.stack([u(.5, 1.5, c), u(-.1, .1, c), u(-.1, .1, c)])
    aff = lambda c: torch.stack([u(.5, 1.5, c), u(-.3, .3, c)])
    cases = []
    for h in levels:
        act = lambda c: u(-1, 1, b, h, h, c, dt=dtype)
        relu = lambda c: torch.relu(act(c))
        x, g, gl, dz2l, dz1l = act(C), act(C), act(cl), act(cml), act(cml)
        a1, a2, a1l, a2l, a3l = relu(CM), relu(CM), relu(cml), relu(cml), \
            relu(cl)
        w1, w2 = u(-lim1, lim1, C, cml), u(-lim2, lim2, 3, 3, CM, cml)
        w3 = u(-lim1, lim1, CM, cl)
        b1, b2, b3 = u(-.1, .1, cml), u(-.1, .1, cml), u(-.1, .1, cl)
        aff1, aff2, k1, k3 = aff(CM), aff(CM), kk(cml), kk(cl)
        red3 = ("act", "red", "red", "red")
        for label, name, args, kw, kinds in (
                ("conv1x1_relu_stats@unit1", "conv1x1_relu_stats",
                 (x, w1, b1), {}, ("act", "red")),
                ("conv3x3_relu_stats", "conv3x3_relu_stats",
                 (a1, w2, b2, *aff1), {}, ("act", "red")),
                ("conv1x1_relu_stats@unit3", "conv1x1_relu_stats",
                 (a2, w3, b3, *aff2), {}, ("act", "red")),
                ("bn_bwd_reduce@unit3", "bn_bwd_reduce", (gl, a3l), {},
                 ("red",)),
                ("bn_bwd_reduce@unit2", "bn_bwd_reduce", (dz2l, a2l), {},
                 ("red",)),
                ("unit1x1_bwd@no_next", "unit1x1_bwd",
                 (gl, a3l, a2, w3, k3, aff2), dict(reduce_next=False), red3),
                ("unit1_bwd", "unit1_bwd", (dz1l, a1l, x, g, w1, k1), {},
                 ("act", "red", "red"))):
            kern, plain = getattr(tk, name), getattr(tk, name + "_plain")
            cases.append((f"{label}@{h} model axis {m}", name,
                          lambda f=kern, a=args, kw=kw: f(*a, **kw),
                          lambda f=plain, a=args, kw=kw: f(*a, **kw), kinds))
    return cases


# The 3x3 units (#14b, #14e) at the edges of the kernels' contract, as
# (batch, side, channels): 16 and 48 channels (one input chunk, narrow and
# odd warp widths), 1024 (sixteen input chunks, eight output chunks), and
# batch 11, which leaves a partial last group of images at 8 px (two images
# a tile) and at 4 px (eight a tile).
UNIT3_EDGES = ((2, 16, 16), (2, 16, 48), (2, 4, 1024), (11, 8, CM),
               (11, 4, CM))


def unit3_edge_cases(rng, dtype, device, edges=UNIT3_EDGES):
    """(label, name, kernel call, plain call, output kinds) of #14b and
    #14e at each of `edges`, with operands drawn as train_unit_inputs
    draws the 3x3 unit's at c channels."""
    import torch

    from single_person_pose_estimation_tpu_torch.ops.cuda import (
        bottleneck_train_kernel as tk,
    )

    def u(lo, hi, *shape, dt=torch.float32):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32)) \
            .to(device=device, dtype=dt)

    cases = []
    for b, h, c in edges:
        act = u(-1, 1, b, h, h, c, dt=dtype)
        a1, a2 = torch.relu(u(-1, 1, b, h, h, c, dt=dtype)), torch.relu(act)
        lim = np.sqrt(6 / (18 * c))
        w2, b2 = u(-lim, lim, 3, 3, c, c), u(-.1, .1, c)
        aff = torch.stack([u(.5, 1.5, c), u(-.3, .3, c)])
        k = torch.stack([u(.5, 1.5, c), u(-.1, .1, c), u(-.1, .1, c)])
        dz = u(-1, 1, b, h, h, c, dt=dtype)
        for name, args, kinds in (
                ("conv3x3_relu_stats", (a1, w2, b2, *aff), ("act", "red")),
                ("unit3x3_bwd", (dz, a2, a1, w2, k, aff),
                 ("act", "red", "red", "red"))):
            kern, plain = getattr(tk, name), getattr(tk, name + "_plain")
            cases.append((f"{name}@{h} C={c} B={b}", name,
                          lambda f=kern, a=args: f(*a),
                          lambda f=plain, a=args: f(*a), kinds))
    return cases


# The 1x1 units (#14d, also without the next sums, #14f, and the forward
# #14a in both call forms, unit 1 C -> Cm and unit 3 Cm -> C with the
# affine) at the edges of the kernels' contract, as (batch, side, C, Cm):
# C the channels of the block's input and output, Cm of its middle. 16 and
# 48 channels (one input chunk; 48 leaves threads idle in the copies and
# an odd count of n8 tiles), 1024 (sixteen input chunks, the B operand
# streamed through the ring instead of resident), 48 against 1024 both
# ways (a partial dW tile, B streamed), and batch 11, which leaves ragged
# last row tiles at 8 and 4 px (the forward's zero-filled rows there give
# relu(b) or relu(shift . W + b), which its sums must leave out).
UNIT1_EDGES = ((2, 16, 16, 16), (2, 16, 48, 48), (2, 4, 1024, 1024),
               (2, 8, 48, 1024), (2, 8, 1024, 48), (11, 8, C, CM),
               (11, 4, C, CM))


def unit1_edge_cases(rng, dtype, device, edges=UNIT1_EDGES):
    """(label, name, kernel call, plain call, output kinds) of #14d (with
    and without reduce_next), #14f and #14a (unit 1, and unit 3 with the
    affine) at each of `edges`, with operands drawn as train_unit_inputs
    draws them at c and cm channels."""
    import torch

    from single_person_pose_estimation_tpu_torch.ops.cuda import (
        bottleneck_train_kernel as tk,
    )

    def u(lo, hi, *shape, dt=torch.float32):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32)) \
            .to(device=device, dtype=dt)

    cases = []
    for b, h, c, cm in edges:
        act = lambda n: u(-1, 1, b, h, h, n, dt=dtype)
        relu = lambda n: torch.relu(act(n))
        lim = np.sqrt(6 / (c + cm))
        kk = lambda n: torch.stack([u(.5, 1.5, n), u(-.1, .1, n),
                                    u(-.1, .1, n)])
        x, g, dz1, a1, a2, a3 = act(c), act(c), act(cm), relu(cm), relu(cm), \
            relu(c)
        w1, w3 = u(-lim, lim, c, cm), u(-lim, lim, cm, c)
        aff2 = torch.stack([u(.5, 1.5, cm), u(-.3, .3, cm)])
        k1, k3 = kk(cm), kk(c)
        b1, b3 = u(-.1, .1, cm), u(-.1, .1, c)
        red3 = ("act", "red", "red", "red")
        for label, name, args, kw, kinds in (
                ("unit1x1_bwd", "unit1x1_bwd", (g, a3, a2, w3, k3, aff2), {},
                 red3),
                ("unit1x1_bwd@no_next", "unit1x1_bwd",
                 (g, a3, a2, w3, k3, aff2), dict(reduce_next=False), red3),
                ("unit1_bwd", "unit1_bwd", (dz1, a1, x, g, w1, k1), {},
                 ("act", "red", "red")),
                ("conv1x1_relu_stats@unit1", "conv1x1_relu_stats",
                 (x, w1, b1), {}, ("act", "red")),
                ("conv1x1_relu_stats@unit3", "conv1x1_relu_stats",
                 (a2, w3, b3, *aff2), {}, ("act", "red"))):
            kern, plain = getattr(tk, name), getattr(tk, name + "_plain")
            cases.append((f"{label}@{h} C={c} Cm={cm} B={b}", name,
                          lambda f=kern, a=args, kw=kw: f(*a, **kw),
                          lambda f=plain, a=args, kw=kw: f(*a, **kw), kinds))
    return cases


def hold_unit_cases(report, cases, dtype, suffix):
    """Hold each train-unit case's outputs against its plain version's
    (unit_err), and its rerun to the same bits; the largest |d| goes to
    the report. Returns the failures."""
    import torch

    failures = []
    for label, name, kern, plain, kinds in cases:
        label += suffix
        got, again, want = kern(), kern(), plain()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        again = again if isinstance(again, tuple) else (again,)
        want = want if isinstance(want, tuple) else (want,)
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        if not same:
            failures.append(f"{label} {dtype}: a rerun differs")
        for i, (g, w, kind) in enumerate(zip(got, want, kinds)):
            if g.shape != w.shape or g.dtype != w.dtype:
                failures.append(f"{label} out{i}: {g.shape}/{g.dtype} vs "
                                f"{w.shape}/{w.dtype}")
                continue
            err, used = unit_err(g, w, kind, dtype)
            ok = used <= 1.0
            key = "max_abs_err_f32" if dtype == torch.float32 else \
                "max_abs_err"
            ent = report.setdefault(name, {})
            ent[key] = max(ent.get(key, 0.0), err)
            log(f"kernel {label} {str(dtype)[6:]} out{i} ({kind}): "
                f"max|d| = {err:.3e}, {used:.3e} of its limit"
                f"{'' if same else ' RERUN DIFFERS'} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"{label} {dtype} out{i}: {err}")
    return failures


def unit_err(got, want, kind, dtype):
    """(max |d|, the largest share of its limit that an element uses) of
    one train-unit output; it passes when the share is at most 1."""
    import torch

    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        return float("inf"), float("inf")
    d = (g - w).abs()
    if kind == "red" and dtype == torch.float32:
        lim = TOL_UNIT_RED_F32 * max(w.abs().max().item(), 1e-30)
    else:
        rel = TOL_UNIT_ACT_F32 if dtype == torch.float32 else TOL_UNIT_BF16
        lim = rel * torch.clamp(w.abs(), min=1.0)
    return d.max().item(), (d / lim).max().item()


def phase_fused_train_kernels(report):
    """#14a-f against their plain versions at every level, f32 and bf16,
    at B=8 and at the train step's B=64 (where the 64 px 3x3 weight
    gradient caps its partials at DW_WORKSPACE and its row slices straddle
    images); a rerun of each kernel gives the same bits; at 64 px the cuda
    bottleneck backend against the plain one (check_bottleneck_backends);
    then #14b and #14e at the contract's edges (UNIT3_EDGES), and #14a,
    #14d and #14f at theirs (UNIT1_EDGES); then #14a-d and #14f at the
    channel slices of tp_train's model axis (tp_unit_cases) at its two
    batches."""
    import torch

    rng = np.random.default_rng(30)
    failures = []
    for b, dtype in itertools.product((B_CHECK, B_TRAIN),
                                      (torch.float32, torch.bfloat16)):
        failures += hold_unit_cases(
            report, train_unit_cases(rng, dtype, "cuda", b), dtype, f" B={b}")
        torch.cuda.empty_cache()
    failures += check_bottleneck_backends(rng, B_CHECK)
    for dtype in (torch.float32, torch.bfloat16):
        failures += hold_unit_cases(
            report, unit3_edge_cases(rng, dtype, "cuda"), dtype, "")
        failures += hold_unit_cases(
            report, unit1_edge_cases(rng, dtype, "cuda"), dtype, "")
    for b, dtype in itertools.product((B_TP_BF16, B_DP_F32),
                                      (torch.float32, torch.bfloat16)):
        failures += hold_unit_cases(
            report, tp_unit_cases(rng, dtype, "cuda", b, TP_WORLD), dtype,
            f" B={b}")
    if failures:
        raise AssertionError("train-unit kernels disagree: "
                             + "; ".join(failures))


def check_bottleneck_backends(rng, b, h=64):
    """One bottleneck at float32, cuda backend against plain: (1) the
    forwards' out and stats; (2) the backwards on the same residuals, each
    of the 13 grads within TOL_BACKEND_GRAD of its largest |g|; (3) the
    autograd function end to end. In (3) the two forwards differ by float32
    summation order, which flips the ReLU mask of the few activations
    within ~1e-6 of 0; each flip changes dy there by O(K1 * dz) and the
    grads near it by O(1) (measured on the card: dx up to 2.2% of its
    largest |g| from a 1.5e-6 difference in a2), so (3) is held by the
    relative L2 distance of each grad, TOL_FUSED_GRAD. Returns the
    failures."""
    import torch

    from single_person_pose_estimation_tpu_torch.experimental import (
        bottleneck_grad as bg,
    )

    p = train_unit_inputs(rng, torch.float32, "cuda", b, h)
    u = lambda lo, hi, n: torch.from_numpy(
        rng.uniform(lo, hi, n).astype(np.float32)).cuda()
    args = [p["x"], p["w1"], p["b1"], p["w2"], p["b2"], p["w3"], p["b3"],
            u(.5, 1.5, CM), u(-.3, .3, CM), u(.5, 1.5, CM), u(-.3, .3, CM),
            u(.5, 1.5, C), u(-.3, .3, C)]
    cot, failures = p["g"], []

    def hold(label, got, want, tol_rel, l2=False):
        d = (got.float() - want.float())
        ref = want.float()
        err = (d.norm() / ref.norm()).item() if l2 else \
            d.abs().max().item() / max(ref.abs().max().item(), 1e-30)
        ok = bool(torch.isfinite(got).all()) and err <= tol_rel
        log(f"bottleneck cuda vs plain @{h} f32 {label}: "
            f"{'L2' if l2 else 'max'} rel {err:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"bottleneck {label}: {err}")

    out_c, st_c, res_c = bg.bottleneck_train_fwd_cuda(*args)
    out_p, st_p, _ = bg.bottleneck_train_fwd(*args)
    hold("forward out", out_c, out_p, TOL_UNIT_ACT_F32)
    for i, (sc, sp) in enumerate(zip(st_c, st_p)):
        hold(f"forward stats {i}", sc, sp, TOL_UNIT_RED_F32)
    res = (*res_c, *st_c, args[1], args[3], args[5], *args[7:])
    for i, (gc, gp) in enumerate(zip(bg.bottleneck_train_bwd_cuda(res, cot),
                                     bg.bottleneck_train_bwd(res, cot))):
        hold(f"backward, same residuals, grad {i}", gc, gp,
             TOL_BACKEND_GRAD)
    grads = []
    for backend in ("cuda", "plain"):
        leaves = [a.clone().requires_grad_() for a in args]
        y, _ = bg.make_bottleneck_train(backend)(*leaves)
        (y.float() * cot).sum().backward()
        grads.append([t.grad for t in leaves])
    for i, (gc, gp) in enumerate(zip(*grads)):
        hold(f"autograd end to end, grad {i}", gc, gp, TOL_FUSED_GRAD,
             l2=True)
    return failures

FUSED_STEPS = 3
B_FUSED_F32 = 16       # batch of the f32 fused-vs-default step comparisons
F32_SEEDS = (12, 13, 14, 15, 16)
# The (fused, plain) grads at f32, relative L2 (see check_fused_f32): by
# stacks, 2x the largest reading of F32_SEEDS on the card (S1 1.40e-2, S4
# 8.69e-2: PERF.md); and at most ULP_FACTOR times the distance between
# the plain path's grads on the images and on the images one ulp away
# (the largest ratio read: 0.93).
TOL_FUSED_L2 = {1: 0.03, 4: 0.18}
ULP_FACTOR = 2.0


def fused_want(steps):
    """Exact launch counts of `steps` fused train steps with augmentation."""
    want = {n: steps * BNECKS_PER_STEP * CALLS_PER_BNECK[n]
            * LAUNCHES_PER_CALL[n] for n in FUSED_KERNELS}
    want.update(resample_last_axis=2 * steps, render_heatmaps_batch=steps)
    return want


def phase_fused_train(report):
    """S4/256 bf16 B=64 through make_train_step(model_backend="fused"):
    3 augmented steps with exact launch counts; a fixed batch whose loss
    falls over 20 steps; at f32 and B=16, for each of F32_SEEDS, one fused
    step against one default step from the same state, at S4 and at S1
    (check_fused_f32)."""
    import torch

    from single_person_pose_estimation_tpu_torch import losses
    from single_person_pose_estimation_tpu_torch.data.in_memory import (
        synthetic_crops,
    )
    from single_person_pose_estimation_tpu_torch.ops import cuda as kernels
    from single_person_pose_estimation_tpu_torch.training import (
        steps as steps_lib,
    )

    cfg = train_config(os.path.join(ROOT, "temp"))
    new_state = lambda model, lr=2.5e-4: steps_lib.TrainState.create(
        model, lambda m: steps_lib.make_optimizer(m, lr), seed=0,
        device="cuda")
    batch = lambda seed: {
        k: torch.from_numpy(v).cuda()
        for k, v in synthetic_crops(B_TRAIN, IMG, seed=seed).items()}
    state = new_state(build_s4_train())
    step = steps_lib.make_train_step(losses.weighted_mse, cfg, augment=True,
                                     model_backend="fused")
    b = batch(11)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    got = []
    for _ in range(FUSED_STEPS):
        state, m = step(state, b)
        got.append(m["loss"])
    got = torch.stack(got).tolist()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = kernels.launch_counts()
    want = fused_want(FUSED_STEPS)
    log(f"fused_train: S4/256 bf16 B={B_TRAIN}, {FUSED_STEPS} steps in "
        f"{elapsed:.1f} s, losses {got}; launches {counts}")
    if {n: counts[n] for n in want} != want or any(
            v for n, v in counts.items() if n not in want):
        raise AssertionError(f"fused train launch counts {counts} != {want}")
    if not np.isfinite(got).all():
        raise AssertionError(f"non-finite fused losses: {got}")
    for n in FUSED_KERNELS:
        report.setdefault(n, {})["launches"] = counts[n]
    del state

    # One fixed batch, no augmentation: the loss must go down.
    state = new_state(build_s4_train(), lr=1e-3)
    step = steps_lib.make_train_step(losses.weighted_mse, cfg, augment=False,
                                     model_backend="fused")
    b = batch(7)
    got = []
    for _ in range(20):
        state, m = step(state, b)
        got.append(m["loss"])
    got = torch.stack(got).tolist()
    log("fused_train fixed batch, 20 steps: loss " + " ".join(
        f"{v:.4f}" for v in got))
    if not (np.isfinite(got).all() and np.mean(got[-5:]) < 0.95 * got[0]):
        raise AssertionError(f"the fixed-batch fused loss did not go down: "
                             f"{got}")
    del state

    for seed in F32_SEEDS:
        check_fused_f32(cfg, seed, stacks=4)
        check_fused_f32(train_config(os.path.join(ROOT, "temp"), stacks=1),
                        seed, stacks=1)


def fused_f32_runs(cfg, seed, stacks):
    """At float32 from one state: the fused step (the kernels), the default
    step, and the fused forward and loss on the plain backend, on
    "cuda_bwd" (plain forward, kernel backward), on "cuda_fwd" (kernel
    forward, plain backward), and on the plain backend with every pixel
    moved by one ulp ("plain_ulp"). {name: (loss, grads, running
    statistics)}."""
    import torch

    from single_person_pose_estimation_tpu_torch import losses
    from single_person_pose_estimation_tpu_torch.data.in_memory import (
        synthetic_crops,
    )
    from single_person_pose_estimation_tpu_torch.experimental.fused_train import (
        fused_train_apply,
    )
    from single_person_pose_estimation_tpu_torch.ops.cuda.heatmap_kernel import (
        render_heatmaps_batch,
    )
    from single_person_pose_estimation_tpu_torch.training import (
        steps as steps_lib,
    )

    b = {k: torch.from_numpy(v).cuda() for k, v in
         synthetic_crops(B_FUSED_F32, IMG, seed=seed).items()}
    hms = render_heatmaps_batch(b["kx"], b["ky"], b["kv"])
    base = build_s4_train(seed, stacks)
    base.compute_dtype = torch.float32
    runs = {}
    for name in ("fused", "flax", "plain", "cuda_bwd", "cuda_fwd",
                 "plain_ulp"):
        st = steps_lib.TrainState.create(
            copy.deepcopy(base), lambda m: steps_lib.make_optimizer(m, 2.5e-4),
            seed=0, device="cuda")
        if name in ("fused", "flax"):
            step = steps_lib.make_train_step(losses.weighted_mse, cfg,
                                             augment=False,
                                             model_backend=name)
            st, m = step(st, b)
            loss = m["loss"].item()
        else:
            img = b["image"]
            if name == "plain_ulp":
                img = torch.nextafter(img, torch.full_like(img, np.inf))
            outs = fused_train_apply(st.model, img, name.removesuffix("_ulp"))
            total = losses.total_loss(losses.weighted_mse, hms, outs)
            total.backward()
            loss = total.item()
        grads = torch.cat([p.grad.flatten()
                           for _, p in sorted(st.model.named_parameters())])
        stats = {n: t.clone() for n, t in st.model.state_dict().items()
                 if "running" in n}
        runs[name] = (loss, grads, stats)
        del st
    return runs


def check_fused_f32(cfg, seed, stacks):
    """One fused step against one default step at float32 from the same
    state (seed), B=16. Held: the loss (TOL_FUSED_LOSS), the running
    statistics (TOL_FUSED_STATS), the backward kernels inside the model by
    "cuda_bwd" against "plain" (the same forward, so the grads differ by
    summation order alone: TOL_FUSED_GRAD of the largest |g|), and the
    kernel path (forward and backward) against "plain" in relative L2:
    within TOL_FUSED_L2, and within ULP_FACTOR times what one ulp on the
    input pixels moves the plain path's grads ("plain_ulp").

    The grads of the fused step are not held against the default step's
    within TOL_FUSED_GRAD: the forwards differ by float32 summation order,
    and the grads are discontinuous in the forward where a ReLU mask
    flips (an activation within ~1e-6 of 0 changes its dy by O(1)), which
    the E[x^2]-E[x]^2 variance of the following BNs amplifies. The log
    shows where the kernel path's gap comes from: "cuda_fwd" (the kernel
    forward, plain backward) lies as far from "plain" as the kernel path.
    """
    runs = fused_f32_runs(cfg, seed, stacks)
    gmax = runs["flax"][1].abs().max().item()

    def gdiff(a, b):
        d = runs[a][1] - runs[b][1]
        return (d.abs().max().item() / gmax,
                (d.norm() / runs[b][1].norm()).item())

    pairs = {k: gdiff(*k) for k in (
        ("fused", "flax"), ("plain", "flax"), ("cuda_bwd", "plain"),
        ("fused", "plain"), ("cuda_fwd", "plain"), ("plain_ulp", "plain"))}
    tag = f"fused_train f32 S{stacks} B={B_FUSED_F32} seed {seed}"
    for (x, y), (mx, l2) in pairs.items():
        log(f"{tag} grads {x} vs {y}: max|d| {mx:.3e} of the largest |g| "
            f"{gmax:.3e}, L2 rel {l2:.3e}")
    lf, lx = runs["fused"][0], runs["flax"][0]
    lerr = abs(lf - lx) / abs(lx)
    sf, sx = runs["fused"][2], runs["flax"][2]
    serr = max((sf[n] - sx[n]).abs().max().item()
               / max(sx[n].abs().max().item(), 1e-30) for n in sx)
    log(f"{tag}, fused vs default step: loss {lf:.7f} vs {lx:.7f} (rel "
        f"{lerr:.2e}), running stats {serr:.3e}")
    ok = (lerr <= TOL_FUSED_LOSS and serr <= TOL_FUSED_STATS
          and pairs[("cuda_bwd", "plain")][0] <= TOL_FUSED_GRAD
          and pairs[("fused", "plain")][1] <= min(
              TOL_FUSED_L2[stacks],
              ULP_FACTOR * pairs[("plain_ulp", "plain")][1]))
    if not ok:
        raise AssertionError(f"{tag}: the fused step disagrees with the "
                             f"default step: loss {lerr}, stats {serr}, "
                             f"grads {pairs}")


# The bf16 3x3 units' tensor-core kernels as the fused step's trace names
# them: #14b's conv, #14e's din, #14e's dW and db.
UNIT3_KERNELS = {"3x3 forward": "unit3_tc_kernel<1, 0>",
                 "3x3 din": "unit3_tc_kernel<2, 2>",
                 "3x3 dW": "dw3_tc_kernel"}
# The bf16 1x1 units' tensor-core kernels as the trace names them (both
# instantiations of each, WIDE or not; unit1_tc_kernel<PRO, EPI, WIDE>):
# #14a's forward of unit 1 (z = x) and of unit 3 (z = affine(x)), #14d's
# din with the next sums and its dW (z re-normalized), #14f's dx and its dW
# (z = x).
UNIT1_KERNELS = {"1x1 forward, unit 1": "unit1_tc_kernel<0, 0, ",
                 "1x1 forward, unit 3": "unit1_tc_kernel<1, 0, ",
                 "1x1 din": "unit1_tc_kernel<2, 2, ",
                 "1x1 dW": "dw1_tc_kernel<true, ",
                 "1x1 dx": "unit1_tc_kernel<2, 3, ",
                 "1x1 dW, unit 1": "dw1_tc_kernel<false, "}
# The FMA unit body in bfloat16, which the fused bf16 step must not launch:
# every bf16 unit runs on the tensor cores.
BF16_FMA_UNIT = "unit_kernel<__nv_bfloat16"


def fused_bounds(b=B_TRAIN, h=64):
    """Bounds of #14a-f at the 64 px level (bf16): each activation read
    once and written once, weights read once; 2 operations per
    multiply-add."""
    r, e = b * h * h, 2
    w1, w2 = C * CM * e, 9 * CM * CM * e
    return {
        "conv1x1_relu_stats": bound(2 * r * C * CM, r * (C + CM) * e + w1,
                                    PEAK_BF16),
        "conv3x3_relu_stats": bound(2 * r * 9 * CM * CM, 2 * r * CM * e + w2,
                                    PEAK_BF16),
        "bn_bwd_reduce": bound(2 * r * C, 2 * r * C * e, PEAK_BF16),
        "unit1x1_bwd": bound(4 * r * C * CM, r * (2 * C + 2 * CM) * e + w1,
                             PEAK_BF16),
        "unit3x3_bwd": bound(4 * r * 9 * CM * CM, 4 * r * CM * e + w2,
                             PEAK_BF16),
        "unit1_bwd": bound(4 * r * C * CM, r * (2 * CM + 3 * C) * e + w1,
                           PEAK_BF16),
    }


def phase_fused_train_times(report, card):
    """The fused step against the default step (S4/256 bf16 B=64, median of
    5 runs of 2 steps, alternating), the fused step's device busy time and
    idle share with the per-step time of the 3x3 and 1x1 units' tensor-core
    kernels (UNIT3_KERNELS, UNIT1_KERNELS; each must appear in the trace,
    and no bfloat16 FMA unit body, BF16_FMA_UNIT, may), and #14a-f at 64
    px beside their plain versions, bounds and a library yardstick the port
    never calls."""
    import torch
    import torch.nn.functional as F

    from single_person_pose_estimation_tpu_torch import losses
    from single_person_pose_estimation_tpu_torch.data.in_memory import (
        synthetic_crops,
    )
    from single_person_pose_estimation_tpu_torch.ops.cuda import (
        bottleneck_train_kernel as tk,
    )
    from single_person_pose_estimation_tpu_torch.training import (
        steps as steps_lib,
    )

    cfg = train_config(os.path.join(ROOT, "temp"))
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in synthetic_crops(B_TRAIN, IMG, seed=9).items()}
    steps = {}
    for backend in ("fused", "flax"):
        st = steps_lib.TrainState.create(
            build_s4_train(), lambda m: steps_lib.make_optimizer(m, 2.5e-4),
            seed=0, device="cuda")
        fn = steps_lib.make_train_step(losses.weighted_mse, cfg, augment=True,
                                       model_backend=backend)
        steps[backend] = (lambda st=st, fn=fn: fn(st, batch))
        steps[backend]()
    times = {n: [] for n in steps}
    for i in range(5):
        for name in (("fused", "flax") if i % 2 == 0 else ("flax", "fused")):
            times[name].append(cuda_ms(steps[name], iters=2, warmup=0))
    med = {n: statistics.median(ts) for n, ts in times.items()}
    for name, ms in med.items():
        log(f"fused_train_times S4/256 bf16 B={B_TRAIN} step "
            f"model_backend={name}: median {ms:.3f} ms ({B_TRAIN / ms * 1e3:.1f}"
            f" img/s) over 5 runs {[round(t, 3) for t in times[name]]} "
            f"[{card}]")
    report["_fused_step_ms"] = med["fused"]
    report["_default_step_ms"] = med["flax"]
    span, busy, per, _, _ = device_trace(steps["fused"], calls=2)
    log(f"trace S4/256 bf16 B={B_TRAIN} fused train step: device span "
        f"{span:.2f} ms/step, busy {busy:.2f} ms, idle share "
        f"{1 - busy / span:.4f} [{card}]")
    for kname, (ms, n) in sorted(per.items(), key=lambda kv: -kv[1][0])[:14]:
        log(f"  {ms:9.3f} ms/step {ms / busy:6.1%} x{n:6.1f}  {kname}")
    for label, key in {**UNIT3_KERNELS, **UNIT1_KERNELS}.items():
        ms = sum(v[0] for k, v in per.items() if key in k)
        n = sum(v[1] for k, v in per.items() if key in k)
        log(f"trace fused train step, {label} ({key}): {ms:.3f} ms/step "
            f"{ms / busy:.1%} of busy, x{n:.1f} [{card}]")
        if not n:
            raise AssertionError(f"the fused step's trace shows no {key}")
    fma = [k for k in per if BF16_FMA_UNIT in k]
    log(f"trace fused train step, {BF16_FMA_UNIT}: {len(fma)} kernels "
        f"[{card}]")
    if fma:
        raise AssertionError(f"the fused bf16 step launched an FMA unit "
                             f"body: {fma}")
    del steps
    torch.cuda.empty_cache()

    rng = np.random.default_rng(31)
    p = train_unit_inputs(rng, torch.bfloat16, "cuda", B_TRAIN, 64)
    bf = torch.bfloat16
    nchw = lambda t: t.permute(0, 3, 1, 2)
    w1c = p["w1"].to(bf).T[:, :, None, None]          # (Cm, C, 1, 1)
    w2c = p["w2"].to(bf).permute(3, 2, 0, 1)
    w3b, w1b = p["w3"].to(bf), p["w1"].to(bf)
    flat = lambda t: t.reshape(-1, t.shape[-1])
    zero_c = torch.zeros(p["g"].shape[-1], device="cuda")
    one_c = torch.ones(p["g"].shape[-1], device="cuda")
    cases = {
        "conv1x1_relu_stats": (
            (p["x"], p["w1"], p["b1"]), {},
            lambda: F.conv2d(nchw(p["x"]), w1c)),
        "conv3x3_relu_stats": (
            (p["a1"], p["w2"], p["b2"], *p["aff1"]), {},
            lambda: F.conv2d(nchw(p["a1"]), w2c, padding=1)),
        # [sum dz, sum dz*a] per channel in one call: the batch-norm
        # backward reduction with mean 0 and invstd 1 (sum_dy, sum_dy_xmu).
        "bn_bwd_reduce": (
            (p["g"], p["a3"]), {},
            lambda: torch.ops.aten.batch_norm_backward_reduce(
                flat(p["g"]), flat(p["a3"]), zero_c, one_c, None, True,
                False, False)),
        "unit1x1_bwd": (
            (p["g"], p["a3"], p["a2"], p["w3"], p["k3"], p["aff2"]), {},
            lambda: (flat(p["g"]) @ w3b.T, flat(p["a2"]).T @ flat(p["g"]))),
        "unit3x3_bwd": (
            (p["dz2"], p["a2"], p["a1"], p["w2"], p["k2"], p["aff1"]), {},
            lambda: torch.ops.aten.convolution_backward(
                nchw(p["dz2"]), nchw(p["a1"]), w2c, None, [1, 1], [1, 1],
                [1, 1], False, [0, 0], 1, [True, True, False])),
        "unit1_bwd": (
            (p["dz1"], p["a1"], p["x"], p["g"], p["w1"], p["k1"]), {},
            lambda: (flat(p["dz1"]) @ w1b.T, flat(p["x"]).T @ flat(p["dz1"]))),
    }
    bounds = fused_bounds()
    for name, (args, kw, lib) in cases.items():
        kern = lambda f=getattr(tk, name), a=args: f(*a, **kw)
        plain = lambda f=getattr(tk, name + "_plain"), a=args: f(*a, **kw)
        before = getattr(tk, name).launches
        ms, plain_ms = cuda_ms(kern, iters=10), cuda_ms(plain, iters=10)
        device_ms = kernel_device_ms(kern, name)
        lib_ms = cuda_ms(lib, iters=10) if lib is not None else None
        getattr(tk, name).launches = before
        bms, by = bounds[name]
        report.setdefault(name, {}).update(
            ms=ms, device_ms=device_ms, plain_ms=plain_ms, bound_ms=bms,
            bound_by=by, library_ms=lib_ms)
        log(f"times {name} bf16 B={B_TRAIN} 64 px: kernel {ms:.4f} ms per "
            f"call ({device_ms:.4f} ms on the device), plain {plain_ms:.4f} "
            f"ms, library {'none' if lib_ms is None else f'{lib_ms:.4f} ms'}"
            f", bound {bms:.4f} ms ({by}) [{card}]")


# ---------------------------------------------------------------------------
# The fused front and subtree dials (#6, #7) and the row-blocked
# bottleneck (#5).
# ---------------------------------------------------------------------------

DIAL_KERNELS = ("fused_bottleneck_convskip", "fused_subtree",
                "fused_bottleneck_rows")
DEPTHS = (1, 2, 3)
# The dial forwards on top of MAIN_FLAGS, and the launches each adds to or
# takes from a main-flags S4 forward (per stack: fuse_bottom=d keeps 1 of
# #1, 3-d of #2 and 4-d up-levels, and adds 1 of #7; fuse_front adds 1 of
# #1 and 1 of #6 per forward).
DIALS = {"front": dict(fuse_front=True),
         **{f"bottom{d}": dict(fuse_bottom=d) for d in DEPTHS}}
# #7 in bfloat16 chains 6-12 bottlenecks, and a one-ulp flip of a t1 or t2
# value where the kernel's float32 sums and cuDNN's land on either side of
# a rounding boundary moves every value it feeds downstream: at B=8 the
# kernel lies up to 0.5-0.75 from the plain walk and up to 0.4% of the
# values leave TOL_BF16_REL's band, while the one-ulp input control moves
# the plain walk as far (PERF.md, section 6). So #7 in bf16 is held (1) bit
# for bit to the same walk composed of #1 and #3's up-add launches, which
# phase 3 holds to TOL_BF16_REL one bottleneck at a time, and (2) within
# SUBTREE_ULP_FACTOR times, in relative L2, what one ulp on every input
# value moves the plain walk (readings 0.23-0.64).
SUBTREE_ULP_FACTOR = 1.0
# #6 at its contract's edges, (batch, side, Cin, C), on top of the 64 px
# main case: batch 11 on a 12 px map (ragged 8 x 8 tiles), 4 px, Cin/C =
# 32/64 (chunks of 32) through 512/1024 (4 x 8 tiles in bf16), Cin = C =
# 1024 (the widest x halo) and Cin > C = 32 (chunks of 16).
CONVSKIP_EDGES = ((11, 12, C // 2, C), (11, 4, C // 2, C), (2, 8, 32, 64),
                  (2, 8, 64, 128), (2, 8, 256, 512), (2, 8, 512, 1024),
                  (2, 12, 1024, 1024), (2, 6, 48, 32))


def dial_want(flags, stacks=4):
    """Exact launches of one S4 forward with MAIN_FLAGS plus `flags`."""
    d = flags.get("fuse_bottom", 0)
    want = {"fused_bottleneck": stacks * (1 if d else 4),
            "fused_bottleneck_pool": stacks * (3 - d),
            "fused_uplevel": stacks * 2 * (4 - d), "fused_head": stacks,
            "fused_subtree": stacks * bool(d),
            "fused_bottleneck_convskip": 0}
    if flags.get("fuse_front"):
        want["fused_bottleneck"] += 1
        want["fused_bottleneck_convskip"] += 1
    return want


def convskip_params(rng, dtype, device, c=C, cin=None):
    """front_bottleneck_3's operands: c/2 (or cin) -> c channels, Cm c/2
    (128 -> 256, Cm 128 at the model's width)."""
    from single_person_pose_estimation_tpu_torch.ops.cuda.bottleneck_kernel import (
        ConvSkipParams,
        bn_affine,
    )
    import torch

    def u(lo, hi, *shape):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32))

    cm = c // 2
    cin = cin or cm
    lim1, lim2 = np.sqrt(6 / (cin + cm)), np.sqrt(6 / (18 * cm))
    affs = [bn_affine(u(.5, 1.5, n), u(-.3, .3, n), u(-.5, .5, n),
                      u(.5, 1.5, n)) for n in (cm, cm, c)]
    return ConvSkipParams.pack(
        u(-lim1, lim1, cin, c), u(-.1, .1, c),
        u(-lim1, lim1, cin, cm), u(-.1, .1, cm), u(-lim2, lim2, 3, 3, cm, cm),
        u(-.1, .1, cm), u(-lim1, lim1, cm, c), u(-.1, .1, c),
        *affs[0], *affs[1], *affs[2], dtype=dtype, device=device)


def subtree_params(rng, dtype, device, depth, c=C):
    from single_person_pose_estimation_tpu_torch.ops.cuda.bottom_kernel import (
        SubtreeParams,
        bneck_order,
    )

    return SubtreeParams.pack(
        {f"hg0_{s}": bneck_params(rng, dtype, device, c)
         for s in bneck_order(depth)}, "hg0", depth)


def subtree_composed(x, sp, depth):
    """#7's walk composed of single-bottleneck kernel launches (#1, and
    #3's first launch for the up-add), tiled as #7 tiles each level."""
    import torch

    from single_person_pose_estimation_tpu_torch.ops.cuda import (
        bottleneck_kernel as bk,
        bottom_kernel as bt,
    )

    def upadd(f, inner, p):
        s = torch.empty_like(f)
        bk.launch_bottleneck(bk.MODE_UPADD, f, p, s, u_lo=inner)
        return s

    return bt.subtree_walk(x, sp, depth, bk.fused_bottleneck, upadd)


def rel_l2(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def plain_walk(fp, x, sp, depth, stack="hg0"):
    """#7's library yardstick: the walk of `bneck_order(depth)` composed
    of the plain model's own bottlenecks (fi._bottleneck_plain, cuDNN
    convs), exact pools and upsample-adds, in the walk's order."""
    from single_person_pose_estimation_tpu_torch.models import (
        fused_inference as fi,
    )
    from single_person_pose_estimation_tpu_torch.ops.cuda import (
        bottom_kernel as bt,
    )

    names = iter(bt.bneck_order(depth))
    c = x.shape[-1]
    block = lambda v: fi._bottleneck_plain(fp, v, f"{stack}_{next(names)}", c)
    return bt.subtree_walk(x, sp, depth, lambda v, p: block(v),
                           lambda f, inner, p: block(f)
                           + fi.upsample2x(inner))


def subtree_hold(x, sp, depth):
    """The hold of #7 against its plain walk (see SUBTREE_ULP_FACTOR):
    float32 as max_err; bfloat16 bit-equal to `subtree_composed` and
    within SUBTREE_ULP_FACTOR of the one-ulp input control."""
    import torch

    from single_person_pose_estimation_tpu_torch.ops.cuda import (
        bottom_kernel as bt,
    )

    def hold(got, want, dtype):
        if dtype == torch.float32:
            return max_err(got, want, dtype)
        x_ulp = (x.view(torch.int16) + 1).view(torch.bfloat16)
        ctrl = rel_l2(bt.fused_subtree_plain(x_ulp, sp, depth), want)
        same = torch.equal(got, subtree_composed(x, sp, depth))
        err, in_band = max_err(got, want, dtype)
        d = (got.float() - want.float()).abs()
        share = (d <= TOL_BF16_REL * want.float().abs().clamp(min=1.0)
                 ).float().mean().item()
        log(f"  #7 depth {depth} bf16: bit-equal to the composed launches "
            f"{same}; rel L2 {rel_l2(got, want):.3e} vs one-ulp control "
            f"{ctrl:.3e}; {share:.6f} of the values within TOL_BF16_REL")
        return err, bool(same and torch.isfinite(got).all().item()
                         and rel_l2(got, want) <= SUBTREE_ULP_FACTOR * ctrl)

    return hold


def dial_kernel_cases(rng, dtype, device, b):
    """(name, kernel call, plain call[, hold]) of #5-#7 at the dials'
    shapes: #6 at 64 px (128 -> 256), #7 at depths 1-3 (8, 16 and 32 px
    inputs, with `subtree_hold`), #5 at 128 px; then #6 at CONVSKIP_EDGES
    and #7 at its edges."""
    import torch

    from single_person_pose_estimation_tpu_torch.ops.cuda import (
        bottleneck_kernel as bk,
        bottom_kernel as bt,
    )

    x = torch.from_numpy(rng.uniform(-1, 1, (b, 64, 64, C // 2))
                         .astype(np.float32)).to(device=device, dtype=dtype)
    p = convskip_params(rng, dtype, device)
    cases = [("fused_bottleneck_convskip@64", "fused_bottleneck_convskip",
              lambda: bk.fused_bottleneck_convskip(x, p),
              lambda: bk.fused_bottleneck_convskip_plain(x, p))]
    for d in DEPTHS:
        xd = nhwc(rng, b, 4 << d, dtype, device)
        sp = subtree_params(rng, dtype, device, d)
        cases.append((f"fused_subtree@depth{d}", "fused_subtree",
                      lambda xd=xd, sp=sp, d=d: bt.fused_subtree(xd, sp, d),
                      lambda xd=xd, sp=sp, d=d:
                          bt.fused_subtree_plain(xd, sp, d),
                      subtree_hold(xd, sp, d)))
    x128, p128 = nhwc(rng, b, 128, dtype, device), bneck_params(rng, dtype,
                                                                device)
    cases.append(("fused_bottleneck_rows@128", "fused_bottleneck_rows",
                  lambda: bk.fused_bottleneck_rows(x128, p128),
                  lambda: bk.fused_bottleneck_rows_plain(x128, p128)))
    # #6 at its contract's edges (CONVSKIP_EDGES): in bf16 the tile of
    # convskip_tc_plan, in float32 the FMA tile of fma_tile_plan (8 x 8 up
    # to C=384, then 4 x 4, and 2 x 2 at Cin = C = 1024).
    for nb, h, cin, c in CONVSKIP_EDGES:
        xc = nhwc(rng, nb, h, dtype, device, cin)
        pc = convskip_params(rng, dtype, device, c, cin)
        cases.append((f"fused_bottleneck_convskip@{h} B={nb} Cin={cin} C={c}",
                      "fused_bottleneck_convskip",
                      lambda xc=xc, pc=pc: bk.fused_bottleneck_convskip(xc, pc),
                      lambda xc=xc, pc=pc:
                          bk.fused_bottleneck_convskip_plain(xc, pc)))
    # The bf16 body's edges in the walk: a batch of 11 at depth 1, and C=64
    # (output chunks of 32) at depth 2; C = 512 and 1024 at depth 1 (the
    # float32 walk on 4 x 4 tiles).
    for nb, d, c in ((11, 1, C), (b, 2, 64), (2, 1, 512), (2, 1, 1024)):
        xd = nhwc(rng, nb, 4 << d, dtype, device, c)
        sp = subtree_params(rng, dtype, device, d, c)
        cases.append((f"fused_subtree@depth{d} B={nb} C={c}", "fused_subtree",
                      lambda xd=xd, sp=sp, d=d: bt.fused_subtree(xd, sp, d),
                      lambda xd=xd, sp=sp, d=d:
                          bt.fused_subtree_plain(xd, sp, d),
                      subtree_hold(xd, sp, d)))
    return cases


def phase_dial_slice(report, model):
    """S4/256 bf16 at B=128 through fused_apply with each dial: exact
    launch counts, finite heatmaps; then at f32 and B=8 each dial's last
    stack against the main flags' kernel path."""
    import torch

    from single_person_pose_estimation_tpu_torch.models import (
        fused_inference as fi,
    )
    from single_person_pose_estimation_tpu_torch.ops import cuda as kernels

    fp = fi.prepare_fused(model)
    rng = np.random.default_rng(30)
    x = torch.from_numpy(rng.uniform(0, 1, (B_TIME, 256, 256, 3))
                         .astype(np.float32)).cuda()
    totals = dict.fromkeys(DIAL_KERNELS, 0)
    with torch.inference_mode():
        for label, flags in DIALS.items():
            kernels.reset_launch_counts()
            fi.plain_routes.update(forward=0, level=0)
            hm = fi.fused_apply(fp, x, **MAIN_FLAGS, **flags)[-1]
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            want = dial_want(flags)
            got = {n: counts[n] for n in want}
            others = {n: c for n, c in counts.items()
                      if n not in want and c}
            log(f"dial_slice {label}: launches {got} expected {want}")
            if got != want or others or any(fi.plain_routes.values()):
                raise AssertionError(f"dial {label}: launches {counts}, "
                                     f"plain routes {fi.plain_routes}")
            if hm.shape != (B_TIME, 64, 64, K) or not torch.isfinite(
                    hm).all():
                raise AssertionError(f"dial {label}: bad heatmaps")
            for n in DIAL_KERNELS:
                totals[n] += counts[n]
    for n in DIAL_KERNELS[:2]:
        report.setdefault(n, {})["launches"] = totals[n]
    log(f"dial_slice launches of the dial kernels over the four dial "
        f"forwards: {totals}")

    # f32 (TF32 off): each dial against the main flags' kernel path, the
    # phase_slice tolerances.
    x8 = x[:8]
    model.compute_dtype = torch.float32
    try:
        fp32 = fi.prepare_fused(model)
        with torch.inference_mode():
            base = fi.fused_apply(fp32, x8, **MAIN_FLAGS)[-1]
            for label, flags in DIALS.items():
                hm = fi.fused_apply(fp32, x8, **MAIN_FLAGS, **flags)[-1]
                d = (hm - base).abs()
                log(f"dial_slice {label} f32 B=8 vs main flags: max|d| = "
                    f"{d.max().item():.3e}, mean|d| = "
                    f"{d.mean().item():.3e}")
                if not (d.max().item() <= TOL_S4_F32_MAX
                        and d.mean().item() <= TOL_S4_F32_MEAN):
                    raise AssertionError(f"dial {label} f32: max "
                                         f"{d.max().item()}, mean "
                                         f"{d.mean().item()}")
    finally:
        model.compute_dtype = torch.bfloat16
    # The fuse_front path (#6 on the tensor cores in bf16) against the plain
    # model on the unsaturated copy, as phase_slice holds the main flags.
    scaled_readings(model, x8, "dial_slice front",
                    {**MAIN_FLAGS, **DIALS["front"]})


def phase_dial_times(report, model, card):
    """S4/256 bf16 forward img/s at B=128 with each dial (median of 10,
    alternating); #5-#7 at B=128 beside their plain versions; #5 at
    128 px against the plain cuDNN bottleneck."""
    import torch

    from single_person_pose_estimation_tpu_torch.models import (
        fused_inference as fi,
    )
    from single_person_pose_estimation_tpu_torch.ops import cuda as kernels
    from single_person_pose_estimation_tpu_torch.ops.cuda import (
        bottleneck_kernel as bk,
        bottom_kernel as bt,
    )

    fp = fi.prepare_fused(model)
    rng = np.random.default_rng(31)
    x = torch.from_numpy(rng.uniform(0, 1, (B_TIME, 256, 256, 3))
                         .astype(np.float32)).cuda()
    variants = {"main": {}, **DIALS}
    runs = {k: (lambda f=f: fi.fused_apply(fp, x, **MAIN_FLAGS, **f)[-1])
            for k, f in variants.items()}
    times = {k: [] for k in runs}
    names = list(runs)
    with torch.inference_mode():
        for fn in runs.values():
            fn()
        for i in range(10):
            for name in (names if i % 2 == 0 else names[::-1]):
                times[name].append(cuda_ms(runs[name], iters=1, warmup=0))
    med = {k: statistics.median(v) for k, v in times.items()}
    for name, ms in med.items():
        log(f"dial_times S4/256 bf16 forward B={B_TIME} {name}: median "
            f"{ms:.2f} ms over 10 runs = {B_TIME / ms * 1e3:.1f} img/s, "
            f"{med['main'] / ms:.4f}x main flags [{card}]")
    report["_dial_forward"] = {k: B_TIME / ms * 1e3 for k, ms in med.items()}

    # The fuse_front forward, traced once: no bf16 FMA body may run; the
    # trace must give whole launches a forward (#6 once on the tensor
    # cores, #1-#4 as the main flags plus the front's #1) and #6's device
    # ms a forward.
    with torch.inference_mode():
        span, busy, _, _, evs = device_trace(runs["front"])
    fma = {e[2][:60] for e in evs if any(
        n in e[2] for n in (BF16_FMA_BNECK, BF16_FMA_HEAD, BF16_FMA_CONVSKIP))}
    _, launches = forward_device_ms(evs)
    want = {**PER_FORWARD,
            "fused_bottleneck": PER_FORWARD["fused_bottleneck"] + 1}
    six = [(e - s) / 1e3 for s, e, n in evs if TC_CONVSKIP in n]
    log(f"trace S4/256 bf16 B={B_TIME} fuse_front: device span {span:.2f} "
        f"ms/forward, busy {busy:.2f} ms, idle share {1 - busy / span:.4f}; "
        f"#6 {len(six) / 3:g} launches and {sum(six) / 3:.3f} device ms a "
        f"forward; #1-#4 launches {launches} [{card}]")
    if fma or launches != want or len(six) != 3:
        raise AssertionError(f"fuse_front trace: bf16 FMA bodies {fma}, "
                             f"launches {launches} (want {want}), "
                             f"{len(six)} #6 launches over 3 forwards")
    report.setdefault("fused_bottleneck_convskip", {})[
        "forward_device_ms"] = sum(six) / 3

    dt = torch.bfloat16
    xs = torch.from_numpy(rng.uniform(-1, 1, (B_TIME, 64, 64, C // 2))
                          .astype(np.float32)).to(device="cuda", dtype=dt)
    cp = fp.bnecks["front_bottleneck_3"]
    # Library yardsticks, never called by the port: the plain bf16 model's
    # own blocks at the same shapes (cuDNN convs, BN and the adds): for #6
    # front_bottleneck_3 with its conv skip, for #7 the same walk composed
    # of the model's bottlenecks, pools and upsample-adds (`plain_walk`).
    cases = {"fused_bottleneck_convskip": (
        "64x64 128->256", lambda: bk.fused_bottleneck_convskip(xs, cp),
        lambda: bk.fused_bottleneck_convskip_plain(xs, cp),
        inference_bounds()["fused_bottleneck_convskip"],
        lambda: fi._bottleneck_plain(fp, xs, "front_bottleneck_3", C))}
    for d in DEPTHS:
        xd = nhwc(rng, B_TIME, 4 << d, dt, "cuda")
        sp = fp.subtree(0, d)
        cases[f"fused_subtree@depth{d}"] = (
            f"{4 << d}x{4 << d} in", lambda xd=xd, sp=sp, d=d:
                bt.fused_subtree(xd, sp, d),
            lambda xd=xd, sp=sp, d=d: bt.fused_subtree_plain(xd, sp, d),
            subtree_bound(d),
            lambda xd=xd, sp=sp, d=d: plain_walk(fp, xd, sp, d))
    x128 = nhwc(rng, B_TIME, 128, dt, "cuda")
    name128 = "hg0_downsample_f1"
    pr = fp.bnecks[name128]
    cases["fused_bottleneck_rows"] = (
        "128x128", lambda: bk.fused_bottleneck_rows(x128, pr),
        lambda: bk.fused_bottleneck_rows_plain(x128, pr),
        inference_bounds()["fused_bottleneck_rows"], None)
    with torch.inference_mode():
        for label, (shape, kern, plain, (bms, by), lib) in cases.items():
            ms = cuda_ms(kern, iters=5)
            plain_ms = cuda_ms(plain, iters=5)
            device_ms = kernel_device_ms(kern, label)
            lib_ms = cuda_ms(lib, iters=5) if lib is not None else None
            log(f"dial_times {label} bf16 B={B_TIME} {shape}: kernel "
                f"{ms:.3f} ms ({device_ms:.3f} ms on the device), plain "
                f"{plain_ms:.3f} ms, library "
                f"{'(the rows A/B below)' if lib_ms is None else f'{lib_ms:.3f} ms'}"
                f", bound {bms:.4f} ms ({by}) [{card}]")
            if label in DIAL_KERNELS or label == "fused_subtree@depth2":
                ent = report.setdefault(label.split("@")[0], {})
                ent.update(ms=ms, plain_ms=plain_ms, device_ms=device_ms)
                if lib_ms is not None:
                    ent["library_ms"] = lib_ms

        # JAX's scripts/bench_rows_bneck_ab.py question on this card: #5 at
        # 128 px against the plain bf16 bottleneck (cuDNN convs), in turns.
        # The kernel's launches in this run are #5's count: no forward
        # reaches it.
        cudnn = lambda: fi._bottleneck_plain(fp, x128, name128, C)
        kernels.reset_launch_counts()
        ab = {"kernel": [], "cudnn": []}
        for i in range(4):
            for k in (("kernel", "cudnn") if i % 2 == 0 else
                      ("cudnn", "kernel")):
                ab[k].append(cuda_ms(cases["fused_bottleneck_rows"][1]
                                     if k == "kernel" else cudnn, iters=3,
                                     warmup=1))
        torch.cuda.synchronize()
        launches = kernels.launch_counts()["fused_bottleneck_rows"]
    if launches != 4 * (3 + 1):          # 4 turns of 1 warm-up + 3 calls
        raise AssertionError(f"#5 launched {launches} times in the A/B")
    report["fused_bottleneck_rows"]["launches"] = launches
    k_ms, c_ms = (statistics.median(ab[k]) for k in ("kernel", "cudnn"))
    report["fused_bottleneck_rows"]["library_ms"] = c_ms
    log(f"dial_times rows A/B bf16 B={B_TIME} 128x128 C={C}: kernel "
        f"{k_ms:.3f} ms, plain cuDNN bottleneck {c_ms:.3f} ms, kernel/"
        f"cuDNN {k_ms / c_ms:.3f} (medians of 4, {launches} launches of "
        f"#5) [{card}]")


# ---------------------------------------------------------------------------
# The entry points a user calls: the CLI (train, resume, eval, serve over a
# glob and over HTTP, export), the two-stage demo and the profiler.
# ---------------------------------------------------------------------------

CLI_ROOT = os.path.join(ROOT, "temp", "chip_smoke_cli")
CLI_BATCH = 64            # the CLI's train, eval and valid batch
CLI_LR = 2.5e-4
CLI_SERVE_IMAGES = 8
CLI_BUCKETS = (16,)       # one bucket: every served step has one shape
DEMO_BOXES = ((100.0, 80.0, 120.0, 260.0, 0.9),
              (400.5, 150.25, 150.0, 200.0, 0.8),
              (560.0, -40.0, 140.0, 160.0, 0.7))   # partly outside
TOL_CROP = 1e-5
EXPORT_BATCHES = (8, 3)   # the exported program's two batch sizes
CLI_DEVICE = "cuda"       # "cpu" only to rehearse these phases off the card


def cli_args(root):
    """The CLI's --set overrides for S4/256 bf16 on `eval_dataset(root)`'s
    records, and --device cuda."""
    fields = dict(dataset_dir=root, temporary_dir=os.path.join(root, "run"),
                  hg_num_stacks=4, hg_num_channels=C, batch_size=CLI_BATCH,
                  min_num_keypoints=1, num_examples_per_record=128,
                  compute_dtype="bfloat16", seed=0)
    args = []
    for k, v in fields.items():
        args += ["--set", f"{k}={v}"]
    return args + ["--device", CLI_DEVICE]


def cli_config(args):
    from single_person_pose_estimation_tpu_torch import Config, cli

    return cli._apply_overrides(Config(), args[1:-2:2])


def cli_state(cfg):
    """The CLI's latest checkpoint restored the way `cli eval` does."""
    from single_person_pose_estimation_tpu_torch import cli
    from single_person_pose_estimation_tpu_torch.utils.model_utils import (
        load_model_from_checkpoint,
    )

    state, _ = load_model_from_checkpoint(cli._build_model(cfg),
                                          cfg.checkpoints_path,
                                          device=CLI_DEVICE)
    return state


def reset_counts():
    from single_person_pose_estimation_tpu_torch.models import (
        fused_inference as fi,
    )
    from single_person_pose_estimation_tpu_torch.ops import cuda as kernels

    kernels.reset_launch_counts()
    fi.plain_routes.update(forward=0, level=0)


def read_counts(label, want):
    """The launch counts since reset_counts, which must equal `want` (0 for
    every kernel it leaves out; a function of the counts gives it), with no
    request sent to the plain layers. Returns the counts."""
    import torch

    from single_person_pose_estimation_tpu_torch.models import (
        fused_inference as fi,
    )
    from single_person_pose_estimation_tpu_torch.ops import cuda as kernels

    if CLI_DEVICE == "cuda":
        torch.cuda.synchronize()
    counts = kernels.launch_counts()
    if callable(want):
        want = want(counts)
    want = {k: want.get(k, 0) for k in counts}
    routes = dict(fi.plain_routes)
    log(f"{label}: launches {counts}; plain routes {routes}")
    if counts != want or any(routes.values()):
        raise AssertionError(f"{label}: launches {counts} != {want} or "
                             f"plain routes {routes}")
    return counts


def add_launches(report, counts):
    for name, n in counts.items():
        if n:
            ent = report.setdefault(name, {})
            ent["launches"] = ent.get("launches", 0) + n


def served_want(forwards):
    return {**{k: v * forwards for k, v in PER_FORWARD.items()},
            "decode_batch": forwards}


def phase_cli_train(report):
    """`cli gen-records`, then `cli train` for one epoch and `cli resume` to
    epoch 2 of S4/256 bf16 at batch 64 from the records, through
    `cli.main` as a user's command line gives it."""
    from single_person_pose_estimation_tpu_torch import cli
    from single_person_pose_estimation_tpu_torch.training import (
        metrics as metrics_lib,
    )
    from single_person_pose_estimation_tpu_torch.training.checkpoint import (
        CheckpointManager,
    )
    from single_person_pose_estimation_tpu_torch.utils.model_utils import (
        list_checkpoints,
    )

    shutil.rmtree(CLI_ROOT, ignore_errors=True)
    _, val = eval_dataset(CLI_ROOT)
    args = cli_args(CLI_ROOT)
    cfg = cli_config(args)
    t0 = time.perf_counter()
    cli.main(args + ["gen-records"])
    t1 = time.perf_counter()
    train = ["--epochs", "1", "--lr", str(CLI_LR), "--loss", "weighted_mse"]
    reset_counts()
    cli.main(args + ["train", *train])
    t2 = time.perf_counter()
    cli.main(args + ["resume", *train])
    t3 = time.perf_counter()
    steps = 2 * (N_EVAL_TRAIN // CLI_BATCH)
    evals = 2 * (N_EVAL // CLI_BATCH)
    counts = read_counts(
        f"cli_train: {steps} train steps and {evals} valid steps",
        {"resample_last_axis": 2 * steps,
         "render_heatmaps_batch": steps + evals})
    add_launches(report, counts)
    epochs, best = list_checkpoints(cfg.checkpoints_path)
    meta = CheckpointManager(cfg.checkpoints_path).read_meta()
    rows = metrics_lib.read_all_session_logs(cfg.logs_path)
    log(f"cli_train: gen-records {t1 - t0:.1f} s, train {t2 - t1:.1f} s, "
        f"resume {t3 - t2:.1f} s; checkpoints {epochs} best {best}; meta "
        f"{meta}; epoch rows {rows}")
    want_meta = {"epoch": 2, "loss_str": "weighted_mse",
                 "learning_rate": CLI_LR, "lr_schedule": None,
                 "warmup_steps": 0}
    if epochs != [1, 2] or not best or meta != want_meta:
        raise AssertionError(f"cli_train: checkpoints {epochs}, best {best}, "
                             f"meta {meta} != {want_meta}")
    if len(rows) < 2 or not all(np.isfinite([r["loss"], r["val_loss"]]).all()
                                for r in rows):
        raise AssertionError(f"cli_train: epoch rows {rows}")
    return args, cfg, val


def phase_cli_eval(report, args, cfg, val):
    """`cli eval --latest --save-path` (no --report: matplotlib is not
    known to be on the card's machine) against an in-process `predict_ds`
    on the same checkpoint: the predictions must be equal."""
    from single_person_pose_estimation_tpu_torch import cli
    from single_person_pose_estimation_tpu_torch.data import pipeline
    from single_person_pose_estimation_tpu_torch.evaluation import predict

    path = os.path.join(CLI_ROOT, "preds.json")
    reset_counts()
    t0 = time.perf_counter()
    cli.main(args + ["eval", "--latest", "--save-path", path])
    elapsed = time.perf_counter() - t0
    counts = read_counts("cli_eval", served_want(N_EVAL // CLI_BATCH))
    add_launches(report, counts)
    with open(path) as f:
        got = json.load(f)
    state = cli_state(cfg)
    with pipeline.DatasetBuilder(cfg) as b:
        want = predict.predict_ds(state.model, state, b.get_ds_prediction(),
                                  conf_threshold=0.1, save_path=None,
                                  device=CLI_DEVICE)
    log(f"cli_eval: {len(got)} predictions in {elapsed:.1f} s (checkpoint "
        f"restore included); in-process predict_ds equal: {got == want}")
    if got != want:
        bad = sum(p != q for p, q in zip(got, want))
        raise AssertionError(f"cli_eval: {bad} of {len(want)} predictions "
                             f"differ from predict_ds's")
    check_predictions(got, val, "cli_eval")


def http_call(port, path, body=None, headers=None):
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body, headers=headers or {},
                                 method="POST" if body is not None else "GET")
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, json.loads(resp.read())


def start_http_server(args, timeout=300):
    """`python -m ...cli serve --http 0` as a child process; returns it,
    its port and the list its output lines go to."""
    import queue
    import re
    import threading

    cmd = [sys.executable, "-m", "single_person_pose_estimation_tpu_torch.cli",
           *args, "serve", "--http", "0", "--latest", "--buckets",
           *map(str, CLI_BUCKETS)]
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            env={**os.environ, "PYTHONPATH": ROOT})
    lines, q = [], queue.Queue()

    def pump():
        for line in proc.stdout:
            lines.append(line.rstrip())
            q.put(line)
        q.put(None)

    threading.Thread(target=pump, daemon=True).start()
    deadline = time.perf_counter() + timeout
    while True:
        try:
            line = q.get(timeout=max(0.1, deadline - time.perf_counter()))
        except queue.Empty:
            line = None
        if line is None:
            proc.kill()
            proc.wait()
            raise AssertionError("cli serve --http did not come up: "
                                 + "\n".join(lines[-40:]))
        m = re.search(r"Serving on http://[\d.]+:(\d+)", line)
        if m:
            return proc, int(m.group(1)), lines


def phase_cli_serve(report, args, cfg, card):
    """`cli serve --images GLOB` against an in-process `PoseServer` on the
    same checkpoint and images; then `cli serve --http 0` in a child
    process: eight JPEG POSTs from concurrent threads and one raw float32
    POST, each equal to the in-process `HttpPoseService` answer; /stats
    must count 9 served; SIGINT must end it with exit code 0."""
    import glob as globlib
    import signal
    import threading

    from single_person_pose_estimation_tpu_torch import cli
    from single_person_pose_estimation_tpu_torch.data.images import (
        read_image,
        resize_bilinear,
    )
    from single_person_pose_estimation_tpu_torch.serving import PoseServer
    from single_person_pose_estimation_tpu_torch.serving_http import (
        HttpPoseService,
    )

    src = sorted(globlib.glob(os.path.join(cfg.valid_images_dir,
                                           "*.jpg")))[:CLI_SERVE_IMAGES]
    serve_dir = os.path.join(CLI_ROOT, "serve")
    os.makedirs(serve_dir)
    paths = []
    for p in src:
        paths.append(os.path.join(serve_dir, os.path.basename(p)))
        shutil.copy(p, paths[-1])
    out = os.path.join(CLI_ROOT, "keypoints.json")
    reset_counts()
    t0 = time.perf_counter()
    cli.main(args + ["serve", "--images", os.path.join(serve_dir, "*.jpg"),
                     "--latest", "--save-path", out, "--buckets",
                     *map(str, CLI_BUCKETS)])
    elapsed = time.perf_counter() - t0
    # Every step, the warm-up's included, is one forward and one decode.
    counts = read_counts("cli_serve --images",
                         lambda c: served_want(c["decode_batch"]))
    if counts["decode_batch"] < 2:          # the warm-up and >= 1 step
        raise AssertionError(f"cli_serve: {counts['decode_batch']} steps")
    add_launches(report, counts)
    with open(out) as f:
        got = json.load(f)
    state = cli_state(cfg)
    size = (cfg.image_height, cfg.image_width)
    with PoseServer(state.model, device=CLI_DEVICE,
                    buckets=CLI_BUCKETS) as server:
        futs = [server.submit(resize_bilinear(
            read_image(p).astype(np.float32) / 255.0, size)) for p in paths]
        want = [f.result().tolist() for f in futs]
        log(f"cli_serve --images: {len(got)} images in {elapsed:.1f} s "
            f"(checkpoint restore and warm-up included); equal to the "
            f"in-process PoseServer: {[got.get(p) for p in paths] == want}")
        if sorted(got) != paths or [got[p] for p in paths] != want:
            raise AssertionError("cli_serve --images: keypoints differ from "
                                 "the in-process PoseServer's")

        svc = HttpPoseService(server, input_size=size)
        bodies = []
        for p in paths:
            with open(p, "rb") as f:
                bodies.append((f.read(), {"Content-Type": "image/jpeg"}))
        raw = resize_bilinear(read_image(paths[0]).astype(np.float32) / 255.0,
                              size)
        bodies.append((raw.tobytes(), {
            "Content-Type": "application/octet-stream",
            "X-Shape": f"{size[0]},{size[1]},3"}))
        want = [svc._predict_one(b, h["Content-Type"], h.get("X-Shape"))
                for b, h in bodies]

    t0 = time.perf_counter()
    proc, port, lines = start_http_server(args)
    try:
        t_up = time.perf_counter() - t0
        if http_call(port, "/healthz") != (200, {"status": "ok"}):
            raise AssertionError("cli_serve --http: /healthz is not ok")
        answers = [None] * len(bodies)

        def post(i):
            answers[i] = http_call(port, "/predict", *bodies[i])

        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(CLI_SERVE_IMAGES)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        post(CLI_SERVE_IMAGES)
        t_req = time.perf_counter() - t0
        _, stats = http_call(port, "/stats")
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    codes = [a[0] if a else None for a in answers]
    same = [a is not None and a[1] == w for a, w in zip(answers, want)]
    log(f"cli_serve --http: up in {t_up:.1f} s; {len(bodies)} requests "
        f"(8 concurrent JPEG, 1 raw float32) in {t_req:.3f} s, status "
        f"{codes}, equal to in-process {same}; stats {stats}; served p50 "
        f"{stats['latency_p50_ms']} ms p99 {stats['latency_p99_ms']} ms "
        f"[{card}]; exit code after SIGINT {rc}")
    if codes != [200] * len(bodies) or not all(same):
        raise AssertionError("cli_serve --http: answers differ from the "
                             "in-process service's:\n" + "\n".join(lines[-20:]))
    if stats["served"] != len(bodies) or rc != 0:
        raise AssertionError(f"cli_serve --http: served {stats['served']}, "
                             f"exit code {rc}:\n" + "\n".join(lines[-20:]))
    report["_http_p50_ms"] = stats["latency_p50_ms"]
    report["_http_p99_ms"] = stats["latency_p99_ms"]


def phase_cli_export(report, args, cfg):
    """`cli export --artifact --savedmodel`: the artifact's predict equal to
    the checkpoint's plain model; the torch.export program (dynamic batch)
    at two batch sizes within the plain bf16 model's band around plain
    f32 (S4_BF16_FACTOR)."""
    import torch

    from single_person_pose_estimation_tpu_torch import cli
    from single_person_pose_estimation_tpu_torch.utils.export import (
        load_exported,
        load_inference_artifact,
    )

    art = os.path.join(CLI_ROOT, "artifact")
    prog_dir = os.path.join(CLI_ROOT, "program")
    reset_counts()
    t0 = time.perf_counter()
    cli.main(args + ["export", "--latest", "--artifact", art, "--savedmodel",
                     prog_dir])
    t1 = time.perf_counter()
    add_launches(report, read_counts("cli_export", {}))
    model = cli_state(cfg).model
    _, _, predict = load_inference_artifact(art, device=CLI_DEVICE)
    t2 = time.perf_counter()
    program = load_exported(prog_dir)
    t3 = time.perf_counter()
    f32 = cli._build_model(cfg.replace(compute_dtype="float32"))
    f32.load_state_dict(model.state_dict())
    f32 = f32.to(CLI_DEVICE).eval()
    x = torch.from_numpy(np.random.default_rng(40).uniform(
        0, 1, (max(EXPORT_BATCHES), 256, 256, 3)).astype(np.float32)).to(
            CLI_DEVICE)
    with torch.inference_mode():
        plain = model(x)[-1]
        same = torch.equal(predict(x), plain)
        bands = []
        for b in EXPORT_BATCHES:
            ref = f32(x[:b])[-1]
            e_plain = (model(x[:b])[-1] - ref).abs().max().item()
            got = program(x[:b])
            e_prog = (got - ref).abs().max().item()
            bands.append((b, tuple(got.shape), e_prog, e_plain))
    log(f"cli_export: export {t1 - t0:.1f} s, program load {t3 - t2:.1f} s; "
        f"artifact predict equal to the plain model: {same}; program vs "
        f"plain f32 (batch, shape, max |d|, plain bf16's max |d|): {bands}")
    if not same:
        raise AssertionError("cli_export: the artifact's predict differs "
                             "from the plain model")
    for b, shape, e_prog, e_plain in bands:
        if shape != (b, 64, 64, K) or not e_prog <= S4_BF16_FACTOR * max(
                e_plain, 1e-6):
            raise AssertionError(f"cli_export: the program at batch {b} is "
                                 f"off: {bands}")


def phase_demo(report, cfg):
    """`Demo.detect` on the card with a stub detector (three boxes on a
    480x640 image, one partly outside): crops within TOL_CROP of the port's
    crop_and_resize on the CPU, keypoints equal to forward_last_stack plus
    the decode on the demo's own crops, one forward through the kernels;
    then `webcam.run_on_video` over a short synthetic video, where
    matplotlib is installed."""
    import cv2
    import torch

    from single_person_pose_estimation_tpu_torch.demo import webcam
    from single_person_pose_estimation_tpu_torch.demo.demo import Demo
    from single_person_pose_estimation_tpu_torch.models.fused_inference import (
        forward_last_stack,
        prepare_fused,
    )
    from single_person_pose_estimation_tpu_torch.ops.cuda.decode_kernel import (
        decode_batch,
    )
    from single_person_pose_estimation_tpu_torch.ops.geometry import (
        crop_and_resize,
    )

    rng = np.random.default_rng(41)
    base = rng.uniform(0, 255, (6, 8, 3))
    image = np.clip(np.kron(base, np.ones((80, 80, 1)))
                    + rng.normal(0, 12, (480, 640, 3)), 0, 255).astype(
                        np.uint8)
    model = cli_state(cfg).model
    demo = Demo(lambda im: list(DEMO_BOXES), model, None, cfg,
                device=CLI_DEVICE)
    if not demo.use_fused:
        raise AssertionError("demo: the kernel path is not in use")
    reset_counts()
    demo.detect(image)
    add_launches(report, read_counts("demo detect", served_want(1)))
    crops = np.stack(demo.cropped_images)
    want_crops = crop_and_resize(
        torch.from_numpy(image.astype(np.float32) / 255.0),
        torch.tensor(demo.square_bboxes), cfg.image_height,
        cfg.image_width).numpy()
    crop_err = float(np.abs(crops - want_crops).max())
    with torch.inference_mode():
        hms = forward_last_stack(model, torch.from_numpy(crops).to(CLI_DEVICE),
                                 use_fused=True, auto=True,
                                 prepared=prepare_fused(model))
        kps = (decode_batch(hms, demo.keypoints_conf_thres, cfg.legacy_decode)
               / torch.tensor([cfg.label_width, cfg.label_height, 1.0],
                              device=CLI_DEVICE)).cpu().numpy()
    same = np.array_equal(np.stack(demo.keypoints_list), kps)
    log(f"demo: {len(demo.square_bboxes)} boxes {demo.square_bboxes}; crops "
        f"vs CPU crop_and_resize max |d| {crop_err:.3g}; keypoints equal to "
        f"forward_last_stack + decode: {same}")
    if crops.shape != (3, 256, 256, 3) or not crop_err <= TOL_CROP or not same:
        raise AssertionError(f"demo: crops {crops.shape} off by {crop_err} "
                             f"or keypoints differ ({same})")
    if importlib.util.find_spec("matplotlib") is None:
        # create_overlay renders with matplotlib, as the JAX demo's does;
        # tests/test_torch_demo.py runs the loop on the CPU.
        log("demo run_on_video: not run, matplotlib is not installed here")
        return
    src = os.path.join(CLI_ROOT, "in.mp4")
    out = os.path.join(CLI_ROOT, "out.mp4")
    w = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"mp4v"), 10, (320, 240))
    for _ in range(4):
        w.write(rng.integers(0, 255, (240, 320, 3)).astype(np.uint8))
    w.release()
    reset_counts()
    t0 = time.perf_counter()
    n = webcam.run_on_video(demo, src, out, max_frames=3)
    elapsed = time.perf_counter() - t0
    add_launches(report, read_counts("demo run_on_video", served_want(n)))
    cap = cv2.VideoCapture(out)
    ok, frame = cap.read()
    cap.release()
    log(f"demo run_on_video: {n} frames in {elapsed:.1f} s, output frame "
        f"{frame.shape if ok else None}")
    if n != 3 or not ok or frame.shape != (240, 320, 3):
        raise AssertionError(f"demo run_on_video: {n} frames, read {ok}")


def phase_profiling(report, cfg, card):
    """One served batch inside `utils/profiling.trace` and an `annotate`
    span: the written Chrome trace must hold the span and the kernels of
    #1-#4 and #13."""
    from single_person_pose_estimation_tpu_torch.serving import PoseServer
    from single_person_pose_estimation_tpu_torch.utils import profiling

    model = cli_state(cfg).model
    imgs = np.random.default_rng(42).uniform(
        0, 1, (CLI_BUCKETS[-1], 256, 256, 3)).astype(np.float32)
    # The batcher waits up to max_wait_s for the bucket to fill, so the
    # 16 requests go to the device as one step.
    with PoseServer(model, device=CLI_DEVICE, buckets=CLI_BUCKETS,
                    max_wait_s=1.0) as server:
        server.warmup()
        reset_counts()
        with profiling.trace(os.path.join(CLI_ROOT, "trace")) as prof:
            with profiling.annotate("serve"):
                kps = server.predict(imgs)
        add_launches(report, read_counts("profiling", served_want(1)))
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    spans = [e for e in events if e.get("name") == "serve"]
    want = {"#1/#3 (<0>)": TC_BNECK + "0", "#2 (<1>)": TC_BNECK + "1",
            "#3 (<2>)": TC_BNECK + "2", "#4": TC_HEAD, "#13": "decode_kernel"}
    found = {k: sum(v in n for n in kernels) for k, v in want.items()}
    busy = sum(e.get("dur", 0) for e in events
               if e.get("cat") == "kernel") / 1e3
    log(f"profiling: trace {os.path.basename(prof.trace_path)} "
        f"({os.path.getsize(prof.trace_path)} bytes), {len(kernels)} kernel "
        f"events ({busy:.2f} ms), 'serve' spans {len(spans)}, kernels "
        f"found {found} [{card}]")
    if kps.shape != (CLI_BUCKETS[-1], K, 3) or not spans \
            or not all(found.values()):
        raise AssertionError(f"profiling: span {len(spans)}, kernels "
                             f"{found}")


# ---------------------------------------------------------------------------
# Data parallel (parallel/): dp_train, dp_nccl, dp_eval, dp_serve.
# ---------------------------------------------------------------------------

DP_WORLD = 2
B_DP_F32 = 16            # global batch of the f32 hold (8 a rank)
B_DP_BF16 = 64           # global batch of the bf16 steps (32 a rank)
DP_STEPS = 3
DP_SEED = 12
DP_BACKENDS = ("flax", "fused")
# One process on the concatenated batch, then on it with every pixel one
# ulp away and with its two halves swapped (its sums in another order, as
# two ranks make them). At S4/256 f32 with random weights either control
# moves the grads 9-42% (relative L2) and the running statistics up to
# 1.9e-4 of their largest value (seeds 12-14 on an NVIDIA H100 80GB HBM3
# at 700.00 W; PERF.md), so two ranks are held within ULP_FACTOR times the
# larger control, grads and statistics alike.
DP_CONTROLS = ("one", "ulp", "perm")
DP_CHILD_TIMEOUT = 300   # s from the launch, for every child process
DP_ROOT = os.path.join(ROOT, "temp", "chip_smoke_dp")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_children(task, world, payload=None):
    """`python3 chip_smoke.py --dp-child TASK DIR` as `world` ranks with
    torchrun's environment; returns (deadline, dir, [(process, log)])."""
    out = os.path.join(DP_ROOT, task)
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    with open(os.path.join(out, "payload.json"), "w") as f:
        json.dump(payload, f)
    port = free_port()
    deadline = time.perf_counter() + DP_CHILD_TIMEOUT
    procs = []
    for rank in range(world):
        env = {**os.environ, "PYTHONPATH": ROOT, "RANK": str(rank),
               "LOCAL_RANK": str(rank), "WORLD_SIZE": str(world),
               "LOCAL_WORLD_SIZE": str(world), "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(port)}
        log_f = open(os.path.join(out, f"rank{rank}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
             "--dp-child", task, out], cwd=ROOT, env=env, stdout=log_f,
            stderr=subprocess.STDOUT), log_f))
    return deadline, out, procs


def wait_children(children):
    """Every rank's result; a child that fails or outlives
    DP_CHILD_TIMEOUT fails the phase (and every child is stopped)."""
    import torch

    deadline, out, procs = children
    try:
        for p, _ in procs:
            p.wait(timeout=max(0.0, deadline - time.perf_counter()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, log_f in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log_f.close()
    for rank, (p, _) in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(out, f"rank{rank}.log")) as f:
                tail = f.read()[-4000:]
            raise AssertionError(f"{os.path.basename(out)} rank {rank} "
                                 f"exited {p.returncode}:\n{tail}")
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(len(procs))]


def dp_batch(n, seed, rows=slice(None)):
    """`rows` of n synthetic 256 px crops on the card."""
    import torch

    from single_person_pose_estimation_tpu_torch.data.in_memory import (
        synthetic_crops,
    )

    return {k: torch.from_numpy(v[rows]).cuda()
            for k, v in synthetic_crops(n, IMG, seed=seed).items()}


def dp_state(dtype, mesh, seed, lr=2.5e-4):
    """S4/256 from init_variables(seed) at `dtype` compute and its train
    state on the card (this rank's device of `mesh`)."""
    from single_person_pose_estimation_tpu_torch.training import (
        steps as steps_lib,
    )

    model = build_s4_train(seed)
    model.compute_dtype = dtype
    return steps_lib.TrainState.create(
        model, lambda m: steps_lib.make_optimizer(m, lr), seed=0,
        device="cuda" if mesh is None else mesh.device)


def dp_step(backend, mesh, augment, bn_mode="batch"):
    """The train step over `mesh` (None: one process)."""
    from single_person_pose_estimation_tpu_torch import losses
    from single_person_pose_estimation_tpu_torch.training import (
        steps as steps_lib,
    )

    return steps_lib.make_train_step(losses.weighted_mse,
                                     train_config(DP_ROOT), augment=augment,
                                     bn_mode=bn_mode, model_backend=backend,
                                     mesh=mesh)


def control_batch(name, n, seed):
    """dp_batch(n, seed) as DP_CONTROLS name it: as it is ("one"), every
    pixel one ulp up ("ulp"), its two halves swapped ("perm")."""
    import torch

    b = dp_batch(n, seed)
    if name == "ulp":
        b["image"] = torch.nextafter(b["image"],
                                     torch.full_like(b["image"], np.inf))
    elif name == "perm":
        half = n // 2
        perm = torch.cat([torch.arange(half, n), torch.arange(half)])
        b = {k: v[perm.to(v.device)] for k, v in b.items()}
    return b


def flat_grads(state):
    import torch

    return torch.cat([p.grad.flatten() for _, p in
                      sorted(state.model.named_parameters())]).cpu()


def flatten_sorted(tensors):
    """flat_grads of a {name: tensor} dict."""
    import torch

    return torch.cat([t.flatten() for _, t in sorted(tensors.items())]).cpu()


def running_stats(state):
    return {n: t.detach().cpu().clone()
            for n, t in state.model.state_dict().items() if "running" in n}


def state_digest(state, skip=frozenset()) -> str:
    """SHA-256 of every parameter and running statistic, in name order,
    but those named in `skip`."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for name, t in sorted(state.model.state_dict().items()):
        if name in skip:
            continue
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().view(-1).view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()


def dp_want(backend, steps, augmented):
    """Exact launches of `steps` train steps on one rank, `augmented` of
    them with augmentation."""
    want = {"render_heatmaps_batch": steps,
            "resample_last_axis": 2 * augmented}
    if backend == "fused":
        want.update({n: v for n, v in fused_want(steps).items()
                     if n in FUSED_KERNELS})
    return want


def dp_train_child(mesh, seed):
    """One rank of dp_train: (a) one f32 step of each backend on the
    rank's rows of B_DP_F32, without augmentation; (b) on the rank's rows
    of one B_DP_BF16 batch, DP_STEPS bf16 steps of each backend without
    augmentation and then DP_STEPS with it."""
    import torch

    from single_person_pose_estimation_tpu_torch.ops import cuda as kernels

    per = lambda n: slice(mesh.rank * n // mesh.data_size,
                          (mesh.rank + 1) * n // mesh.data_size)
    res = {"f32": {}, "bf16": {}, "counts": {}}
    for backend in DP_BACKENDS:
        state = dp_state(torch.float32, mesh, seed)
        step = dp_step(backend, mesh, augment=False)
        b = dp_batch(B_DP_F32, seed, per(B_DP_F32))
        kernels.reset_launch_counts()
        state, m = step(state, b)
        torch.cuda.synchronize()
        res["counts"]["f32", backend] = kernels.launch_counts()
        res["f32"][backend] = {
            "loss": m["loss"].item(), "digest": state_digest(state),
            **({"grads": flat_grads(state), "stats": running_stats(state)}
               if mesh.rank == 0 else {})}
        del state
    for backend in DP_BACKENDS:
        state = dp_state(torch.bfloat16, mesh, seed, lr=1e-3)
        b = dp_batch(B_DP_BF16, 7, per(B_DP_BF16))
        kernels.reset_launch_counts()
        losses, digests = [], []
        for augment in (False, True):
            step = dp_step(backend, mesh, augment)
            for _ in range(DP_STEPS):
                state, m = step(state, b)
                losses.append(m["loss"].item())
                digests.append(state_digest(state))
        torch.cuda.synchronize()
        res["counts"]["bf16", backend] = kernels.launch_counts()
        res["bf16"][backend] = {"losses": losses, "digests": digests}
        del state
    return res


def dp_nccl_child(payload):
    """`cli train --data-parallel` in a process group of one over NCCL,
    joined before the CLI runs so that it trains in it."""
    import torch
    import torch.distributed as dist

    from single_person_pose_estimation_tpu_torch import cli
    from single_person_pose_estimation_tpu_torch.ops import cuda as kernels

    kernels.reset_launch_counts()
    cli.main(payload["args"] + ["train", *payload["train"]])
    torch.cuda.synchronize()
    return {"backend": dist.get_backend(), "world": dist.get_world_size(),
            "counts": kernels.launch_counts()}


def dp_child(task, out):
    """The body of `chip_smoke.py --dp-child TASK DIR`: join the process
    group from torchrun's environment (gloo for "train", "tp" and "pp", two
    ranks on cuda:0, since NCCL refuses two ranks on one device; NCCL for
    "nccl"), run the task, write DIR/rank{R}.pt."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from single_person_pose_estimation_tpu_torch.parallel import (
        distributed,
        mesh as mesh_lib,
    )

    with open(os.path.join(out, "payload.json")) as f:
        payload = json.load(f)
    if not distributed.initialize(
            backend="nccl" if task == "nccl" else "gloo",
            timeout_s=DP_CHILD_TIMEOUT):
        raise RuntimeError("no cluster environment")
    if task == "train":
        res = dp_train_child(mesh_lib.create_mesh(
            devices=["cuda:0"] * dist.get_world_size()), payload["seed"])
    elif task == "tp":
        res = tp_train_child(mesh_lib.create_mesh(
            (1, TP_WORLD), ("data", "model"),
            devices=["cuda:0"] * dist.get_world_size()), payload["seed"], out)
    elif task == "pp":
        res = pp_train_child(mesh_lib.create_mesh(
            (DP_WORLD, PP_DP_STAGES), ("data", "pipe"),
            devices=["cuda:0"] * (DP_WORLD * PP_DP_STAGES)), payload["seed"])
    else:
        res = dp_nccl_child(payload)
    torch.save(res, os.path.join(out, f"rank{dist.get_rank()}.pt"))
    dist.destroy_process_group()
    return 0


def phase_dp_train(report, seed=DP_SEED):
    """Two ranks on cuda:0 over gloo (`Trainer`'s step with `mesh=`), S4/256
    at 256x256: (a) at f32, one step of each backend at a global batch of
    16, without augmentation, against one process on the concatenated
    batch: the loss within TOL_FUSED_LOSS; the grads (relative L2) and the
    running statistics within ULP_FACTOR times the larger of two controls
    of that process, one ulp on the input pixels and the batch's halves
    swapped (DP_CONTROLS); (b) at
    bf16, on a global batch of 64, DP_STEPS steps of each backend on the
    batch as it is, whose loss falls, then DP_STEPS augmented steps; after
    every step both ranks hold the same bits. Exact launches on each
    rank."""
    import torch

    children = start_children("train", DP_WORLD, {"seed": seed})
    half = B_DP_F32 // DP_WORLD
    try:
        ref = {}
        for backend in DP_BACKENDS:
            for name in DP_CONTROLS:
                state = dp_state(torch.float32, None, seed)
                step = dp_step(backend, None, augment=False)
                state, m = step(state, control_batch(name, B_DP_F32, seed))
                ref[backend, name] = (m["loss"].item(), flat_grads(state),
                                      running_stats(state))
                del state
    finally:
        ranks = wait_children(children)
    rel = lambda a, b: (torch.linalg.vector_norm(a - b)
                        / torch.linalg.vector_norm(b)).item()
    stat_err = lambda a, b: max((a[n] - t).abs().max().item()
                                / max(t.abs().max().item(), 1e-30)
                                for n, t in b.items())
    failed = []
    for backend in DP_BACKENDS:
        got = [r["f32"][backend] for r in ranks]
        loss, grads, stats = ref[backend, "one"]
        gap = rel(got[0]["grads"], grads)
        serr = stat_err(got[0]["stats"], stats)
        lerr = max(abs(g["loss"] - loss) / abs(loss) for g in got)
        controls = {name: (rel(ref[backend, name][1], grads),
                           stat_err(ref[backend, name][2], stats))
                    for name in DP_CONTROLS[1:]}
        log(f"dp_train f32 {backend}: 2 ranks x {half} vs one process x "
            f"{B_DP_F32}: loss {got[0]['loss']:.7f} vs {loss:.7f} (rel "
            f"{lerr:.2e}), grads L2 rel {gap:.3e}, running stats "
            f"{serr:.3e}; controls (grads, stats): " + ", ".join(
                f"{n} {g:.3e} {st:.3e}" for n, (g, st) in controls.items()))
        noise = [max(c[i] for c in controls.values()) for i in (0, 1)]
        if lerr > TOL_FUSED_LOSS or gap > ULP_FACTOR * noise[0] \
                or serr > ULP_FACTOR * noise[1] \
                or got[0]["digest"] != got[1]["digest"]:
            failed.append(f"f32 {backend}: loss {lerr}, grads {gap} vs "
                          f"{controls}, stats {serr}, digests equal "
                          f"{got[0]['digest'] == got[1]['digest']}")
        runs = [r["bf16"][backend] for r in ranks]
        log(f"dp_train bf16 {backend}: 2 ranks x "
            f"{B_DP_BF16 // DP_WORLD}, {DP_STEPS} steps on the batch as it "
            f"is, then {DP_STEPS} augmented: losses {runs[0]['losses']}; "
            f"the same bits on both ranks after each step: "
            f"{runs[0]['digests'] == runs[1]['digests']}")
        fixed = runs[0]["losses"][:DP_STEPS]
        if runs[0]["digests"] != runs[1]["digests"] \
                or runs[0]["losses"] != runs[1]["losses"] \
                or not np.isfinite(runs[0]["losses"]).all() \
                or fixed[-1] >= fixed[0]:
            failed.append(f"bf16 {backend}: {runs}")
    for rank, r in enumerate(ranks):
        for (kind, backend), counts in r["counts"].items():
            want = dp_want(backend, 1, 0) if kind == "f32" \
                else dp_want(backend, 2 * DP_STEPS, DP_STEPS)
            want = {k: want.get(k, 0) for k in counts}
            if counts != want:
                failed.append(f"rank {rank} {kind} {backend}: launches "
                              f"{counts} != {want}")
            add_launches(report, counts)
        log(f"dp_train rank {rank}: launches {r['counts']}")
    if failed:
        raise AssertionError("dp_train: " + "; ".join(failed))
    return ref


# ---------------------------------------------------------------------------
# Tensor parallel (parallel/sharding_rules.py): tp_train. H-sharded
# inference (parallel/spatial.py, parallel/spatial_model.py): spatial.
# ---------------------------------------------------------------------------

TP_WORLD = 2             # model axis 2 x data axis 1, two ranks on cuda:0
B_TP_BF16 = 8            # the bf16 steps' batch; every rank takes it whole
# An f32 step of the flax backend with frozen BN: no batch statistics
# amplify a reordered sum there (train-mode BN at random weights moves
# the grads 9-42% for one ulp, DP_CONTROLS), so the model group's
# collectives are held within ULP_FACTOR times the larger of the one-ulp
# and batch-halves controls, which a lost share would pass by far.
B_TP_FROZEN = 8
B_TP_BNECK = 8           # tp_bottleneck_readings' batch
# bf16 steps on the batch as it is, then augmented (the augmentation is
# the backends' common code: the flax backend takes it). gloo carries each
# gathered activation through the host at ~0.5 GB/s: a fused bf16 step at
# B=8 takes 5 s, a flax one 4 s, an f32 one at 16 12 s, so the phase
# keeps its batch and its steps few.
TP_FIXED_STEPS = 2
TP_AUGMENTED_STEPS = {"flax": 1, "fused": 0}
BNECKS_PER_LEVEL = 12    # 3 identity-skip bottlenecks a level x 4 stacks
SP_SIZE = 1024           # spatial: one 1024x1024 crop
SP_SHARDS = 2            # ... on [cuda:0, cuda:0]
SP_GATHER_H = 64
TOL_SP_F32 = 1e-4
SP_BF16_FACTOR = 2.0


def tp_fused_want(b, dtype, steps, m=TP_WORLD):
    """Exact launches of #14a-f in `steps` fused train steps at batch b on
    one rank of a model axis of m: per bottleneck unit 3's backward skips
    its next-unit sums and bn_bwd_reduce takes them (a second call), and
    the 3x3 backward runs on its gathered weight
    (experimental/bottleneck_grad.py). A bf16 weight gradient skips its
    finalize when its plan takes one row slice."""
    import torch

    from single_person_pose_estimation_tpu_torch.ops.cuda import (
        bottleneck_train_kernel as tk,
    )

    dw = (lambda plan: 1 + (plan["slices"] > 1)) \
        if dtype == torch.bfloat16 else (lambda plan: 2)
    want = dict.fromkeys(FUSED_KERNELS, 0)
    for h in LEVELS:
        per = {"conv1x1_relu_stats": 4, "conv3x3_relu_stats": 2,
               "bn_bwd_reduce": 4,
               "unit1x1_bwd": 1 + dw(tk.dw1_plan(b, h, h, CM, C // m)),
               "unit3x3_bwd": 2 + dw(tk.dw3_plan(b, h, h, CM, CM)),
               "unit1_bwd": 1 + dw(tk.dw1_plan(b, h, h, C, CM // m))}
        for name, n in per.items():
            want[name] += steps * BNECKS_PER_LEVEL * n
    return want


def tp_want(backend, b, dtype, steps, augmented):
    want = {"render_heatmaps_batch": steps,
            "resample_last_axis": 2 * augmented}
    if backend == "fused":
        want.update(tp_fused_want(b, dtype, steps))
    return want


def tp_state(dtype, mesh, seed, lr=2.5e-4):
    """dp_state, sharded over the mesh's model axis."""
    from single_person_pose_estimation_tpu_torch.parallel.sharding_rules import (
        shard_state,
    )

    return shard_state(dp_state(dtype, mesh, seed, lr), mesh)


def tp_step(backend, mesh, augment, bn_mode="batch"):
    from single_person_pose_estimation_tpu_torch import losses
    from single_person_pose_estimation_tpu_torch.training import (
        steps as steps_lib,
    )

    return steps_lib.make_train_step(losses.weighted_mse,
                                     train_config(DP_ROOT), augment=augment,
                                     bn_mode=bn_mode, model_backend=backend,
                                     mesh=mesh, model_axis="model")


def tp_bottleneck_readings(tp, device, b=B_TP_BNECK, levels=LEVELS,
                           seed=31):
    """One train-mode bottleneck at f32 at each level through the kernels
    (`make_bottleneck_train("cuda")`: on a CPU tensor their plain
    versions), under `tp` on this rank's channels against one process on
    every channel, from the same inputs on every rank: the output and x's
    grad (every channel), this rank's slices of the statistics and of the
    12 weight and BN grads. Returns (label, relative L2, limit) triples:
    the forward within TOL_UNIT_ACT_F32, the grads within TOL_FUSED_GRAD
    (check_bottleneck_backends (3): float32 sum order flips the ReLU
    mask of activations within ~1e-6 of 0). A model-group share that a
    backward leaves out moves a grad by a share of its size."""
    import torch

    from single_person_pose_estimation_tpu_torch.experimental import (
        bottleneck_grad as bg,
    )

    rng = np.random.default_rng(seed)
    u = lambda lo, hi, n: torch.from_numpy(
        rng.uniform(lo, hi, n).astype(np.float32)).to(device)
    mine = lambda t: tp.local(t, -1)
    out = []
    for h in levels:
        p = train_unit_inputs(rng, torch.float32, device, b, h)
        args = [p["x"], p["w1"], p["b1"], p["w2"], p["b2"], p["w3"], p["b3"],
                u(.5, 1.5, CM), u(-.3, .3, CM), u(.5, 1.5, CM),
                u(-.3, .3, CM), u(.5, 1.5, C), u(-.3, .3, C)]
        runs = []
        # Every operand but x holds its output channels last.
        for fn, ops in ((bg.make_bottleneck_train("cuda", tp=tp),
                         [args[0]] + [mine(a).contiguous() for a in args[1:]]),
                        (bg.make_bottleneck_train("cuda"), args)):
            leaves = [a.clone().requires_grad_() for a in ops]
            y, stats = fn(*leaves)
            (y.float() * p["g"]).sum().backward()
            runs.append((y.detach(), stats, [t.grad for t in leaves]))
        (y, stats, grads), (y1, stats1, grads1) = runs
        out.append((f"out@{h}", rel_l2(y, y1), TOL_UNIT_ACT_F32))
        out += [(f"stats {i}@{h}", rel_l2(a, mine(w)), TOL_UNIT_ACT_F32)
                for i, (a, w) in enumerate(zip(stats, stats1))]
        out.append((f"grad x@{h}", rel_l2(grads[0], grads1[0]),
                    TOL_FUSED_GRAD))
        out += [(f"grad {i}@{h}", rel_l2(grads[i], mine(grads1[i])),
                 TOL_FUSED_GRAD) for i in range(1, 13)]
    return out


def tp_train_child(mesh, seed, out):
    """One rank of tp_train: tp_bottleneck_readings; one f32 step of the
    flax backend with frozen BN on a batch of B_TP_FROZEN: loss, grads
    of this rank's channels, the digest of the replicated leaves; (a) one
    f32 step of each backend on the whole B_DP_F32 batch of dp_train,
    without augmentation: loss, grads and running statistics of this
    rank's channels, the digest of the replicated leaves; (b)
    TP_FIXED_STEPS bf16 steps of each backend on a batch of B_TP_BF16 as
    it is, then TP_AUGMENTED_STEPS augmented, with losses and replicated
    digests after each; the last state of the flax backend saved by
    CheckpointManager into OUT/ckpt, beside this rank's own copy of its
    tensors."""
    import torch

    from single_person_pose_estimation_tpu_torch.ops import cuda as kernels
    from single_person_pose_estimation_tpu_torch.parallel.sharding_rules import (
        TensorParallel,
    )
    from single_person_pose_estimation_tpu_torch.training.checkpoint import (
        CheckpointManager,
    )

    res = {"f32": {}, "bf16": {}, "counts": {}, "seconds": {}, "traffic": {}}
    clock = time.perf_counter
    t0 = clock()
    res["bottleneck"] = tp_bottleneck_readings(
        TensorParallel(mesh.model_group, mesh.model_size, mesh.model_index),
        "cuda")
    res["seconds"]["bottleneck"] = clock() - t0
    state = tp_state(torch.float32, mesh, seed)
    t0 = clock()
    state, m = tp_step("flax", mesh, False, "frozen")(
        state, dp_batch(B_TP_FROZEN, seed))
    res["seconds"]["frozen"] = clock() - t0
    res["frozen"] = {"loss": m["loss"].item(),
                     "digest": state_digest(state, skip=state.model
                                            .tensor_parallel.split),
                     "grads": {n: p.grad.cpu()
                               for n, p in state.model.named_parameters()}}
    del state
    for backend in DP_BACKENDS:
        state = tp_state(torch.float32, mesh, seed)
        split = state.model.tensor_parallel.split
        step = tp_step(backend, mesh, augment=False)
        b = dp_batch(B_DP_F32, seed)
        kernels.reset_launch_counts()
        t0 = clock()
        state, m = step(state, b)
        torch.cuda.synchronize()
        res["seconds"]["f32", backend] = clock() - t0
        res["traffic"]["f32", backend] = dict(
            state.model.tensor_parallel.traffic)
        res["counts"]["f32", backend] = kernels.launch_counts()
        res["split"] = split
        res["f32"][backend] = {
            "loss": m["loss"].item(),
            "digest": state_digest(state, skip=split),
            "grads": {n: p.grad.cpu()
                      for n, p in state.model.named_parameters()},
            "stats": running_stats(state)}
        del state
    for backend in DP_BACKENDS:
        state = tp_state(torch.bfloat16, mesh, seed, lr=1e-3)
        b = dp_batch(B_TP_BF16, 7)
        kernels.reset_launch_counts()
        losses, digests = [], []
        t0 = clock()
        for augment, n in ((False, TP_FIXED_STEPS),
                           (True, TP_AUGMENTED_STEPS[backend])):
            step = tp_step(backend, mesh, augment)
            for _ in range(n):
                state, m = step(state, b)
                losses.append(m["loss"].item())
                digests.append(state_digest(state, skip=res["split"]))
        torch.cuda.synchronize()
        res["seconds"]["bf16", backend] = clock() - t0
        res["traffic"]["bf16", backend] = dict(
            state.model.tensor_parallel.traffic)
        res["counts"]["bf16", backend] = kernels.launch_counts()
        res["bf16"][backend] = {"losses": losses, "digests": digests}
        if backend == "flax":
            t0 = clock()
            CheckpointManager(os.path.join(out, "ckpt"),
                              group=mesh.group).save(1, state, {"epoch": 1})
            res["seconds"]["ckpt"] = clock() - t0
            res["saved"] = {n: t.detach().cpu().clone()
                            for n, t in state.model.state_dict().items()}
        del state
    return res


def phase_tp_train(report, ref, seed=DP_SEED):
    """Two ranks on cuda:0 over gloo, a ("data", "model") mesh of 1 x 2,
    S4/256 at 256x256 sharded by `shard_state` (conv weights split on
    their output channels, C=256 and 128 to 128 and 64 a rank): one
    bottleneck at each level through the kernels under the model axis
    against one process (tp_bottleneck_readings); one f32 step of the
    flax backend with frozen BN against one process on the same batch,
    the grads (relative L2) within ULP_FACTOR times the larger of its
    one-ulp and batch-halves controls (B_TP_FROZEN); (a) at
    f32, one step of each backend at the batch of 16 of dp_train, without
    augmentation, against dp_train's one process (`ref`): the loss within
    TOL_FUSED_LOSS, the reassembled grads (relative L2) and running
    statistics within ULP_FACTOR times the larger of its one-ulp and
    batch-halves controls; (b) at bf16, TP_FIXED_STEPS steps of each
    backend on a batch of B_TP_BF16 as it is, whose loss falls, then
    TP_AUGMENTED_STEPS augmented;
    after every step the leaves that the rule replicates hold the same
    bits on both ranks; (c) the checkpoint the ranks saved restores into
    an unsharded state with the reassembled tensors, bit for bit. Exact
    launches on each rank."""
    import torch

    from single_person_pose_estimation_tpu_torch.training.checkpoint import (
        CheckpointManager,
    )

    children = start_children("tp", TP_WORLD, {"seed": seed})
    try:
        frozen = {}
        for name in DP_CONTROLS:
            state = dp_state(torch.float32, None, seed)
            state, m = dp_step("flax", None, False, "frozen")(
                state, control_batch(name, B_TP_FROZEN, seed))
            frozen[name] = (m["loss"].item(), flat_grads(state))
            del state
    finally:
        ranks = wait_children(children)
    split = ranks[0]["split"]
    full = lambda parts: {n: torch.cat([p[n] for p in parts])
                          if n in split else parts[0][n] for n in parts[0]}
    rel = lambda a, b: (torch.linalg.vector_norm(a - b)
                        / torch.linalg.vector_norm(b)).item()
    stat_err = lambda a, b: max((a[n] - t).abs().max().item()
                                / max(t.abs().max().item(), 1e-30)
                                for n, t in b.items())
    failed = []
    got = [r["frozen"] for r in ranks]
    loss, grads = frozen["one"]
    gap = rel(flatten_sorted(full([g["grads"] for g in got])), grads)
    lerr = max(abs(g["loss"] - loss) / abs(loss) for g in got)
    controls = {name: rel(frozen[name][1], grads)
                for name in DP_CONTROLS[1:]}
    log(f"tp_train f32 flax, frozen BN: model axis {TP_WORLD} vs one "
        f"process x {B_TP_FROZEN}: loss rel {lerr:.2e}, grads L2 rel "
        f"{gap:.3e} (|g| {torch.linalg.vector_norm(grads).item():.3e}); "
        f"controls: " + ", ".join(f"{n} {c:.3e}" for n, c in
                                  controls.items())
        + f"; replicated leaves equal on both ranks: "
        f"{got[0]['digest'] == got[1]['digest']}")
    if lerr > TOL_FUSED_LOSS or not gap <= ULP_FACTOR * max(
            controls.values()) or got[0]["digest"] != got[1]["digest"]:
        failed.append(f"f32 frozen: loss {lerr}, grads {gap} vs {controls}")
    for rank, r in enumerate(ranks):
        worst = max(r["bottleneck"], key=lambda t: t[1] / t[2])
        grad = max((t for t in r["bottleneck"] if t[0].startswith("grad")),
                   key=lambda t: t[1])
        bad = [t for t in r["bottleneck"] if not t[1] <= t[2]]
        log(f"tp_train rank {rank}: one bottleneck f32 at each level, "
            f"kernels under the model axis vs one process: "
            f"{len(r['bottleneck']) - len(bad)} of {len(r['bottleneck'])} "
            f"readings within their limits; the largest share "
            f"{worst[0]} {worst[1]:.3e} of {worst[2]:.0e}, the largest "
            f"grad {grad[0]} {grad[1]:.3e} of {grad[2]:.0e}; out and grad x "
            + ", ".join(f"{n} {e:.2e}" for n, e, _ in r["bottleneck"]
                        if n.startswith(("out", "grad x"))))
        if bad:
            failed.append(f"rank {rank} bottleneck: {bad}")
    for backend in DP_BACKENDS:
        got = [r["f32"][backend] for r in ranks]
        loss, grads, stats = ref[backend, "one"]
        gap = rel(flatten_sorted(full([g["grads"] for g in got])), grads)
        serr = stat_err(full([g["stats"] for g in got]), stats)
        lerr = max(abs(g["loss"] - loss) / abs(loss) for g in got)
        controls = {name: (rel(ref[backend, name][1], grads),
                           stat_err(ref[backend, name][2], stats))
                    for name in DP_CONTROLS[1:]}
        noise = [max(c[i] for c in controls.values()) for i in (0, 1)]
        log(f"tp_train f32 {backend}: model axis {TP_WORLD} vs one process "
            f"x {B_DP_F32}: loss {got[0]['loss']:.7f} vs {loss:.7f} (rel "
            f"{lerr:.2e}), grads L2 rel {gap:.3e}, running stats "
            f"{serr:.3e}; controls (grads, stats): " + ", ".join(
                f"{n} {g:.3e} {st:.3e}" for n, (g, st) in controls.items())
            + f"; replicated leaves equal on both ranks: "
            f"{got[0]['digest'] == got[1]['digest']}, losses "
            f"{[g['loss'] for g in got]}")
        if lerr > TOL_FUSED_LOSS or gap > ULP_FACTOR * noise[0] \
                or serr > ULP_FACTOR * noise[1] \
                or got[0]["digest"] != got[1]["digest"]:
            failed.append(f"f32 {backend}: loss {lerr}, grads {gap} vs "
                          f"{controls}, stats {serr}")
        runs = [r["bf16"][backend] for r in ranks]
        fixed = runs[0]["losses"][:TP_FIXED_STEPS]
        log(f"tp_train bf16 {backend}: batch {B_TP_BF16}, {TP_FIXED_STEPS} "
            f"steps on the batch as it is, then "
            f"{TP_AUGMENTED_STEPS[backend]} augmented: losses "
            f"{runs[0]['losses']}; replicated leaves equal on both ranks "
            f"after each step: {runs[0]['digests'] == runs[1]['digests']}")
        if runs[0]["digests"] != runs[1]["digests"] \
                or runs[0]["losses"] != runs[1]["losses"] \
                or not np.isfinite(runs[0]["losses"]).all() \
                or fixed[-1] >= fixed[0]:
            failed.append(f"bf16 {backend}: {runs}")
    state = dp_state(torch.bfloat16, None, seed + 1, lr=1e-3)
    CheckpointManager(os.path.join(DP_ROOT, "tp", "ckpt")).restore(state)
    saved = full([r["saved"] for r in ranks])
    restored = {n: t.cpu() for n, t in state.model.state_dict().items()}
    unequal = [n for n in saved if not torch.equal(saved[n], restored[n])]
    log(f"tp_train: the checkpoint restored unsharded equals the ranks' "
        f"state in {len(saved) - len(unequal)} of {len(saved)} tensors "
        f"({len(split)} split)")
    if unequal or saved.keys() != restored.keys():
        failed.append(f"checkpoint: {unequal[:5]}")
    del state
    for rank, r in enumerate(ranks):
        for (kind, backend), counts in r["counts"].items():
            want = tp_want(backend, B_DP_F32, torch.float32, 1, 0) \
                if kind == "f32" else tp_want(backend, B_TP_BF16,
                                              torch.bfloat16,
                                              TP_FIXED_STEPS
                                              + TP_AUGMENTED_STEPS[backend],
                                              TP_AUGMENTED_STEPS[backend])
            want = {k: want.get(k, 0) for k in counts}
            if counts != want:
                failed.append(f"rank {rank} {kind} {backend}: launches "
                              f"{counts} != {want}")
            add_launches(report, counts)
        log(f"tp_train rank {rank}: launches {r['counts']}; seconds "
            f"{r['seconds']}; model-group all_reduce calls and bytes "
            f"{r['traffic']}")
    if failed:
        raise AssertionError("tp_train: " + "; ".join(failed))


def phase_spatial(report, model, card):
    """`spatial_apply` of S4/256 at SP_SIZE x SP_SIZE, batch 1, over a
    ("spatial",) mesh of [cuda:0, cuda:0] (each map taller than
    SP_GATHER_H split into two blocks of rows, halos copied between them)
    against the plain forward of the whole crop, on a copy whose last
    predict conv is scaled so that its heatmaps do not saturate
    (`scaled_readings`): f32 within TOL_SP_F32 on every stack; bf16 on
    the last stack, in max|d| and mean|d| from plain f32, within
    SP_BF16_FACTOR times the plain bf16 forward's own distance. Then the
    bf16 spatial forward's ms beside the plain bf16 forward's. No kernel
    of the port runs (JAX's spatial forward runs no Pallas kernel). The
    f32 distance is split, for the log, by `spatial_apply` over a mesh of
    one device (no halo, the BN folded): its distance from the split run
    is the split's own, its distance from the plain forward that of the
    folded BN and the ops' order."""
    import torch

    from single_person_pose_estimation_tpu_torch.ops import cuda as kernels
    from single_person_pose_estimation_tpu_torch.parallel.mesh import (
        create_mesh,
    )
    from single_person_pose_estimation_tpu_torch.parallel.spatial_model import (
        spatial_apply,
    )

    mesh = create_mesh((SP_SHARDS,), ("spatial",),
                       devices=["cuda:0"] * SP_SHARDS)
    one = create_mesh((1,), ("spatial",), devices=["cuda:0"])
    rng = np.random.default_rng(40)
    x = torch.from_numpy(rng.uniform(0, 1, (1, SP_SIZE, SP_SIZE, 3))
                         .astype(np.float32)).cuda()
    peaked = copy.deepcopy(model)
    peaked.compute_dtype = torch.float32
    with torch.inference_mode():
        z = predict_logits(peaked, x)
    pred = getattr(peaked, f"hg{peaked.num_stacks - 1}_conv_1x1_predict")
    k = 4.0 / z.abs().max().item()
    with torch.no_grad():
        pred.weight.mul_(k)
        pred.bias.mul_(k)
    kernels.reset_launch_counts()
    run = lambda dt, m=mesh: spatial_apply(
        peaked, x, m, gather_h=SP_GATHER_H, compute_dtype=dt)
    with torch.inference_mode():
        plain32 = peaked(x)
        sp32 = run(torch.float32)
        one32 = run(torch.float32, one)
        peaked.compute_dtype = torch.bfloat16
        plain16 = peaked(x)
        sp16 = run(torch.bfloat16)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        sp_ms = cuda_ms(lambda: run(torch.bfloat16), iters=5)
        plain_ms = cuda_ms(lambda: peaked(x), iters=5)
    open_share = ((plain32[-1] > 0) & (plain32[-1] < 1)).float().mean().item()
    dist = lambda xs, ys: [(a - b).abs().max().item() for a, b in zip(xs, ys)]
    stacks32 = dist(sp32, plain32)
    err32 = max(stacks32)
    d = lambda a: ((a[-1] - plain32[-1]).abs().max().item(),
                   (a[-1] - plain32[-1]).abs().mean().item())
    sp, ctrl = d(sp16), d(plain16)
    shape_ok = all(t.shape == (1, SP_SIZE // 4, SP_SIZE // 4, K)
                   and bool(torch.isfinite(t).all()) for t in sp32 + sp16)
    log(f"spatial: S4/256 at {SP_SIZE}x{SP_SIZE}, rows split over "
        f"{SP_SHARDS} devices above {SP_GATHER_H} px; {open_share:.4f} of the "
        f"plain f32 last-stack heatmap values open; f32 spatial vs plain "
        f"max|d| {err32:.3e} (every stack); bf16 last stack vs plain f32 max "
        f"{sp[0]:.3e} mean {sp[1]:.3e}, plain bf16 control max {ctrl[0]:.3e} "
        f"mean {ctrl[1]:.3e}; kernel launches {sum(counts.values())}")
    log(f"spatial: f32 max|d| by stack: split vs plain "
        + ", ".join(f"{e:.3e}" for e in stacks32) + "; split vs one device "
        + ", ".join(f"{e:.3e}" for e in dist(sp32, one32))
        + "; one device vs plain "
        + ", ".join(f"{e:.3e}" for e in dist(one32, plain32)))
    log(f"spatial: bf16 forward {sp_ms:.2f} ms spatial, {plain_ms:.2f} ms "
        f"plain ({card})")
    if not shape_ok or open_share < 0.99 or err32 > TOL_SP_F32 \
            or any(s > SP_BF16_FACTOR * c for s, c in zip(sp, ctrl)) \
            or any(counts.values()):
        raise AssertionError(f"spatial: shapes/finite {shape_ok}, open "
                             f"{open_share}, f32 {err32}, bf16 {sp} vs "
                             f"{ctrl}, launches {counts}")
    report["_spatial_ms"] = (round(sp_ms, 3), round(plain_ms, 3))


def phase_dp_nccl(report, args):
    """`cli train --data-parallel` for one epoch of 2 steps (--ratio 0.5 of
    the CLI's records) in a process group of one over NCCL, under
    torchrun's environment."""
    tmp = os.path.join(DP_ROOT, "nccl_run")
    shutil.rmtree(tmp, ignore_errors=True)
    train = ["--epochs", "1", "--lr", str(CLI_LR), "--loss", "weighted_mse",
             "--ratio", "0.5"]
    (res,) = wait_children(start_children(
        "nccl", 1, {"args": args + ["--set", f"temporary_dir={tmp}"],
                    "train": train}))
    steps = (N_EVAL_TRAIN // 2) // CLI_BATCH
    evals = (N_EVAL // 2) // CLI_BATCH
    want = {"resample_last_axis": 2 * steps,
            "render_heatmaps_batch": steps + evals}
    counts = {k: v for k, v in res["counts"].items() if v}
    from single_person_pose_estimation_tpu_torch.training.checkpoint import (
        CheckpointManager,
    )
    meta = CheckpointManager(os.path.join(tmp, "checkpoints")).read_meta()
    log(f"dp_nccl: backend {res['backend']}, world {res['world']}, "
        f"launches {counts} ({steps} train and {evals} valid steps), meta "
        f"{meta}")
    if res["backend"] != "nccl" or res["world"] != 1 or counts != want \
            or not meta or meta["epoch"] != 1:
        raise AssertionError(f"dp_nccl: {res}, meta {meta}, want {want}")
    add_launches(report, counts)


def phase_dp_eval(report, cfg, val):
    """`predict_ds` over a mesh of two replicas on cuda:0 at B=128 (64
    rows a replica) against `predict_ds` without a mesh: the same
    predictions; exact launches."""
    from single_person_pose_estimation_tpu_torch.data import pipeline
    from single_person_pose_estimation_tpu_torch.evaluation import (
        predict,
    )
    from single_person_pose_estimation_tpu_torch.parallel.mesh import (
        create_mesh,
    )

    state = eval_model(cfg, seed=1)
    runs = {}
    for name, mesh in (("no mesh", None),
                       ("mesh", create_mesh(devices=["cuda:0"] * DP_WORLD))):
        forwards = (N_EVAL // B_TIME) * (1 if mesh is None else DP_WORLD)
        with pipeline.DatasetBuilder(cfg) as b:
            reset_counts()
            t0 = time.perf_counter()
            runs[name] = predict.predict_ds(state.model, state,
                                            b.get_ds_prediction(),
                                            save_path=None, mesh=mesh)
            elapsed = time.perf_counter() - t0
            counts = read_counts(f"dp_eval {name} ({elapsed:.2f} s)",
                                 served_want(forwards))
    add_launches(report, counts)
    check_predictions(runs["mesh"], val, "dp_eval")
    bad = sum(p != q for p, q in zip(runs["mesh"], runs["no mesh"]))
    log(f"dp_eval: {len(runs['mesh'])} predictions, {bad} differ from the "
        f"pass without a mesh")
    if bad or len(runs["mesh"]) != N_EVAL:
        raise AssertionError(f"dp_eval: {bad} predictions differ")
    return state


def phase_dp_serve(report, cfg, state):
    """`PoseServer` over a mesh of two replicas on cuda:0 against
    `PoseServer(device="cuda")` on 128 crops from the records, each server
    with one bucket of 128 that it waits up to 1 s to fill, so that each
    serves one step: the same keypoints, exact launches. (A step's rows
    depend on when the requests arrive, and cuDNN's front convolutions
    round a small batch otherwise than a large one.) The buckets of a mesh
    are rounded up to multiples of its 2 replicas."""
    from single_person_pose_estimation_tpu_torch.data import pipeline
    from single_person_pose_estimation_tpu_torch.parallel.mesh import (
        create_mesh,
    )
    from single_person_pose_estimation_tpu_torch.serving import PoseServer

    with pipeline.DatasetBuilder(cfg) as b:
        images, _ = next(iter(b.get_ds_prediction()))
    x = np.asarray(images, np.float32)
    if images.dtype == np.uint8:
        x /= 255.0
    serve = dict(buckets=(B_TIME,), max_wait_s=1.0)
    with PoseServer(state.model, device="cuda", **serve) as server:
        want = server.predict(x)
        plain_steps = server.stats()["steps"]
    mesh = create_mesh(devices=["cuda:0"] * DP_WORLD)
    with PoseServer(state.model, mesh=mesh, buckets=(1, 3, B_TIME)) as server:
        rounded = server.buckets
    reset_counts()
    with PoseServer(state.model, mesh=mesh, **serve) as server:
        got = server.predict(x)
        steps = server.stats()["steps"]
    counts = read_counts(f"dp_serve: {steps} step(s) of {B_TIME} over 2 "
                         f"replicas", served_want(steps * DP_WORLD))
    add_launches(report, counts)
    log(f"dp_serve: buckets (1, 3, {B_TIME}) over the mesh: {rounded}; "
        f"{len(got)} keypoint sets, equal to the served keypoints without "
        f"a mesh: {np.array_equal(got, want)}")
    if rounded != (2, 4, B_TIME) or (steps, plain_steps) != (1, 1) \
            or not np.array_equal(got, want):
        raise AssertionError(f"dp_serve: buckets {rounded}, steps {steps} "
                             f"and {plain_steps}; max |d| "
                             f"{np.abs(got - want).max()}")


# ---------------------------------------------------------------------------
# The GPipe pipeline over stacks (parallel/pipeline.py): pipeline. The
# space-to-depth front, remat and the mobile depthwise lowerings (the
# model's dials): s2d_remat.
# ---------------------------------------------------------------------------

PP_STAGES = 4            # ("pipe",) mesh of [cuda:0] * 4, one stack a stage
B_PP_FWD, PP_FWD_M = 32, 4
B_PP_TRAIN, PP_TRAIN_M, PP_STEPS, PP_LR = 16, 4, 3, 1e-3
B_PP_DP = 8              # the ("data", "pipe") step: 2 ranks x 2 stages
PP_DP_STAGES = 2
TOL_PP_F32 = 1e-4        # against seq_microbatched
PP_ROOT = os.path.join(ROOT, "temp", "chip_smoke_pp")
B_S2D = 128
TOL_S2D_FRONT = 1e-5     # relative L2 of the f32 front's output
TOL_REMAT_LOSS = 1e-6    # relative
REMAT_MODES = (False, True, "conv_out")


def pp_model(dtype, stacks=4, **kw):
    """An S4/256 StackedHourglass (random torch weights) at `dtype`: the
    template whose settings the pipeline's modules copy."""
    from single_person_pose_estimation_tpu_torch.models.hourglass import (
        StackedHourglass,
    )

    return StackedHourglass(num_stacks=stacks, num_channels=C,
                            compute_dtype=dtype, **kw)


def pp_mesh(stages, device="cuda:0"):
    from single_person_pose_estimation_tpu_torch.parallel.mesh import (
        create_mesh,
    )

    return create_mesh((stages,), ("pipe",), devices=[device] * stages)


def pp_state(variables, dtype, mesh, lr):
    from single_person_pose_estimation_tpu_torch.parallel import (
        pipeline as pp,
    )
    from single_person_pose_estimation_tpu_torch.training import (
        steps as steps_lib,
    )

    return pp.PipelineTrainState.create(
        pp_model(dtype), lambda m: steps_lib.make_optimizer(m, lr), mesh,
        seed=0, variables=variables)


def pp_step(dtype, mesh, m, augment):
    from single_person_pose_estimation_tpu_torch import losses
    from single_person_pose_estimation_tpu_torch.parallel import (
        pipeline as pp,
    )

    return pp.make_pipeline_train_step(pp_model(dtype), losses.weighted_mse,
                                       train_config(DP_ROOT), mesh, m,
                                       augment=augment)


def pp_grads(state):
    """A pipelined state's grads under the sequential model's parameter
    names; the last stack's zero-padded interface convs get none."""
    grads = {n: p.grad for n, p in state.front.named_parameters()}
    for s, stage in enumerate(state.stacked):
        grads.update({f"hg{s}" + n[len("hg0"):]: p.grad
                      for n, p in stage.named_parameters()
                      if p.grad is not None})
    return grads


def pp_stats(variables):
    """The running statistics of full-model variables, by state_dict name."""
    import torch

    from single_person_pose_estimation_tpu_torch.utils.weight_convert import (
        to_state_dict,
    )

    return {n: t for n, t in to_state_dict(
        {"params": variables["params"],
         "batch_stats": variables["batch_stats"]}).items()
        if "running" in n}


def stats_err(a, b):
    """The largest distance of a's running statistics from b's, each over
    the tensor's largest |value|."""
    return max((a[n].float().cpu() - t.float().cpu()).abs().max().item()
               / max(t.abs().max().item(), 1e-30) for n, t in b.items())


def pp_ghost_stats(variables, images, replicas):
    """The ("data", "pipe") step's running statistics, computed directly
    in one process: the front's train-mode BN over the whole batch, each
    replica's rows through its own copies of the stages (train-mode BN
    over those rows), the stages' statistics averaged over the replicas."""
    import torch

    from single_person_pose_estimation_tpu_torch.parallel import (
        pipeline as pp,
    )

    model = pp_model(torch.float32)
    front, stages = pp.place_pipeline(
        model, *pp.split_pipeline_variables(variables, 4),
        [images.device] * PP_DP_STAGES)
    per = []
    with torch.no_grad():
        x0 = front.front(front.input_nchw(images), True)
        for rows in x0.chunk(replicas):
            copies = copy.deepcopy(stages)
            for stage in copies:
                rows, _ = stage.run(rows, True)
            per.append(pp.pipeline_variables(front, copies))
    stacked = {"params": per[0][1]["params"],
               "batch_stats": {n: {k: np.mean([p[1]["batch_stats"][n][k]
                                               for p in per], axis=0)
                                   for k in ("mean", "var")}
                               for n in per[0][1]["batch_stats"]}}
    return pp_stats(pp.merge_pipeline_variables(per[0][0], stacked, 4))


def seq_microbatched(model, x):
    """The sequential model's last-stack heatmaps computed as the pipeline
    computes them: the front over the whole batch, then the stacks on
    each of PP_FWD_M microbatches."""
    x0 = model.front(model.input_nchw(x))
    outs = []
    for y in x0.chunk(PP_FWD_M):
        for i in range(model.num_stacks):
            y, pred = model._hourglass(y, i, i == model.num_stacks - 1)
        outs.append(pred.float().permute(0, 2, 3, 1))
    return outs


def pp_train_child(mesh, seed):
    """One rank of the pipeline phase's ("data", "pipe") check: one f32
    step of S4/256 at M = 1 on this rank's B_PP_DP / 2 rows, without
    augmentation."""
    import torch

    from single_person_pose_estimation_tpu_torch.ops import cuda as kernels
    from single_person_pose_estimation_tpu_torch.utils.weight_convert import (
        init_variables,
    )

    state = pp_state(init_variables(4, C, seed=seed), torch.float32, mesh,
                     2.5e-4)
    step = pp_step(torch.float32, mesh, 1, augment=False)
    n = B_PP_DP // mesh.data_size
    b = dp_batch(B_PP_DP, seed, slice(mesh.rank * n, (mesh.rank + 1) * n))
    kernels.reset_launch_counts()
    state, m = step(state, b)
    torch.cuda.synchronize()
    variables = state.variables()
    res = {"loss": m["loss"].item(), "counts": kernels.launch_counts(),
           "digest": variables_digest(variables), "shape": mesh.shape}
    if mesh.rank == 0:
        res.update(grads=flatten_sorted(pp_grads(state)),
                   stats=pp_stats(variables))
    return res


def variables_digest(variables) -> str:
    """SHA-256 of every leaf of flax-layout variables, in key order."""
    import hashlib

    h = hashlib.sha256()

    def walk(tree, path):
        for k in sorted(tree):
            if isinstance(tree[k], dict):
                walk(tree[k], f"{path}/{k}")
            else:
                h.update(f"{path}/{k}".encode())
                h.update(np.ascontiguousarray(tree[k]).tobytes())
    walk(variables, "")
    return h.hexdigest()


def phase_pipeline(report, ref, card, seed=DP_SEED):
    """The GPipe pipeline of S4/256 (13,784,260 parameters,
    init_variables) over a ("pipe",) mesh of [cuda:0] * 4, one stack a
    stage: (a) the eval forward at B=32, M=4, on the weights with the last
    predict conv scaled so that no heatmap saturates (`unsaturated_copy`),
    f32 within TOL_PP_F32 of the sequential model's front on the batch
    and stacks on the same microbatches (`seq_microbatched`) and of its
    whole-batch forward (mean within TOL_S4_F32_MEAN); bf16 within
    S4_BF16_FACTOR times the plain bf16 forward's distance from plain f32
    in max|d| and mean|d|; (b) PP_STEPS bf16 train steps at
    B=16, M=4, augmentation on ("auto": the warp #11 twice and the
    heatmap #12 once a step, exact), whose loss falls; (c) one f32 step at
    M=1 against dp_train's one-process step on its batch (`ref`): loss
    within TOL_FUSED_LOSS, grads and running statistics within
    ULP_FACTOR times the larger of dp_train's one-ulp and batch-halves
    controls; (d) merged variables saved through CheckpointManager and
    restored into a StackedHourglass, every tensor equal; (e) two gloo
    ranks x 2 stages on cuda:0 over a ("data", "pipe") mesh, one f32 step
    at B=8 and M=1, against one process on a pipe-only mesh at M=2 (the
    same row groups): loss (within TOL_FUSED_LOSS, or ULP_FACTOR times
    the larger of that process's one-ulp and halves-swapped controls) and
    grads within ULP_FACTOR times those controls, running statistics within
    ULP_FACTOR times the one-ulp control of `pp_ghost_stats`; both ranks
    the same bits. Prints the pipelined and sequential ms a forward and a
    step (smoke readings)."""
    import torch

    from single_person_pose_estimation_tpu_torch import losses as losses_lib
    from single_person_pose_estimation_tpu_torch.models.hourglass import (
        StackedHourglass,
    )
    from single_person_pose_estimation_tpu_torch.parallel import (
        pipeline as pp,
    )
    from single_person_pose_estimation_tpu_torch.training import (
        steps as steps_lib,
    )
    from single_person_pose_estimation_tpu_torch.training.checkpoint import (
        CheckpointManager,
    )
    from single_person_pose_estimation_tpu_torch.utils.weight_convert import (
        init_variables,
        load_variables,
        to_state_dict,
        to_variables,
    )

    children = start_children("pp", DP_WORLD, {"seed": seed})
    failed, readings = [], {}
    try:
        v = init_variables(4, C, seed=0)
        mesh = pp_mesh(PP_STAGES)
        # (a) the eval forward, with the last predict conv scaled so that
        # no heatmap saturates (scaled_readings).
        x = dp_batch(B_PP_FWD, 3)["image"]
        seq = load_variables(pp_model(torch.float32), v).cuda()
        if seq.count_params() != S4_PARAMS:
            raise AssertionError(f"S4/256: {seq.count_params()} params")
        vs = to_variables(unsaturated_copy(seq, x)[0])
        out = {}
        for dt in (torch.float32, torch.bfloat16):
            seq = load_variables(pp_model(dt), vs).cuda()
            parts = pp.place_pipeline(seq, *pp.split_pipeline_variables(
                vs, 4), mesh.pipe_devices())
            fwd = pp.make_pipeline_forward(seq, mesh, PP_FWD_M)
            with torch.inference_mode():
                out["seq", dt] = seq(x)[-1]
                out["mb", dt] = torch.cat(seq_microbatched(seq, x))
                out["pp", dt] = fwd(*parts, x)
                if dt == torch.bfloat16:
                    readings["forward_ms"] = cuda_ms(
                        lambda: fwd(*parts, x), iters=3, warmup=1)
                    readings["seq_forward_ms"] = cuda_ms(
                        lambda: seq(x), iters=3, warmup=1)
            del seq, parts
        f32, b16 = torch.float32, torch.bfloat16
        dist = lambda a, b: ((a - b).abs().max().item(),
                             (a - b).abs().mean().item())
        d_mb = dist(out["pp", f32], out["mb", f32])[0]
        d_seq = dist(out["pp", f32], out["seq", f32])
        ctl = dist(out["seq", b16], out["seq", f32])
        d16 = dist(out["pp", b16], out["seq", f32])
        open_share = ((out["seq", f32] > 0) & (out["seq", f32] < 1)).float(
            ).mean().item()
        log(f"pipeline forward B={B_PP_FWD} M={PP_FWD_M} over "
            f"{PP_STAGES} stages ({open_share:.4f} of the heatmap values "
            f"strictly between 0 and 1): f32 vs the sequential model's "
            f"stacks on the same microbatches max|d| {d_mb:.3e}, vs its "
            f"whole-batch forward max|d| {d_seq[0]:.3e} mean|d| "
            f"{d_seq[1]:.3e}; bf16 vs plain f32 max|d| {d16[0]:.3e} mean|d| "
            f"{d16[1]:.3e} (plain bf16 control {ctl[0]:.3e}, {ctl[1]:.3e})")
        if not all(torch.isfinite(t).all() for t in out.values()) \
                or out["pp", f32].shape != (B_PP_FWD, 64, 64, K) \
                or open_share < 0.99 or d_mb > TOL_PP_F32 \
                or d_seq[0] > TOL_PP_F32 or d_seq[1] > TOL_S4_F32_MEAN \
                or any(d > S4_BF16_FACTOR * c for d, c in zip(d16, ctl)):
            failed.append(f"forward: f32 {d_mb} {d_seq}, bf16 {d16} vs "
                          f"{ctl}, open {open_share}")
        del out

        # (b) bf16 steps with augmentation.
        state = pp_state(v, torch.bfloat16, mesh, PP_LR)
        step = pp_step(torch.bfloat16, mesh, PP_TRAIN_M, augment=True)
        b = dp_batch(B_PP_TRAIN, 7)
        reset_counts()
        seen = []
        for _ in range(PP_STEPS):
            state, m = step(state, b)
            seen.append(m["loss"].item())
        counts = read_counts(
            f"pipeline {PP_STEPS} bf16 steps B={B_PP_TRAIN} M={PP_TRAIN_M}",
            {"render_heatmaps_batch": PP_STEPS,
             "resample_last_axis": 2 * PP_STEPS})
        add_launches(report, counts)
        readings["step_ms"] = cuda_ms(lambda: step(state, b), iters=2,
                                      warmup=0)
        del state
        seq_state = steps_lib.TrainState.create(
            load_variables(pp_model(torch.bfloat16), v),
            lambda mm: steps_lib.make_optimizer(mm, PP_LR), device="cuda")
        seq_step = steps_lib.make_train_step(losses_lib.weighted_mse,
                                             train_config(DP_ROOT),
                                             augment=True)
        readings["seq_step_ms"] = cuda_ms(lambda: seq_step(seq_state, b),
                                          iters=2, warmup=1)
        del seq_state
        log(f"pipeline bf16 losses {seen}")
        if not np.isfinite(seen).all() or seen[-1] >= seen[0]:
            failed.append(f"bf16 steps: losses {seen}")

        # (c) one f32 step at M=1 against the sequential step.
        state = pp_state(init_variables(4, C, seed=seed), torch.float32,
                         mesh, 2.5e-4)
        step = pp_step(torch.float32, mesh, 1, augment=False)
        reset_counts()
        state, m = step(state, control_batch("one", B_DP_F32, seed))
        add_launches(report, read_counts("pipeline f32 step M=1",
                                         {"render_heatmaps_batch": 1}))
        loss, grads, stats = ref["flax", "one"]
        merged = state.variables()
        lerr = abs(m["loss"].item() - loss) / abs(loss)
        gap = rel_l2(flatten_sorted(pp_grads(state)), grads)
        serr = stats_err(pp_stats(merged), stats)
        controls = {n: (rel_l2(ref["flax", n][1], grads),
                        stats_err(ref["flax", n][2], stats))
                    for n in DP_CONTROLS[1:]}
        noise = [max(c[i] for c in controls.values()) for i in (0, 1)]
        log(f"pipeline f32 M=1 step vs the sequential step (B="
            f"{B_DP_F32}): loss rel {lerr:.2e}, grads L2 rel {gap:.3e}, "
            f"running stats {serr:.3e}; controls (grads, stats): "
            + ", ".join(f"{n} {g:.3e} {s:.3e}"
                        for n, (g, s) in controls.items()))
        if lerr > TOL_FUSED_LOSS or gap > ULP_FACTOR * noise[0] \
                or serr > ULP_FACTOR * noise[1]:
            failed.append(f"M=1 step: loss {lerr}, grads {gap}, stats "
                          f"{serr}, controls {controls}")

        # (d) merge -> CheckpointManager -> StackedHourglass.
        shutil.rmtree(PP_ROOT, ignore_errors=True)
        mgr = CheckpointManager(PP_ROOT)
        opt = lambda mm: steps_lib.make_optimizer(mm, 2.5e-4)
        saved = steps_lib.TrainState.create(
            load_variables(StackedHourglass(num_stacks=4, num_channels=C),
                           merged), opt, device="cuda")
        mgr.save(1, saved, {"epoch": 1})
        fresh = steps_lib.TrainState.create(
            StackedHourglass(num_stacks=4, num_channels=C), opt,
            device="cuda")
        mgr.restore(fresh)
        want = to_state_dict(merged)
        got = {k: t for k, t in fresh.model.state_dict().items()
               if not k.endswith("num_batches_tracked")}
        equal = got.keys() == want.keys() and all(
            torch.equal(got[k].cpu(), want[k]) for k in want)
        log(f"pipeline round trip: {len(want)} tensors merged, saved and "
            f"restored into StackedHourglass, all equal: {equal}")
        if not equal:
            failed.append("round trip through CheckpointManager")
        del state, saved, fresh

        # (e) the one-process reference of the ("data", "pipe") ranks.
        mesh2 = pp_mesh(PP_DP_STAGES)
        dp_ref = {}
        for name in DP_CONTROLS:
            state = pp_state(init_variables(4, C, seed=seed), torch.float32,
                             mesh2, 2.5e-4)
            state, m = pp_step(torch.float32, mesh2, DP_WORLD, False)(
                state, control_batch(name, B_PP_DP, seed))
            dp_ref[name] = (m["loss"].item(),
                            flatten_sorted(pp_grads(state)),
                            pp_stats(state.variables()))
            del state
        ghost = pp_ghost_stats(init_variables(4, C, seed=seed),
                               dp_batch(B_PP_DP, seed)["image"], DP_WORLD)
        ghost_ulp = pp_ghost_stats(init_variables(4, C, seed=seed),
                                   control_batch("ulp", B_PP_DP,
                                                 seed)["image"], DP_WORLD)
    finally:
        ranks = wait_children(children)
        shutil.rmtree(PP_ROOT, ignore_errors=True)
    loss, grads, _ = dp_ref["one"]
    got = ranks[0]
    rel_loss = lambda v: abs(v - loss) / abs(loss)
    lerr = max(rel_loss(r["loss"]) for r in ranks)
    gap = rel_l2(got["grads"], grads)
    controls = {n: (rel_loss(dp_ref[n][0]), rel_l2(dp_ref[n][1], grads))
                for n in DP_CONTROLS[1:]}
    noise = [max(c[i] for c in controls.values()) for i in (0, 1)]
    serr = stats_err(got["stats"], ghost)
    sctl = stats_err(ghost_ulp, ghost)
    log(f"pipeline ('data', 'pipe') {ranks[0]['shape']}: 2 ranks x "
        f"{B_PP_DP // DP_WORLD} rows vs one process at M={DP_WORLD}: loss "
        f"rel {lerr:.2e}, grads L2 rel {gap:.3e}; controls (loss, grads): "
        + ", ".join(f"{n} {lc:.2e} {g:.3e}"
                    for n, (lc, g) in controls.items())
        + f"; running stats vs the direct reference {serr:.3e} (one-ulp "
        f"control {sctl:.3e}); same bits on both ranks: "
        f"{ranks[0]['digest'] == ranks[1]['digest']}")
    if lerr > max(TOL_FUSED_LOSS, ULP_FACTOR * noise[0]) \
            or gap > ULP_FACTOR * noise[1] or serr > ULP_FACTOR * sctl \
            or ranks[0]["digest"] != ranks[1]["digest"]:
        failed.append(f"data x pipe: loss {lerr}, grads {gap} vs "
                      f"{controls}, stats {serr} vs {sctl}")
    for rank, r in enumerate(ranks):
        want = {k: 0 for k in r["counts"]}
        want["render_heatmaps_batch"] = 1
        if r["counts"] != want:
            failed.append(f"rank {rank} launches {r['counts']}")
        add_launches(report, r["counts"])
    log(f"pipeline smoke readings ({card}): bf16 forward B={B_PP_FWD} "
        f"M={PP_FWD_M} over {PP_STAGES} stages on one card "
        f"{readings['forward_ms']:.2f} ms, sequential "
        f"{readings['seq_forward_ms']:.2f} ms; bf16 train step B="
        f"{B_PP_TRAIN} M={PP_TRAIN_M} {readings['step_ms']:.2f} ms, "
        f"sequential {readings['seq_step_ms']:.2f} ms")
    if failed:
        raise AssertionError("pipeline: " + "; ".join(failed))


def phase_s2d_remat(report, model, card):
    """The model's dials on S4/256: (a) `front_s2d` on the kernel path at
    B=128 bf16 (#1-#4 with MAIN_FLAGS, with `fuse_front` also #6; exact
    launches), then at B=8 on an unsaturated copy (`unsaturated_copy`):
    the kernel path with front_s2d against the plain model
    (scaled_readings' bounds), and the plain model's s2d front against its
    7x7 front: the front's output within TOL_S2D_FRONT (f32, relative L2),
    the heatmaps within TOL_F32 at f32 and, at bf16, within
    S4_BF16_FACTOR times the 7x7 bf16 forward's distance from f32; (b)
    `remat` True and
    "conv_out": one f32 train step at B=16 against remat=False: loss
    within TOL_REMAT_LOSS, grads within the one-ulp control of the step
    without remat (cuDNN may pick other algorithms in the recompute), the
    running statistics bit for bit; (c) `mobile_depthwise` "dense" and
    "taps" against "conv" on the plain mobile model at f32 (B=8), within
    phase_slice's tolerances. Prints each remat mode's peak memory and
    step ms and the s2d front's ms against the 7x7 front's (readings).
    The Keras weight import needs TensorFlow, which is logged."""
    import torch

    from single_person_pose_estimation_tpu_torch.models import (
        fused_inference as fi,
    )
    from single_person_pose_estimation_tpu_torch.training import (
        steps as steps_lib,
    )
    from single_person_pose_estimation_tpu_torch.utils.weight_convert import (
        init_variables,
        load_variables,
    )

    failed = []
    rng = np.random.default_rng(40)
    x = torch.from_numpy(rng.uniform(0, 1, (B_S2D, 256, 256, 3))
                         .astype(np.float32)).cuda()
    fp = fi.prepare_fused(model)
    xin = model.input_nchw(x)
    with torch.inference_mode():
        front_ms = cuda_ms(lambda: model.front(xin), iters=5)
        fwd_ms = cuda_ms(lambda: fi.fused_apply(fp, x, **MAIN_FLAGS),
                         iters=3)
        for label, flags in (("kernels", {}),
                             ("kernels, fuse_front", DIALS["front"])):
            reset_counts()
            hm = fi.fused_apply(fp, x, front_s2d=True, **MAIN_FLAGS,
                                **flags)[-1]
            add_launches(report, read_counts(
                f"s2d_remat front_s2d on the {label} path",
                dial_want(flags)))
            if hm.shape != (B_S2D, 64, 64, K) or not torch.isfinite(
                    hm).all():
                failed.append(f"front_s2d on the {label} path: bad heatmaps")
        s2d_fwd_ms = cuda_ms(lambda: fi.fused_apply(
            fp, x, front_s2d=True, **MAIN_FLAGS), iters=3)
        model.front_s2d = True
        try:
            s2d_ms = cuda_ms(lambda: model.front(xin), iters=5)
        finally:
            model.front_s2d = False
    del fp, hm
    # Accuracy on an unsaturated copy: the kernel path with front_s2d (and
    # fuse_front) against the plain model (scaled_readings), and the plain
    # model's s2d front against its 7x7 front.
    x8 = x[:8]
    for label, flags in (("front_s2d", {}),
                         ("front_s2d, fuse_front", DIALS["front"])):
        scaled_readings(model, x8, f"s2d_remat {label}",
                        {**MAIN_FLAGS, **flags, "front_s2d": True})
    peaked = unsaturated_copy(model, x8)[0]
    with torch.inference_mode():
        ref32 = peaked(x8)[-1]
        f7 = peaked.front(peaked.input_nchw(x8))
        peaked.front_s2d = True
        s2d32 = peaked(x8)[-1]
        fs = peaked.front(peaked.input_nchw(x8))
        peaked.compute_dtype = torch.bfloat16
        s2d16 = peaked(x8)[-1]
        peaked.front_s2d = False
        ctl16 = peaked(x8)[-1]
    del peaked
    dist = lambda a, b: ((a - b).abs().max().item(),
                         (a - b).abs().mean().item())
    got32, got16, ctl = (dist(s2d32, ref32), dist(s2d16, ref32),
                         dist(ctl16, ref32))
    front_rel = rel_l2(fs, f7)
    log(f"s2d_remat plain model, scaled copy, B=8: the s2d front's output "
        f"L2 rel {front_rel:.3e} from the 7x7 front's (f32); heatmaps "
        f"against the 7x7 f32 forward: s2d f32 max|d| {got32[0]:.3e} "
        f"mean|d| {got32[1]:.3e}, s2d bf16 {got16[0]:.3e} {got16[1]:.3e} "
        f"(7x7 bf16 control {ctl[0]:.3e} {ctl[1]:.3e})")
    if front_rel > TOL_S2D_FRONT or got32[0] > TOL_F32 \
            or got32[1] > TOL_S4_F32_MEAN \
            or any(g > S4_BF16_FACTOR * c for g, c in zip(got16, ctl)):
        failed.append(f"plain front_s2d: front {front_rel}, f32 {got32}, "
                      f"bf16 {got16} vs {ctl}")

    # (b) remat.
    v = init_variables(4, C, seed=DP_SEED)
    step = dp_step("flax", None, augment=False)
    runs, readings = {}, {}
    for mode, batch in [(m, "one") for m in REMAT_MODES] + [(False, "ulp")]:
        state = steps_lib.TrainState.create(
            load_variables(pp_model(torch.float32, remat=mode), v),
            lambda mm: steps_lib.make_optimizer(mm, 2.5e-4), device="cuda")
        b = control_batch(batch, B_DP_F32, DP_SEED)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state, m = step(state, b)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        runs[mode, batch] = (m["loss"].item(), flat_grads(state),
                             running_stats(state))
        if batch == "one":
            readings[mode] = (peak, cuda_ms(lambda: step(state, b), iters=2,
                                            warmup=0))
        del state
    loss0, g0, s0 = runs[False, "one"]
    ulp = rel_l2(runs[False, "ulp"][1], g0)
    for mode in REMAT_MODES[1:]:
        loss, g, s = runs[mode, "one"]
        lerr = abs(loss - loss0) / abs(loss0)
        gap = rel_l2(g, g0)
        same = all(torch.equal(s[n], s0[n]) for n in s0)
        log(f"s2d_remat remat={mode!r} f32 B={B_DP_F32}: loss rel "
            f"{lerr:.2e}, grads L2 rel {gap:.3e} (one-ulp control "
            f"{ulp:.3e}), running stats bit-equal: {same}")
        if lerr > TOL_REMAT_LOSS or gap > ulp or not same:
            failed.append(f"remat {mode}: loss {lerr}, grads {gap} vs "
                          f"{ulp}, stats equal {same}")
    log(f"s2d_remat readings ({card}): f32 step B={B_DP_F32} peak memory "
        "and ms: " + ", ".join(f"remat={mode!r} {p:.2f} GiB {ms:.1f} ms"
                                for mode, (p, ms) in readings.items())
        + f"; bf16 B={B_S2D} front module {front_ms:.2f} ms (7x7) vs "
        f"{s2d_ms:.2f} ms (s2d), kernel-path forward {fwd_ms:.2f} vs "
        f"{s2d_fwd_ms:.2f} ms")

    # (c) the mobile depthwise lowerings.
    vm = init_variables(4, C, seed=0, mobile=True)
    xm = x[:8]
    outs = {}
    with torch.inference_mode():
        for impl in ("conv", "dense", "taps"):
            mm = load_variables(pp_model(torch.float32, mobile=True,
                                         mobile_depthwise=impl), vm).cuda()
            outs[impl] = mm(xm)[-1]
            del mm
    for impl in ("dense", "taps"):
        d = (outs[impl] - outs["conv"]).abs()
        log(f"s2d_remat mobile_depthwise={impl!r} vs 'conv' f32 B=8: "
            f"max|d| {d.max().item():.3e}, mean|d| {d.mean().item():.3e}")
        if not torch.isfinite(outs[impl]).all() \
                or d.max().item() > TOL_S4_F32_MAX \
                or d.mean().item() > TOL_S4_F32_MEAN:
            failed.append(f"mobile_depthwise {impl}: {d.max().item()}")
    if importlib.util.find_spec("tensorflow") is None:
        log("s2d_remat: the Keras weight import (utils/weight_import.py) "
            "needs TensorFlow, which this machine lacks; it is covered by "
            "the CPU tests only (tests/test_torch_weight_import.py)")
    else:
        log("s2d_remat: TensorFlow is installed here, but the weight import "
            "is covered by the CPU tests (tests/test_torch_weight_import.py)")
    if failed:
        raise AssertionError("s2d_remat: " + "; ".join(failed))


def timed(name, fn, *args, **kwargs):
    """Run one phase and log its wall time."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "single_person_pose_estimation_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    if sys.argv[1:2] == ["--dp-child"]:
        return dp_child(*sys.argv[2:4])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    card = card_line()
    log(card)
    report = {}
    timed("build", phase_build)
    timed("kernels", phase_kernels, report, main_kernel_cases, twice=True)
    timed("golden", phase_golden)
    model = build_s4().to("cuda")
    timed("decode_kernel", phase_decode_kernel, report, model)
    timed("slice", phase_slice, report, model)
    timed("times", phase_times, report, model, card)
    timed("trace", phase_trace, report, model, card)
    timed("dial_kernels", phase_kernels, report, dial_kernel_cases, seed=30,
          twice=True)
    timed("dial_slice", phase_dial_slice, report, model)
    timed("dial_times", phase_dial_times, report, model, card)
    timed("spatial", phase_spatial, report, model, card)
    timed("s2d_remat", phase_s2d_remat, report, model, card)
    del model
    torch.cuda.empty_cache()
    timed("mobile_kernels", phase_kernels, report, mobile_main_cases,
          seed=20, twice=True)
    timed("mobile_golden", phase_mobile_golden)
    model = build_s4_mobile().to("cuda")
    timed("mobile_slice", phase_mobile_slice, report, model)
    timed("mobile_times", phase_mobile_times, report, model, card)
    del model
    torch.cuda.empty_cache()
    try:
        cfg, val = timed("eval", phase_eval, report)
        torch.cuda.empty_cache()
        timed("eval_times", phase_eval_times, report, cfg, card)
        torch.cuda.empty_cache()
        timed("mobile_eval", phase_mobile_eval, report, cfg, val, card)
        torch.cuda.empty_cache()
        state = timed("dp_eval", phase_dp_eval, report, cfg, val)
        timed("dp_serve", phase_dp_serve, report, cfg, state)
        del state
    finally:
        shutil.rmtree(EVAL_ROOT, ignore_errors=True)
    torch.cuda.empty_cache()
    timed("train_kernels", phase_train_kernels, report)
    timed("train", phase_train, report)
    timed("train_times", phase_train_times, report, card)
    torch.cuda.empty_cache()
    timed("fused_train_kernels", phase_fused_train_kernels, report)
    timed("fused_train", phase_fused_train, report)
    torch.cuda.empty_cache()
    timed("fused_train_times", phase_fused_train_times, report, card)
    torch.cuda.empty_cache()
    try:
        ref = timed("dp_train", phase_dp_train, report)
        torch.cuda.empty_cache()
        timed("tp_train", phase_tp_train, report, ref)
        torch.cuda.empty_cache()
        timed("pipeline", phase_pipeline, report, ref, card)
        del ref
        torch.cuda.empty_cache()
        args, cfg, val = timed("cli_train", phase_cli_train, report)
        timed("dp_nccl", phase_dp_nccl, report, args)
        torch.cuda.empty_cache()
        timed("cli_eval", phase_cli_eval, report, args, cfg, val)
        timed("cli_serve", phase_cli_serve, report, args, cfg, card)
        timed("cli_export", phase_cli_export, report, args, cfg)
        timed("demo", phase_demo, report, cfg)
        timed("profiling", phase_profiling, report, cfg, card)
    finally:
        shutil.rmtree(CLI_ROOT, ignore_errors=True)
        shutil.rmtree(DP_ROOT, ignore_errors=True)
    for name, (bms, by) in inference_bounds().items():
        report[name].update(bound_ms=bms, bound_by=by)
        report[name].setdefault("library_ms", None)
    log(f"all phases: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"forward_img_per_s_b128_bf16": report.pop("_forward"),
                    "dial_forward_img_per_s_b128_bf16":
                        report.pop("_dial_forward"),
                    "eval_img_per_s_b128_bf16": report.pop("_eval"),
                    "mobile_forward_img_per_s_b128_bf16":
                        report.pop("_mobile_forward"),
                    "mobile_eval_img_per_s_b128_bf16":
                        report.pop("_mobile_eval"),
                    "fused_train_step_ms_b64_bf16":
                        report.pop("_fused_step_ms"),
                    "default_train_step_ms_b64_bf16":
                        report.pop("_default_step_ms"),
                    "http_served_p50_ms": report.pop("_http_p50_ms"),
                    "http_served_p99_ms": report.pop("_http_p99_ms"),
                    "spatial_and_plain_forward_ms_1024_bf16":
                        report.pop("_spatial_ms"),
                    "card": card}))
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], **report[name]} for name in REPLACES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
