"""Command-line entry points of the PyTorch port.

The counterpart of the JAX package's `cli.py`, with the same subcommands,
flags and `--set FIELD=VALUE` overrides:

    python -m single_person_pose_estimation_tpu_torch.cli gen-records [...]
    python -m single_person_pose_estimation_tpu_torch.cli train [...]
    python -m single_person_pose_estimation_tpu_torch.cli resume [...]
    python -m single_person_pose_estimation_tpu_torch.cli eval [...]
    python -m single_person_pose_estimation_tpu_torch.cli export [...]
    python -m single_person_pose_estimation_tpu_torch.cli serve [...]
    python -m single_person_pose_estimation_tpu_torch.cli bench

Each subcommand calls the port module that does the work: `gen-records`
`data/coco.gen_trainval_records`; `train` and `resume` the `Trainer`;
`eval` `load_model_from_checkpoint`, `recalibrate_batch_stats`,
`predict_ds`, `eval_oks`, `eval_pck` and `utils/reporting`; `serve`
`PoseServer` (and `HttpPoseService` for `--http PORT`); `export`
`utils/export`.

One argument is the port's own: `--device` (default "cuda"). Given "cuda"
on a host without CUDA the command raises; it never carries on on the
CPU. The tests pass `--device cpu`. `bench` exits non-zero: the port has
no bench yet.

`--data-parallel` (on by default): `train` and `resume` launched by
`torchrun` (one process per card) join the process group and train data
parallel, each process on its own card and its own record shards,
`config.batch_size` rows a process (parallel/). With one visible card and
no cluster environment they train on that card; several visible cards
without `torchrun` raise. `eval` splits its batches over every visible
card of one process.
"""

from __future__ import annotations

import argparse

from single_person_pose_estimation_tpu_torch.configs.default_config import (
    Config,
)

BENCH_MISSING = (
    "bench: the PyTorch port has no bench yet (ROADMAP Queue 1, the port "
    "bench); the JAX package's `bench` runs bench.py in JAX")


def _apply_overrides(cfg: Config, overrides) -> Config:
    for item in overrides or []:
        key, _, value = item.partition("=")
        if not hasattr(cfg, key):
            raise SystemExit(f"unknown config field: {key}")
        current = getattr(cfg, key)
        if isinstance(current, bool):
            parsed = value.lower() in ("1", "true", "yes")
        elif isinstance(current, int):
            parsed = int(value)
        elif isinstance(current, float):
            parsed = float(value)
        else:
            parsed = value
        cfg = cfg.replace(**{key: parsed})
    return cfg


def _device(args):
    from single_person_pose_estimation_tpu_torch.training.steps import (
        resolve_device,
    )

    return resolve_device(args.device)


def _build_model(cfg: Config):
    """The port's StackedHourglass for `cfg`. front_s2d "on" builds the
    space-to-depth front; "auto" means off here, as the JAX package's
    "auto" turns it on only on a TPU."""
    from single_person_pose_estimation_tpu_torch.utils.export import (
        model_from_config,
    )

    if cfg.front_s2d not in ("auto", "on", "off"):
        raise ValueError(f"front_s2d must be auto/on/off: {cfg.front_s2d!r}")
    even = cfg.image_height % 2 == 0 and cfg.image_width % 2 == 0
    if cfg.front_s2d == "on" and not even:
        raise ValueError(
            "front_s2d needs even image dimensions (the 2x2 space-to-depth "
            f"blocking), got {cfg.image_height}x{cfg.image_width}")
    return model_from_config(cfg, front_s2d=cfg.front_s2d == "on")


def _train_mesh(args, device):
    """--data-parallel for train/resume: under torchrun's environment,
    join the process group (NCCL between cards, gloo with --device cpu)
    and return a mesh of one device per process; with no cluster
    environment and one visible card, None."""
    import torch

    from single_person_pose_estimation_tpu_torch.parallel import (
        distributed,
        mesh as mesh_lib,
    )

    if not args.data_parallel:
        return None
    cuda = device.type == "cuda"
    if distributed.initialize(backend="nccl" if cuda else "gloo"):
        world = torch.distributed.get_world_size()
        return mesh_lib.create_mesh(devices=None if cuda else [device] * world)
    if cuda and torch.cuda.device_count() > 1:
        raise SystemExit(
            f"--data-parallel over {torch.cuda.device_count()} visible cards "
            "runs one process per card: launch with torchrun "
            f"--nproc_per_node={torch.cuda.device_count()}, or make one "
            "card visible (CUDA_VISIBLE_DEVICES)")
    return None


def _eval_mesh(args, device):
    """--data-parallel for eval: a mesh over every visible card when
    there are several, else None."""
    import torch

    if args.data_parallel and device.type == "cuda" \
            and torch.cuda.device_count() > 1:
        from single_person_pose_estimation_tpu_torch.parallel import (
            mesh as mesh_lib,
        )
        return mesh_lib.create_mesh()
    return None


def cmd_gen_records(args, cfg: Config):
    from single_person_pose_estimation_tpu_torch.data import coco

    coco.gen_trainval_records(cfg, drop_min_num_kps=not args.keep_sparse)


def _make_trainer(args, cfg: Config):
    from single_person_pose_estimation_tpu_torch.data.pipeline import (
        DatasetBuilder,
    )
    from single_person_pose_estimation_tpu_torch.training.trainer import (
        Trainer,
    )

    device = _device(args)
    mesh = _train_mesh(args, device)
    model = _build_model(cfg)
    if mesh is None:
        builder = DatasetBuilder(cfg, ratio=args.ratio)
    else:
        builder = DatasetBuilder(cfg, ratio=args.ratio,
                                 process_index=mesh.data_index,
                                 process_count=mesh.data_size)
    return Trainer(model, builder, args.epochs, args.lr, args.loss, cfg,
                   mesh=mesh, augment=not args.no_augment,
                   bn_mode="frozen" if args.freeze_bn else "batch",
                   accum_steps=args.accum_steps,
                   lr_schedule=args.lr_schedule,
                   warmup_steps=args.warmup_steps,
                   ema_decay=args.ema_decay,
                   device=device if mesh is None else None)


def _run_trainer(args, cfg: Config, resume: bool):
    import torch.distributed as dist

    from single_person_pose_estimation_tpu_torch.parallel.distributed import (
        is_initialized,
    )

    joined_here = not is_initialized()
    trainer = _make_trainer(args, cfg)
    try:
        if resume:
            trainer.resume_training()
        else:
            trainer.train()
    finally:
        trainer.close()
        if joined_here and is_initialized():
            dist.destroy_process_group()


def cmd_train(args, cfg: Config):
    _run_trainer(args, cfg, resume=False)


def cmd_resume(args, cfg: Config):
    _run_trainer(args, cfg, resume=True)


def _load(args, cfg: Config, device):
    """The checkpoint's TrainState (the best, or the latest with
    --latest) on `device`; its model holds the weights."""
    from single_person_pose_estimation_tpu_torch.utils.model_utils import (
        load_model_from_checkpoint,
    )

    state, meta = load_model_from_checkpoint(
        _build_model(cfg), cfg.checkpoints_path, best=not args.latest,
        device=device)
    print(f"Loaded checkpoint meta: {meta}")
    return state


def _maybe_ema_params(state, args, what: str):
    """Swap the Polyak-averaged params in when --ema was passed.

    The meta-aware loader already rebuilt the EMA from the checkpoint's
    meta; get_ema_params raises clearly for checkpoints trained without
    --ema-decay."""
    if not getattr(args, "ema", False):
        return state
    import torch

    from single_person_pose_estimation_tpu_torch.training import steps

    ema = steps.get_ema_params(state.optimizer)
    with torch.no_grad():
        for name, p in state.model.named_parameters():
            p.copy_(ema[name])
    print(f"{what} the Polyak-averaged (EMA) params")
    return state


def cmd_eval(args, cfg: Config):
    from single_person_pose_estimation_tpu_torch.configs.default_config import (
        COCO_KEYPOINT_LABELS,
    )
    from single_person_pose_estimation_tpu_torch.data.pipeline import (
        DatasetBuilder,
    )
    from single_person_pose_estimation_tpu_torch.evaluation.oks import (
        eval_oks,
    )
    from single_person_pose_estimation_tpu_torch.evaluation.pck import (
        eval_pck,
    )
    from single_person_pose_estimation_tpu_torch.evaluation.predict import (
        predict_ds,
    )

    if args.report:
        # Fail before the (long) evaluation, not after it when the report
        # writer first imports matplotlib.
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            raise SystemExit("--report needs matplotlib")
    device = _device(args)
    mesh = _eval_mesh(args, device)
    state = _maybe_ema_params(_load(args, cfg, device), args, "Evaluating")
    builder = DatasetBuilder(cfg, ratio=args.ratio)
    try:
        if args.recalibrate_batches:
            # BN running stats (Keras momentum .99) take ~1e4 steps to
            # converge; after short trainings eval-mode outputs are
            # unusable without a recalibration pass over train batches.
            from single_person_pose_estimation_tpu_torch.training.steps import (
                recalibrate_batch_stats,
            )
            train_it, _ = builder.build_datasets()
            n = args.recalibrate_batches
            momentum = 0.0 if n == 1 else 1.0 - 1.0 / n
            state = recalibrate_batch_stats(
                state, (next(train_it) for _ in range(n)), momentum=momentum)
            print(f"Recalibrated BN stats over {n} train batches")
        preds = predict_ds(state.model, state, builder.get_ds_prediction(),
                           conf_threshold=args.conf_threshold,
                           legacy_decode=cfg.legacy_decode,
                           save_path=args.save_path,
                           flip_test=args.flip_test,
                           flip_pairs=cfg.flip_pairs, mesh=mesh,
                           device=device)
    finally:
        builder.close()
    print(f"{len(preds)} predictions -> {args.save_path}")
    stats = None
    if args.gt:
        stats = eval_oks(preds, args.gt)
        print("OKS stats:", [round(float(s), 3) for s in stats])
    pck = eval_pck(preds, COCO_KEYPOINT_LABELS,
                   pck_threshold=args.pck_threshold)
    if args.report:
        from single_person_pose_estimation_tpu_torch.utils.reporting import (
            save_eval_report,
        )
        paths = save_eval_report(args.report, pck, COCO_KEYPOINT_LABELS,
                                 oks_stats=stats,
                                 pck_threshold=args.pck_threshold)
        print("Report written:", ", ".join(paths))


def cmd_serve(args, cfg: Config):
    """Serve pose estimation: over HTTP (--http PORT: POST /predict with
    image bytes, GET /healthz, GET /stats; serving_http.HttpPoseService)
    or as a one-shot batch over a glob of images."""
    import glob as globlib
    import json
    import threading

    import numpy as np

    from single_person_pose_estimation_tpu_torch.serving import PoseServer

    if args.http is None and not args.images:
        raise SystemExit("pass --images GLOB or --http PORT")
    device = _device(args)
    state = _maybe_ema_params(_load(args, cfg, device), args, "Serving")
    server = PoseServer(state.model, device=device,
                        buckets=tuple(args.buckets),
                        transfer_dtype=args.transfer_dtype)
    server.warmup(image_shape=(cfg.image_height, cfg.image_width, 3))
    if args.http is not None:
        from single_person_pose_estimation_tpu_torch.serving_http import (
            HttpPoseService,
        )

        svc = HttpPoseService(
            server, input_size=(cfg.image_height, cfg.image_width))
        port = svc.start(host=args.host, port=args.http)
        print(f"Serving on http://{args.host}:{port} "
              "(POST /predict, GET /healthz, GET /stats); Ctrl-C to stop",
              flush=True)
        try:
            # Block until Ctrl-C (SIGINT raises KeyboardInterrupt here);
            # an Event wait, unlike signal.pause, also works off the main
            # thread.
            threading.Event().wait()
        except KeyboardInterrupt:
            pass
        finally:
            svc.close()
            server.close()
        return
    paths = sorted(globlib.glob(args.images))
    if not paths:
        raise SystemExit(f"no images match {args.images!r}")
    from single_person_pose_estimation_tpu_torch.data.images import (
        read_image,
        resize_bilinear,
    )

    futures = {}
    for path in paths:
        img = read_image(path).astype(np.float32) / 255.0
        img = resize_bilinear(img, (cfg.image_height, cfg.image_width))
        futures[path] = server.submit(img)
    records = {}
    for path, fut in futures.items():
        kps = np.asarray(fut.result())
        records[path] = kps.tolist()
    stats = server.stats()
    server.close()
    with open(args.save_path, "w") as f:
        json.dump(records, f)
    print(f"{len(records)} images -> {args.save_path}; "
          f"p50 {stats['latency_p50_ms']:.1f} ms, "
          f"avg batch {stats['avg_batch']:.1f}")


def cmd_export(args, cfg: Config):
    """Deployment export (save_model.ipynb parity): checkpoint -> an
    inference artifact (config.json + weights.pt) and/or a torch.export
    program (model.pt2 + config.json). TFLite is not available."""
    from single_person_pose_estimation_tpu_torch.utils import (
        export as export_lib,
    )

    if args.tflite:
        raise SystemExit(export_lib.TFLITE_UNAVAILABLE)
    if not (args.artifact or args.savedmodel):
        raise SystemExit(
            "nothing to do: pass --artifact and/or --savedmodel")
    device = _device(args)
    state = _maybe_ema_params(_load(args, cfg, device), args, "Exporting")
    wrote = []
    if args.artifact:
        export_lib.save_inference_artifact(cfg, state.model, args.artifact)
        wrote.append(args.artifact)
    if args.savedmodel:
        wrote.append(export_lib.export_savedmodel(
            cfg, state.model, args.savedmodel, batch_size=args.batch_size,
            device=device))
    print("Exported:", ", ".join(wrote))


def cmd_bench(args, cfg: Config):
    raise SystemExit(BENCH_MISSING)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="single_person_pose_estimation_tpu_torch")
    p.add_argument("--set", action="append", dest="overrides", default=[],
                   metavar="FIELD=VALUE", help="override a Config field")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; raises "
                        "without CUDA, never falls back to the CPU)")
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("gen-records", help="COCO json -> record shards ETL")
    g.add_argument("--keep-sparse", action="store_true",
                   help="keep people with < MIN_NUM_KEYPOINTS keypoints")
    g.set_defaults(fn=cmd_gen_records)

    for name, fn in (("train", cmd_train), ("resume", cmd_resume)):
        t = sub.add_parser(name)
        t.add_argument("--epochs", type=int, default=10)
        t.add_argument("--lr", type=float, default=1e-3)
        t.add_argument("--loss", default="iou",
                       choices=["mse", "weighted_mse", "iou",
                                "weighted_keypoint_mse"])
        t.add_argument("--ratio", type=float, default=1.0)
        t.add_argument("--data-parallel", action="store_true", default=True,
                       help="on by default: under torchrun, one process "
                            "per card, each on its own record shards; "
                            "with one visible card and no torchrun, that "
                            "card")
        t.add_argument("--no-augment", action="store_true",
                       help="disable on-device train augmentation")
        t.add_argument("--freeze-bn", action="store_true",
                       help="fine-tuning: normalize with frozen running "
                            "BN statistics (do not use from-scratch)")
        t.add_argument("--accum-steps", type=int, default=1,
                       help="gradient accumulation: N microbatches per "
                            "optimizer step (activation memory scales "
                            "with batch/N)")
        t.add_argument("--lr-schedule", default=None,
                       choices=["constant", "cosine"],
                       help="lr schedule (default: constant, reference "
                            "semantics)")
        t.add_argument("--warmup-steps", type=int, default=0,
                       help="linear lr warmup steps")
        t.add_argument("--ema-decay", type=float, default=None,
                       help="track a Polyak EMA of params in the "
                            "optimizer state (e.g. 0.999)")
        t.set_defaults(fn=fn)

    e = sub.add_parser("eval")
    e.add_argument("--gt", default=None,
                   help="COCO GT json for OKS (default: PCK only)")
    e.add_argument("--conf-threshold", type=float, default=0.1)
    e.add_argument("--pck-threshold", type=float, default=0.05)
    e.add_argument("--ratio", type=float, default=1.0)
    e.add_argument("--latest", action="store_true",
                   help="evaluate the latest instead of the best checkpoint")
    e.add_argument("--recalibrate-batches", type=int, default=0,
                   help="refresh BN running stats over N train batches "
                        "before predicting (needed after short trainings)")
    e.add_argument("--save-path", default="result.json")
    e.add_argument("--ema", action="store_true",
                   help="evaluate the Polyak-averaged params (checkpoint "
                        "must come from train --ema-decay)")
    e.add_argument("--flip-test", action="store_true",
                   help="test-time augmentation: average heatmaps with the "
                        "horizontally mirrored input (left/right channels "
                        "swapped back); ~2x forward cost per image")
    e.add_argument("--data-parallel", action="store_true", default=True,
                   help="on by default: split eval batches over every "
                        "visible card (a model replica per card)")
    e.add_argument("--report", default=None, metavar="PREFIX",
                   help="write PREFIX.md + PCK/OKS figures (the artifacts "
                        "the reference publishes as README screenshots)")
    e.set_defaults(fn=cmd_eval)

    x = sub.add_parser("export", help="checkpoint -> deployment artifacts")
    x.add_argument("--artifact", default=None, metavar="DIR",
                   help="write an inference artifact: DIR/config.json and "
                        "DIR/weights.pt (torch.save of the state_dict)")
    x.add_argument("--savedmodel", default=None, metavar="DIR",
                   help="write DIR/model.pt2, a torch.export program of "
                        "the plain last-stack forward, and "
                        "DIR/config.json")
    x.add_argument("--tflite", default=None, metavar="FILE",
                   help="not available in the PyTorch port (no installed "
                        "TFLite converter); exits with an error")
    x.add_argument("--batch-size", type=int, default=None,
                   help="static batch size; omit for a dynamic batch "
                        "dimension")
    x.add_argument("--quantize", default=None,
                   choices=["dynamic", "float16"],
                   help="TFLite quantization (TFLite is not available in "
                        "the PyTorch port)")
    x.add_argument("--latest", action="store_true",
                   help="export the latest instead of the best checkpoint")
    x.add_argument("--ema", action="store_true",
                   help="export the Polyak-averaged params (checkpoint "
                        "must come from train --ema-decay)")
    x.set_defaults(fn=cmd_export)

    b = sub.add_parser("bench", help="not available in the PyTorch port "
                                     "yet; exits with an error")
    b.set_defaults(fn=cmd_bench)

    sv = sub.add_parser("serve",
                        help="serve over HTTP or over an image glob")
    sv.add_argument("--images", default=None,
                    help="glob of image files for one-shot batch serving")
    sv.add_argument("--http", type=int, default=None, metavar="PORT",
                    help="serve over HTTP instead (0 = ephemeral port): "
                         "POST /predict, GET /healthz, GET /stats")
    sv.add_argument("--host", default="127.0.0.1",
                    help="HTTP bind address (default loopback)")
    sv.add_argument("--save-path", default="keypoints.json")
    sv.add_argument("--latest", action="store_true")
    sv.add_argument("--ema", action="store_true",
                    help="serve the Polyak-averaged params (checkpoint "
                         "must come from train --ema-decay)")
    sv.add_argument("--buckets", type=int, nargs="+", default=[1, 4, 16])
    sv.add_argument("--transfer-dtype", default="uint8",
                    choices=["uint8", "bfloat16", "float32"])
    sv.set_defaults(fn=cmd_serve)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = _apply_overrides(Config(), args.overrides)
    args.fn(args, cfg)


if __name__ == "__main__":
    main()
