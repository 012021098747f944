"""The port's `cli.py` on the CPU, against the JAX package's where both
have the same function: `_apply_overrides` gives the same `Config` and
the same errors; the parser has the same subcommands and flags, plus
`--device`. End to end on `--device cpu` from synthetic records:
gen-records -> train -> resume -> eval (with `--report`) -> serve
`--images` -> export; the eval predictions equal the port's `predict_ds`
called directly on the same checkpoint, and the served keypoints equal
the JAX package's `PoseServer` on the same weights (x and y equal,
confidences within 1e-4, on a peaked checkpoint whose top-two gap the
test asserts). `--device cuda` without CUDA raises; `--tflite` and
`bench` exit non-zero with their messages."""

import argparse
import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import torch

from single_person_pose_estimation_tpu import cli as jcli
from single_person_pose_estimation_tpu.configs.default_config import (
    Config as JConfig,
)
from single_person_pose_estimation_tpu.models.hourglass import (
    StackedHourglass as JHourglass,
)
from single_person_pose_estimation_tpu.serving import PoseServer as JServer
from single_person_pose_estimation_tpu_torch import Config, cli
from single_person_pose_estimation_tpu_torch.data import pipeline
from single_person_pose_estimation_tpu_torch.data.images import (
    read_image,
    resize_bilinear,
)
from single_person_pose_estimation_tpu_torch.evaluation.predict import (
    predict_ds,
)
from single_person_pose_estimation_tpu_torch.training import steps
from single_person_pose_estimation_tpu_torch.training.checkpoint import (
    CheckpointManager,
)
from single_person_pose_estimation_tpu_torch.utils.export import (
    load_inference_artifact,
)
from single_person_pose_estimation_tpu_torch.utils.model_utils import (
    list_checkpoints,
    load_model_from_checkpoint,
)
from torch_port_fixtures import make_spot_coco, peaked_variables, torch_model

SMALL = ["image_height=64", "image_width=64", "label_height=16",
         "label_width=16", "hg_num_stacks=1", "hg_num_channels=16",
         "batch_size=2", "host_workers=1", "min_num_keypoints=1",
         "num_examples_per_record=3", "compute_dtype=float32"]
TOL_CONF = 1e-4
MARGIN = 1e-4


def _sets(root, extra=()):
    out = []
    for item in [*SMALL, f"dataset_dir={root}/dataset",
                 f"temporary_dir={root}/run", *extra]:
        out += ["--set", item]
    return out + ["--device", "cpu"]


# ---------------------------------------------------------------------------
# Overrides and the parser, against the JAX CLI
# ---------------------------------------------------------------------------

OVERRIDES = [
    [],
    ["hg_num_stacks=4", "learning_rate=0.001", "mobile=true",
     "dataset_dir=/tmp/x", "async_checkpointing=false"],
    ["compute_dtype=float32", "legacy_decode=0", "bbox_scale=1.5",
     "hm_activation=linear", "front_s2d=auto", "mobile=yes"],
]


@pytest.mark.parametrize("overrides", OVERRIDES)
def test_apply_overrides_gives_the_same_config(overrides):
    got = cli._apply_overrides(Config(), overrides)
    want = jcli._apply_overrides(JConfig(), overrides)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.to_json() == want.to_json()


@pytest.mark.parametrize("overrides,exc,match", [
    (["bogus=1"], SystemExit, "unknown config field: bogus"),
    (["hg_num_stacks=four"], ValueError, "invalid literal"),
    (["front_s2d=yes"], ValueError, "front_s2d"),
    (["compute_dtype=bf16"], ValueError, "compute_dtype"),
])
def test_apply_overrides_gives_the_same_errors(overrides, exc, match):
    errors = []
    for mod, cfg in ((cli, Config()), (jcli, JConfig())):
        with pytest.raises(exc, match=match) as info:
            mod._apply_overrides(cfg, overrides)
        errors.append(str(info.value))
    assert errors[0] == errors[1]


class _Parsed(Exception):
    pass


def _shape(parser):
    """{subcommand or "": {option: (default, choices, nargs)}}."""
    def opts(p):
        return {s: (a.default, a.choices, a.nargs)
                for a in p._actions if not isinstance(
                    a, (argparse._SubParsersAction, argparse._HelpAction))
                for s in a.option_strings}

    out = {"": opts(parser)}
    for a in parser._actions:
        if isinstance(a, argparse._SubParsersAction):
            for name, sp in a.choices.items():
                out[name] = opts(sp)
    return out


def test_parser_has_the_jax_subcommands_and_flags_plus_device(monkeypatch):
    captured = []

    def parse_args(self, args=None, namespace=None):
        captured.append(self)
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse_args)
    with pytest.raises(_Parsed):
        jcli.main([])
    monkeypatch.undo()
    want = _shape(captured[0])
    got = _shape(cli.build_parser())
    assert got[""].pop("--device") == ("cuda", None, None)
    assert got == want
    assert sorted(got) == ["", "bench", "eval", "export", "gen-records",
                           "resume", "serve", "train"]


def test_build_model_follows_the_config():
    m = cli._build_model(Config().replace(hg_num_stacks=2,
                                          hg_num_channels=32,
                                          hm_activation="relu"))
    assert (m.num_stacks, m.num_channels, m.predict_activation) == (
        2, 32, "relu")
    assert m.compute_dtype == torch.bfloat16
    assert cli._build_model(Config().replace(
        compute_dtype="float32", front_s2d="auto")).compute_dtype == \
        torch.float32
    assert not cli._build_model(Config().replace(front_s2d="auto")).front_s2d
    assert cli._build_model(Config().replace(front_s2d="on")).front_s2d
    with pytest.raises(ValueError, match="even image dimensions"):
        cli._build_model(Config().replace(front_s2d="on", image_height=255))


def test_cuda_tflite_and_bench_refuse(tmp_path):
    if not torch.cuda.is_available():
        args = [a for a in _sets(tmp_path) if a not in ("--device", "cpu")]
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(args + ["train", "--epochs", "1"])
    with pytest.raises(SystemExit, match="TFLite") as exc:
        cli.main(_sets(tmp_path) + ["export", "--tflite", "m.tflite"])
    assert "no installed converter" in str(exc.value)
    with pytest.raises(SystemExit, match="nothing to do"):
        cli.main(_sets(tmp_path) + ["export", "--latest"])
    with pytest.raises(SystemExit, match="no bench yet") as exc:
        cli.main(["bench"])
    assert exc.value.code not in (0, None)
    with pytest.raises(SystemExit, match="--images GLOB or --http"):
        cli.main(_sets(tmp_path) + ["serve"])


# ---------------------------------------------------------------------------
# End to end on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """gen-records, train one epoch, resume one more, eval with a report."""
    root = tmp_path_factory.mktemp("cli")
    make_spot_coco(str(root / "dataset"), "train2017", n_images=4, seed=12)
    ann = make_spot_coco(str(root / "dataset"), "val2017", n_images=4)
    sets = _sets(root)
    cli.main(sets + ["gen-records"])
    cli.main(sets + ["train", "--epochs", "1", "--loss", "weighted_mse"])
    cli.main(sets + ["resume", "--epochs", "1", "--loss", "weighted_mse"])
    preds = str(root / "preds.json")
    cli.main(sets + ["eval", "--latest", "--gt", ann, "--save-path", preds,
                     "--report", str(root / "report")])
    return root, ann, preds


def test_train_and_resume_write_the_trainer_checkpoints(run):
    root, _, _ = run
    cfg = cli._apply_overrides(Config(), _sets(root)[1:-2:2])
    assert list_checkpoints(cfg.checkpoints_path) == ([1, 2], True)
    meta = CheckpointManager(cfg.checkpoints_path).read_meta()
    assert meta["epoch"] == 2 and meta["loss_str"] == "weighted_mse"
    assert len(glob.glob(os.path.join(cfg.logs_path, "log_E*.csv"))) == 2


def test_eval_equals_predict_ds_and_writes_the_report(run):
    root, _, preds = run
    cfg = cli._apply_overrides(Config(), _sets(root)[1:-2:2])
    state, _ = load_model_from_checkpoint(cli._build_model(cfg),
                                          cfg.checkpoints_path, device="cpu")
    with pipeline.DatasetBuilder(cfg) as builder:
        want = predict_ds(state.model, state, builder.get_ds_prediction(),
                          conf_threshold=0.1, save_path=None, device="cpu")
    got = json.load(open(preds))
    assert len(got) == 4 and got == want
    report = open(root / "report.md").read()
    assert "COCO OKS" in report and "PCK@0.05" in report
    assert os.path.getsize(root / "report_pck.png") > 0
    assert os.path.getsize(root / "report_oks.png") > 0


def test_export_writes_the_checkpoint_weights(run):
    root, _, _ = run
    cfg = cli._apply_overrides(Config(), _sets(root)[1:-2:2])
    cli.main(_sets(root) + ["export", "--latest", "--artifact",
                            str(root / "artifact")])
    state, _ = load_model_from_checkpoint(cli._build_model(cfg),
                                          cfg.checkpoints_path, device="cpu")
    _, state_dict, _ = load_inference_artifact(str(root / "artifact"),
                                               device="cpu")
    want = state.model.state_dict()
    assert state_dict.keys() == want.keys()
    assert all(torch.equal(state_dict[k], want[k]) for k in want)


def _to_flax(model):
    """The standard model's state_dict -> flax variables (the inverse of
    utils/weight_convert.to_state_dict)."""
    params, stats = {}, {}
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    for name, mod in model.named_children():
        if isinstance(mod, torch.nn.Conv2d):
            params[name] = {"kernel": sd[f"{name}.weight"].transpose(
                2, 3, 1, 0), "bias": sd[f"{name}.bias"]}
        else:
            params[name] = {"scale": sd[f"{name}.weight"],
                            "bias": sd[f"{name}.bias"]}
            stats[name] = {"mean": sd[f"{name}.running_mean"],
                           "var": sd[f"{name}.running_var"]}
    return {"params": params, "batch_stats": stats}


def test_serve_images_equals_the_jax_pose_server(run):
    """A peaked checkpoint (peaked_variables) served over the val images
    by `cli serve --images` and by JAX's PoseServer on the same weights
    and the same inputs."""
    root, _, _ = run
    sets = _sets(root / "peaked")
    cfg = cli._apply_overrides(Config(), sets[1:-2:2])
    model = torch_model(peaked_variables(), 1, 16)
    state = steps.TrainState.create(
        model, lambda m: steps.make_optimizer(m, 1e-3), device="cpu")
    CheckpointManager(cfg.checkpoints_path).save(
        1, state, {"epoch": 1, "lr_schedule": None, "warmup_steps": 0})
    pattern = str(root / "dataset" / "images" / "val2017" / "*.jpg")
    out = str(root / "keypoints.json")
    cli.main(sets + ["serve", "--images", pattern, "--save-path", out,
                     "--latest", "--buckets", "1", "2",
                     "--transfer-dtype", "float32"])
    got = json.load(open(out))
    paths = sorted(glob.glob(pattern))
    assert sorted(got) == paths
    x = np.stack([resize_bilinear(read_image(p).astype(np.float32) / 255.0,
                                  (64, 64)) for p in paths])
    with torch.no_grad():
        hms = model(torch.from_numpy(x))[-1].numpy()
    top2 = np.sort(hms.reshape(len(x), -1, 17), axis=1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() > MARGIN
    flax = _to_flax(model)
    with JServer(JHourglass(num_stacks=1, num_channels=16), flax["params"],
                 flax["batch_stats"], buckets=(4,), use_fused=False,
                 transfer_dtype="float32") as server:
        want = server.predict(x)
    g = np.asarray([got[p] for p in paths])
    np.testing.assert_array_equal(g[..., :2], want[..., :2])
    assert np.abs(g[..., 2] - want[..., 2]).max() <= TOL_CONF


def test_console_script_names_the_port_cli():
    import tomllib

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    assert scripts["spe-torch"] == (
        "single_person_pose_estimation_tpu_torch.cli:main")
    assert scripts["spe-tpu"] == "single_person_pose_estimation_tpu.cli:main"
