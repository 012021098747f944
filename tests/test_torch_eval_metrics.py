"""The port's evaluation metrics against the JAX package's on the same
prediction lists and GT annotations: `eval_oks` (and `KeypointEval` on
COCO-format detections) and `eval_pck`, exactly. Then
`load_model_from_checkpoint` and `list_checkpoints` on a checkpoint the
port's `Trainer` wrote, with an lr schedule and an EMA: the restored
params, BN statistics, Adam moments, schedule count, EMA, step and
generator equal what was saved."""

import json

import numpy as np
import pytest
import torch

from single_person_pose_estimation_tpu.evaluation import oks as joks
from single_person_pose_estimation_tpu.evaluation import pck as jpck
from single_person_pose_estimation_tpu_torch import Config
from single_person_pose_estimation_tpu_torch.configs.default_config import (
    COCO_KEYPOINT_LABELS,
)
from single_person_pose_estimation_tpu_torch.data.in_memory import (
    ArrayDatasetBuilder,
    synthetic_crops,
)
from single_person_pose_estimation_tpu_torch.evaluation import oks, pck
from single_person_pose_estimation_tpu_torch.training.trainer import Trainer
from single_person_pose_estimation_tpu_torch.utils import model_utils
from torch_port_fixtures import random_variables, torch_model


def _scene(seed, n_images=8):
    """GT annotations (crowds, unlabeled GTs, missing areas, small, medium
    and large people) and predict_ds-style records near them, with some
    spurious ones."""
    rng = np.random.default_rng(seed)
    anns, preds = [], []
    for img in range(1, n_images + 1):
        for _ in range(int(rng.integers(1, 4))):
            side = float(rng.choice([20.0, 60.0, 150.0]))
            x0, y0 = rng.uniform(0, 300, 2)
            vis = rng.choice([0, 1, 2], 17, p=[0.3, 0.2, 0.5])
            if rng.random() < 0.15:
                vis[:] = 0
            kx, ky = x0 + rng.uniform(0, side, 17), y0 + rng.uniform(0, side, 17)
            ann = {"id": len(anns) + 1, "image_id": img, "category_id": 1,
                   "iscrowd": int(rng.random() < 0.15),
                   "num_keypoints": int((vis > 0).sum()),
                   "bbox": [x0, y0, side, side],
                   "keypoints": [v for k in range(17) for v in
                                 (float(kx[k]), float(ky[k]), int(vis[k]))]}
            if rng.random() < 0.8:
                ann["area"] = side * side * float(rng.uniform(0.6, 1.0))
            anns.append(ann)
            noise = rng.uniform(0.5, side * 0.3)
            preds.append({
                "xs/pred": (kx + rng.normal(0, noise, 17)).tolist(),
                "ys/pred": (ky + rng.normal(0, noise, 17)).tolist(),
                "xs/gt": kx.tolist(), "ys/gt": ky.tolist(),
                "vs": vis.astype(int).tolist(),
                "confs": rng.uniform(0, 1, 17).tolist(),
                "image_id": img, "ann_id": ann["id"],
                "original_bbox": [x0, y0, side, side]})
        if rng.random() < 0.5:
            p = dict(preds[-1])
            p["xs/pred"] = rng.uniform(0, 400, 17).tolist()
            p["confs"] = rng.uniform(0, 1, 17).tolist()
            preds.append(p)
    return {"images": [{"id": i} for i in range(1, n_images + 1)],
            "annotations": anns, "categories": []}, preds


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_oks_and_pck_match_jax_exactly(tmp_path, seed):
    gt, preds = _scene(seed)
    path = str(tmp_path / "gt.json")
    with open(path, "w") as f:
        json.dump(gt, f)
    got = oks.eval_oks(preds, path, verbose=False)
    want = joks.eval_oks(preds, path, verbose=False)
    assert got.shape == (10,) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)
    for thr in (0.05, 0.2):
        assert pck.eval_pck(preds, COCO_KEYPOINT_LABELS, thr, False) == \
            jpck.eval_pck(preds, COCO_KEYPOINT_LABELS, thr, False)
    dets = [{"image_id": p["image_id"], "score": float(np.mean(p["confs"])),
             "keypoints": [v for x, y in zip(p["xs/pred"], p["ys/pred"])
                           for v in (x, y, 1)]} for p in preds]
    np.testing.assert_array_equal(oks.KeypointEval(gt, dets).evaluate(),
                                  joks.KeypointEval(gt, dets).evaluate())
    assert oks.KeypointEval.summarize(got) == \
        joks.KeypointEval.summarize(want)


def _state_tensors(state):
    opt = state.optimizer.state_dict()
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    for i, st in opt["adam"]["state"].items():
        out.update({f"adam.{i}.{k}": v for k, v in st.items()})
    out.update({f"ema.{k}": v for k, v in opt["ema"].items()})
    out["generator"] = state.generator.get_state()
    return out, (opt["count"], state.step)


def test_load_model_from_checkpoint_round_trip(tmp_path):
    cfg = Config(image_height=64, image_width=64, label_height=16,
                 label_width=16, hg_num_stacks=1, hg_num_channels=16,
                 batch_size=2, compute_dtype="float32",
                 temporary_dir=str(tmp_path))
    builder = ArrayDatasetBuilder(synthetic_crops(4, 64, label_size=16),
                                  synthetic_crops(2, 64, label_size=16,
                                                  seed=1), 2)
    trainer = Trainer(torch_model(random_variables(1, 16), 1, 16), builder,
                      1, 1e-3, "weighted_mse", cfg, device="cpu",
                      lr_schedule="cosine", warmup_steps=1, ema_decay=0.9)
    trainer.train()
    saved, counts = _state_tensors(trainer.state)
    trainer.close()
    assert model_utils.list_checkpoints(cfg.checkpoints_path) == ([1], True)
    state, meta = model_utils.load_model_from_checkpoint(
        torch_model(random_variables(1, 16, seed=5), 1, 16),
        cfg.checkpoints_path, device="cpu")
    assert meta["epoch"] == 1 and meta["ema_decay"] == 0.9
    got, got_counts = _state_tensors(state)
    assert got.keys() == saved.keys() and got_counts == counts == (2, 2)
    for k in saved:
        assert torch.equal(got[k], saved[k]), k
    best, best_meta = model_utils.load_model_from_checkpoint(
        torch_model(random_variables(1, 16, seed=6), 1, 16),
        cfg.checkpoints_path, best=True, device="cpu")
    assert best_meta["epoch"] == 1 and "val_loss" in best_meta
    assert model_utils.list_checkpoints(str(tmp_path / "none")) == ([], False)
