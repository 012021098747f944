"""Shared inputs of the port's tests (tests/test_torch_*.py): flax-layout
variables, images and small COCO-layout datasets made with numpy from a
seed, so the JAX package and the PyTorch port see the same numbers."""

import json
import os

import numpy as np
import torch

from single_person_pose_estimation_tpu_torch.data.images import encode_jpeg
from single_person_pose_estimation_tpu_torch.models.hourglass import (
    StackedHourglass,
)
from single_person_pose_estimation_tpu_torch.utils.weight_convert import (
    init_variables,
    load_variables,
)


def random_variables(num_stacks, num_channels, seed=0, mobile=False):
    """init_variables plus random conv biases and BN scales/shifts, so
    every bias and affine of the reference is exercised (a separable
    conv's bias is its pointwise one)."""
    v = init_variables(num_stacks, num_channels, seed=seed, mobile=mobile)
    rng = np.random.default_rng(seed + 1)
    for leaves in v["params"].values():
        leaves = leaves.get("pointwise", leaves)
        n = leaves["bias"].shape
        leaves["bias"] = rng.uniform(-.1, .1, n).astype(np.float32)
        if "scale" in leaves:
            leaves["scale"] = rng.uniform(.5, 1.5, n).astype(np.float32)
    return v


def images(b, size=64, seed=2):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, (b, size, size, 3)).astype(np.float32)


def torch_model(variables, num_stacks, num_channels,
                compute_dtype=torch.float32, mobile=False):
    m = StackedHourglass(num_stacks=num_stacks, num_channels=num_channels,
                         compute_dtype=compute_dtype, mobile=mobile)
    return load_variables(m, variables)


def make_spot_coco(root, split="val2017", n_images=4, seed=2, sigma=4.0):
    """A tiny COCO-format split whose crops carry one bright Gaussian spot
    on dark noise: 80x80 JPEG images, one person each, whose square crop
    (bbox side 51.2 x bbox_scale 1.25) is 64 px, so a 64 px model input
    needs no resize. Returns the annotation file's path."""
    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, "images", split)
    ann_dir = os.path.join(root, "annotations")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)
    yy, xx = np.mgrid[0:80, 0:80]
    images, annotations = [], []
    for i in range(n_images):
        cy, cx = rng.uniform(20, 60, 2)
        img = rng.uniform(0, 0.05, (80, 80, 1)) + np.exp(
            -((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sigma ** 2))[..., None]
        img = np.clip(np.repeat(img, 3, axis=2) * 255, 0, 255)
        name = f"{i:012d}.jpg"
        with open(os.path.join(img_dir, name), "wb") as f:
            f.write(encode_jpeg(img.astype(np.uint8)))
        images.append({"id": i, "file_name": name, "width": 80,
                       "height": 80, "coco_url": f"http://x/{name}"})
        kps = []
        for k in range(17):
            vis = int(rng.integers(0, 3))
            kps += [float(rng.uniform(12, 58)), float(rng.uniform(12, 58)),
                    vis]
        annotations.append({
            "id": 500 + i, "image_id": i, "iscrowd": 0, "category_id": 1,
            "bbox": [8.0, 8.0, 51.2, 51.2], "area": 51.2 * 51.2,
            "num_keypoints": sum(v > 0 for v in kps[2::3]),
            "keypoints": kps})
    ann_file = os.path.join(ann_dir, f"person_keypoints_{split}.json")
    with open(ann_file, "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": []}, f)
    return ann_file


def peaked_variables(num_stacks=1, num_channels=16, seed=2, scale=0.04,
                     mobile=False):
    """random_variables with the last stack's predict kernel made
    non-negative and scaled down: the sigmoid stays clear of saturation
    (no ties at 1.0), and on make_spot_coco's crops every channel's
    maximum leads its runner-up by more than 1e-4 (tests/
    test_torch_predict.py asserts it)."""
    v = random_variables(num_stacks, num_channels, seed=seed, mobile=mobile)
    p = v["params"][f"hg{num_stacks - 1}_conv_1x1_predict"]
    p["kernel"] = np.abs(p["kernel"]) * scale
    return v
