"""COCO keypoints ETL: annotation JSON -> person-crop record shards.

Replaces the reference's coco_df.py + gen_tfrecords.py without pycocotools
or pandas: the COCO annotation JSON is parsed directly (it is plain JSON;
pycocotools' COCO class is an index over it), each (image x person) pair
with iscrowd == 0 and num_keypoints >= MIN becomes one example
(coco_df.py:55-75 semantics), and examples are written as TFRecord shards
of 2048 with the reference's exact 14-feature schema and shard naming
(gen_tfrecords.py:71-86, 105-115) so the two frameworks' datasets are
interchangeable.

Per example (create_example, gen_tfrecords.py:12-87):
  * square-expand the person bbox by BBOX_SCALE about its center;
  * crop-and-zero-pad the image to that (integer-truncated) box;
  * shift keypoints into the crop frame, zeroing any outside the open box
    or invisible;
  * store the re-encoded JPEG crop + keypoints + ids + bbox metadata.

The port's counterpart of the JAX package's `data/coco.py`, with the same
functions and the same example bytes for the same inputs
(`tests/test_torch_records.py`), so the port writes what it reads.

NOTE (reference divergence, deliberate): gen_tfrecords.py:156 passes
`train_df` when generating the *valid* split — a latent bug (the shipped
valid TFRecords were actually built from valid_df in a notebook). This ETL
uses the valid examples for the valid split.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from single_person_pose_estimation_tpu_torch.configs.default_config import (
    Config,
)
from single_person_pose_estimation_tpu_torch.data import (
    example_codec,
    tfrecord,
)
from single_person_pose_estimation_tpu_torch.data.images import (
    encode_jpeg,
    read_image,
    resize_bilinear_u8,
)


@dataclass
class PersonExample:
    """One person instance: the unit of the dataset (a row of the
    reference's merged DataFrame, coco_df.py:23-53)."""

    ann_id: int
    image_id: int
    image_path: str
    coco_url: str
    width: int
    height: int
    bbox: Tuple[float, float, float, float]
    keypoints: List[float]   # COCO triplets (x0, y0, v0, x1, ...)
    num_keypoints: int


def load_person_examples(annot_file: str, min_num_keypoints: int = 1
                         ) -> List[PersonExample]:
    """Parse a COCO person_keypoints_*.json into per-person examples,
    filtered to iscrowd == 0 and num_keypoints >= min (coco_df.py:64,70)."""
    with open(annot_file) as f:
        coco = json.load(f)
    images = {im["id"]: im for im in coco["images"]}
    out: List[PersonExample] = []
    for ann in coco["annotations"]:
        if ann.get("iscrowd", 0) != 0:
            continue
        if ann.get("num_keypoints", 0) < min_num_keypoints:
            continue
        im = images[ann["image_id"]]
        out.append(PersonExample(
            ann_id=ann["id"],
            image_id=ann["image_id"],
            image_path=im["file_name"],
            coco_url=im.get("coco_url", ""),
            width=im["width"],
            height=im["height"],
            bbox=tuple(ann["bbox"]),
            keypoints=list(ann["keypoints"]),
            num_keypoints=ann["num_keypoints"],
        ))
    return out


def transform_bbox_square_np(bbox, scale: float = 1.0):
    """Host-side square bbox expansion (same math as ops.geometry)."""
    x, y, w, h = bbox
    cx, cy = x + w / 2.0, y + h / 2.0
    side = max(w, h) * scale
    return (cx - side / 2.0, cy - side / 2.0, side, side)


def crop_and_pad_np(image: np.ndarray, bbox) -> np.ndarray:
    """Crop to an integer-truncated box, zero-padding outside the frame.

    Numpy equivalent of the reference's tf.image pad_to_bounding_box +
    crop_to_bounding_box sequence (data_utils.py:48-98) including its
    int() truncations; implemented as a single paste instead of
    materializing the padded image.
    """
    H, W = image.shape[:2]
    x, y, w, h = bbox
    # Reference truncations: pad offsets int(abs(coord)); crop offsets
    # int(max(coord, 0)); crop size int(w), int(h).
    pt = int(abs(y)) if y < 0 else 0
    pl = int(abs(x)) if x < 0 else 0
    cy, cx = int(max(y, 0.0)), int(max(x, 0.0))
    ch, cw = int(h), int(w)
    out = np.zeros((ch, cw) + image.shape[2:], dtype=image.dtype)
    y0, y1 = max(cy, pt), min(cy + ch, pt + H)
    x0, x1 = max(cx, pl), min(cx + cw, pl + W)
    if y1 > y0 and x1 > x0:
        out[y0 - cy:y1 - cy, x0 - cx:x1 - cx] = \
            image[y0 - pt:y1 - pt, x0 - pl:x1 - pl]
    return out


def build_example_features(image: np.ndarray, ex: PersonExample,
                           bbox_scale: float,
                           record_size: int = 0) -> Dict:
    """Produce the 14-feature dict for one person crop
    (schema: gen_tfrecords.py:71-86).

    record_size > 0 stores the crop pre-resized to that square size with
    keypoints scaled into the resized frame (config.record_image_size) —
    the stored width/height features describe the resized crop, so the
    training pipeline's crop-space -> heatmap-space rescale is unchanged."""
    sq = transform_bbox_square_np(ex.bbox, bbox_scale)
    crop = crop_and_pad_np(image, sq)

    kps = ex.keypoints
    xs = kps[0::3]
    ys = kps[1::3]
    vs = [int(v) for v in kps[2::3]]
    fx: List[float] = []
    fy: List[float] = []
    fv: List[int] = []
    for x, y, v in zip(xs, ys, vs):
        sx, sy = x - sq[0], y - sq[1]
        if 0 < sx < sq[2] and 0 < sy < sq[3] and v > 0:
            fx.append(float(sx))
            fy.append(float(sy))
            fv.append(v)
        else:
            fx.append(0.0)
            fy.append(0.0)
            fv.append(0)
    num_kps = sum(1 for v in fv if v > 0)

    if record_size:
        ch, cw = crop.shape[:2]
        crop = resize_bilinear_u8(crop, (record_size, record_size))
        fx = [x * record_size / cw for x in fx]
        fy = [y * record_size / ch for y in fy]

    return {
        "ann_id": [ex.ann_id],
        "image_id": [ex.image_id],
        "image": [encode_jpeg(crop)],
        "image_path": [ex.image_path.encode()],
        "coco_url": [ex.coco_url.encode()],
        "width": [crop.shape[1]],
        "height": [crop.shape[0]],
        "keypoints/x": fx,
        "keypoints/y": fy,
        "keypoints/vis": fv,
        "keypoints/num": [num_kps],
        "bbox_x": [float(sq[0])],
        "bbox_y": [float(sq[1])],
        "original_bbox": [float(v) for v in ex.bbox],
    }


def generate_records(
    examples: Sequence[PersonExample],
    config: Config,
    is_train: bool,
    progress_every: int = 5000,
) -> List[str]:
    """Write shard files of `num_examples_per_record` examples each.

    Mirrors gen_TFRecords (gen_tfrecords.py:89-116): shards named
    file_{split}_%02i-%i.tfrec with the example count in the suffix.
    Returns the shard paths.
    """
    per = config.num_examples_per_record
    out_dir = config.train_tfrecords_dir if is_train else config.valid_tfrecords_dir
    img_dir = config.train_images_dir if is_train else config.valid_images_dir
    os.makedirs(out_dir, exist_ok=True)

    paths = []
    t0 = time.time()
    done = 0
    for shard_idx in range(0, (len(examples) + per - 1) // per):
        chunk = examples[shard_idx * per:(shard_idx + 1) * per]
        path = tfrecord.shard_filename(out_dir, shard_idx, len(chunk))
        with tfrecord.TFRecordWriter(path) as w:
            for ex in chunk:
                image = read_image(os.path.join(img_dir, ex.image_path))
                feats = build_example_features(
                    image, ex, config.bbox_scale,
                    record_size=config.record_image_size)
                w.write(example_codec.encode_example(feats))
                done += 1
                if progress_every and done % progress_every == 0:
                    rate = done / (time.time() - t0)
                    print(f"  {done}/{len(examples)} examples "
                          f"({rate:.0f}/s)", flush=True)
        paths.append(path)
    return paths


def gen_trainval_records(config: Config, drop_min_num_kps: bool = True):
    """Full offline ETL for both splits (gen_tfrecords.py __main__
    equivalent, with the valid-split bug fixed)."""
    min_kps = config.min_num_keypoints if drop_min_num_kps else 1
    train = load_person_examples(config.train_annot_file, min_kps)
    print(f"train: {len(train)} person examples")
    train_paths = generate_records(train, config, is_train=True)
    valid = load_person_examples(config.valid_annot_file, min_kps)
    print(f"valid: {len(valid)} person examples")
    valid_paths = generate_records(valid, config, is_train=False)
    return train_paths, valid_paths


if __name__ == "__main__":
    gen_trainval_records(Config())
