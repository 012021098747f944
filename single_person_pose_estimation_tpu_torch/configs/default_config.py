"""Configuration of the PyTorch port: the JAX package's `Config`, copied.

The port imports nothing of the JAX package, so it keeps its own copy of
that package's framework-free `configs/default_config.py`: the same fields,
defaults, validation, `replace` and `to_json`/`from_json`, so a JSON config
written by either package loads in the other. Field values replicate the
reference's flat config module (reference: configs/default_config.py:1-99);
they are load-bearing for numeric parity (sigma=1, kernel 7, bbox scale
1.25, sigmoid heads, flip pairs). Some field comments describe the JAX
package's TPU measurements; they are kept with the fields, not measured
here.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Tuple

import numpy as np

# COCO skeleton metadata (reference: configs/default_config.py:52-98).
# Flip pairs swap left/right keypoints after a horizontal flip.
COCO_INDEX_FLIP_PAIRS: Tuple[Tuple[int, int], ...] = (
    (1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (11, 12), (13, 14), (15, 16),
)

COCO_KEYPOINT_LABELS: Tuple[str, ...] = (
    "nose",
    "left_eye", "right_eye",
    "left_ear", "right_ear",
    "left_shoulder", "right_shoulder",
    "left_elbow", "right_elbow",
    "left_wrist", "right_wrist",
    "left_hip", "right_hip",
    "left_knee", "right_knee",
    "left_ankle", "right_ankle",
)

COCO_KEYPOINT_COLORS: Tuple[str, ...] = (
    "red",
    "brown", "chocolate",
    "orange", "tan",
    "lime", "teal",
    "navy", "violet",
    "black", "coral",
    "yellow", "gold",
    "cyan", "green",
    "orchid", "indigo",
)

# 19 skeleton edges, 0-indexed keypoint pairs (reference 1-indexed array minus 1).
COCO_SKELETON: Tuple[Tuple[int, int], ...] = tuple(
    (a - 1, b - 1)
    for a, b in (
        (16, 14), (14, 12), (17, 15), (15, 13), (12, 13), (6, 12), (7, 13),
        (6, 7), (6, 8), (7, 9), (8, 10), (9, 11), (2, 3), (1, 2), (1, 3),
        (2, 4), (3, 5), (4, 6), (5, 7),
    )
)


@dataclasses.dataclass(frozen=True)
class Config:
    """Frozen, hashable configuration.

    Defaults mirror reference configs/default_config.py exactly.
    """

    # --- Dataset (reference lines 4-7) ---
    num_keypoints: int = 17
    min_num_keypoints: int = 5
    bbox_scale: float = 1.25
    num_examples_per_record: int = 2048

    # --- Image / heatmap geometry (reference lines 9-18) ---
    image_height: int = 256
    image_width: int = 256
    label_height: int = 64
    label_width: int = 64
    gaussian_kernel: int = 7
    hm_activation: str = "sigmoid"
    hm_sigma: float = 1.0

    # --- Hourglass (reference lines 21-22) ---
    hg_num_channels: int = 256
    hg_num_stacks: int = 2
    mobile: bool = False

    # --- Training (reference lines 26-28) ---
    batch_size: int = 16
    shuffle_buffer: int = 1000
    learning_rate: float = 0.01

    # --- TPU-native additions (not in reference) ---
    compute_dtype: str = "bfloat16"   # forward/backward compute precision
    param_dtype: str = "float32"      # parameter storage precision
    # Host->device image wire for training batches: "float32" (reference
    # numerics) or "uint8" (quantize the resized crop on the host, /255 on
    # device — 4x less transfer; <=0.5/255 per-pixel quantization, the same
    # trade serving.PoseServer makes on its wire).
    train_transfer_dtype: str = "float32"
    # Same dial for the PREDICTION path (get_ds_prediction ->
    # evaluation.predict_ds): f32 crops are 100 MB per 128-batch on the
    # wire, 4x the uint8 form — on wire-bound links (tunnels; congested
    # PCIe) eval throughput scales with it (PERF.md "Eval from records").
    # Default float32 = reference numerics. The uint8 wire's
    # quantization-induced decode drift is bounded by test at <2 px MEAN
    # in original-image coords on a random-init model
    # (tests/test_eval.py::test_predict_ds_uint8_wire_matches_float32);
    # on trained, peaked heatmaps the argmax is far less sensitive, but
    # that tighter band is not what the test pins.
    eval_transfer_dtype: str = "float32"
    # Host-side decode workers (JPEG decode + resize release the GIL, so
    # threads scale across cores). 0 = auto: min(4, cpu_count - 1), serial
    # on a single-core host.
    host_workers: int = 0
    # Space-to-depth front fold (ops/space_to_depth.py): compute the 7x7/s2
    # opening conv as the exactly-equal folded 4x4/s1 conv over the
    # 2x2-blocked input — a 3-deep reduction underfills the MXU's 128-deep
    # systolic dimension. Same stored parameter; checkpoints interchange.
    # Interleaved A/B medians on v5e measured a WASH on both paths
    # (inference -0.5%, train +0.4%, inside the +-1.5% run-to-run band;
    # PERF.md "Space-to-depth front fold"), so the default is "off".
    # "auto" = on for TPU / off elsewhere; "on" forces it — the fold is
    # exactly equal, so either setting is safe if it wins on other
    # TPU generations.
    front_s2d: str = "off"
    # Pre-resize person crops to this square size at ETL time (0 = store
    # the native crop resolution, the reference's gen_tfrecords behavior).
    # Keypoints are stored scaled into the resized frame, so the training
    # pipeline is unchanged; evaluation recovers the true square-crop side
    # from original_bbox for its un-crop mapping (pipeline.py
    # _parse_prediction_example). The host decodes record_size^2 JPEGs
    # instead of native-size crops: measured 2.09x host-pipeline
    # throughput at 256 vs native-400 crops (interleaved medians,
    # scripts/bench_record_size_ab.py; PERF.md "record_image_size A/B").
    # Set to image_height when the host input stage binds training (small
    # hosts); 0 keeps full-resolution crops, which larger input sizes or
    # future re-crops could still consume.
    record_image_size: int = 0
    seed: int = 0
    mesh_shape: Tuple[int, ...] = (-1,)        # -1: all available devices
    mesh_axis_names: Tuple[str, ...] = ("data",)
    checkpoint_every_epochs: int = 1
    async_checkpointing: bool = True
    legacy_decode: bool = True        # reproduce reference decode-v2 offset bias
    augment_backend: str = "auto"     # geometric warp: auto | gather | matmul2pass
    # Augmentation ranges (reference dataset_builder.py:175-182)
    aug_scale_min: float = 0.75
    aug_scale_max: float = 1.25
    aug_rotate_deg: float = 30.0
    aug_flip_prob: float = 0.5
    aug_brightness: float = 0.2
    aug_contrast_min: float = 0.5
    aug_contrast_max: float = 2.0
    aug_saturation_min: float = 0.75
    aug_saturation_max: float = 1.25
    aug_hue: float = 0.1

    # --- Directories (reference lines 31-49) ---
    dataset_dir: str = "dataset"
    temporary_dir: str = "temp"

    # ------------------------------------------------------------------
    def __post_init__(self):
        # Validate the string-enum fields consumed by `== "..."` checks
        # downstream — a typo ('unit8', 'bf16') would otherwise silently
        # select the fallback path instead of erroring.
        _enums = {
            "train_transfer_dtype": ("float32", "uint8"),
            "eval_transfer_dtype": ("float32", "uint8"),
            "compute_dtype": ("float32", "bfloat16"),
            "param_dtype": ("float32", "bfloat16"),
            "front_s2d": ("off", "auto", "on"),
            "hm_activation": ("sigmoid", "linear", "relu"),
        }
        for field, allowed in _enums.items():
            v = getattr(self, field)
            if v not in allowed:
                raise ValueError(
                    f"config.{field} must be one of {allowed}, got {v!r}")

    @property
    def image_shape(self) -> Tuple[int, int, int]:
        return (self.image_height, self.image_width, 3)

    @property
    def label_shape(self) -> Tuple[int, int, int]:
        return (self.label_height, self.label_width, self.num_keypoints)

    @property
    def images_dir(self) -> str:
        return os.path.join(self.dataset_dir, "images")

    @property
    def train_images_dir(self) -> str:
        return os.path.join(self.images_dir, "train2017")

    @property
    def valid_images_dir(self) -> str:
        return os.path.join(self.images_dir, "val2017")

    @property
    def annot_dir(self) -> str:
        return os.path.join(self.dataset_dir, "annotations")

    @property
    def train_annot_file(self) -> str:
        return os.path.join(self.annot_dir, "person_keypoints_train2017.json")

    @property
    def valid_annot_file(self) -> str:
        return os.path.join(self.annot_dir, "person_keypoints_val2017.json")

    @property
    def tfrecords_dir(self) -> str:
        return os.path.join(self.dataset_dir, "tfrecords")

    @property
    def train_tfrecords_dir(self) -> str:
        return os.path.join(self.tfrecords_dir, "train")

    @property
    def valid_tfrecords_dir(self) -> str:
        return os.path.join(self.tfrecords_dir, "valid")

    @property
    def checkpoints_path(self) -> str:
        return os.path.join(self.temporary_dir, "checkpoints")

    @property
    def logs_path(self) -> str:
        return os.path.join(self.temporary_dir, "logs")

    # Skeleton metadata exposed as properties so a Config instance is a
    # drop-in for the reference's `cfg` module object.
    @property
    def flip_pairs(self) -> Tuple[Tuple[int, int], ...]:
        return COCO_INDEX_FLIP_PAIRS

    @property
    def keypoint_labels(self) -> Tuple[str, ...]:
        return COCO_KEYPOINT_LABELS

    @property
    def keypoint_colors(self) -> Tuple[str, ...]:
        return COCO_KEYPOINT_COLORS

    @property
    def skeleton(self) -> np.ndarray:
        return np.asarray(COCO_SKELETON, dtype=np.int32)

    # ------------------------------------------------------------------
    def replace(self, **kwargs: Any) -> "Config":
        return dataclasses.replace(self, **kwargs)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "Config":
        d = json.loads(s)
        # JSON round-trips tuples as lists; restore tuples for hashability.
        for k, v in d.items():
            if isinstance(v, list):
                d[k] = tuple(tuple(x) if isinstance(x, list) else x for x in v)
        return cls(**d)


# Aliases matching the reference's ALL_CAPS constant names, so code written
# against `from configs import default_config as cfg` ports one-to-one.
_DEFAULT = Config()
NUM_KEYPOINTS = _DEFAULT.num_keypoints
MIN_NUM_KEYPOINTS = _DEFAULT.min_num_keypoints
BBOX_SCALE = _DEFAULT.bbox_scale
IMAGE_SHAPE = _DEFAULT.image_shape
LABEL_SHAPE = _DEFAULT.label_shape
GAUSSIAN_KERNEL = _DEFAULT.gaussian_kernel
HM_SIGMA = _DEFAULT.hm_sigma
HG_NUM_CHANNELS = _DEFAULT.hg_num_channels
HG_NUM_STACKS = _DEFAULT.hg_num_stacks
BATCH_SIZE = _DEFAULT.batch_size
LEARNING_RATE = _DEFAULT.learning_rate
