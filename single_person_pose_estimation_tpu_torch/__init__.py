"""PyTorch and CUDA port of the stacked-hourglass pose estimator.

The JAX package `single_person_pose_estimation_tpu` is the reference; this
package computes the same functions with PyTorch tensors, and runs the hot
loops of inference, evaluation and training through hand-written CUDA
kernels (`ops/cuda/`) on an NVIDIA Hopper card. It imports neither JAX nor
any module of the JAX package: what it needs of that package's
framework-free modules (`Config`, the training metrics files, the record
codec and image helpers, OKS and PCK) it keeps as its own copies.
"""

from single_person_pose_estimation_tpu_torch.configs.default_config import (
    COCO_INDEX_FLIP_PAIRS,
    COCO_KEYPOINT_LABELS,
    COCO_SKELETON,
    Config,
)

__all__ = [
    "Config",
    "COCO_INDEX_FLIP_PAIRS",
    "COCO_KEYPOINT_LABELS",
    "COCO_SKELETON",
    "StackedHourglass",
    "create_hourglass_model",
    "Trainer",
    "DatasetBuilder",
    "PoseServer",
]


def __getattr__(name):
    # Lazy re-exports, as the JAX package makes them: importing the package
    # loads no model, trainer, data or serving module until one is asked
    # for.
    if name in ("StackedHourglass", "create_hourglass_model"):
        from single_person_pose_estimation_tpu_torch.models import hourglass
        return getattr(hourglass, name)
    if name == "Trainer":
        from single_person_pose_estimation_tpu_torch.training.trainer import (
            Trainer,
        )
        return Trainer
    if name == "DatasetBuilder":
        from single_person_pose_estimation_tpu_torch.data.pipeline import (
            DatasetBuilder,
        )
        return DatasetBuilder
    if name == "PoseServer":
        from single_person_pose_estimation_tpu_torch.serving import PoseServer
        return PoseServer
    raise AttributeError(name)
