from single_person_pose_estimation_tpu_torch.configs.default_config import (
    COCO_INDEX_FLIP_PAIRS,
    COCO_KEYPOINT_LABELS,
    COCO_SKELETON,
    Config,
)

__all__ = ["Config", "COCO_INDEX_FLIP_PAIRS", "COCO_KEYPOINT_LABELS",
           "COCO_SKELETON"]
