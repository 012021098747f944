from single_person_pose_estimation_tpu_torch.ops import (  # noqa: F401
    augment,
    decode,
    geometry,
    heatmap,
)
