"""Hand-written CUDA kernels of the inference (standard and mobile, with
the fused front and subtree dials), evaluation and training paths (the
fused train-mode bottleneck included), each with its plain PyTorch version
beside it (see each module's docstring)."""

from single_person_pose_estimation_tpu_torch.ops.cuda.bottleneck_kernel import (
    fused_bottleneck,
    fused_bottleneck_convskip,
    fused_bottleneck_pool,
    fused_bottleneck_rows,
)
from single_person_pose_estimation_tpu_torch.ops.cuda.bottleneck_train_kernel import (
    bn_bwd_reduce,
    conv1x1_relu_stats,
    conv3x3_relu_stats,
    unit1_bwd,
    unit1x1_bwd,
    unit3x3_bwd,
)
from single_person_pose_estimation_tpu_torch.ops.cuda.bottom_kernel import (
    fused_subtree,
)
from single_person_pose_estimation_tpu_torch.ops.cuda.decode_kernel import (
    decode_batch,
)
from single_person_pose_estimation_tpu_torch.ops.cuda.head_kernel import (
    fused_head,
)
from single_person_pose_estimation_tpu_torch.ops.cuda.heatmap_kernel import (
    render_heatmaps_batch,
)
from single_person_pose_estimation_tpu_torch.ops.cuda.mobile_kernel import (
    fused_bottleneck_mobile,
    fused_bottleneck_mobile_pool,
    fused_uplevel_mobile,
)
from single_person_pose_estimation_tpu_torch.ops.cuda.uplevel_kernel import (
    fused_uplevel,
)
from single_person_pose_estimation_tpu_torch.ops.cuda.warp_kernel import (
    resample_last_axis,
)

# The wrappers whose `launches` attribute counts kernel launches.
KERNEL_WRAPPERS = {
    "fused_bottleneck": fused_bottleneck,
    "fused_bottleneck_pool": fused_bottleneck_pool,
    "fused_uplevel": fused_uplevel,
    "fused_head": fused_head,
    "resample_last_axis": resample_last_axis,
    "render_heatmaps_batch": render_heatmaps_batch,
    "decode_batch": decode_batch,
    "fused_bottleneck_mobile": fused_bottleneck_mobile,
    "fused_bottleneck_mobile_pool": fused_bottleneck_mobile_pool,
    "fused_uplevel_mobile": fused_uplevel_mobile,
    "conv1x1_relu_stats": conv1x1_relu_stats,
    "conv3x3_relu_stats": conv3x3_relu_stats,
    "bn_bwd_reduce": bn_bwd_reduce,
    "unit1x1_bwd": unit1x1_bwd,
    "unit3x3_bwd": unit3x3_bwd,
    "unit1_bwd": unit1_bwd,
    "fused_bottleneck_convskip": fused_bottleneck_convskip,
    "fused_subtree": fused_subtree,
    "fused_bottleneck_rows": fused_bottleneck_rows,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def reset_launch_counts():
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0
