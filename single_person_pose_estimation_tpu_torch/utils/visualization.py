"""Keypoint/skeleton drawing helpers.

The port's copy of the JAX package's `utils/visualization.py` (numpy and
a matplotlib axis; no framework), on the port's own config. Reference:
utilities/visualization_utils.py:5-37: scatter 17 keypoints scaled from
heatmap space to image size; plot the 19 skeleton edges, skipping zero
coordinates.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from single_person_pose_estimation_tpu_torch.configs.default_config import (
    COCO_KEYPOINT_COLORS,
    COCO_SKELETON,
)


def draw_keypoints(ax, keypoints: np.ndarray, image_shape,
                   heatmap_shape=(64, 64),
                   colors: Sequence[str] = COCO_KEYPOINT_COLORS,
                   marker_size: float = 30.0):
    """Scatter keypoints (K, >=2) given in heatmap space onto an image axis
    (visualization_utils.py:5-16)."""
    keypoints = np.asarray(keypoints)
    sy = image_shape[0] / heatmap_shape[0]
    sx = image_shape[1] / heatmap_shape[1]
    for i, (x, y) in enumerate(keypoints[:, :2]):
        if x or y:
            ax.scatter(x * sx, y * sy, s=marker_size,
                       c=colors[i % len(colors)])


def draw_skeleton(ax, keypoints: np.ndarray, image_shape,
                  heatmap_shape=(64, 64),
                  skeleton: Optional[np.ndarray] = None,
                  linewidth: float = 3.0):
    """Plot skeleton edges, skipping edges touching a zero keypoint
    (visualization_utils.py:18-37)."""
    keypoints = np.asarray(keypoints)
    if skeleton is None:
        skeleton = np.asarray(COCO_SKELETON)
    sy = image_shape[0] / heatmap_shape[0]
    sx = image_shape[1] / heatmap_shape[1]
    xs = keypoints[:, 0]
    ys = keypoints[:, 1]
    for a, b in skeleton:
        if xs[a] and ys[a] and xs[b] and ys[b]:
            ax.plot((xs[a] * sx, xs[b] * sx), (ys[a] * sy, ys[b] * sy),
                    linewidth=linewidth)
