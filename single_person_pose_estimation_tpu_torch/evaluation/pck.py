"""PCK (Percentage of Correct Keypoints) evaluation.

Reference: eval.py:53-96 — per-keypoint-label PCK where a prediction is
correct if its distance to GT is <= threshold * sqrt(w^2 + h^2) of the
person's ORIGINAL (pre-square-expansion) bbox; only GT-visible keypoints
count. Vectorized over examples instead of the reference's Python loops.

The port's copy of the JAX package's `evaluation/pck.py` (numpy only,
unchanged).
"""

from __future__ import annotations

import json
from typing import List, Sequence

import numpy as np


def eval_pck(predictions, keypoint_labels: Sequence[str],
             pck_threshold: float = 0.05, verbose: bool = True
             ) -> List[float]:
    """predictions: list (or JSON path) of predict_ds outputs. Returns
    per-label PCK in `keypoint_labels` order (printed like the reference)."""
    if isinstance(predictions, str):
        with open(predictions) as f:
            predictions = json.load(f)

    K = len(keypoint_labels)
    xs_p = np.asarray([p["xs/pred"] for p in predictions], dtype=np.float64)
    ys_p = np.asarray([p["ys/pred"] for p in predictions], dtype=np.float64)
    xs_g = np.asarray([p["xs/gt"] for p in predictions], dtype=np.float64)
    ys_g = np.asarray([p["ys/gt"] for p in predictions], dtype=np.float64)
    vs = np.asarray([p["vs"] for p in predictions])
    bbox = np.asarray([p["original_bbox"] for p in predictions],
                      dtype=np.float64)

    diameter = np.sqrt(bbox[:, 2] ** 2 + bbox[:, 3] ** 2)
    thresh = pck_threshold * diameter                       # (N,)
    dist = np.sqrt((xs_g - xs_p) ** 2 + (ys_g - ys_p) ** 2)  # (N, K)
    visible = vs > 0
    correct = (dist <= thresh[:, None]) & visible

    stats = []
    for k, label in enumerate(keypoint_labels):
        n_vis = int(visible[:, k].sum())
        pct = float(correct[:, k].sum()) / n_vis if n_vis else 0.0
        stats.append(pct)
        if verbose:
            print(f"{label}: {pct:.2f}%")
    return stats
