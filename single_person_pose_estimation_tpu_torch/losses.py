"""Heatmap losses with intermediate supervision across hourglass stacks.

The counterpart of the JAX package's `losses.py` (reference loss.py:2-36
and the dispatch in trainer.py:224-245). Each loss takes (y_true, y_pred)
NHWC maps (B, H, W, K) and returns the per-element loss with the last
(keypoint) axis reduced, as the reference's Keras losses do;
`total_loss` averages each stack's map and sums over the stacks.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch

# Keras backend epsilon, used by the reference's IOU loss (loss.py:24).
_EPSILON = 1e-7


def mse(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """Plain MSE over the keypoint axis (tf.keras mean_squared_error)."""
    return torch.mean(torch.square(y_true - y_pred), dim=-1)


def weighted_mse(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """Pixels inside a Gaussian blob weigh 82 (81 + 1), background 1."""
    weights = (y_true > 0).float() * 81.0 + 1.0
    return torch.mean(torch.square(y_true - y_pred) * weights, dim=-1)


def iou(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """1 - the mean over keypoints of the soft IoU over the spatial axes.
    Returns (B,)."""
    inter = torch.sum(y_true * y_pred, dim=(-3, -2))
    union = (torch.sum(y_true * y_true, dim=(-3, -2))
             + torch.sum(y_pred * y_pred, dim=(-3, -2)) - inter)
    return 1.0 - torch.mean((inter + _EPSILON) / (union + _EPSILON), dim=-1)


def weighted_keypoint_mse(y_true: torch.Tensor,
                          y_pred: torch.Tensor) -> torch.Tensor:
    """MSE with the channels whose target map is empty masked out."""
    heatmap_sum = torch.sum(y_true, dim=(-3, -2), keepdim=True)
    keypoint_weights = 1.0 - (heatmap_sum == 0.0).float()
    return torch.mean(torch.square(y_true - y_pred) * keypoint_weights,
                      dim=-1)


LossFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

_REGISTRY: Dict[str, LossFn] = {
    "weighted_mse": weighted_mse,
    "weight_mean_squared_error": weighted_mse,
    "mse": mse,
    "mean_squared_error": mse,
    "iou": iou,
    "weighted_keypoint_mse": weighted_keypoint_mse,
}


def get_loss_from_string(loss_str: str) -> LossFn:
    """Name -> loss function; an unknown name raises ValueError."""
    key = loss_str.lower()
    if key not in _REGISTRY:
        raise ValueError(
            f"Unknown loss '{loss_str}'. Available: {sorted(set(_REGISTRY))}")
    return _REGISTRY[key]


def per_stack_losses(loss_fn: LossFn, y_true: torch.Tensor,
                     stack_outputs: Sequence[torch.Tensor]
                     ) -> List[torch.Tensor]:
    """Scalar loss per stack output (Keras' per-output mean)."""
    return [torch.mean(loss_fn(y_true, y_pred)) for y_pred in stack_outputs]


def total_loss(loss_fn: LossFn, y_true: torch.Tensor,
               stack_outputs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Intermediate supervision: the sum of the per-stack mean losses."""
    return torch.stack(per_stack_losses(loss_fn, y_true,
                                        stack_outputs)).sum()
