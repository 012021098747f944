"""Deployment export: self-contained inference artifacts.

The counterpart of the JAX package's `utils/export.py`. Reference
equivalent: save_model.ipynb exports a Keras SavedModel from a weights
checkpoint. Here:

  * `save_inference_artifact` writes `<path>/config.json` and
    `<path>/weights.pt` (`torch.save` of the model's `state_dict`, in
    place of the JAX package's Orbax checkpoint); `load_inference_artifact`
    rebuilds the model from the config alone and returns a predict
    function of the last stack's heatmaps.
  * `export_savedmodel` (the JAX package's jax2tf SavedModel; the name is
    kept for the CLI's `--savedmodel`) writes `<path>/model.pt2`, a
    `torch.export` program of the same last-stack forward, plus
    `<path>/config.json`. Without a batch size its batch dimension is
    dynamic, as the JAX SavedModel is batch-polymorphic.
  * `export_tflite` raises: torch has no installed converter to TFLite.

Every exported forward is the PLAIN model (`StackedHourglass.forward`,
cuDNN on the card): the port calls its CUDA kernels through ctypes,
which `torch.export` cannot trace. This matches the JAX package, whose
jax2tf export converts `model.apply`, not the Pallas kernels.
"""

from __future__ import annotations

import os
from typing import Callable, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from single_person_pose_estimation_tpu_torch.configs.default_config import (
    Config,
)
from single_person_pose_estimation_tpu_torch.models.hourglass import (
    StackedHourglass,
)
from single_person_pose_estimation_tpu_torch.training.steps import (
    resolve_device,
)

WEIGHTS = "weights.pt"
PROGRAM = "model.pt2"
# The largest batch of a dynamic-batch program: the guards that torch.export
# derives from the model's ops on the card admit no more.
MAX_BATCH = 65535
TFLITE_UNAVAILABLE = (
    "TFLite export is not available in the PyTorch port: torch has no "
    "installed converter to TFLite. Use --savedmodel (a torch.export "
    "program) or the JAX package's export for TFLite.")


def model_from_config(cfg: Config, front_s2d: bool = False
                      ) -> StackedHourglass:
    """The StackedHourglass a config describes (fresh weights)."""
    return StackedHourglass(
        num_classes=cfg.num_keypoints,
        num_stacks=cfg.hg_num_stacks,
        num_channels=cfg.hg_num_channels,
        predict_activation=cfg.hm_activation,
        mobile=cfg.mobile,
        compute_dtype=torch.bfloat16 if cfg.compute_dtype == "bfloat16"
        else torch.float32,
        front_s2d=front_s2d,
    )


def _state_dict(weights: Union[torch.nn.Module, Mapping]) -> dict:
    if isinstance(weights, torch.nn.Module):
        weights = weights.state_dict()
    return {k: v.detach().cpu() for k, v in weights.items()}


def _write_config(cfg: Config, path: str) -> str:
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        f.write(cfg.to_json())
    return path


def _read_config(path: str) -> Config:
    with open(os.path.join(path, "config.json")) as f:
        return Config.from_json(f.read())


def save_inference_artifact(cfg: Config,
                            weights: Union[torch.nn.Module, Mapping],
                            path: str) -> None:
    """Write <path>/{config.json, weights.pt}: everything needed to serve.
    `weights` is the model holding them, or its state_dict."""
    path = _write_config(cfg, path)
    torch.save(_state_dict(weights), os.path.join(path, WEIGHTS))


def load_inference_artifact(path: str, device="cuda"
                            ) -> Tuple[StackedHourglass, dict, Callable]:
    """Load an artifact -> (model, state_dict, predict), on `device`
    ("cuda" raises without CUDA).

    `predict` maps (B, H, W, 3) float images in [0, 1] (a tensor or a
    numpy array) to the LAST stack's heatmaps (B, H/4, W/4, K) on the
    device, through the plain model (the JAX function's
    `model.apply(...)[-1]`, the eval.py:108 convention).
    """
    device = resolve_device(device)
    path = os.path.abspath(path)
    cfg = _read_config(path)
    state_dict = torch.load(os.path.join(path, WEIGHTS), map_location="cpu",
                            weights_only=True)
    model = model_from_config(cfg)
    model.load_state_dict(state_dict)
    model = model.to(device).eval()

    def predict(images):
        x = torch.as_tensor(np.asarray(images) if not isinstance(
            images, torch.Tensor) else images).to(device, torch.float32)
        with torch.inference_mode():
            return model(x)[-1]

    return model, state_dict, predict


class LastStack(torch.nn.Module):
    """The inference forward every exported program holds: images in
    [0, 1] -> the last stack's heatmaps."""

    def __init__(self, model: StackedHourglass):
        super().__init__()
        self.model = model

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.model(images)[-1]


def export_savedmodel(cfg: Config, weights: Union[torch.nn.Module, Mapping],
                      path: str, batch_size: Optional[int] = None,
                      device="cuda") -> str:
    """Write <path>/model.pt2, a `torch.export` program of the plain
    last-stack forward (see the module docstring), and
    <path>/config.json. Returns the program's path.

    batch_size None -> a dynamic batch dimension (1 to MAX_BATCH);
    otherwise the program takes that batch only. The program is traced on
    `device` ("cuda" raises without CUDA), and its weights and constants
    live there; `load_exported` loads it.
    """
    device = resolve_device(device)
    model = model_from_config(cfg)
    model.load_state_dict(_state_dict(weights))
    model = LastStack(model.to(device).eval())
    example = torch.zeros((batch_size or 2, cfg.image_height,
                           cfg.image_width, 3), device=device)
    dynamic = None
    if batch_size is None:
        dynamic = ({0: torch.export.Dim("batch", min=1, max=MAX_BATCH)},)
    with torch.no_grad():
        program = torch.export.export(model, (example,),
                                      dynamic_shapes=dynamic)
    path = _write_config(cfg, path)
    out = os.path.join(path, PROGRAM)
    torch.export.save(program, out)
    return out


def load_exported(path: str) -> torch.nn.Module:
    """The callable module of <path>/model.pt2: images (B, H, W, 3) ->
    last-stack heatmaps."""
    return torch.export.load(os.path.join(path, PROGRAM)).module()


def export_tflite(cfg: Config, weights, path: str, batch_size: int = 1,
                  quantize: Optional[str] = None,
                  representative_images=None) -> int:
    """Not available in the port: torch has no installed TFLite
    converter (the JAX package converts through TensorFlow's)."""
    raise NotImplementedError(TFLITE_UNAVAILABLE)
