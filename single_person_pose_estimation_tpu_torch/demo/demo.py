"""Two-stage multi-person demo: external person boxes -> pose per person.

The counterpart of the JAX package's `demo/demo.py`. Reference Demo
(demo.py:12-171): YOLOv5 person detection (stage 1), then per-box
square-expand x1.25, crop_and_pad, resize 256, batch through the
hourglass, decode v2, and matplotlib rendering. Here:

  * Stage 1 is an INTERFACE, not a dependency: any callable
    `image -> [(x, y, w, h, confidence), ...]` works. `yolov5_adapter`
    wraps a torch-hub YOLOv5 model into that shape (the reference's
    detector); tests use a stub.
  * Stage 2 runs on the model's device (the card by default): every box
    is cut from the full image with one `ops/geometry.crop_and_resize`
    gather, the crops go through one forward (`models/fused_inference.py`,
    the kernels #1-#4 on the card in bfloat16 when `auto_use_fused` says
    so, the plain model otherwise), and the v2 decode runs through
    `ops/cuda/decode_kernel.py` (the decode kernel on a CUDA tensor, its
    plain version on the CPU). Only the detected boxes are processed, so
    no slot is padded or masked.

Rendering (`show`, `show_bboxes`, `show_separate`, `create_overlay`)
mirrors the reference API, including the RGBA overlay for video streaming.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from single_person_pose_estimation_tpu_torch.configs.default_config import (
    Config,
)
from single_person_pose_estimation_tpu_torch.models.fused_inference import (
    auto_use_fused,
    forward_last_stack,
    prepare_fused,
)
from single_person_pose_estimation_tpu_torch.ops.cuda.decode_kernel import (
    decode_batch,
)
from single_person_pose_estimation_tpu_torch.ops.geometry import (
    crop_and_resize,
    transform_bbox_square,
)
from single_person_pose_estimation_tpu_torch.training.steps import (
    resolve_device,
)

PersonDetector = Callable[[np.ndarray],
                          Sequence[Tuple[float, float, float, float, float]]]


def yolov5_adapter(yolo_model, conf_threshold: float = 0.0) -> PersonDetector:
    """Wrap a torch-hub YOLOv5 model (the reference's stage 1, demo.py:29-42)
    into the PersonDetector interface: RGB image -> [(x, y, w, h, conf)].

    Handles both YOLOv5 result APIs: the raw tensor `results.xyxy[0]`
    ((N, 6) rows [xmin, ymin, xmax, ymax, conf, cls], person class == 0)
    and the pandas `results.pandas().xyxy[0]` the reference uses
    (columns xmin/ymin/xmax/ymax/confidence/class/name, filtered on
    name == 'person' and confidence strictly > threshold, demo.py:32)."""

    def detect(image: np.ndarray):
        results = yolo_model(image)
        boxes = []
        xyxy = getattr(results, "xyxy", None)
        if xyxy is not None:
            rows = xyxy[0]
            if isinstance(rows, torch.Tensor):
                rows = rows.detach().cpu()
            for row in np.asarray(rows):
                xmin, ymin, xmax, ymax, conf, cls = row[:6]
                if int(cls) == 0 and conf > conf_threshold:
                    boxes.append((float(xmin), float(ymin),
                                  float(xmax - xmin), float(ymax - ymin),
                                  float(conf)))
        else:
            df = results.pandas().xyxy[0]
            df = df[(df["name"] == "person")
                    & (df["confidence"] > conf_threshold)]
            for xmin, ymin, xmax, ymax, conf in zip(
                    df["xmin"], df["ymin"], df["xmax"], df["ymax"],
                    df["confidence"]):
                boxes.append((float(xmin), float(ymin),
                              float(xmax - xmin), float(ymax - ymin),
                              float(conf)))
        return boxes

    return detect


class Demo:
    def __init__(self, person_detector: PersonDetector, keypoints_detector,
                 state=None, cfg: Config = Config(), max_num_ppl: int = 6,
                 person_conf_thres: float = 1e-6,
                 keypoints_conf_thres: float = 1e-6, *, device="cuda"):
        """keypoints_detector: the port's StackedHourglass holding its
        weights; state: None, or a TrainState whose model is used
        instead (`load_model_from_checkpoint`). The model moves to
        `device` ("cuda" raises without CUDA) and to eval mode. Stage 2
        takes the kernel path of `models/fused_inference.py` where
        `auto_use_fused` says so: on a CUDA device at a 2-byte compute
        dtype."""
        self.person_detector = person_detector
        self.device = resolve_device(device)
        if state is not None:
            keypoints_detector = state.model
        self.model = keypoints_detector.to(self.device).eval()
        self.state = state
        self.cfg = cfg
        self.max_num_ppl = max_num_ppl
        self.person_conf_thres = person_conf_thres
        self.keypoints_conf_thres = keypoints_conf_thres
        self.skeleton = cfg.skeleton
        self.use_fused = auto_use_fused(self.model, self.device)
        self._prepared = prepare_fused(self.model) if self.use_fused else None

    def stage2(self, image: torch.Tensor, boxes: torch.Tensor):
        """image (Hi, Wi, 3) float32 and boxes (P, 4) square xywh, on the
        model's device. Returns (crops (P, H, W, 3), keypoints (P, K, 3)
        crop-normalized), on the device: every crop cut from the full
        image in one gather, one forward over the crops, one decode."""
        cfg = self.cfg
        crops = crop_and_resize(image, boxes, cfg.image_height,
                                cfg.image_width)
        with torch.inference_mode():
            hms = forward_last_stack(self.model, crops,
                                     use_fused=self.use_fused, auto=True,
                                     prepared=self._prepared)
            kps = decode_batch(hms, self.keypoints_conf_thres,
                               cfg.legacy_decode)
        # Normalize to [0, 1] crop coords (demo.py:62-64).
        scale = torch.tensor([cfg.label_width, cfg.label_height, 1.0],
                             dtype=kps.dtype, device=kps.device)
        return crops, kps / scale

    # ------------------------------------------------------------------

    def detect(self, image: np.ndarray) -> None:
        """Run both stages; stash results on self (reference demo.py:25-71).

        image: RGB uint8 or float array (any size).
        """
        img = np.asarray(image)
        if img.dtype == np.uint8:
            img_f = img.astype(np.float32) / 255.0
        else:
            img_f = img.astype(np.float32)

        detections = [d for d in self.person_detector(img)
                      if d[4] > self.person_conf_thres]
        detections = detections[: self.max_num_ppl]
        bboxes = [tuple(d[:4]) for d in detections]
        square_bboxes = [
            tuple(float(v) for v in transform_bbox_square(
                bbox, self.cfg.bbox_scale))
            for bbox in bboxes]

        if bboxes:
            crops, kps = self.stage2(
                torch.from_numpy(img_f).to(self.device),
                torch.tensor(square_bboxes, dtype=torch.float32,
                             device=self.device))
            crops = crops.cpu().numpy()
            kps = kps.cpu().numpy()
        else:
            crops = np.zeros((0, self.cfg.image_height,
                              self.cfg.image_width, 3), np.float32)
            kps = np.zeros((0, self.cfg.num_keypoints, 3), np.float32)

        self.image = img
        self.cropped_images = list(crops)
        self.original_bboxes = bboxes
        self.square_bboxes = square_bboxes
        self.keypoints_list = list(kps)

    # ------------------------------------------------------------------
    # Rendering (matplotlib, mirrors demo.py:73-171)
    # ------------------------------------------------------------------

    def _plot_skeletons(self, ax, to_image_coords: bool = True):
        """Skeleton edges colored per keypoint from the config palette
        (cfg.keypoint_colors; reference visualization_utils.py:5-16 +
        COCO_KEYPOINT_COLORS, default_config.py:70-78): each edge takes the
        color of its second endpoint's keypoint, plus per-keypoint scatter
        markers in their own colors."""
        colors = self.cfg.keypoint_colors
        for keypoints, bbox in zip(self.keypoints_list, self.square_bboxes):
            xs, ys = keypoints[:, 0], keypoints[:, 1]
            for a, b in self.skeleton:
                x1, y1, x2, y2 = xs[a], ys[a], xs[b], ys[b]
                if x1 and y1 and x2 and y2:
                    if to_image_coords:
                        pts = ((x1 * bbox[2] + bbox[0], x2 * bbox[2] + bbox[0]),
                               (y1 * bbox[3] + bbox[1], y2 * bbox[3] + bbox[1]))
                    else:
                        pts = ((x1, x2), (y1, y2))
                    ax.plot(*pts, linewidth=5,
                            color=colors[int(b) % len(colors)])
            for i, (x, y) in enumerate(zip(xs, ys)):
                if x and y:
                    if to_image_coords:
                        px, py = x * bbox[2] + bbox[0], y * bbox[3] + bbox[1]
                    else:
                        px, py = x, y
                    ax.scatter(px, py, s=49, c=colors[i % len(colors)],
                               zorder=3)

    def show(self, figsize=(12, 12), show_bboxes: bool = False,
             save: bool = False, save_path: str = "saved_file.png"):
        import matplotlib.pyplot as plt
        import matplotlib.patches as patches

        fig = plt.figure(figsize=figsize)
        plt.imshow(self.image)
        ax = plt.gca()
        self._plot_skeletons(ax)
        if show_bboxes:
            for bb in self.original_bboxes:
                ax.add_patch(patches.Rectangle((bb[0], bb[1]), bb[2], bb[3],
                                               linewidth=3, edgecolor="r",
                                               facecolor="none"))
        plt.axis("off")
        if save:
            plt.savefig(save_path, bbox_inches="tight", pad_inches=0)
        plt.show()
        return fig

    def show_bboxes(self, figsize=(12, 12), show_square_bboxes: bool = False):
        import matplotlib.pyplot as plt
        import matplotlib.patches as patches

        fig = plt.figure(figsize=figsize)
        plt.imshow(self.image)
        ax = plt.gca()
        boxes = self.square_bboxes if show_square_bboxes else self.original_bboxes
        for bb in boxes:
            ax.add_patch(patches.Rectangle((bb[0], bb[1]), bb[2], bb[3],
                                           linewidth=3, edgecolor="r",
                                           facecolor="none"))
        plt.axis("off")
        plt.show()
        return fig

    def show_separate(self, figsize=(12, 12), max_per_row: int = 3):
        import matplotlib.pyplot as plt

        n = len(self.cropped_images)
        rows = int(np.ceil(n / max_per_row))
        fig = plt.figure(figsize=figsize)
        for i, (img, keypoints) in enumerate(zip(self.cropped_images,
                                                 self.keypoints_list)):
            ax = fig.add_subplot(rows, max_per_row, i + 1)
            ax.imshow(np.clip(img, 0, 1))
            xs = keypoints[:, 0] * img.shape[1]
            ys = keypoints[:, 1] * img.shape[0]
            colors = self.cfg.keypoint_colors
            for a, b in self.skeleton:
                if xs[a] and ys[a] and xs[b] and ys[b]:
                    ax.plot((xs[a], xs[b]), (ys[a], ys[b]), linewidth=5,
                            color=colors[int(b) % len(colors)])
            for k, (x, y) in enumerate(zip(xs, ys)):
                if x and y:
                    ax.scatter(x, y, s=49, c=colors[k % len(colors)],
                               zorder=3)
            ax.set_title(f"Image: {i + 1}")
            ax.axis("off")
        plt.show()
        return fig

    def create_overlay(self, figsize=(12, 12), show_bboxes: bool = False
                       ) -> np.ndarray:
        """RGBA overlay (H, W, 4) of the skeletons on transparent background
        for compositing over video frames (reference demo.py:136-171,
        without the png/cv2 round trip: rendered straight off the canvas)."""
        import matplotlib
        import matplotlib.pyplot as plt

        H, W = self.image.shape[:2]
        dpi = 100
        fig = plt.figure(figsize=(W / dpi, H / dpi), dpi=dpi)
        ax = fig.add_axes([0, 0, 1, 1])
        ax.set_xlim(0, W)
        ax.set_ylim(H, 0)
        ax.axis("off")
        fig.patch.set_alpha(0.0)
        ax.set_facecolor("none")
        self._plot_skeletons(ax)
        fig.canvas.draw()
        buf = np.array(fig.canvas.buffer_rgba())
        plt.close(fig)
        rgb = buf[:, :, :3]
        # Use the canvas's true alpha: background is (white, alpha=0).
        alpha = np.where(buf[:, :, 3] > 0, 255, 0).astype(np.uint8)
        rgb = np.where(alpha[..., None] > 0, rgb, 0).astype(np.uint8)
        overlay = np.dstack([rgb, alpha])
        if overlay.shape[:2] != (H, W):
            from single_person_pose_estimation_tpu_torch.data.images import (
                resize_bilinear,
            )
            overlay = resize_bilinear(overlay, (H, W)).astype(np.uint8)
        return overlay
