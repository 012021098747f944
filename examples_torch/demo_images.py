"""demo.ipynb equivalent: two-stage multi-person pose on an image.

Stage 1 needs a person detector. With torch-hub YOLOv5 available:
    import torch
    yolo = torch.hub.load("ultralytics/yolov5", "yolov5s")
    detector = yolov5_adapter(yolo)
Any callable image -> [(x, y, w, h, conf)] works (here: full-image box).
"""
from single_person_pose_estimation_tpu_torch.configs.default_config import (
    Config,
)
from single_person_pose_estimation_tpu_torch.data.images import read_image
from single_person_pose_estimation_tpu_torch.demo.demo import (  # noqa: F401
    Demo,
    yolov5_adapter,
)
from single_person_pose_estimation_tpu_torch.models.hourglass import (
    StackedHourglass,
)
from single_person_pose_estimation_tpu_torch.utils.model_utils import (
    load_model_from_checkpoint,
)

if __name__ == "__main__":
    import sys

    cfg = Config().replace(hg_num_stacks=4)
    model = StackedHourglass(num_stacks=4, num_channels=cfg.hg_num_channels)
    state, _ = load_model_from_checkpoint(model, cfg.checkpoints_path,
                                          best=True)

    def whole_image_detector(image):
        h, w = image.shape[:2]
        return [(0.0, 0.0, float(w), float(h), 1.0)]

    demo = Demo(whole_image_detector, model, state, cfg)
    image = read_image(sys.argv[1] if len(sys.argv) > 1 else "person.jpg")
    demo.detect(image)
    demo.show(show_bboxes=True, save=True, save_path="pose_overlay.png")
