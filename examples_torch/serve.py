"""Production-shaped serving: a micro-batching PoseServer over images.

No reference-notebook counterpart (the reference's closest analog is the
Colab webcam loop, one synchronous predict per frame); the server pads
requests to bucketed batch sizes, sends uint8 to the card, runs the
kernel path, and reports latency and batching statistics.

Usage:
    python examples_torch/serve.py "images/*.jpg"
or through the CLI:
    python -m single_person_pose_estimation_tpu_torch.cli serve --images "..."
"""
import glob

import numpy as np

from single_person_pose_estimation_tpu_torch.configs.default_config import (
    Config,
)
from single_person_pose_estimation_tpu_torch.data.images import (
    read_image,
    resize_bilinear,
)
from single_person_pose_estimation_tpu_torch.models.hourglass import (
    StackedHourglass,
)
from single_person_pose_estimation_tpu_torch.serving import PoseServer
from single_person_pose_estimation_tpu_torch.utils.model_utils import (
    load_model_from_checkpoint,
)

if __name__ == "__main__":
    import sys

    cfg = Config().replace(hg_num_stacks=4)
    model = StackedHourglass(num_stacks=4, num_channels=cfg.hg_num_channels)
    state, _ = load_model_from_checkpoint(model, cfg.checkpoints_path,
                                          best=True)
    server = PoseServer(state.model, device="cuda", buckets=(1, 8, 32))
    server.warmup()
    futures = {}
    for path in sorted(glob.glob(sys.argv[1] if len(sys.argv) > 1
                                 else "*.jpg")):
        img = read_image(path).astype(np.float32) / 255.0
        img = resize_bilinear(img, (cfg.image_height, cfg.image_width))
        futures[path] = server.submit(img)
    for path, fut in futures.items():
        kps = fut.result()  # (17, 3): x, y, confidence in heatmap units
        print(path, np.round(np.asarray(kps), 2).tolist())
    print(server.stats())
    server.close()
