"""Network serving: the stdlib HTTP front end over the micro-batching
PoseServer (serving_http.HttpPoseService).

No reference-notebook counterpart — the reference has no network
interface at all. Endpoints:

    POST /predict   image bytes (JPEG/PNG) or raw float32 + X-Shape: H,W,3
                    -> {"keypoints": [[x, y, conf] * 17], ...} in the
                    uploaded image's pixel frame
    GET  /healthz   liveness
    GET  /stats     p50/p99 latency, batch occupancy, served count

Concurrent clients coalesce into bucketed micro-batches on the card with
no cooperation between them.

Usage:
    python examples_torch/serve_http.py 8080
or through the CLI:
    python -m single_person_pose_estimation_tpu_torch.cli serve --http 8080

Then:  curl -X POST --data-binary @person.jpg \
            -H 'Content-Type: image/jpeg' http://127.0.0.1:8080/predict
"""
from single_person_pose_estimation_tpu_torch.configs.default_config import (
    Config,
)
from single_person_pose_estimation_tpu_torch.models.hourglass import (
    StackedHourglass,
)
from single_person_pose_estimation_tpu_torch.serving import PoseServer
from single_person_pose_estimation_tpu_torch.serving_http import (
    HttpPoseService,
)
from single_person_pose_estimation_tpu_torch.utils.model_utils import (
    load_model_from_checkpoint,
)

if __name__ == "__main__":
    import signal
    import sys

    cfg = Config().replace(hg_num_stacks=4)
    model = StackedHourglass(num_stacks=4, num_channels=cfg.hg_num_channels)
    state, _ = load_model_from_checkpoint(model, cfg.checkpoints_path,
                                          best=True)
    server = PoseServer(state.model, device="cuda")
    server.warmup(image_shape=(cfg.image_height, cfg.image_width, 3))
    svc = HttpPoseService(server,
                          input_size=(cfg.image_height, cfg.image_width))
    port = svc.start(port=int(sys.argv[1]) if len(sys.argv) > 1 else 8080)
    print(f"Serving on http://127.0.0.1:{port} — Ctrl-C to stop")
    try:
        signal.pause()
    except KeyboardInterrupt:
        pass
    finally:
        svc.close()
        server.close()
