"""The port's two-stage demo (`demo/demo.py`) against the JAX package's
`Demo.detect` on the CPU, with a stub person detector and the same flax
variables: crops within 1e-5, keypoint x and y equal and confidences
within 1e-4 on a peaked fixture (bright spots on dark noise,
`peaked_variables`; the test asserts every channel's top-two gap), for
boxes inside and partly outside the frame, fractional boxes, square
boxes, truncation to `max_num_ppl` and no person (a box wholly outside
is tests/test_torch_geometry.py's). Also the rendering paths, the
overlay's alpha, the webcam codec round trip, the Colab gates,
`run_on_video` and `yolov5_adapter`, as JAX's tests/test_demo.py checks
them."""

import base64
import os
import types

import matplotlib

matplotlib.use("Agg")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from single_person_pose_estimation_tpu.configs.default_config import (  # noqa: E402
    Config as JConfig,
)
from single_person_pose_estimation_tpu.demo.demo import Demo as JDemo  # noqa: E402
from single_person_pose_estimation_tpu.models.hourglass import (  # noqa: E402
    StackedHourglass as JHourglass,
)
from single_person_pose_estimation_tpu_torch import Config  # noqa: E402
from single_person_pose_estimation_tpu_torch.data.images import (  # noqa: E402
    encode_jpeg,
)
from single_person_pose_estimation_tpu_torch.demo import webcam  # noqa: E402
from single_person_pose_estimation_tpu_torch.demo.demo import (  # noqa: E402
    Demo,
    yolov5_adapter,
)
from single_person_pose_estimation_tpu_torch.ops.geometry import (  # noqa: E402
    crop_and_resize,
)
from torch_port_fixtures import peaked_variables, torch_model  # noqa: E402

SMALL = dict(image_height=64, image_width=64, label_height=16,
             label_width=16, hg_num_stacks=1, hg_num_channels=16)
CFG = Config(**SMALL)
TOL_CROP = 1e-5
TOL_CONF = 1e-4
MARGIN = 1e-4
# (x, y, w, h, confidence): inside, partly outside (left/top and
# right/bottom), fractional, below the person threshold.
BOXES = [(30.0, 20.0, 40.0, 60.0, 0.9),
         (-12.5, -8.0, 36.0, 30.0, 0.8),
         (131.3, 92.7, 45.2, 40.9, 0.7),
         (0.0, 0.0, 5.0, 5.0, 1e-9)]
YOLO_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "fixtures", "yolov5_xyxy.npz")


def spot_image(h=120, w=160, seed=0):
    """Dark noise with a bright Gaussian spot in each person box."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = rng.uniform(0, 0.05, (h, w))
    for x, y, bw, bh, _ in BOXES[:3]:
        cx = np.clip(x + bw * rng.uniform(0.3, 0.7), 2, w - 3)
        cy = np.clip(y + bh * rng.uniform(0.3, 0.7), 2, h - 3)
        img += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 4.0 ** 2))
    img = np.repeat(img[..., None], 3, axis=2)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def variables():
    return peaked_variables()


@pytest.fixture(scope="module")
def demos(variables):
    """One port and one JAX demo; both detectors read `boxes[0]`."""
    boxes = [BOXES]
    detector = lambda image: boxes[0]  # noqa: E731
    state = types.SimpleNamespace(params=variables["params"],
                                  batch_stats=variables["batch_stats"])
    jdemo = JDemo(detector, JHourglass(num_stacks=1, num_channels=16), state,
                  JConfig(**SMALL), max_num_ppl=4)
    demo = Demo(detector, torch_model(variables, 1, 16), None, CFG,
                max_num_ppl=4, device="cpu")
    return demo, jdemo, boxes


def _compare(demo, jdemo, image):
    demo.detect(image)
    jdemo.detect(image)
    assert demo.original_bboxes == jdemo.original_bboxes
    assert demo.square_bboxes == jdemo.square_bboxes
    assert len(demo.cropped_images) == len(jdemo.cropped_images)
    for c, jc in zip(demo.cropped_images, jdemo.cropped_images):
        assert c.shape == (64, 64, 3)
        assert np.abs(c - jc).max() <= TOL_CROP
    for k, jk in zip(demo.keypoints_list, jdemo.keypoints_list):
        assert k.shape == (17, 3)
        np.testing.assert_array_equal(k[:, :2], jk[:, :2])
        assert np.abs(k[:, 2] - jk[:, 2]).max() <= TOL_CONF


def test_detect_matches_jax_on_a_peaked_fixture(demos):
    demo, jdemo, boxes = demos
    boxes[0] = BOXES
    image = spot_image()
    _compare(demo, jdemo, image)
    assert len(demo.keypoints_list) == 3        # sub-threshold box dropped
    # The fixture is peaked on the port's heatmaps of these crops.
    crops = torch.from_numpy(np.stack(demo.cropped_images))
    with torch.no_grad():
        hms = demo.model(crops)[-1].numpy()
    top2 = np.sort(hms.reshape(3, -1, 17), axis=1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() > MARGIN
    kps = np.stack(demo.keypoints_list)
    assert (kps[..., 2] > 0).all() and (kps[..., :2] <= 1.0).all()
    # The crops are the geometry module's, one box at a time.
    img_f = torch.from_numpy(image.astype(np.float32) / 255.0)
    for crop, sq in zip(demo.cropped_images, demo.square_bboxes):
        want = crop_and_resize(img_f, torch.tensor(sq), 64, 64).numpy()
        assert np.abs(crop - want).max() <= TOL_CROP


def test_square_boxes_truncation_and_float_input(demos):
    demo, jdemo, boxes = demos
    x, y, w, h, _ = BOXES[0]
    boxes[0] = BOXES
    demo.detect(np.zeros((120, 160, 3), np.uint8))
    sx, sy, sw, sh = demo.square_bboxes[0]
    assert sw == sh == pytest.approx(max(w, h) * CFG.bbox_scale)
    assert (sx + sw / 2, sy + sh / 2) == pytest.approx((x + w / 2, y + h / 2))
    boxes[0] = [(5.0 * i, 5.0, 20.0, 30.0, 0.9) for i in range(10)]
    image = spot_image(seed=1).astype(np.float32) / 255.0
    _compare(demo, jdemo, image)
    assert len(demo.original_bboxes) == 4


def test_no_person(demos):
    demo, jdemo, boxes = demos
    boxes[0] = []
    _compare(demo, jdemo, spot_image())
    assert demo.keypoints_list == [] and demo.cropped_images == []
    assert demo.create_overlay().shape == (120, 160, 4)


def test_rendering_paths_and_overlay_alpha(demos):
    import matplotlib.pyplot as plt

    demo, _, boxes = demos
    boxes[0] = BOXES
    demo.detect(spot_image())
    for fig in (demo.show(figsize=(3, 3), show_bboxes=True),
                demo.show_bboxes(figsize=(3, 3), show_square_bboxes=True),
                demo.show_separate(figsize=(3, 3))):
        plt.close(fig)
    overlay = demo.create_overlay()
    assert overlay.shape == (120, 160, 4) and overlay.dtype == np.uint8
    assert (overlay[:, :, 3] == 0).any()
    assert (overlay[:, :, 3] == 255).any()
    assert not overlay[overlay[:, :, 3] == 0, :3].any()


def test_webcam_codec_round_trip_and_colab_gates(demos):
    img = np.random.default_rng(2).integers(0, 255, (32, 32, 3)).astype(
        np.uint8)
    data = "data:image/jpeg;base64," + base64.b64encode(
        encode_jpeg(img)).decode()
    assert webcam.js_to_image(data).shape == (32, 32, 3)
    overlay = np.zeros((16, 16, 4), np.uint8)
    overlay[4:8, 4:8] = [255, 0, 0, 255]
    s = webcam.overlay_to_bytes(overlay)
    assert s.startswith("data:image/png;base64,")
    back = webcam.js_to_image(s)
    assert back.shape == (16, 16, 3) and back[5, 5, 0] == 255
    demo = demos[0]
    with pytest.raises(RuntimeError, match="Colab"):
        webcam.take_photo(demo)
    with pytest.raises(RuntimeError, match="Colab"):
        webcam.start_video_stream(demo)


def test_run_on_video(tmp_path, demos):
    import cv2

    demo, _, boxes = demos
    boxes[0] = BOXES[:1]
    src = str(tmp_path / "in.mp4")
    w = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"mp4v"), 10, (96, 64))
    rng = np.random.default_rng(0)
    for _ in range(3):
        w.write(rng.integers(0, 255, (64, 96, 3)).astype(np.uint8))
    w.release()
    out = str(tmp_path / "out.mp4")
    assert webcam.run_on_video(demo, src, out, max_frames=2) == 2
    cap = cv2.VideoCapture(out)
    ok, frame = cap.read()
    cap.release()
    assert ok and frame.shape == (64, 96, 3)


def test_yolov5_adapter_tensor_api():
    data = np.load(YOLO_FIXTURE)

    class StubResults:
        xyxy = [torch.from_numpy(data["xyxy"])]

    boxes = yolov5_adapter(lambda img: StubResults(), conf_threshold=0.25)(
        np.zeros((480, 640, 3), np.uint8))
    assert len(boxes) == 3
    x, y, w, h, conf = boxes[0]
    np.testing.assert_allclose((x, y), (105.31, 80.24), rtol=1e-5)
    np.testing.assert_allclose((w, h), (215.66 - 105.31, 410.88 - 80.24),
                               rtol=1e-5)
    assert conf == pytest.approx(0.9213, rel=1e-5)


def test_the_device_defaults_to_cuda(variables):
    model = torch_model(variables, 1, 16)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Demo(lambda im: [], model, None, CFG)
    demo = Demo(lambda im: [], model, None, CFG, device="cpu")
    assert demo.device == torch.device("cpu") and not demo.use_fused
