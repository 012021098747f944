"""Webcam demo loops: local OpenCV capture, plus an optional Colab bridge.

The port's copy of the JAX package's `demo/webcam.py`; each loop drives
the port's `demo.Demo`, whose stage 2 runs on the model's device.

The reference's utilities/javascript_utils.py (C13) is a Colab-only
browser-webcam bridge: embedded JS streams JPEG frames to Python, the demo
overlay is pushed back as a base64 png (javascript_utils.py:45-248). Here:

  * `run_local_webcam` — the portable equivalent: cv2.VideoCapture frame
    loop -> Demo.detect -> overlay composite -> cv2.imshow. No Colab.
  * `take_photo` / `start_video_stream` — Colab-gated equivalents of the
    reference entry points; they raise a clear error outside Colab instead
    of importing google.colab at module load.
  * `js_to_image` / `overlay_to_bytes` — the base64 codec helpers.
"""

from __future__ import annotations

import base64
from typing import Optional

import numpy as np


def js_to_image(js_reply_data: str) -> np.ndarray:
    """base64 data-URL (from the browser canvas) -> RGB uint8 image
    (javascript_utils.py:12-25)."""
    from single_person_pose_estimation_tpu_torch.data.images import decode_jpeg

    image_bytes = base64.b64decode(js_reply_data.split(",")[1])
    return decode_jpeg(image_bytes)


def overlay_to_bytes(overlay_rgba: np.ndarray) -> str:
    """RGBA overlay -> base64 png data-URL for the browser
    (javascript_utils.py:28-43)."""
    try:
        import cv2
        ok, buf = cv2.imencode(
            ".png", cv2.cvtColor(overlay_rgba, cv2.COLOR_RGBA2BGRA))
        png = bytes(buf)
    except Exception:
        import io
        from PIL import Image
        b = io.BytesIO()
        Image.fromarray(overlay_rgba, "RGBA").save(b, format="PNG")
        png = b.getvalue()
    return "data:image/png;base64," + base64.b64encode(png).decode()


def _require_colab():
    try:
        from google.colab.output import eval_js  # noqa: F401
        from IPython.display import Javascript, display  # noqa: F401
    except Exception as e:
        raise RuntimeError(
            "Colab webcam bridge requires google.colab; use "
            "run_local_webcam() outside Colab.") from e


def take_photo(demo, quality: float = 0.8):
    """Single browser-webcam shot -> demo.detect -> demo.show
    (javascript_utils.py:45-85). Colab only."""
    _require_colab()
    from google.colab.output import eval_js
    from IPython.display import Javascript, display

    display(Javascript(_CAPTURE_JS))
    data = eval_js(f"takePhoto({quality})")
    image = js_to_image(data)
    demo.detect(image)
    demo.show()
    return image


def start_video_stream(demo, max_frames: Optional[int] = None):
    """Continuous browser-webcam loop pushing skeleton overlays back onto
    the video (javascript_utils.py:226-248). Colab only."""
    _require_colab()
    from google.colab.output import eval_js
    from IPython.display import Javascript, display

    display(Javascript(_STREAM_JS))
    eval_js("startStream()")
    overlay_data = ""
    n = 0
    while max_frames is None or n < max_frames:
        reply = eval_js(f'streamFrame("{overlay_data}")')
        if not reply:
            break
        image = js_to_image(reply)
        demo.detect(image)
        overlay_data = overlay_to_bytes(demo.create_overlay())
        n += 1


def run_local_webcam(demo, camera_index: int = 0,
                     max_frames: Optional[int] = None,
                     display: bool = True):
    """Local webcam loop (the non-Colab path the reference lacked):
    capture -> detect -> composite overlay -> imshow. Esc quits."""
    import cv2

    cap = cv2.VideoCapture(camera_index)
    if not cap.isOpened():
        raise RuntimeError(f"cannot open camera {camera_index}")
    n = 0
    try:
        while max_frames is None or n < max_frames:
            ok, frame_bgr = cap.read()
            if not ok:
                break
            frame = cv2.cvtColor(frame_bgr, cv2.COLOR_BGR2RGB)
            demo.detect(frame)
            overlay = demo.create_overlay()
            alpha = overlay[:, :, 3:4].astype(np.float32) / 255.0
            comp = (frame.astype(np.float32) * (1 - alpha)
                    + overlay[:, :, :3].astype(np.float32) * alpha
                    ).astype(np.uint8)
            if display:
                cv2.imshow("pose", cv2.cvtColor(comp, cv2.COLOR_RGB2BGR))
                if cv2.waitKey(1) & 0xFF == 27:
                    break
            n += 1
    finally:
        cap.release()
        if display:
            cv2.destroyAllWindows()
    return n


# Minimal JS payloads for the Colab bridge (DOM video+canvas capture).
_CAPTURE_JS = r"""
async function takePhoto(quality) {
  const video = document.createElement('video');
  const stream = await navigator.mediaDevices.getUserMedia({video: true});
  document.body.appendChild(video);
  video.srcObject = stream;
  await video.play();
  await new Promise(r => setTimeout(r, 300));
  const canvas = document.createElement('canvas');
  canvas.width = video.videoWidth;
  canvas.height = video.videoHeight;
  canvas.getContext('2d').drawImage(video, 0, 0);
  stream.getVideoTracks()[0].stop();
  video.remove();
  return canvas.toDataURL('image/jpeg', quality);
}
"""

_STREAM_JS = r"""
var _spe_video = null, _spe_canvas = null, _spe_overlay = null;
async function startStream() {
  _spe_video = document.createElement('video');
  const stream = await navigator.mediaDevices.getUserMedia({video: true});
  _spe_video.srcObject = stream;
  document.body.appendChild(_spe_video);
  await _spe_video.play();
  _spe_canvas = document.createElement('canvas');
  _spe_overlay = document.createElement('img');
  _spe_overlay.style.position = 'absolute';
  document.body.appendChild(_spe_overlay);
}
async function streamFrame(overlayData) {
  if (!_spe_video) return '';
  if (overlayData) _spe_overlay.src = overlayData;
  _spe_canvas.width = _spe_video.videoWidth;
  _spe_canvas.height = _spe_video.videoHeight;
  _spe_canvas.getContext('2d').drawImage(_spe_video, 0, 0);
  return _spe_canvas.toDataURL('image/jpeg', 0.8);
}
"""


def run_on_video(demo, input_path: str, output_path: Optional[str] = None,
                 max_frames: Optional[int] = None) -> int:
    """Process a video FILE frame by frame: detect -> overlay composite;
    optionally write the annotated video (the offline counterpart of the
    reference's live webcam loop). Returns frames processed."""
    import cv2

    cap = cv2.VideoCapture(input_path)
    if not cap.isOpened():
        raise RuntimeError(f"cannot open video {input_path}")
    writer = None
    n = 0
    try:
        while max_frames is None or n < max_frames:
            ok, frame_bgr = cap.read()
            if not ok:
                break
            frame = cv2.cvtColor(frame_bgr, cv2.COLOR_BGR2RGB)
            demo.detect(frame)
            overlay = demo.create_overlay()
            alpha = overlay[:, :, 3:4].astype(np.float32) / 255.0
            comp = (frame.astype(np.float32) * (1 - alpha)
                    + overlay[:, :, :3].astype(np.float32) * alpha
                    ).astype(np.uint8)
            if output_path is not None:
                if writer is None:
                    fps = cap.get(cv2.CAP_PROP_FPS) or 24.0
                    writer = cv2.VideoWriter(
                        output_path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                        (comp.shape[1], comp.shape[0]))
                writer.write(cv2.cvtColor(comp, cv2.COLOR_RGB2BGR))
            n += 1
    finally:
        cap.release()
        if writer is not None:
            writer.release()
    return n
