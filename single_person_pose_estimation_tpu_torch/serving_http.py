"""HTTP front end for PoseServer: a stdlib-only network serving layer.

The counterpart of the JAX package's `serving_http.py`, in front of the
port's `serving.PoseServer` (the fused forward and the decode on the
card) with the port's image helpers (`data/images.py`). The reference
has no network interface at all; this module puts an HTTP boundary in
front of the micro-batching server using only the standard library:

  POST /predict    body = JPEG/PNG bytes (Content-Type image/jpeg) or a
                   raw float32 array with X-Shape: H,W,3. Response JSON:
                   {"keypoints": [[x, y, conf] * K], "units": ...,
                    "image_size": [H, W]}; 400 on bad input.
  GET  /healthz    200 once the server is warmed and accepting requests.
  GET  /stats      PoseServer.stats() as JSON (p50/p99, batch occupancy).
  Any other route is a 404.

Concurrency model: ThreadingHTTPServer gives each request its own
thread; each handler submits ONE image and blocks on the Future. The
micro-batcher underneath coalesces whatever arrives within its
`max_wait_s` window into bucketed device steps, so batching emerges from
concurrent clients with no cooperation between them.

Units: by default keypoints are returned in input-image pixels (the
heatmap-space decode is scaled by the model's 4x label stride and then
by the original image's size, mirroring the demo's un-crop math,
demo.py:61-64); pass units="heatmap" for raw heatmap coordinates.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

import numpy as np


class HttpPoseService:
    """Serve a PoseServer over HTTP. Stdlib only; close() is idempotent.

    Args:
      pose_server: a started serving.PoseServer.
      input_size: (H, W) the model expects; uploads are resized to this.
      units: "pixels" (default) returns keypoints in the UPLOADED image's
        pixel coordinates; "heatmap" returns raw decode output.
    """

    def __init__(self, pose_server, input_size: Tuple[int, int] = (256, 256),
                 units: str = "pixels"):
        if units not in ("pixels", "heatmap"):
            raise ValueError(f"units must be 'pixels' or 'heatmap': {units!r}")
        self._pose = pose_server
        self._input_size = tuple(input_size)
        self._units = units
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    def _predict_one(self, body: bytes, content_type: str,
                     shape_header: Optional[str]):
        from single_person_pose_estimation_tpu_torch.data.images import (
            decode_jpeg,
            resize_bilinear,
        )

        if shape_header:
            shape = tuple(int(s) for s in shape_header.split(","))
            if len(shape) != 3 or shape[2] != 3 or min(shape) <= 0:
                # min(shape) guard: a -1 dim would silently make reshape
                # infer it from the body length.
                raise ValueError(f"X-Shape must be H,W,3: {shape_header!r}")
            img = np.frombuffer(body, np.float32).reshape(shape)
            orig_h, orig_w = shape[0], shape[1]
            if np.isnan(img).any():
                raise ValueError("input contains NaN")
            img = np.clip(img, 0.0, 1.0)
        else:
            img = decode_jpeg(body)  # JPEG or PNG bytes
            orig_h, orig_w = img.shape[0], img.shape[1]
            img = img.astype(np.float32) / 255.0
        if (orig_h, orig_w) != self._input_size:
            img = resize_bilinear((img * 255.0).astype(np.uint8),
                                  self._input_size).astype(np.float32) / 255.0

        kps = self._pose.submit(img).result()  # (K, 3) heatmap units
        kps = np.asarray(kps, np.float64)
        if self._units == "pixels":
            # heatmap -> model-input pixels (4x label stride) -> original
            # image pixels (the resize is uniform per axis).
            hm_h = self._input_size[0] // 4
            hm_w = self._input_size[1] // 4
            out = kps.copy()
            out[:, 0] = kps[:, 0] / hm_w * orig_w
            out[:, 1] = kps[:, 1] / hm_h * orig_h
            kps = out
        return {"keypoints": [[float(v) for v in row] for row in kps],
                "units": self._units,
                "image_size": [int(orig_h), int(orig_w)]}

    # ------------------------------------------------------------------
    def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Start serving; returns the bound port (0 = ephemeral)."""
        service = self

        class Handler(BaseHTTPRequestHandler):
            # Silence per-request stderr logging (stats() has the numbers).
            def log_message(self, *args):
                pass

            def _send(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._send(200, {"status": "ok"})
                elif self.path == "/stats":
                    self._send(200, service._pose.stats())
                else:
                    self._send(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                if self.path != "/predict":
                    self._send(404, {"error": f"no route {self.path}"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = self.rfile.read(n)
                    result = service._predict_one(
                        body, self.headers.get("Content-Type", ""),
                        self.headers.get("X-Shape"))
                    self._send(200, result)
                except Exception as e:  # bad input or closed server
                    self._send(400, {"error": f"{type(e).__name__}: {e}"})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self._httpd.server_address[1]

    def close(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
