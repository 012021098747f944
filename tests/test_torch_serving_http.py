"""The port's `HttpPoseService` against the JAX package's, over loopback,
on the same flax variables and the same uploads: JPEG at the model's size
and at 1.5x (resized on the host), and raw float32 with X-Shape, in pixel
and in heatmap units. The fixture is peaked (a bright spot on dark noise,
`peaked_variables`): every channel's maximum leads its runner-up by more
than 1e-4, which the test asserts, so x and y must be equal and the
confidences (heatmap values) agree within 1e-4. `units` and `image_size`
are equal. The mobile model (separable convs) is held the same way on
its own peaked fixture. Also the 400/404 paths, health, stats and
concurrent clients, as JAX's tests/test_serving_http.py checks them."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from single_person_pose_estimation_tpu.models.hourglass import (
    StackedHourglass as JHourglass,
)
from single_person_pose_estimation_tpu.serving import PoseServer as JServer
from single_person_pose_estimation_tpu.serving_http import (
    HttpPoseService as JHttp,
)
from single_person_pose_estimation_tpu_torch.data.images import (
    decode_jpeg,
    encode_jpeg,
    resize_bilinear,
)
from single_person_pose_estimation_tpu_torch.serving import PoseServer
from single_person_pose_estimation_tpu_torch.serving_http import (
    HttpPoseService,
)
from torch_port_fixtures import peaked_variables, torch_model

H = W = 64
TOL_CONF = 1e-4
MARGIN = 1e-4


def _spot(side, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:side, 0:side]
    cy, cx = rng.uniform(0.25 * side, 0.75 * side, 2)
    img = rng.uniform(0, 0.05, (side, side, 1)) + np.exp(
        -((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * (side / 16) ** 2))[..., None]
    return np.clip(np.repeat(img, 3, axis=2), 0, 1).astype(np.float32)


def _uploads():
    """name -> (body, headers, the model input the service makes of it)."""
    out = {}
    for name, side, seed in (("jpeg64", H, 1), ("jpeg96", 96, 2)):
        body = encode_jpeg((_spot(side, seed) * 255).astype(np.uint8))
        img = decode_jpeg(body)
        if side != H:
            img = resize_bilinear(img, (H, W))
        out[name] = (body, {"Content-Type": "image/jpeg"},
                     img.astype(np.float32) / 255.0)
    raw = _spot(H, 3)
    out["raw"] = (raw.tobytes(), {"Content-Type": "application/octet-stream",
                                  "X-Shape": f"{H},{W},3"}, raw)
    return out


UPLOADS = _uploads()


@pytest.fixture(scope="module")
def services():
    """Port and JAX services, in pixel and heatmap units, on one pose
    server each."""
    variables = peaked_variables()
    port_server = PoseServer(torch_model(variables, 1, 16), device="cpu",
                             buckets=(1, 4), use_fused=False,
                             transfer_dtype="float32")
    jax_server = JServer(JHourglass(num_stacks=1, num_channels=16),
                         variables["params"], variables["batch_stats"],
                         buckets=(1,), use_fused=False,
                         transfer_dtype="float32")
    svcs = {}
    for units in ("pixels", "heatmap"):
        for name, cls, server in (("port", HttpPoseService, port_server),
                                  ("jax", JHttp, jax_server)):
            svc = cls(server, input_size=(H, W), units=units)
            svcs[name, units] = (svc, svc.start(port=0))
    yield svcs, port_server, variables
    for svc, _ in svcs.values():
        svc.close()
    port_server.close()
    jax_server.close()


def _post(port, body, headers, path="/predict"):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body, headers=headers, method="POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as resp:
        return resp.status, json.loads(resp.read())


def test_fixture_is_peaked(services):
    """On the port's heatmaps (tests/test_torch_hourglass.py holds them
    within 1e-4 of JAX's): the gap is checked with room to spare."""
    _, _, variables = services
    x = torch.from_numpy(np.stack([u[2] for u in UPLOADS.values()]))
    with torch.no_grad():
        hms = torch_model(variables, 1, 16)(x)[-1].numpy()
    top2 = np.sort(hms.reshape(len(x), -1, 17), axis=1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() > MARGIN


@pytest.mark.parametrize("units", ["pixels", "heatmap"])
@pytest.mark.parametrize("upload", sorted(UPLOADS))
def test_responses_match_jax(services, upload, units):
    svcs, _, _ = services
    body, headers, _ = UPLOADS[upload]
    got = _post(svcs["port", units][1], body, headers)
    want = _post(svcs["jax", units][1], body, headers)
    assert got["units"] == want["units"] == units
    assert got["image_size"] == want["image_size"]
    g, w = np.asarray(got["keypoints"]), np.asarray(want["keypoints"])
    assert g.shape == w.shape == (17, 3)
    np.testing.assert_array_equal(g[:, :2], w[:, :2])
    assert np.abs(g[:, 2] - w[:, 2]).max() <= TOL_CONF
    assert (g[:, 2] > 0).all()


def test_healthz_stats_and_concurrent_clients(services):
    svcs, server, _ = services
    port = svcs["port", "pixels"][1]
    assert _get(port, "/healthz") == (200, {"status": "ok"})
    before = server.stats()["served"]
    body, headers, _ = UPLOADS["raw"]
    results = [None] * 8

    def call(i):
        results[i] = _post(port, body, headers)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert all(r == results[0] for r in results)
    status, stats = _get(port, "/stats")
    assert status == 200 and stats["served"] == before + 8
    assert stats["avg_batch"] >= 1.0


def test_bad_input_is_400_and_unknown_route_404(services):
    svcs, _, _ = services
    port = svcs["port", "pixels"][1]
    for body, headers in [
        (b"not a jpeg", {"Content-Type": "image/jpeg"}),
        (b"\x00" * 10, {"Content-Type": "application/octet-stream",
                        "X-Shape": "4,4"}),
        (np.full((4, 4, 3), np.nan, np.float32).tobytes(),
         {"Content-Type": "application/octet-stream", "X-Shape": "4,4,3"}),
        (np.zeros((4, 4, 3), np.float32).tobytes(),
         {"Content-Type": "application/octet-stream",
          "X-Shape": "-1,4,3"}),
    ]:
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(port, body, headers)
        assert exc.value.code == 400
        assert "error" in json.loads(exc.value.read())
    for path in ("/nope", "/predict/x"):
        with pytest.raises(urllib.error.HTTPError) as exc:
            _get(port, path)
        assert exc.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(port, b"", {}, path="/nope")
    assert exc.value.code == 404
    assert _get(port, "/healthz")[0] == 200


def test_bad_units_rejected():
    with pytest.raises(ValueError, match="units"):
        HttpPoseService(object(), units="degrees")
    with pytest.raises(ValueError, match="units"):
        JHttp(object(), units="degrees")


def test_closed_service_is_idempotent():
    svc = HttpPoseService(object())
    svc.start(port=0)
    svc.close()
    svc.close()


@pytest.fixture(scope="module")
def mobile_services():
    """Port and JAX services in pixel units over the mobile model, with
    tests/test_torch_mobile.py's peaked mobile variables."""
    variables = peaked_variables(seed=10, mobile=True)
    port_server = PoseServer(torch_model(variables, 1, 16, mobile=True),
                             device="cpu", buckets=(1,), use_fused=False,
                             transfer_dtype="float32")
    jax_server = JServer(JHourglass(num_stacks=1, num_channels=16,
                                    mobile=True),
                         variables["params"], variables["batch_stats"],
                         buckets=(1,), use_fused=False,
                         transfer_dtype="float32")
    svcs = {name: cls(server, input_size=(H, W))
            for name, cls, server in (("port", HttpPoseService, port_server),
                                      ("jax", JHttp, jax_server))}
    ports = {name: svc.start(port=0) for name, svc in svcs.items()}
    yield ports, variables
    for svc in svcs.values():
        svc.close()
    port_server.close()
    jax_server.close()


@pytest.mark.parametrize("upload", sorted(UPLOADS))
def test_mobile_responses_match_jax(mobile_services, upload):
    """The mobile model's fixture is peaked too (checked on the port's
    heatmaps, which tests/test_torch_mobile.py holds against JAX), so the
    keypoints must be equal and the confidences within TOL_CONF."""
    ports, variables = mobile_services
    body, headers, img = UPLOADS[upload]
    with torch.no_grad():
        hm = torch_model(variables, 1, 16, mobile=True)(
            torch.from_numpy(img[None]))[-1].numpy()
    top2 = np.sort(hm.reshape(-1, 17), axis=0)[-2:]
    assert (top2[1] - top2[0]).min() > MARGIN
    got = _post(ports["port"], body, headers)
    want = _post(ports["jax"], body, headers)
    assert got["units"] == want["units"] == "pixels"
    g, w = np.asarray(got["keypoints"]), np.asarray(want["keypoints"])
    assert g.shape == w.shape == (17, 3)
    np.testing.assert_array_equal(g[:, :2], w[:, :2])
    assert np.abs(g[:, 2] - w[:, 2]).max() <= TOL_CONF
