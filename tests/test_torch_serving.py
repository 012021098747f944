"""Port PoseServer on device="cpu": answers equal fused forward + decode on
the same batch, pads to buckets, resolves every future on close(), and
refuses work after close()."""

import numpy as np
import pytest
import torch

from single_person_pose_estimation_tpu_torch.models.fused_inference import (
    fused_apply,
    prepare_fused,
)
from single_person_pose_estimation_tpu_torch.ops.decode import decode_batch
from single_person_pose_estimation_tpu_torch.parallel.mesh import create_mesh
from single_person_pose_estimation_tpu_torch.serving import PoseServer
from torch_port_fixtures import images, random_variables, torch_model


@pytest.fixture(scope="module")
def model():
    return torch_model(random_variables(1, 16, seed=11), 1, 16)


def _expected(model, imgs, wire):
    """fused forward + decode of the batch as the server's wire sees it."""
    x = torch.from_numpy(imgs)
    if wire == "uint8":
        x = torch.from_numpy(np.clip(imgs * 255 + .5, 0, 255)
                             .astype(np.uint8)).float() / 255.0
    hm = fused_apply(prepare_fused(model), x, fuse_levels=True,
                     pool_fuse_max_h=32, fuse_heads=True)[-1]
    return decode_batch(hm).numpy()


@pytest.mark.parametrize("wire", ["uint8", "float32"])
def test_server_answers_equal_fused_plus_decode(model, wire):
    imgs = images(6, seed=12)
    with PoseServer(model, device="cpu", buckets=(1, 4, 8), use_fused=True,
                    transfer_dtype=wire) as server:
        assert server.use_fused
        got = server.predict(imgs)
        single = server.submit(imgs[0]).result(timeout=60)
    assert got.shape == (6, 17, 3) and got.dtype == np.float32
    want = _expected(model, imgs, wire)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(single, want[0], atol=1e-5)


def test_server_pads_to_buckets(model):
    server = PoseServer(model, device="cpu", buckets=(1, 4, 8),
                        max_wait_s=0.5, use_fused="auto")
    assert not server.use_fused       # auto: plain model on the CPU
    seen = []
    step = server._step
    server._step = lambda x: (seen.append(x.shape[0]), step(x))[1]
    imgs = images(7, seed=13)
    futs = [server.submit(im) for im in imgs[:3]]
    [f.result(timeout=60) for f in futs]
    futs = [server.submit(im) for im in imgs[3:]]
    [f.result(timeout=60) for f in futs]
    server.close()
    assert set(seen) <= {1, 4, 8} and sum(seen) >= 7
    assert 4 in seen                  # three requests padded to bucket 4
    st = server.stats()
    assert st["served"] == 7 and st["steps"] == len(seen)
    assert st["latency_p50_ms"] is not None


def test_close_resolves_every_future_and_refuses_submits(model):
    server = PoseServer(model, device="cpu", buckets=(1, 2), max_wait_s=0.0)
    futs = [server.submit(im) for im in images(5, seed=14)]
    server.close()
    for f in futs:
        assert f.done()
        assert f.result().shape == (17, 3)
    with pytest.raises(RuntimeError, match="closed"):
        server.submit(images(1)[0])
    server.close()                    # idempotent


def test_step_failure_reaches_the_caller(model):
    with PoseServer(model, device="cpu", buckets=(1,)) as server:
        fut = server.submit(np.zeros((96, 96, 3), np.float32))
        with pytest.raises(ValueError, match="divisible by 64"):
            fut.result(timeout=60)


def test_constructor_checks():
    m = torch_model(random_variables(1, 16, seed=15), 1, 16)
    with pytest.raises(NotImplementedError, match="mesh axes"):
        create_mesh((-1, 2), ("model", "data"), devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="a device or a mesh"):
        PoseServer(m)
    with pytest.raises(ValueError, match="ascending"):
        PoseServer(m, device="cpu", buckets=(4, 1))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            PoseServer(m, device="cuda")


def test_concurrent_submitters_all_resolve(model):
    """Many client threads submitting at once, with frequent thread
    switches: every future resolves once and the served count adds up."""
    import sys
    import threading

    imgs = images(4, seed=16)
    results, errors = [], []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with PoseServer(model, device="cpu", buckets=(1, 4, 16),
                        max_wait_s=0.001) as server:
            def client(k):
                try:
                    futs = [server.submit(imgs[(k + j) % 4])
                            for j in range(4)]
                    results.extend(f.result(timeout=120) for f in futs)
                except Exception as e:  # reported by the assert below
                    errors.append(e)

            threads = [threading.Thread(target=client, args=(k,))
                       for k in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
        assert server.stats()["served"] == 64
    finally:
        sys.setswitchinterval(old)
    assert not errors and len(results) == 64
    assert all(r.shape == (17, 3) for r in results)
