"""The decode kernel's wrapper (`ops/cuda/decode_kernel.decode_batch`) on
the CPU, where it runs its plain version, against the JAX package's
Pallas decode kernel `decode_batch_pallas` in interpret mode: exact
equality on peaked, tied, border-peak, below-threshold, random and
sigmoid-of-bf16 maps, legacy and corrected, at 16x16 and 64x64. The same
wrapper launches `csrc/decode.cu` on a CUDA tensor; chip_smoke.py and
tests/test_torch_cuda_kernels.py hold that one against this plain version
on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from single_person_pose_estimation_tpu.experimental.decode_kernel import (
    decode_batch_pallas,
)
from single_person_pose_estimation_tpu_torch.ops.cuda import decode_kernel

K = 17


def decode_cases(size, seed=0):
    """(B, size, size, K) float32 maps, one kind of case per image."""
    rng = np.random.default_rng(seed)
    s = size - 1
    hm = rng.uniform(0, 0.2, (9, size, size, K)).astype(np.float32)
    # 0-1: one peak per channel, on every border and corner and inside,
    # with a runner-up neighbour in a channel-dependent direction.
    peaks = [(0, 0), (0, s), (s, 0), (s, s), (0, size // 2), (s, size // 3),
             (size // 3, 0), (2 * size // 3, s), (size // 2, size // 2),
             (3, size - 4)]
    for b in range(2):
        for k in range(K):
            py, px = peaks[(k + b) % len(peaks)]
            hm[b, py, px, k] = 0.9
            ny = min(max(py + (k % 3) - 1, 0), s)
            nx = min(max(px + (k // 3) % 3 - 1, 0), s)
            if (ny, nx) != (py, px):
                hm[b, ny, nx, k] = 0.6
    # 2: tied maxima in the map, and tied neighbours around a peak.
    hm[2] = 0.1
    hm[2, 4, 4] = 0.8
    hm[2, s - 2, 2] = 0.8
    hm[2, 4, 5] = 0.5
    hm[2, 5, 4] = 0.5
    hm[3] = np.round(hm[3] * 4) / 4              # many ties everywhere
    hm[4] = 0.0                                  # below threshold: zeroed
    hm[4, 0, 1, ::2] = 0.7                       # border peak, 2-wide patch
    hm[5] = 0.3                                  # flat: every pixel tied
    hm[6] = rng.uniform(0, 1, (size, size, K))   # random
    # 7: sigmoid of bf16-rounded logits, as a bf16 head gives: many exact
    # ties, among them at the peak.
    logits = torch.from_numpy(rng.normal(0, 3, (size, size, K)).astype(
        np.float32)).to(torch.bfloat16)
    hm[7] = torch.sigmoid(logits.float()).numpy()
    hm[8] = -rng.uniform(0, 1, (size, size, K))  # all negative: zeroed
    return hm


@pytest.mark.parametrize("size", [16, 64])
@pytest.mark.parametrize("legacy", [True, False], ids=["legacy", "corrected"])
def test_plain_route_matches_pallas_kernel_exactly(size, legacy):
    hm = decode_cases(size)
    want = np.asarray(decode_batch_pallas(jnp.asarray(hm), legacy=legacy,
                                          interpret=True))
    before = decode_kernel.decode_batch.launches
    got = decode_kernel.decode_batch(torch.from_numpy(hm), legacy=legacy)
    assert decode_kernel.decode_batch.launches == before  # CPU: no kernel
    assert got.shape == (9, K, 3) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # The cases reach what they are for: zeroed images, border peaks.
    assert not want[4, 1::2].any() and not want[8].any()
    assert (want[1, :, :2] == 0).any() or (want[0, :, :2] == 0).any()


def test_threshold_and_input_dtypes():
    hm = decode_cases(16, seed=1)
    want = np.asarray(decode_batch_pallas(jnp.asarray(hm),
                                          conf_threshold=0.5,
                                          interpret=True))
    got = decode_kernel.decode_batch(torch.from_numpy(hm), 0.5)
    np.testing.assert_array_equal(got.numpy(), want)
    # Another float dtype is decoded in float32, as the Pallas kernel casts.
    half = torch.from_numpy(hm).to(torch.bfloat16)
    np.testing.assert_array_equal(
        decode_kernel.decode_batch(half).numpy(),
        np.asarray(decode_batch_pallas(jnp.asarray(half.float().numpy()),
                                       interpret=True)))
    with pytest.raises(TypeError):
        decode_kernel.decode_batch(torch.zeros((1, 4, 4, K), dtype=torch.int32))
    with pytest.raises(ValueError):
        decode_kernel.decode_batch(torch.zeros((4, 4, K)))
