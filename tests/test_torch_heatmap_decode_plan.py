"""The launch plans of the heatmap render (#12, `heatmap_geometry` of
`ops/cuda/heatmap_kernel.py`) and of the decode (#13, `decode_geometry`
of `ops/cuda/decode_kernel.py`), which the wrappers pass to
`csrc/heatmap.cu` and `csrc/decode.cu` as integers, and a numpy
emulation of each kernel's partition on those plans:

* #12: every output element is stored exactly once, 16-byte stores
  start on 16 bytes, and the emulated values (each chunk zeroed, then
  one item a (keypoint, row, column) of a window, each into its own
  slot) match the plain version;
* #13: every (pixel, k) of an image is read by exactly one lane slot,
  each slot keeps to one keypoint, and combining the slots' running
  (max, first index) in the kernel's order (a block's groups, then a
  keypoint's slots of a row in the first block and in the cluster's
  other blocks) gives the plain first
  argmax, and with the patch step the plain decode exactly, on tied,
  flat, border-peak, quantized and all -inf maps.

And both wrappers, on the CPU (their plain versions), against the JAX
package at these shapes: the Pallas kernels in interpret mode (#12 at
ATOL_HEATMAP, #13 exactly, where the Pallas decode agrees with the JAX
package's own plain decode) and the JAX plain decode exactly. The kernels
themselves run only on the card (`tests/test_torch_cuda_kernels.py`)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from single_person_pose_estimation_tpu.experimental.decode_kernel import (
    decode_batch_pallas,
)
from single_person_pose_estimation_tpu.experimental.heatmap_kernel import (
    render_heatmaps_batch_pallas,
)
from single_person_pose_estimation_tpu.ops import decode as jdecode
from single_person_pose_estimation_tpu_torch.ops.cuda import (
    bottleneck_kernel as bk,
    decode_kernel as dk,
    heatmap_kernel as hk,
)

ATOL_HEATMAP = 1e-6   # the two exp implementations may round an ulp apart
NO_KEYPOINT = np.iinfo(np.int32).min

# (B, H, W, K, sigma): K = 1, 16, 17; 16, 32 and 64 px; non-square maps;
# sigma 2 (radius 6); W*K and H*W*K not a multiple of 4.
HEATMAP_SHAPES = [(1, 32, 32, 1, 2.0), (2, 16, 16, 16, 1.0),
                  (3, 64, 64, 17, 1.0), (1, 32, 32, 17, 2.0),
                  (2, 16, 32, 17, 1.0), (2, 48, 20, 16, 2.0),
                  (2, 17, 33, 17, 1.0), (1, 20, 15, 3, 2.0)]
DECODE_SHAPES = [(2, 16, 16, 1), (3, 32, 32, 16), (2, 64, 64, 17),
                 (3, 16, 32, 17), (2, 32, 16, 17), (2, 13, 7, 33),
                 (2, 15, 15, 17), (1, 1, 1, 17), (2, 1, 9, 5)]


def _keypoints(rng, b, k, h, w):
    """Uniform keypoints plus the border, negative and invisible cases."""
    kx = rng.uniform(-3, w + 3, (b, k)).astype(np.float32)
    ky = rng.uniform(-3, h + 3, (b, k)).astype(np.float32)
    edge = [0.0, 0.5, w - 1.0, w - 0.1, float(w), -0.7]
    kx[0, :min(6, k)] = edge[:min(6, k)]
    ky[-1, :min(6, k)] = [0.0, 0.5, h - 1.0, h - 0.1, float(h),
                          -0.7][:min(6, k)]
    kv = rng.integers(0, 3, (b, k)).astype(np.int32)
    kv[:, 0] = 2            # K = 1 renders somewhere too
    kx[:, 0] = np.minimum(np.maximum(kx[:, 0], 1.0), w - 1.0)
    ky[:, 0] = np.minimum(np.maximum(ky[:, 0], 1.0), h - 1.0)
    return kx, ky, kv


def _gauss(adx, ady, two_s2):
    """csrc/heatmap.cu's value: every float32 operation rounded."""
    fx = np.asarray(adx).astype(np.float32)
    fy = np.asarray(ady).astype(np.float32)
    d2 = (fx * fx + fy * fy).astype(np.float32)
    return np.exp(-d2 / two_s2, dtype=np.float32)


def emulate_heatmap(kx, ky, kv, H, W, sigma):
    """csrc/heatmap.cu on heatmap_geometry's launch, block by block in
    numpy (a block's threads as arrays). Returns the maps, the plan and
    how often each element was stored."""
    B, K = kx.shape
    geo = hk.heatmap_geometry(B, H, W, K, int(3 * sigma))
    r, chunk, T = geo["radius"], geo["chunk"], geo["threads"]
    vec = 4 if geo["vec"] else 1
    two_s2 = np.float32(2.0 * sigma * sigma)
    rowlen = W * K
    n = H * rowlen
    assert geo["grid"] == B * geo["chunks"] and geo["chunks"] * chunk >= n
    assert geo["smem"] == 4 * chunk <= 4 * hk.HEATMAP_CHUNK_MAX
    assert chunk % rowlen == 0 or rowlen > hk.HEATMAP_CHUNK_MAX
    out = np.full(B * n, np.nan, np.float32)
    stores = np.zeros(B * n, np.int64)
    for blk in range(geo["grid"]):
        b, c = divmod(blk, geo["chunks"])
        c0 = c * chunk
        size = min(chunk, n - c0)
        ylo = c0 // rowlen
        ny = (c0 + size - 1) // rowlen - ylo + 1
        img = np.zeros(size, np.float32)      # the chunk, zeroed
        # one item a (keypoint, row, column) of a window
        span = min(2 * r + 1, W)
        it = np.arange(K * ny * span if r >= 0 else 0)
        assert len(it) < 2 ** 32
        k, rest = it % K, it // K
        xi = np.trunc(kx[b, k]).astype(np.int64)
        yi = np.trunc(ky[b, k]).astype(np.int64)
        on = (xi > 0) & (xi < W) & (yi > 0) & (yi < H) & (kv[b, k] > 0)
        y = ylo + rest % ny
        x = np.maximum(xi - r, 0) + rest // ny
        dx, dy = x - xi, y - yi
        e = (y * W + x) * K + k - c0
        hit = (on & (np.abs(dy) <= r) & (dx <= r) & (x < W) & (e >= 0)
               & (e < size))
        assert len(np.unique(e[hit])) == hit.sum()   # one item a slot
        img[e[hit]] = _gauss(np.abs(dx[hit]), np.abs(dy[hit]), two_s2)
        # streamed out: thread t stores floats vec*t, vec*(t + T), ...
        base = b * n + c0
        for t0 in range(0, size, vec * T):
            e0 = t0 + vec * np.arange(T)
            e0 = e0[e0 < size]
            if vec == 4:              # 16-byte stores on 16 bytes
                assert ((base + e0) % 4 == 0).all()
                assert (e0 + 3 < size).all()
            for j in range(vec):
                out[base + e0 + j] = img[e0 + j]
                np.add.at(stores, base + e0 + j, 1)
    return out.reshape(B, H, W, K), geo, stores


@pytest.mark.parametrize("B,H,W,K,sigma", HEATMAP_SHAPES)
def test_heatmap_plan_stores_each_element_once(B, H, W, K, sigma):
    kx, ky, kv = _keypoints(np.random.default_rng(H * W + K), B, K, H, W)
    got, geo, stores = emulate_heatmap(kx, ky, kv, H, W, sigma)
    assert (stores == 1).all()
    assert geo["vec"] == ((W * K) % 4 == 0)
    assert geo["threads"] == hk.HEATMAP_THREADS
    want = hk.render_heatmaps_batch_plain(*map(torch.from_numpy,
                                               (kx, ky, kv)),
                                          H, W, sigma).numpy()
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_HEATMAP)
    assert (want == 1.0).any(), "no keypoint rendered"


def test_heatmap_plan_at_the_train_step():
    """(64, 64, 64, 17), sigma 1: four 4,352-byte rows a block built in
    shared memory and stored 16 bytes at a time, 1,024 blocks."""
    geo = hk.heatmap_geometry(64, 64, 64, 17, 3)
    assert geo == dict(rows=4, chunk=4352, chunks=16, grid=1024,
                       threads=256, vec=True, radius=3, smem=17408)


@pytest.mark.parametrize("B,H,W,K,sigma", [
    (1, 3, 1, 4100, 1.0),    # 4,100 keypoints on a 1-px-wide map
    (2, 6, 13, 700, 2.0),    # rows of 9,100 floats, one row a block
    (2, 70, 70, 3, 22.0),    # a window of 70x70 pixels
    (1, 5, 7, 4099, 1.0),    # many keypoints, 4-byte stores
])
def test_heatmap_plan_past_shared_memory(B, H, W, K, sigma):
    """Shapes whose rows are longer than a block's chunk (which then
    starts and ends inside a row), with thousands of keypoints, or with
    a window as wide as the map: every element still stored once and
    right."""
    kx, ky, kv = _keypoints(np.random.default_rng(H + K), B, K, H, W)
    got, geo, stores = emulate_heatmap(kx, ky, kv, H, W, sigma)
    assert geo["vec"] == ((W * K) % 4 == 0)
    assert (stores == 1).all()
    want = hk.render_heatmaps_batch_plain(*map(torch.from_numpy,
                                               (kx, ky, kv)),
                                          H, W, sigma).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_HEATMAP)
    np.testing.assert_array_equal(got > 0, want > 0)
    assert W == 1 or (want == 1.0).any()    # a 1-px-wide map renders none


def test_heatmap_plan_clamps_the_radius():
    """A huge or negative radius renders as one clamped to [-1, max(H,
    W)]: no |dx| or |dy| exceeds max(H, W) - 1."""
    assert hk.heatmap_geometry(2, 8, 8, 3, -4)["radius"] == -1
    assert hk.heatmap_geometry(2, 8, 8, 3, 10 ** 12)["radius"] == 8
    geo = hk.heatmap_geometry(1, 96, 96, 5000, 120)
    assert geo["radius"] == 96 and geo["rows"] == 1
    assert geo["chunk"] == hk.HEATMAP_CHUNK_MAX and geo["smem"] == 32768


@pytest.mark.parametrize("B,H,W,K,sigma", HEATMAP_SHAPES)
def test_heatmap_wrapper_matches_jax(B, H, W, K, sigma):
    kx, ky, kv = _keypoints(np.random.default_rng(K + 3 * H), B, K, H, W)
    got = hk.render_heatmaps_batch(*map(torch.from_numpy, (kx, ky, kv)),
                                   height=H, width=W, sigma=sigma).numpy()
    pallas = np.asarray(render_heatmaps_batch_pallas(
        jnp.asarray(kx), jnp.asarray(ky), jnp.asarray(kv), height=H,
        width=W, sigma=sigma, interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=0, atol=ATOL_HEATMAP)
    np.testing.assert_array_equal(got > 0, pallas > 0)
    np.testing.assert_array_equal(got == 1.0, pallas == 1.0)


# ---------------------------------------------------------------------------
# #13
# ---------------------------------------------------------------------------

def decode_maps(rng, B, H, W, K):
    """(B, H, W, K) float32 maps, one kind per image: random, a peak on a
    border or corner with a runner-up neighbour, tied maxima, flat,
    quantized, the maximum in the last pixel, all negative, all -inf."""
    hm = rng.uniform(0, 1, (B, H, W, K)).astype(np.float32)
    spots = [(0, 0), (0, W - 1), (H - 1, 0), (H - 1, W - 1), (H // 2, 0),
             (0, W // 2), (H // 2, W // 2)]
    for i in range(B):
        kind = (i + H + K) % 8
        if kind == 1:
            hm[i] *= 0.2
            for k in range(K):
                py, px = spots[(i + k) % len(spots)]
                hm[i, py, px, k] = 0.9
                hm[i, min(py + 1, H - 1), max(px - 1, 0), k] = 0.6
                hm[i, py, min(px + 1, W - 1), k] = 0.6
        elif kind == 2:
            hm[i] = 0.1
            hm[i, H // 3, W // 3] = hm[i, H - 1, W // 2] = 0.8
        elif kind == 3:
            hm[i] = 0.3
        elif kind == 4:
            hm[i] = np.round(hm[i] * 4) / 4
        elif kind == 5:
            hm[i, H - 1, W - 1] = 2.0
        elif kind == 6:
            hm[i] = -hm[i]
        elif kind == 7:
            hm[i] = -np.inf
    return hm


def _take(av, ai, bv, bi):
    """csrc/decode.cu decode_take on arrays: the larger value, on a tie
    the lower index."""
    b = (bv > av) | ((bv == av) & (bi < ai))
    return np.where(b, bv, av), np.where(b, bi, ai)


def emulate_decode_argmax(hm, vec=True):
    """csrc/decode.cu's scan and combinations on decode_geometry's launch:
    per image and keypoint (conf, first index), and how often each float
    of each image was read."""
    B, H, W, K = hm.shape
    geo = dk.decode_geometry(B, H, W, K, vec=vec)
    v = 4 if vec else 1
    R, lanes, groups, cs = (geo["row_floats"], geo["lanes"], geo["groups"],
                            geo["cluster"])
    assert R == math.lcm(v, K) and lanes * v == R and R % K == 0
    n, nrows, G, ppr = H * W * K, geo["rows"], cs * groups, R // K
    assert nrows == -(-n // R) and G <= nrows
    steps = -(-nrows // G)
    # Lane slot (rank, g, c, j) at step i reads float e of its image.
    rank, g, c, j, i = np.meshgrid(np.arange(cs), np.arange(groups),
                                   np.arange(lanes), np.arange(v),
                                   np.arange(steps), indexing="ij")
    row = rank * groups + g + i * G
    ok = (row < nrows) & (row * R + v * c < n)
    e = row * R + v * c + j
    assert (e[ok] < n).all()
    # Each slot keeps to one keypoint, and its pixels come in order.
    assert (e % K == (v * c + j) % K)[ok].all()
    pix = e // K
    assert (pix == row * ppr + (v * c + j) // K)[ok].all()
    # csrc/decode.cu's count of each lane's rows, the last one only as far
    # as the map goes
    r0 = (rank * groups + g)[..., 0]
    cnt = np.where(r0 < nrows, (nrows - 1 - r0) // G + 1, 0)
    last = r0 + (np.maximum(cnt, 1) - 1) * G
    cnt = cnt - ((r0 < nrows) & (last * R + v * c[..., 0] >= n))
    np.testing.assert_array_equal(cnt, ok.sum(-1))
    assert (ok == (i < cnt[..., None])).all()     # a prefix of the steps
    reads = np.zeros((B, n), np.int64)
    best_v = np.empty((B, cs, groups, R))
    best_i = np.empty((B, cs, groups, R), np.int64)
    for img in range(B):
        np.add.at(reads[img], e[ok], 1)
        vals = np.where(ok, hm[img].reshape(-1)[np.where(ok, e, 0)], -np.inf)
        first = np.argmax(vals, axis=-1)      # the strict > scan: first max
        bv = np.take_along_axis(vals, first[..., None], -1)[..., 0]
        bi = np.take_along_axis(pix, first[..., None], -1)[..., 0]
        empty = ~ok[..., 0]                   # no row: (-inf, INT_MAX)
        bv[empty], bi[empty] = -np.inf, np.iinfo(np.int32).max
        # slot v*c + j of group g's row of partials
        best_v[img] = bv.reshape(cs, groups, R)
        best_i[img] = bi.reshape(cs, groups, R)
    for q in range(1, groups):                # one thread a slot
        best_v[:, :, 0], best_i[:, :, 0] = _take(
            best_v[:, :, 0], best_i[:, :, 0], best_v[:, :, q],
            best_i[:, :, q])
    rv, ri = best_v[:, :, 0], best_i[:, :, 0]  # (B, cluster, R)
    conf, idx = rv[:, 0, :K], ri[:, 0, :K]     # the first block's, then
    for m in range(1, ppr):                     # a keypoint's other slots
        conf, idx = _take(conf, idx, rv[:, 0, m * K:(m + 1) * K],
                          ri[:, 0, m * K:(m + 1) * K])
    for q in range(1, cs):                      # and the other blocks'
        for m in range(ppr):
            conf, idx = _take(conf, idx, rv[:, q, m * K:(m + 1) * K],
                              ri[:, q, m * K:(m + 1) * K])
    return np.stack([conf, idx], -1), geo, reads


def emulate_decode(hm, legacy, threshold=1e-6, vec=True):
    """The whole kernel in numpy: the emulated argmax, then its patch step
    as csrc/decode.cu writes it."""
    B, H, W, K = hm.shape
    best, geo, reads = emulate_decode_argmax(hm, vec)
    out = np.zeros((B, K, 3), np.float32)
    for img in range(B):
        for k in range(K):
            conf, idx = np.float32(best[img, k, 0]), int(best[img, k, 1])
            x, y = idx % W, idx // H
            x1, y1 = max(x - 1, 0), max(y - 1, 0)
            pw, ph = min(x + 2, W) - x1, min(y + 2, H) - y1
            pv = []
            for j in range(9):
                if legacy:
                    row, col, valid = j // pw, j % pw, j < ph * pw
                else:
                    row, col = y - y1 + j // 3 - 1, x - x1 + j % 3 - 1
                    ny, nx = y1 + row, x1 + col
                    valid = 0 <= ny < H and 0 <= nx < W and j != 4
                ry = min(max(y1 + row, 0), H - 1)
                rx = min(max(x1 + col, 0), W - 1)
                val = hm[img, ry, rx, k]
                if legacy and j == pw + 1:
                    val = 0.0
                pv.append(val if valid else -np.inf)
            p = int(np.argmax(pv))
            if legacy:
                off = (p % 3 / 4.0, p // 3 / 4.0)
            else:
                off = ((p % 3 - 1) / 4.0, (p // 3 - 1) / 4.0)
            if conf > np.float32(threshold):
                out[img, k] = (np.float32(x) + np.float32(off[0]),
                               np.float32(y) + np.float32(off[1]), conf)
    return out, geo, reads


@pytest.mark.parametrize("B,H,W,K,vec", [
    (*s, v) for s in DECODE_SHAPES for v in (True, False)
    if not v or math.prod(s[1:]) % 4 == 0] + [(16, 64, 64, 17, True),
                                            (128, 16, 16, 17, True)])
def test_decode_plan_reads_each_element_once(B, H, W, K, vec):
    """On the plan of this batch; vec only where every image starts on
    16 bytes, as the wrapper asks."""
    hm = decode_maps(np.random.default_rng(H + W + K), B, H, W, K)
    got, geo, reads = emulate_decode_argmax(hm, vec)
    assert (reads == 1).all()
    assert 1 <= geo["cluster"] <= dk.DECODE_CLUSTER
    assert geo["threads"] <= max(dk.DECODE_THREADS, geo["lanes"])
    assert geo["grid"] == B * geo["cluster"]
    assert geo["smem"] == 4 * (dk.DECODE_STAGES + 2) * geo["threads"] * (
        4 if vec else 1) <= bk.SMEM_LIMIT
    flat = hm.reshape(B, -1, K)
    idx = np.argmax(flat, axis=1)             # the first maximum
    np.testing.assert_array_equal(got[..., 1], idx)
    np.testing.assert_array_equal(got[..., 0],
                                  np.take_along_axis(flat, idx[:, None],
                                                     1)[:, 0])


@pytest.mark.parametrize("B,H,W,K", DECODE_SHAPES[:6])
@pytest.mark.parametrize("legacy", [True, False], ids=["legacy", "corrected"])
def test_decode_emulation_matches_plain_exactly(B, H, W, K, legacy):
    hm = decode_maps(np.random.default_rng(B * K), 8, H, W, K)
    got, _, _ = emulate_decode(hm, legacy, vec=(H * W * K) % 4 == 0)
    want = dk.decode_batch_plain(torch.from_numpy(hm), legacy=legacy)
    np.testing.assert_array_equal(got, want.numpy())


def test_decode_plan_at_the_served_and_evaluated_batches():
    """64x64x17: a bucket of 1 or 16 takes clusters of 4 blocks of 255
    threads; B=64 and 128 one block an image."""
    for b, cs, groups in ((1, 4, 15), (16, 4, 15), (64, 1, 15),
                          (128, 1, 15)):
        geo = dk.decode_geometry(b, 64, 64, 17)
        assert (geo["cluster"], geo["groups"], geo["lanes"]) == \
            (cs, groups, 17)
        assert geo["row_floats"] == 68 and geo["rows"] == 1024


@pytest.mark.parametrize("K", [1, 2, 3, 4, 16, 17, 33, 255, 543, 544])
@pytest.mark.parametrize("B", [1, 3, 16, 128, 1000])
def test_decode_plan_fits_every_admitted_keypoint_count(B, K):
    """Up to K_MAX = 544, csrc/decode.cu's kDecodeMaxThreads."""
    assert K <= dk.K_MAX == 544
    for H, W in ((64, 64), (1, 1), (3, 5)):
        for vec in (True, False):
            geo = dk.decode_geometry(B, H, W, K, vec)
            assert geo["threads"] <= dk.K_MAX and geo["lanes"] <= dk.K_MAX
            assert geo["smem"] <= bk.SMEM_LIMIT
            assert geo["cluster"] * geo["groups"] <= max(geo["rows"], 1)
            assert geo["cluster"] >= 1 and geo["groups"] >= 1
            assert geo["args"] == (int(vec), geo["lanes"], geo["groups"],
                                   geo["cluster"], geo["smem"])


def _degenerate_corrected(hm):
    """Where the JAX package's Pallas decode departs from its own plain
    decode (corrected only): y = idx // H leaves the peak no neighbour on
    the map (on a map with W > H + 1, or 1x1), and x or y is 0. The Pallas
    kernel then measures the offset from the clipped patch's corner (0),
    the plain decode from the first slot (-0.25), unless the confidence
    is at or below the threshold and both write zeros."""
    B, H, W, K = hm.shape
    flat = hm.reshape(B, -1, K)
    idx = np.argmax(flat, axis=1)
    x, y = idx % W, idx // H
    lonely = np.ones_like(x, bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                lonely &= ~((y + dy >= 0) & (y + dy < H) & (x + dx >= 0)
                            & (x + dx < W))
    kept = flat.max(axis=1) > np.float32(1e-6)
    return lonely & ((x == 0) | (y == 0)) & kept


@pytest.mark.parametrize("B,H,W,K", [DECODE_SHAPES[i]
                                     for i in (0, 1, 2, 3, 5, 7)])
@pytest.mark.parametrize("legacy", [True, False], ids=["legacy", "corrected"])
def test_decode_wrapper_matches_jax(B, H, W, K, legacy):
    """K = 1, 16, 17, 33 at 16, 32 and 64 px, on a wide map (16x32), an
    odd one (13x7x33) and a 1x1 map."""
    hm = decode_maps(np.random.default_rng(7 * K + H), 8, H, W, K)
    hm[hm == -np.inf] = -1.0        # JAX's argmax takes -inf maps alike
    before = dk.decode_batch.launches
    got = dk.decode_batch(torch.from_numpy(hm), legacy=legacy).numpy()
    assert dk.decode_batch.launches == before    # CPU: the plain version
    plain = np.asarray(jdecode.decode_batch(jnp.asarray(hm), legacy=legacy))
    np.testing.assert_array_equal(got, plain)
    pallas = np.asarray(decode_batch_pallas(jnp.asarray(hm), legacy=legacy,
                                            interpret=True))
    apart = np.zeros((8, K), bool) if legacy else _degenerate_corrected(hm)
    np.testing.assert_array_equal(got[~apart], pallas[~apart])
    np.testing.assert_array_equal(np.any(got != pallas, axis=-1), apart)


def test_pallas_decode_departs_from_plain_on_a_wide_map():
    """The case of _degenerate_corrected, shown alone: a 16x32 map whose
    peak lies in column 0 of row 12 gives idx 384, y = 384 // 16 = 24."""
    hm = np.zeros((1, 16, 32, 1), np.float32)
    hm[0, 12, 0, 0] = 1.0
    got = dk.decode_batch(torch.from_numpy(hm), legacy=False).numpy()
    plain = np.asarray(jdecode.decode_batch(jnp.asarray(hm), legacy=False))
    pallas = np.asarray(decode_batch_pallas(jnp.asarray(hm), legacy=False,
                                            interpret=True))
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, [[[-0.25, 23.75, 1.0]]])
    np.testing.assert_array_equal(pallas, [[[0.0, 23.75, 1.0]]])
