"""Batched prediction over the validation split for OKS/PCK evaluation.

The port's counterpart of the JAX package's `evaluation/predict.py`. The
reference's predict_ds (eval.py:99-146) runs model.predict per batch, then
decodes each example's heatmaps in a Python loop on the host. Here the
forward (last stack only, eval.py:108, through the CUDA kernels of
`models/fused_inference.py` on the card, for the standard or the mobile
model) and the decode (the CUDA decode kernel of
`ops/cuda/decode_kernel.py`) both run on the device; the host
only un-crops the (B, K, 3) keypoints into original-image coordinates
(_undo_bbox, eval.py:153-158) and assembles the JSON records.

`device` is explicit: "cuda" (the default) raises without CUDA, and the
tests run on "cpu", where each kernel's plain version runs. With `mesh=`
(parallel/mesh.py) one process evaluates on every device of the mesh: a
model replica per device, each batch padded to a multiple of the device
count and split evenly over the replicas, and the padding rows dropped
from the gathered keypoints.
"""

from __future__ import annotations

import json
from functools import lru_cache
from typing import List, Optional

import numpy as np
import torch

from single_person_pose_estimation_tpu_torch.data.device_prefetch import (
    Prefetcher,
)
from single_person_pose_estimation_tpu_torch.models.fused_inference import (
    auto_use_fused,
    forward_last_stack,
    prepare_fused,
)
from single_person_pose_estimation_tpu_torch.ops.augment import (
    DEFAULT_FLIP_PAIRS,
    _flip_permutation,
)
from single_person_pose_estimation_tpu_torch.ops.cuda.decode_kernel import (
    decode_batch,
)
from single_person_pose_estimation_tpu_torch.ops.decode import (
    decode_v1_batch,
)
from single_person_pose_estimation_tpu_torch.parallel import mesh as mesh_lib
from single_person_pose_estimation_tpu_torch.training.steps import (
    resolve_device,
)


def unflip_heatmaps(hms: torch.Tensor, flip_perm: torch.Tensor,
                    shift: bool = True) -> torch.Tensor:
    """Map heatmaps predicted on a horizontally MIRRORED input back into
    the original frame: mirror the width axis and swap the left/right
    keypoint channels (the same flip pairs the training augmentation
    swaps, dataset_builder.py:271-301).

    hms: (B, H, W, K); flip_perm: (K,) channel permutation.

    shift=True re-aligns the mirrored grid by one column: the stride-4
    heatmap grid is not mirror-symmetric about the image center (input
    column c lands in bin c//4, so mirroring the input sends a keypoint
    at x to W_in-1-x whose bin is offset by the intra-bin phase), and
    shifting the un-mirrored maps one column right, keeping column 0, is
    the standard correction used by hourglass-family eval pipelines.
    """
    out = hms.flip(2)[..., flip_perm.to(hms.device)]
    if shift:
        out = torch.cat([out[:, :, :1], out[:, :, :-1]], dim=2)
    return out


def make_predict_decode_fn(model, conf_threshold: float = 1e-6,
                           legacy: bool = True, version: int = 2,
                           use_fused="auto", flip_test: bool = False,
                           flip_pairs=DEFAULT_FLIP_PAIRS,
                           flip_shift: bool = True, device="cuda"):
    """The predict step, (model, images, prepared) -> (B, K, 3) keypoints
    in heatmap pixels on the device, memoized per option set: repeated
    predict_ds calls with the same options reuse one function.

    use_fused="auto" is resolved for `model` on `device` (the kernels on a
    CUDA device with a 2-byte compute dtype) BEFORE the memo lookup, so a
    function built for one device is never replayed on another. The memo
    holds options only, never a model or its weights: the step reads the
    weights from the model it is given, and `prepared` is that model's
    `prepare_fused` (built on each call when not given). The function's
    `use_fused` attribute says whether it runs the kernels.
    """
    auto = use_fused == "auto"
    if auto:
        use_fused = auto_use_fused(model, device)
    return _cached_predict_decode_fn(
        conf_threshold, legacy, version, bool(use_fused), auto, flip_test,
        tuple(tuple(p) for p in flip_pairs), flip_shift)


def clear_predict_cache() -> None:
    """Drop all memoized predict functions."""
    _cached_predict_decode_fn.cache_clear()


@lru_cache(maxsize=16)
def _cached_predict_decode_fn(conf_threshold, legacy, version, use_fused,
                              auto, flip_test, flip_pairs, flip_shift):
    """Forward plus decode on the images' device.

    flip_test: test-time augmentation. ALSO forward the horizontally
    mirrored batch, un-mirror its heatmaps (width flip + left/right
    channel swap, see unflip_heatmaps), and decode the average of the
    two. It runs the forward twice, so expect about half the throughput.
    Version 2 decodes through the decode kernel on the card (its plain
    version on the CPU); version 1 is the plain argmax decode.
    """

    def forward(model, images, prepared):
        return forward_last_stack(model, images, use_fused=use_fused,
                                  auto=auto, prepared=prepared)

    def fn(model, images, prepared=None):
        with torch.inference_mode():
            if images.dtype == torch.uint8:
                # uint8 wire (config.eval_transfer_dtype): 4x less
                # host->device traffic; normalize on the device.
                images = images.float() / 255.0
            hms = forward(model, images, prepared)
            if flip_test:
                perm = _flip_permutation(hms.shape[-1], flip_pairs)
                hms_f = forward(model, images.flip(2), prepared)
                hms = 0.5 * (hms + unflip_heatmaps(hms_f, perm,
                                                   shift=flip_shift))
            if version == 1:
                return decode_v1_batch(hms, conf_threshold)
            return decode_batch(hms, conf_threshold, legacy)

    fn.use_fused = use_fused
    return fn


def predict_ds(
    model,
    state,
    ds_prediction,
    conf_threshold: float = 1e-6,
    legacy_decode: bool = True,
    decode_version: int = 2,
    save_path: Optional[str] = "result.json",
    flip_test: bool = False,
    flip_pairs=DEFAULT_FLIP_PAIRS,
    mesh=None,
    device="cuda",
) -> List[dict]:
    """Iterate the prediction dataset; return the reference's prediction
    records (eval.py:110-141): per example the un-cropped predicted and GT
    keypoints, visibilities, confidences, ids, original bbox.

    `state` is the TrainState of `load_model_from_checkpoint`, whose model
    holds the weights, or None to predict with `model` as it is.
    `ds_prediction` yields (images [B, H, W, 3], metas list), see
    DatasetBuilder.get_ds_prediction. Keypoints are normalized by the
    heatmap size then mapped through the stored square crop box. The model
    moves to `device` and switches to eval mode; the forward takes the
    CUDA kernels on a CUDA device at a 2-byte compute dtype (the "auto"
    policy of `auto_use_fused`), the plain model otherwise.

    `mesh` (a `parallel.mesh.Mesh`) evaluates on the mesh's local devices
    instead of `device`, with a replica of the model on each.
    """
    if state is not None:
        model = state.model
    if mesh is None:
        devices = (resolve_device(device),)
        models = [model.to(devices[0])]
    else:
        devices = mesh.local_devices
        models = mesh_lib.replicas(model, mesh)
    for m in models:
        m.eval()
    fn = make_predict_decode_fn(models[0], conf_threshold, legacy_decode,
                                decode_version, flip_test=flip_test,
                                flip_pairs=flip_pairs, device=devices[0])
    prepared = {id(m): prepare_fused(m) if fn.use_fused else None
                for m in models}
    replicas = [(m, prepared[id(m)], d,
                 torch.cuda.Stream(d) if d.type == "cuda" else None)
                for m, d in zip(models, devices)]

    def _put(pair):
        # Runs on the prefetch thread: batch N+1 is padded to the replica
        # count, split, and each piece copied to its device on a side
        # stream while the devices run batch N.
        images, metas = pair
        host = torch.from_numpy(np.ascontiguousarray(images))
        host, n = mesh_lib.pad_batch_to_devices(host, len(replicas))
        pieces = []
        for (_, _, dev, stream), piece in zip(replicas,
                                             host.chunk(len(replicas))):
            if stream is None:
                pieces.append((piece, None))
                continue
            with torch.cuda.stream(stream):
                x = piece.pin_memory().to(dev, non_blocking=True)
                done = torch.cuda.Event()
                done.record(stream)
            pieces.append((x, done))
        return pieces, metas, n

    # Tie the source's lifetime to the prefetcher (closed on the producer
    # thread when it exits) and always close: an exception mid-eval must
    # not strand the transfer thread holding device batches.
    pf = Prefetcher(iter(ds_prediction), depth=2, map_fn=_put,
                    on_stop=getattr(ds_prediction, "close", None))
    try:
        predictions = _predict_loop(pf, fn, replicas)
    finally:
        pf.close()

    if save_path:
        with open(save_path, "w") as f:
            json.dump(predictions, f)
    return predictions


def _predict_loop(pf, fn, replicas) -> List[dict]:
    predictions: List[dict] = []
    for pieces, metas, n in pf:
        outs = []
        for (model, prepared, dev, _), (images, done) in zip(replicas,
                                                            pieces):
            if done is not None:
                # The copy ran on the side stream: order it before this
                # stream's use, and keep the allocator from reusing the
                # batch too early.
                cur = torch.cuda.current_stream(dev)
                cur.wait_event(done)
                images.record_stream(cur)
            with mesh_lib.on_device(dev):
                outs.append(fn(model, images, prepared))
        kps = np.concatenate([o.cpu().numpy() for o in outs])[:n]
        # decode returns heatmap-space coords; normalize by heatmap dims
        # (the model's label resolution is input/4 by construction).
        hm_h = images.shape[1] // 4
        hm_w = images.shape[2] // 4
        for j, meta in enumerate(metas):
            xs_pred = kps[j, :, 0] / hm_w
            ys_pred = kps[j, :, 1] / hm_h
            confs = kps[j, :, 2]
            bw = int(meta["bbox_w"])
            bh = int(meta["bbox_h"])
            bx = float(meta["bbox_x"])
            by = float(meta["bbox_y"])
            # GT keypoints are stored in the crop's STORED frame, which is
            # the square bbox unless the record was written pre-resized
            # (record_image_size): normalize by the frame, un-crop by the
            # true bbox (see data/pipeline.py:_prediction_meta).
            fw = int(meta.get("frame_w", bw))
            fh = int(meta.get("frame_h", bh))
            xs_gt = np.asarray(meta["keypoints/x"], np.float64) / fw
            ys_gt = np.asarray(meta["keypoints/y"], np.float64) / fh

            predictions.append({
                "xs/pred": (xs_pred * bw + bx).astype(float).tolist(),
                "ys/pred": (ys_pred * bh + by).astype(float).tolist(),
                "xs/gt": (xs_gt * bw + bx).astype(float).tolist(),
                "ys/gt": (ys_gt * bh + by).astype(float).tolist(),
                "vs": np.asarray(meta["keypoints/vis"]).astype(int).tolist(),
                "confs": confs.astype(float).tolist(),
                "image_id": int(meta["image_id"]),
                "ann_id": int(meta["ann_id"]),
                "original_bbox": np.asarray(
                    meta["original_bbox"]).astype(float).tolist(),
            })

    return predictions
