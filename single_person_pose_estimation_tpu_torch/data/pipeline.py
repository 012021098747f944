"""Input pipeline: record shards -> batched host arrays.

The port's counterpart of the JAX package's `data/pipeline.py`, with the
same `DatasetBuilder(config, ratio)`, `build_datasets()` -> (train, valid)
iterators, `get_ds_prediction()`, `num_train_examples` and
`num_valid_examples` (the reference's API, dataset_builder.py:10-67), and
the same output, batch for batch, for the same records and seed. The host
reads record shards (the native mmap reader of `data/tfrecord.py`),
decodes the crops and resizes them to the model's input on a pool of
decode threads, and batches them on a background thread. Augmentation and
targets run on the device, in the train step.

`Trainer` takes this builder as it is. `predict_ds` takes the iterator of
`get_ds_prediction()`.

The background threads are the port's `data/device_prefetch.Prefetcher`.
Every thread a builder starts carries its `thread_prefix`, and `close()`
stops its iterators and joins their decode threads.
"""

from __future__ import annotations

import glob
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Sequence

import numpy as np

from single_person_pose_estimation_tpu_torch.configs.default_config import (
    Config,
)
from single_person_pose_estimation_tpu_torch.data import (
    example_codec,
    tfrecord,
)
from single_person_pose_estimation_tpu_torch.data.device_prefetch import (
    Prefetcher,
)
from single_person_pose_estimation_tpu_torch.data.images import (
    decode_jpeg,
    resize_bilinear,
    resize_bilinear_u8,
)
from single_person_pose_estimation_tpu_torch.parallel.distributed import (
    shard_files_for_process,
)


def _fixed(vals, K: int, dtype) -> np.ndarray:
    arr = np.zeros((K,), dtype=dtype)
    arr[:min(K, len(vals))] = vals[:K]
    return arr


def _parse_example(record: bytes, config: Config, training: bool
                   ) -> Dict[str, np.ndarray]:
    """Record bytes -> {image [H,W,3] f32 in [0,1] (or uint8), kx, ky
    (heatmap space), kv}.

    Replicates parse_tfrecord_fn + prepare_example
    (dataset_builder.py:241-269, 89-113): decode image, resize to the
    input size, rescale keypoints from crop-pixel space directly into
    heatmap space by dividing by the stored crop width/height. With
    `train_transfer_dtype="uint8"` the training crop is resized in uint8
    and shipped quantized; the train step divides by 255 on the device.
    """
    ex = example_codec.decode_example(record)
    K = config.num_keypoints
    img = decode_jpeg(ex["image"][0])
    width = float(ex["width"][0])
    height = float(ex["height"][0])
    size = (config.image_height, config.image_width)
    if config.train_transfer_dtype == "uint8" and training:
        img = resize_bilinear_u8(img, size)
    else:
        img = (resize_bilinear(img, size) / 255.0).astype(np.float32)
    kx = _fixed(ex.get("keypoints/x", []), K, np.float32)
    ky = _fixed(ex.get("keypoints/y", []), K, np.float32)
    kv = _fixed(ex.get("keypoints/vis", []), K, np.int64).astype(np.int32)
    kx = kx / width * config.label_width
    ky = ky / height * config.label_height
    return {"image": img, "kx": kx, "ky": ky, "kv": kv}


def _parse_prediction_example(record: bytes, config: Config):
    """Record bytes -> (image, meta) with un-cropping metadata
    (prepare_prediction_example, dataset_builder.py:115-138). With
    `eval_transfer_dtype="uint8"` the crop ships quantized and
    `predict_ds` normalizes it on the device."""
    ex = example_codec.decode_example(record)
    K = config.num_keypoints
    img = decode_jpeg(ex["image"][0])
    size = (config.image_height, config.image_width)
    if config.eval_transfer_dtype == "uint8":
        img = resize_bilinear_u8(img, size)
        return img, _prediction_meta(ex, config, K)
    img = resize_bilinear(img, size) / 255.0
    return img.astype(np.float32), _prediction_meta(ex, config, K)


def _prediction_meta(ex, config: Config, K: int):
    # Un-crop geometry. Normally the stored crop IS the square bbox, so
    # width/height double as the square side. Records written with
    # config.record_image_size > 0 store the crop RESIZED to that side
    # (keypoints rescaled with it) while bbox_x/bbox_y stay in original-
    # image pixels; for those, recover the true square side from
    # original_bbox (the ETL's transform_bbox_square math), or the un-crop
    # mapping would compress every coordinate by resized/true.
    stored_w, stored_h = int(ex["width"][0]), int(ex["height"][0])
    bbox_w, bbox_h = stored_w, stored_h
    original_bbox = np.asarray(ex.get("original_bbox", [0, 0, 0, 0]),
                               dtype=np.float32)
    side = int(max(original_bbox[2], original_bbox[3]) * config.bbox_scale)
    if side > 0 and (side, side) != (stored_w, stored_h):
        bbox_w, bbox_h = side, side

    return {
        "ann_id": int(ex["ann_id"][0]),
        "image_id": int(ex["image_id"][0]),
        "coco_url": bytes(ex.get("coco_url", [b""])[0]),
        "keypoints/x": _fixed(ex.get("keypoints/x", []), K, np.float32),
        "keypoints/y": _fixed(ex.get("keypoints/y", []), K, np.float32),
        "keypoints/vis": _fixed(ex.get("keypoints/vis", []), K, np.int64),
        "bbox_x": float(ex["bbox_x"][0]),
        "bbox_y": float(ex["bbox_y"][0]),
        "bbox_w": bbox_w,                # true square bbox side
        "bbox_h": bbox_h,
        "frame_w": stored_w,             # frame the keypoints are stored in
        "frame_h": stored_h,
        "original_bbox": original_bbox,
    }


def _stack_batch(examples: Sequence[Dict[str, np.ndarray]]):
    return {k: np.stack([e[k] for e in examples]) for k in examples[0]}


def _pipelined_map(fn, it: Iterator, pool, depth: int):
    """Ordered parallel map with a bounded in-flight window (decode and
    resize release the GIL, so a thread pool scales across host cores)."""
    q = deque()
    for item in it:
        q.append(pool.submit(fn, item))
        if len(q) >= depth:
            yield q.popleft().result()
    while q:
        yield q.popleft().result()


class DatasetBuilder:
    """Builds train/valid/prediction iterators from record shards.

    Several processes: pass process_index/process_count to give each a
    disjoint round-robin subset of the shard files: a mesh's data index and
    data size (`parallel.mesh.Mesh`), so that the ranks of a model group
    read the same files.
    """

    def __init__(self, config: Config, ratio: float = 1.0,
                 process_index: int = 0, process_count: int = 1):
        if not 0 < ratio <= 1:
            raise ValueError("ratio must be in (0, 1]")
        self.config = config
        self.train_filenames = sorted(
            glob.glob(os.path.join(config.train_tfrecords_dir, "*.tfrec")))
        self.valid_filenames = sorted(
            glob.glob(os.path.join(config.valid_tfrecords_dir, "*.tfrec")))
        if ratio < 1:
            self.train_filenames = self.train_filenames[
                :int(np.ceil(ratio * len(self.train_filenames)))]
            self.valid_filenames = self.valid_filenames[
                :int(np.ceil(ratio * len(self.valid_filenames)))]
        if process_count > 1:
            self.train_filenames = shard_files_for_process(
                self.train_filenames, process_index, process_count)
            self.valid_filenames = shard_files_for_process(
                self.valid_filenames, process_index, process_count,
                allow_replicate=True)
        self.num_train_examples = tfrecord.count_examples_from_filenames(
            self.train_filenames)
        self.num_valid_examples = tfrecord.count_examples_from_filenames(
            self.valid_filenames)
        self._rng = np.random.default_rng(config.seed)
        # Decode threads per iterator: config.host_workers, by default
        # min(4, cores - 1); none (decode on the batching thread) on one.
        self._workers = config.host_workers or max(
            1, min(4, (os.cpu_count() or 1) - 1))
        self.thread_prefix = f"spe-data-{id(self):x}"
        self._iterators: List[Prefetcher] = []
        self._pools: List[ThreadPoolExecutor] = []
        print(f"Train dataset with {len(self.train_filenames)} shards and "
              f"{self.num_train_examples} examples.")
        print(f"Valid dataset with {len(self.valid_filenames)} shards and "
              f"{self.num_valid_examples} examples.")

    # -- raw record streams ------------------------------------------------

    def _record_stream(self, filenames: Sequence[str], shuffle: bool
                       ) -> Iterator[bytes]:
        """One pass over the files: shard order and a buffer of records
        shuffled from the builder's generator when `shuffle`."""
        buffer_size = self.config.shuffle_buffer if shuffle else 0
        order = list(filenames)
        if shuffle:
            self._rng.shuffle(order)
        buf: List[bytes] = []
        for path in order:
            for rec in tfrecord.iter_records(path):
                if not buffer_size:
                    yield rec
                else:
                    buf.append(rec)
                    if len(buf) > buffer_size:
                        j = int(self._rng.integers(len(buf)))
                        buf[j], buf[-1] = buf[-1], buf[j]
                        yield buf.pop()
        while buf:
            j = int(self._rng.integers(len(buf)))
            buf[j], buf[-1] = buf[-1], buf[j]
            yield buf.pop()

    def _parallel(self, fn, stream: Iterator, pool):
        if pool is None:
            return map(fn, stream)
        return _pipelined_map(fn, stream, pool, depth=2 * self._workers)

    def _start(self, gen_fn, kind: str) -> Prefetcher:
        """Run gen_fn(pool) on a background thread, with a pool of decode
        threads when there is more than one worker. The pool is shut down,
        its threads joined, when the iterator stops."""
        pool = None
        if self._workers > 1:
            pool = ThreadPoolExecutor(
                self._workers,
                thread_name_prefix=f"{self.thread_prefix}-{kind}")
            self._pools.append(pool)
        on_stop = None if pool is None else (
            lambda: pool.shutdown(wait=True, cancel_futures=True))
        it = Prefetcher(gen_fn(pool), depth=4, on_stop=on_stop,
                        name=f"{self.thread_prefix}-{kind}-batches")
        self._iterators.append(it)
        return it

    # -- public API --------------------------------------------------------

    def _batches(self, filenames, shuffle, repeat, training):
        cfg = self.config

        def gen(pool):
            # Batch *within* an epoch then repeat, matching the reference's
            # ds.batch(B).repeat() ordering (dataset_builder.py:44-45), so
            # the final batch of each epoch is partial rather than wrapping.
            while True:
                batch: List[Dict[str, np.ndarray]] = []
                examples = self._parallel(
                    lambda r: _parse_example(r, cfg, training),
                    self._record_stream(filenames, shuffle), pool)
                for ex in examples:
                    batch.append(ex)
                    if len(batch) == cfg.batch_size:
                        yield _stack_batch(batch)
                        batch = []
                if batch:
                    yield _stack_batch(batch)
                if not repeat:
                    return

        return self._start(gen, "train" if training else "valid")

    def build_datasets(self):
        """(train, valid) batch iterators. Train: shard+buffer shuffled,
        infinite. Valid: ordered, infinite (the reference repeats both,
        dataset_builder.py:45,53); use steps_per_epoch externally."""
        train = self._batches(self.train_filenames, shuffle=True,
                              repeat=True, training=True)
        valid = self._batches(self.valid_filenames, shuffle=False,
                              repeat=True, training=False)
        return train, valid

    def get_ds_prediction(self):
        """Finite iterator of (images [B,H,W,3], meta list) over the valid
        split, metadata preserved for un-cropping (eval parity with
        get_ds_prediction, dataset_builder.py:58-67). Decode and resize
        run on the decode pool; batches are handed over on a background
        thread."""
        cfg = self.config

        def gen(pool):
            pairs = self._parallel(
                lambda r: _parse_prediction_example(r, cfg),
                self._record_stream(self.valid_filenames, shuffle=False),
                pool)
            images: List[np.ndarray] = []
            metas: List[Dict] = []
            for img, meta in pairs:
                images.append(img)
                metas.append(meta)
                if len(images) == cfg.batch_size:
                    yield np.stack(images), metas
                    images, metas = [], []
            if images:
                yield np.stack(images), metas

        return self._start(gen, "pred")

    def close(self) -> None:
        """Stop every iterator this builder made and join its threads."""
        for it in self._iterators:
            it.close()
        for pool in self._pools:
            pool.shutdown(wait=True, cancel_futures=True)
        self._iterators, self._pools = [], []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
