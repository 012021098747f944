"""A dataset builder over crops held in memory.

`Trainer` takes any object with `build_datasets()`, `num_train_examples`
and `num_valid_examples`. This one serves numpy arrays: batches of
`{"image": (B, H, W, 3), "kx", "ky": (B, K) float32, "kv": (B, K) int32}`,
the training split reshuffled every pass from a seed, the validation split
in order, both repeating forever. Images go out as float32 in [0, 1], or
as uint8 with `transfer_dtype="uint8"` (the train step divides by 255 on
the device). `synthetic_crops` makes such arrays from a seed.

Records on disk go through the TFRecord `data/pipeline.py::DatasetBuilder`
instead, which `Trainer` takes the same way.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def synthetic_crops(n: int, size: int = 256, num_keypoints: int = 17,
                    label_size: int = 64, seed: int = 0
                    ) -> Dict[str, np.ndarray]:
    """n random crops with keypoints in heatmap space; each visible
    keypoint is marked by a bright square in the image, and about one in
    eight keypoints is invisible."""
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 0.5, (n, size, size, 3)).astype(np.float32)
    kx = rng.uniform(2, label_size - 2, (n, num_keypoints)).astype(np.float32)
    ky = rng.uniform(2, label_size - 2, (n, num_keypoints)).astype(np.float32)
    kv = (rng.uniform(size=(n, num_keypoints)) > 0.125).astype(np.int32) * 2
    f = size / label_size
    r = max(1, int(f))
    for i in range(n):
        for k in np.flatnonzero(kv[i]):
            x, y = int(kx[i, k] * f), int(ky[i, k] * f)
            images[i, y - r:y + r, x - r:x + r] = 1.0
    return {"image": images, "kx": kx, "ky": ky, "kv": kv}


class _Batches:
    """An endless iterator of batches over in-memory arrays."""

    def __init__(self, arrays, batch_size, shuffle, seed, transfer_dtype):
        self._arrays = arrays
        self._n = len(arrays["image"])
        self._b = batch_size
        self._rng = np.random.default_rng(seed) if shuffle else None
        self._uint8 = transfer_dtype == "uint8"
        self._order = np.arange(self._n)
        self._pos = self._n

    def __iter__(self):
        return self

    def __next__(self):
        if self._pos + self._b > self._n:
            if self._rng is not None:
                self._rng.shuffle(self._order)
            self._pos = 0
        idx = self._order[self._pos:self._pos + self._b]
        self._pos += self._b
        batch = {k: v[idx] for k, v in self._arrays.items()}
        if self._uint8:
            batch["image"] = np.round(batch["image"] * 255).astype(np.uint8)
        return batch

    def close(self):
        pass


class ArrayDatasetBuilder:
    """Train and validation splits held as numpy arrays."""

    def __init__(self, train: Dict[str, np.ndarray],
                 valid: Dict[str, np.ndarray], batch_size: int,
                 seed: int = 0, transfer_dtype: str = "float32"):
        for name, split in (("train", train), ("valid", valid)):
            if len(split["image"]) < batch_size:
                raise ValueError(f"the {name} split has fewer than "
                                 f"{batch_size} examples")
        if transfer_dtype not in ("float32", "uint8"):
            raise ValueError(f"transfer_dtype must be float32 or uint8: "
                             f"{transfer_dtype!r}")
        self.train, self.valid = train, valid
        self.batch_size = batch_size
        self.seed = seed
        self.transfer_dtype = transfer_dtype
        self.num_train_examples = len(train["image"])
        self.num_valid_examples = len(valid["image"])

    def build_datasets(self):
        return (_Batches(self.train, self.batch_size, True, self.seed,
                         self.transfer_dtype),
                _Batches(self.valid, self.batch_size, False, self.seed,
                         self.transfer_dtype))
