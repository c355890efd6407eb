"""Image dataset pipeline: glob -> ``images.npy`` uint8 cache -> batches.

Copy of :mod:`rgbd_gan_tpu.data.dataset` (numpy only; PIL is imported only
to build the cache). Cache format is identical to the reference
(``train_rgbd.py:172-189``): all images stacked as a uint8 array of shape
(N, 3, H, W) saved to ``{dataset_path}/images.npy``. Normalisation to
[-1, 1] happens on the device inside the train step; shipping uint8
quarters host->device bandwidth.

Batching matches Chainer's ``SerialIterator`` with shuffle: a per-epoch
permutation, wrap-around batches.
"""

from __future__ import annotations

import glob
import os

import numpy as np


def make_dataset(dataset_path: str, image_path: str) -> np.ndarray:
    """Build or load the uint8 image cache (reference ``train_rgbd.py:172-184``)."""
    cache = os.path.join(dataset_path, "images.npy")
    if os.path.exists(cache):
        return np.load(cache)
    try:
        from PIL import Image
    except ImportError as e:  # pragma: no cover
        raise RuntimeError("PIL required to build the image cache") from e
    paths = sorted(glob.glob(image_path))
    if not paths:
        raise FileNotFoundError(f"no images match {image_path!r}")
    imgs = []
    for p in paths:
        img = np.array(Image.open(p).convert("RGB")).transpose(2, 0, 1)
        imgs.append(img)
    imgs = np.array(imgs, dtype="uint8")
    os.makedirs(dataset_path, exist_ok=True)
    np.save(cache, imgs)
    return imgs


def prepare_dataset(config) -> np.ndarray:
    return make_dataset(config.dataset_path, config.image_path)


class ImageDataset:
    """Shuffled wrap-around batch iterator over the cached images.

    Yields NHWC uint8 batches (the train step normalises them on the
    device). With ``num_shards > 1`` each rank takes the disjoint strided
    shard ``images[shard_index::num_shards]`` and shuffles it with its own
    stream, seeded ``seed + shard_index`` (the JAX package's per-process
    input pipeline for data parallelism).
    """

    def __init__(self, images: np.ndarray, batch_size: int, seed: int = 0, shard_index: int = 0,
                 num_shards: int = 1):
        if images.ndim != 4:
            raise ValueError(f"expected (N, 3, H, W) or (N, H, W, 3), got {images.shape}")
        if images.shape[1] == 3 and images.shape[-1] != 3:
            images = images.transpose(0, 2, 3, 1)  # NCHW cache -> NHWC
        self.images = images[shard_index::num_shards]
        self.batch_size = batch_size
        self._rng = np.random.RandomState(seed + shard_index)
        self._perm = self._rng.permutation(len(self.images))
        self._pos = 0

    def next(self) -> np.ndarray:
        idx = []
        while len(idx) < self.batch_size:
            take = min(self.batch_size - len(idx), len(self._perm) - self._pos)
            idx.extend(self._perm[self._pos : self._pos + take])
            self._pos += take
            if self._pos >= len(self._perm):
                self._perm = self._rng.permutation(len(self.images))
                self._pos = 0
        return self.images[np.asarray(idx)]


def synthetic_dataset(n: int, size: int, seed: int = 0) -> np.ndarray:
    """Deterministic synthetic uint8 image set (tests / benchmarks without a
    real dataset on disk)."""
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, size=(n, 3, size, size), dtype=np.uint8)
