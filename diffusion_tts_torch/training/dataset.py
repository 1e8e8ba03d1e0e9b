"""Dataset layer: image datasets with labels, xflip doubling, infinite
rank-sharded sampling (counterpart of diffusion_tts_tpu/training/dataset.py,
numpy only: the same index streams and batches for the same seed).

Behavioral counterpart of the reference's dataset stack
(edm/training/dataset.py:26-250 Dataset/ImageFolderDataset;
edm/torch_utils/misc.py:110-142 InfiniteSampler): uint8 images, optional
one-hot labels from dataset.json, max_size truncation with a shuffled
subset, xflip doubling (index >= N means mirrored), and an infinite
shuffled sampler sharded by process for data parallelism.

Batches come out as NHWC float32 in [-1, 1] ready for the loss; sharding
is by the caller's process rank (one process until distributed training is
ported).
"""
from __future__ import annotations

import json
import os
import zipfile
from typing import Iterator

import numpy as np


class ImageDataset:
    """In-memory/zip/folder dataset of uint8 images + optional labels."""

    def __init__(
        self,
        images: np.ndarray | None = None,  # [N, H, W, C] uint8
        labels: np.ndarray | None = None,  # [N] int or [N, D] one-hot
        *,
        path: str | None = None,
        max_size: int | None = None,
        xflip: bool = False,
        use_labels: bool = True,
        random_seed: int = 0,
    ):
        if path is not None:
            images, labels = _load_folder_or_zip(path, use_labels)
        assert images is not None and images.dtype == np.uint8 and images.ndim == 4
        self._images = images
        self._raw_labels = labels if use_labels else None
        n = len(images)

        self._raw_idx = np.arange(n, dtype=np.int64)
        if max_size is not None and n > max_size:
            # shuffled subset (reference dataset.py:49-53)
            rng = np.random.RandomState(random_seed)
            rng.shuffle(self._raw_idx)
            self._raw_idx = np.sort(self._raw_idx[:max_size])
        self._xflip = np.zeros(len(self._raw_idx), dtype=np.uint8)
        if xflip:
            self._raw_idx = np.tile(self._raw_idx, 2)
            self._xflip = np.concatenate([self._xflip, np.ones_like(self._xflip)])

    def __len__(self) -> int:
        return len(self._raw_idx)

    @property
    def image_shape(self) -> tuple[int, int, int]:
        return self._images.shape[1:]

    @property
    def label_dim(self) -> int:
        if self._raw_labels is None:
            return 0
        if self._raw_labels.ndim == 1:
            return int(self._raw_labels.max()) + 1
        return self._raw_labels.shape[1]

    def __getitem__(self, idx: int) -> tuple[np.ndarray, np.ndarray]:
        raw = self._raw_idx[idx]
        img = self._images[raw]
        if self._xflip[idx]:
            img = img[:, ::-1, :]
        return img, self.get_label(idx)

    def get_label(self, idx: int) -> np.ndarray:
        if self._raw_labels is None:
            return np.zeros(0, np.float32)
        lab = self._raw_labels[self._raw_idx[idx]]
        if np.ndim(lab) == 0:
            onehot = np.zeros(self.label_dim, np.float32)
            onehot[int(lab)] = 1.0
            return onehot
        return np.asarray(lab, np.float32)


class InfiniteSampler:
    """Rank-strided shuffled infinite index stream (misc.py:110-142):
    each process sees indices where idx % num_shards == shard, with
    window-based local shuffling so the stream never terminates."""

    def __init__(self, dataset_len: int, *, shard: int = 0, num_shards: int = 1,
                 shuffle: bool = True, seed: int = 0, window_size: float = 0.5):
        assert 0 <= shard < num_shards
        self.n = dataset_len
        self.shard = shard
        self.num_shards = num_shards
        self.shuffle = shuffle
        self.seed = seed
        self.window = int(np.rint(dataset_len * window_size)) if shuffle else 0

    def __iter__(self) -> Iterator[int]:
        order = np.arange(self.n)
        rnd = None
        if self.shuffle:
            rnd = np.random.RandomState(self.seed)
            rnd.shuffle(order)
        idx = 0
        while True:
            i = idx % self.n
            if idx % self.num_shards == self.shard:
                yield int(order[i])
            if self.window >= 2:
                j = (i - rnd.randint(self.window)) % self.n
                order[i], order[j] = order[j], order[i]
            idx += 1


def batch_iterator(
    dataset: ImageDataset, batch_size: int, *, shard: int = 0, num_shards: int = 1,
    seed: int = 0,
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Yields (images [B,H,W,C] float32 in [-1,1], labels [B, D])."""
    sampler = iter(InfiniteSampler(
        len(dataset), shard=shard, num_shards=num_shards, seed=seed
    ))
    while True:
        idx = [next(sampler) for _ in range(batch_size)]
        imgs = np.stack([dataset[i][0] for i in idx])
        labs = np.stack([dataset[i][1] for i in idx])
        yield imgs.astype(np.float32) / 127.5 - 1.0, labs


def _load_folder_or_zip(path: str, use_labels: bool):
    """Reference ImageFolderDataset (dataset.py:166-250): a directory or zip
    of PNGs with an optional dataset.json {"labels": [[fname, label], ...]}."""
    from PIL import Image

    names: list[str]
    read = None
    zf = None
    if os.path.isdir(path):
        names = sorted(
            os.path.relpath(os.path.join(r, f), path)
            for r, _, fs in os.walk(path) for f in fs
        )
        read = lambda name: open(os.path.join(path, name), "rb")
    elif path.endswith(".zip"):
        zf = zipfile.ZipFile(path)
        names = sorted(zf.namelist())
        read = lambda name: zf.open(name, "r")
    else:
        raise IOError(f"path must be a directory or zip: {path}")

    exts = {".png", ".jpg", ".jpeg"}
    image_names = [n for n in names if os.path.splitext(n)[1].lower() in exts]
    labels = None
    if use_labels and "dataset.json" in names:
        with read("dataset.json") as f:
            meta = json.load(f).get("labels")
        if meta is not None:
            lab_map = dict(meta)
            labels = np.asarray([lab_map[n.replace("\\", "/")] for n in image_names])
    images = []
    for n in image_names:
        with read(n) as f:
            arr = np.asarray(Image.open(f).convert("RGB"), np.uint8)
        images.append(arr)
    if zf is not None:
        zf.close()
    return np.stack(images), labels


__all__ = ["ImageDataset", "InfiniteSampler", "batch_iterator"]
