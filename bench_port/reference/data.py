"""The plain reference of the training images a configuration without a
data directory is served: the seeded synthetic source of the program's
``datasets.get_dataset``, worked out again from what it promises.

The train split is 512 images and the test split 128, uint8 pixels drawn
by NumPy's ``default_rng`` seeded 0 and 1. The train stream, seeded by the
configuration's ``seed``, permutes the split at each epoch's start and
cuts it into whole batches; each batch is turned to float32, its images
mirrored left to right where a uniform draw of the stream is under 0.5
(with ``random_flip``), and divided by 255. The test stream is seeded
``seed + 1`` and keeps the split's order, without flips.
"""
from __future__ import annotations

import numpy as np

_SPLITS = {"train": (512, 0), "test": (128, 1)}


def images(data: dict, split: str) -> np.ndarray:
  n, seed = _SPLITS[split]
  size, channels = data["image_size"], data["num_channels"]
  return np.random.default_rng(seed).integers(
      0, 256, size=(n, size, size, channels), dtype=np.uint8)


def batches(data: dict, split: str, batch: int, seed: int,
            count: int) -> list:
  """The first ``count`` NHWC float32 batches in [0, 1] of ``split``'s
  stream."""
  pixels = images(data, split)
  train = split == "train"
  flip = train and data["random_flip"]
  rng = np.random.default_rng(seed if train else seed + 1)
  n, out = pixels.shape[0], []
  while len(out) < count:
    order = rng.permutation(n) if train else np.arange(n)
    for start in range(0, n - batch + 1, batch):
      x = pixels[order[start:start + batch]].astype(np.float32)
      if flip:
        mirrored = rng.random(batch) < 0.5
        x[mirrored] = x[mirrored, :, ::-1, :]
      out.append(x / np.float32(255.0))
      if len(out) == count:
        break
  return out
