"""Data of the port: numpy batches in [0, 1], NHWC float32.

The part of score_sde_pytorch_tpu/datasets.py that the port's train and
eval paths read, copied so that the port imports nothing of the JAX package: the data
scalers (JAX datasets.py:37-50), the in-memory sources (synthetic images
when ``data.data_dir`` is empty, CIFAR-10 pickle batches, an ``.npz`` of
uint8 images; :87-113, :242-249), and the numpy batch iterator with its
prefetch thread (:305-375), built by a single-process :func:`get_dataset`
(the ``loader_backend='python'`` branch of :485-530). The batches are those
of the JAX package's python backend, bit for bit and in the same order, so
a resumed run can replay its stream (``tests/test_torch_copies.py``).

Streaming folders and TFRecords, SVHN, the resize ops and the native C++
loader are not ported: they raise ``NotImplementedError`` (ROADMAP.md
queue 1).
"""
from __future__ import annotations

import os
import pickle
import queue
import threading
from typing import Callable

import numpy as np

Array = np.ndarray


def get_data_scaler(config) -> Callable[[Array], Array]:
  """[0,1] → [−1,1] iff data.centered."""
  if config.data.centered:
    return lambda x: x * 2.0 - 1.0
  return lambda x: x


def get_data_inverse_scaler(config) -> Callable[[Array], Array]:
  """Inverse of the scaler."""
  if config.data.centered:
    return lambda x: (x + 1.0) / 2.0
  return lambda x: x


def _load_cifar10(data_dir: str, split: str) -> Array:
  base = os.path.join(data_dir, "cifar-10-batches-py")
  files = ([f"data_batch_{i}" for i in range(1, 6)] if split == "train"
           else ["test_batch"])
  arrays = []
  for f in files:
    with open(os.path.join(base, f), "rb") as fh:
      d = pickle.load(fh, encoding="bytes")
    arrays.append(np.asarray(d[b"data"], np.uint8))
  data = np.concatenate(arrays, axis=0)
  return data.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)  # NCHW→NHWC


def _load_npz(data_dir: str, split: str) -> Array:
  path = data_dir if data_dir.endswith(".npz") else os.path.join(
      data_dir, f"{split}.npz")
  with np.load(path) as z:
    key = "images" if "images" in z else list(z.keys())[0]
    return np.asarray(z[key], np.uint8)


def _synthetic(config, split: str) -> Array:
  """Deterministic random images for tests and runs without data."""
  n = 512 if split == "train" else 128
  rng = np.random.default_rng(0 if split == "train" else 1)
  size = config.data.image_size
  return rng.integers(0, 256,
                      size=(n, size, size, config.data.num_channels),
                      dtype=np.uint8).astype(np.uint8)


def load_raw_dataset(config, split: str) -> Array:
  """uint8 NHWC images of ``split`` ('train' or 'test')."""
  name = config.data.dataset.upper()
  data_dir = (config.data.get("data_dir", "")
              or config.data.get("tfrecords_path", ""))
  if not data_dir:
    return _synthetic(config, split)
  if name == "CIFAR10":
    return _load_cifar10(data_dir, split)
  if name == "NPZ":
    return _load_npz(data_dir, split)
  raise NotImplementedError(
      f"dataset {name} from {data_dir} is not ported yet (the port reads "
      "synthetic data, CIFAR-10 pickles and .npz); see ROADMAP.md queue 1")


class _Prefetcher:
  """Background-thread prefetch of prepared batches."""

  def __init__(self, make_iter, depth: int = 2):
    self._make_iter = make_iter
    self._q: "queue.Queue" = queue.Queue(maxsize=depth)
    self._thread = threading.Thread(target=self._run, daemon=True)
    self._thread.start()

  def _run(self):
    it = self._make_iter()
    while True:
      self._q.put(next(it))

  def __iter__(self):
    return self

  def __next__(self):
    return self._q.get()


class DatasetIterator:
  """Infinite epoch-shuffled batch iterator over an in-memory uint8 array.

  Yields float32 NHWC batches in [0,1]: optional horizontal flip (train
  only) and uniform dequantization ``(u + 255·x)/256``; the remainder of an
  epoch is dropped, so an epoch is ``batches_per_epoch`` batches."""

  def __init__(self, images: Array, batch_size: int, *, random_flip: bool,
               uniform_dequantization: bool, shuffle: bool, seed: int):
    assert images.dtype == np.uint8 and images.ndim == 4
    self.images = images
    self.batch_size = batch_size
    self.random_flip = random_flip
    self.uniform_dequantization = uniform_dequantization
    self.shuffle = shuffle
    self.seed = seed
    self.batches_per_epoch = images.shape[0] // batch_size
    self._it = _Prefetcher(self._batches)

  def _batches(self):
    rng = np.random.default_rng(self.seed)
    n = self.images.shape[0]
    while True:
      order = rng.permutation(n) if self.shuffle else np.arange(n)
      for start in range(0, n - self.batch_size + 1, self.batch_size):
        idx = order[start:start + self.batch_size]
        batch = self.images[idx].astype(np.float32)
        if self.random_flip:
          flips = rng.random(len(idx)) < 0.5
          batch[flips] = batch[flips, :, ::-1, :]
        if self.uniform_dequantization:
          u = rng.random(batch.shape).astype(np.float32)
          batch = (u + batch) / 256.0
        else:
          batch = batch / 255.0
        yield batch

  def __iter__(self):
    return self

  def __next__(self) -> Array:
    return next(self._it)


def get_dataset(config, *, uniform_dequantization: bool = False,
                evaluation: bool = False):
  """``(train_iter, eval_iter)`` of one process (JAX datasets.py:485-530).

  Batches are ``training.batch_size`` images, or ``eval.batch_size`` with
  ``evaluation``; ``uniform_dequantization`` turns dequantization on
  whatever the config says (the bits/dim stage asks for it). Each iterator
  has ``batches_per_epoch``.

  ``config.data.loader_backend`` may be absent, 'auto' or 'python'; the
  port has only the numpy iterator, so 'native' raises. The seeds and the
  order are the JAX package's python backend's at process 0 of 1."""
  if config.data.get("loader_backend", "auto") not in ("auto", "python"):
    raise NotImplementedError(
        f"data.loader_backend={config.data.loader_backend!r}: the native "
        "loader is not ported; see ROADMAP.md queue 1")
  batch_size = (config.eval.batch_size if evaluation
                else config.training.batch_size)
  dequant = uniform_dequantization or config.data.uniform_dequantization
  seed = config.seed
  train_it = DatasetIterator(
      load_raw_dataset(config, "train"), batch_size,
      random_flip=config.data.random_flip, uniform_dequantization=dequant,
      shuffle=True, seed=seed)
  eval_it = DatasetIterator(
      load_raw_dataset(config, "test"), batch_size, random_flip=False,
      uniform_dequantization=dequant, shuffle=False, seed=seed + 1)
  return train_it, eval_it
