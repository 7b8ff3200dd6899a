"""Data of the port: numpy batches in [0, 1], NHWC float32.

Counterpart of score_sde_pytorch_tpu/datasets.py, copied so that the port
imports nothing of the JAX package (``tests/test_torch_copies.py`` and
``tests/test_torch_datasets.py`` hold the batches equal, bit for bit):

- the data scalers (JAX :37-50) and the resize ops with PIL's bicubic
  (:51-84);
- in-memory sources: synthetic images when ``data.data_dir`` is empty,
  CIFAR-10 pickle batches, SVHN ``.mat`` files, an ``.npz`` of uint8
  images (:87-113, :242-249);
- streaming sources: image folders with the CELEBA/LSUN/FOLDER resize
  chains, and FFHQ/CelebAHQ TFRecords through the port's TensorFlow-free
  reader (:mod:`.tfrecord`); ``data.in_memory`` materializes them
  (:115-172, :252-297);
- per-process shards (:175-239), the in-memory and streaming batch
  iterators (:305-457), the native C++ loader (:mod:`.native`) and
  :func:`get_dataset` (:460-530).

A streaming source yields record handles (a file path, or a record's file
and offset) and decodes one when a batch is built, so the reservoir shuffle
holds handles. Every iterator but the native one has ``skip(k)``: it makes
the random draws of ``k`` batches (permutations, reservoir draws, flips)
and advances the generator over their per-pixel dequantization draws,
without reading an image, so a resumed run takes up its stream where it
stopped. The batches and their order are the JAX package's.

Two departures from the JAX package: ``loader_backend='auto'`` is the
python pipeline (JAX's takes the native loader where it builds), and an
unknown ``loader_backend`` raises (ROADMAP.md §3).
"""
from __future__ import annotations

import itertools
import math
import os
import pickle
import queue
import threading
from typing import Callable, Iterable, Optional

import numpy as np

from score_sde_pytorch_tpu_torch import native, tfrecord
from score_sde_pytorch_tpu_torch.utils import tracing

Array = np.ndarray
BACKENDS = ("auto", "native", "python")


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


def crop_resize(image: Array, resolution: int) -> Array:
  """Central-crop to square then bicubic resize."""
  from PIL import Image
  h, w = image.shape[:2]
  crop = min(h, w)
  top, left = (h - crop) // 2, (w - crop) // 2
  image = image[top:top + crop, left:left + crop]
  img = Image.fromarray(image)
  img = img.resize((resolution, resolution), Image.BICUBIC)
  return np.asarray(img)


def resize_small(image: Array, resolution: int) -> Array:
  """Resize preserving aspect so the short side == resolution."""
  from PIL import Image
  h, w = image.shape[:2]
  ratio = resolution / min(h, w)
  img = Image.fromarray(image)
  img = img.resize((int(round(w * ratio)), int(round(h * ratio))),
                   Image.BICUBIC)
  return np.asarray(img)


def central_crop(image: Array, size: int) -> Array:
  """Central crop."""
  h, w = image.shape[:2]
  top, left = (h - size) // 2, (w - size) // 2
  return image[top:top + size, left:left + size]


# ---------------------------------------------------------------------------
# Raw sources → uint8 NHWC arrays (in-memory) or streaming sources
# ---------------------------------------------------------------------------


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


def _load_svhn(data_dir: str, split: str) -> Array:
  import scipy.io
  name = "train_32x32.mat" if split == "train" else "test_32x32.mat"
  mat = scipy.io.loadmat(os.path.join(data_dir, name))
  return np.transpose(mat["X"], (3, 0, 1, 2)).astype(np.uint8)


def _load_npz(data_dir: str, split: str) -> Array:
  path = data_dir if data_dir.endswith(".npz") else os.path.join(
      data_dir, f"{split}.npz")
  with np.load(path) as z:
    key = "images" if "images" in z else list(z.keys())[0]
    return np.asarray(z[key], np.uint8)


class StreamingSource:
  """Bounded-memory image source: a restartable stream of record handles,
  each decoded on demand to a uint8 HWC image.

  ``handles()`` starts the stream anew; ``decode(handle)`` reads one image;
  ``shape(handle)`` is the shape ``decode`` would give, found without
  decoding the image. ``count`` may be None where it is unknown until
  counted; ``count_fn`` (if given) computes it on demand without decoding.
  By default a handle is the image itself.
  """

  def __init__(self, handles: Callable[[], Iterable],
               decode: Callable = lambda image: image,
               shape: Callable = np.shape, count: Optional[int] = None,
               count_fn: Optional[Callable[[], int]] = None):
    self.handles = handles
    self.decode = decode
    self.shape = shape
    self._count = count
    self._count_fn = count_fn

  @property
  def count(self) -> Optional[int]:
    if self._count is None and self._count_fn is not None:
      self._count = self._count_fn()
    return self._count

  def images(self):
    """The decoded stream, in the source's order."""
    return map(self.decode, self.handles())

  def shard(self, index: int, num_shards: int) -> "StreamingSource":
    """Disjoint strided shard (tf.data ``.shard()`` semantics): this shard
    sees records i with i % num_shards == index."""
    if num_shards == 1:
      return self
    handles = self.handles

    def sharded():
      return itertools.islice(handles(), index, None, num_shards)

    count, count_fn = self._count, self._count_fn
    return StreamingSource(
        sharded, self.decode, self.shape,
        None if count is None else (count - index + num_shards - 1) // num_shards,
        None if count_fn is None
        else lambda: (count_fn() - index + num_shards - 1) // num_shards)

  def materialize(self) -> Array:
    """Decode the whole stream into one uint8 array (small sets / tools)."""
    return np.stack(list(self.images()))


def _image_source(handles: Callable, load: Callable, raw_shape: Callable,
                  op: Callable, **count) -> StreamingSource:
  """A source of ``op(load(handle))``. Its ``shape`` runs ``op`` on zeros
  of the raw image's shape, read from the file's header or the record, so
  it is the decoded image's by construction and decodes nothing."""
  return StreamingSource(
      handles, lambda h: op(load(h)),
      lambda h: op(np.zeros(raw_shape(h), np.uint8)).shape, **count)


def _folder_source(data_dir: str, resize_op: Callable) -> StreamingSource:
  from PIL import Image
  exts = {".png", ".jpg", ".jpeg", ".webp", ".bmp"}
  files = sorted(
      os.path.join(r, f)
      for r, _, fs in os.walk(data_dir)
      for f in fs if os.path.splitext(f)[1].lower() in exts)
  if not files:
    raise FileNotFoundError(f"No images under {data_dir}")

  def load(path):
    with Image.open(path) as img:
      return np.asarray(img.convert("RGB"))

  def raw_shape(path):
    with Image.open(path) as img:  # reads the header only
      w, h = img.size
    return h, w, 3

  return _image_source(lambda: iter(files), load, raw_shape, resize_op,
                       count=len(files))


def _tfrecord_source(data_dir: str, resolution: int) -> StreamingSource:
  """FFHQ/CelebAHQ-style TFRecords: CHW uint8 under 'data', its [3] int64
  'shape'. The records' index is read once, from their headers, when the
  source is first counted or streamed."""
  files = tfrecord.find_files(data_dir)
  cache = []

  def handles():
    if not cache:
      cache.extend(h for f in files for h in tfrecord.index(f))
    return iter(cache)

  def load(handle):
    shape, data = tfrecord.parse_image_example(tfrecord.read(handle))
    img = np.frombuffer(data, np.uint8).reshape(shape)
    return img.transpose(1, 2, 0)  # CHW → HWC

  def raw_shape(handle):
    c, h, w = tfrecord.parse_image_example(tfrecord.read(handle))[0]
    return h, w, c

  def op(img):
    return crop_resize(img, resolution) if img.shape[0] != resolution else img

  return _image_source(handles, load, raw_shape, op,
                       count_fn=lambda: sum(1 for _ in handles()))


def shard_for_process(images, process_index: int, process_count: int):
  """Per-process shard of a data source: disjoint strided shards, so no two
  processes ever compute gradients on the same example."""
  if process_count == 1:
    return images
  if isinstance(images, StreamingSource):
    return images.shard(process_index, process_count)
  return images[process_index::process_count]


def materialize(source) -> Array:
  """uint8 array from either an in-memory array or a StreamingSource."""
  if isinstance(source, StreamingSource):
    return source.materialize()
  return source


def _synthetic(config, split: str) -> Array:
  """Deterministic random images for tests and runs without data."""
  n = 512 if split == "train" else 128
  rng = np.random.default_rng(0 if split == "train" else 1)
  size = config.data.image_size
  return rng.integers(0, 256,
                      size=(n, size, size, config.data.num_channels),
                      dtype=np.uint8).astype(np.uint8)


def load_raw_dataset(config, split: str):
  """uint8 NHWC images of ``split`` ('train' or 'test'), in memory, or a
  bounded-memory StreamingSource.

  Small standard sets (CIFAR10/SVHN/NPZ/synthetic) load in RAM; folder-
  and TFRecord-backed sets stream (1024px FFHQ is ~220 GB decoded).
  ``config.data.in_memory = True`` materializes them (small folder sets:
  full-set shuffling and the native loader). ``data.tfrecords_path``, the
  reference's key for FFHQ/CelebAHQ, stands in for ``data.data_dir``.
  """
  name = config.data.dataset.upper()
  data_dir = (config.data.get("data_dir", "")
              or config.data.get("tfrecords_path", ""))
  size = config.data.image_size
  in_memory = config.data.get("in_memory", False)
  if not data_dir:
    return _synthetic(config, split)
  if name == "CIFAR10":
    return _load_cifar10(data_dir, split)
  if name == "SVHN":
    return _load_svhn(data_dir, split)
  if name == "NPZ":
    return _load_npz(data_dir, split)
  if name in ("CELEBA", "LSUN", "FOLDER"):
    # The reference's resize chains: CELEBA central_crop(140) then
    # resize_small; LSUN at 128 resize_small then central_crop; otherwise
    # crop_resize.
    if name == "CELEBA":
      resize_op = lambda img: resize_small(central_crop(img, 140), size)
    elif name == "LSUN" and size == 128:
      resize_op = lambda img: central_crop(resize_small(img, size), size)
    else:
      resize_op = lambda img: crop_resize(img, size)
    split_dir = os.path.join(data_dir, split)
    src = _folder_source(split_dir if os.path.isdir(split_dir) else data_dir,
                         resize_op)
    return src.materialize() if in_memory else src
  if name in ("FFHQ", "CELEBAHQ"):
    src = _tfrecord_source(data_dir, size)
    return src.materialize() if in_memory else src
  raise NotImplementedError(f"Dataset {name} not supported.")


# ---------------------------------------------------------------------------
# Batching pipeline
# ---------------------------------------------------------------------------


def _augment(batch: Array, rng, random_flip: bool,
             uniform_dequantization: bool) -> Array:
  """Optional horizontal flips, then uniform dequantization ``(u + x)/256``
  or ``x/255``, of a float32 batch of 0..255 values."""
  if random_flip:
    flips = rng.random(batch.shape[0]) < 0.5
    batch[flips] = batch[flips, :, ::-1, :]
  if uniform_dequantization:
    u = rng.random(batch.shape).astype(np.float32)
    return (u + batch) / 256.0
  return batch / 255.0


def _augment_draws(rng, shape: tuple, random_flip: bool,
                   uniform_dequantization: bool) -> None:
  """The random draws of :func:`_augment` on a batch of ``shape``, without
  the batch: the flips are drawn, the dequantization draws advanced over."""
  if random_flip:
    rng.random(shape[0])
  if uniform_dequantization:
    _advance(rng, math.prod(shape))


def _advance(rng, n: int) -> None:
  """Moves ``rng`` past ``rng.random(n)``: n 64-bit draws of its PCG64.

  ``advance`` also drops the 32-bit half that the generator keeps from an
  earlier bounded integer draw (a permutation, a reservoir index), which
  ``random`` leaves in place; it is put back."""
  bitgen = rng.bit_generator
  before = bitgen.state
  bitgen.advance(n)
  after = bitgen.state
  after["has_uint32"] = before["has_uint32"]
  after["uinteger"] = before["uinteger"]
  bitgen.state = after


class _Prefetcher:
  """Batches made ahead by a background thread, which starts at the first
  ``next``. An exception of the producer is raised by that ``next`` (and
  every later one). The wait for a batch is the ``data.next`` span and the
  ``data.wait`` counter (``utils/tracing.py``)."""

  def __init__(self, it, depth: int = 2):
    self._it = it
    self._q: "queue.Queue" = queue.Queue(maxsize=depth)
    self._thread = None
    self._error = None

  @property
  def started(self) -> bool:
    return self._thread is not None

  def _run(self):
    try:
      while True:
        self._q.put((next(self._it), None))
    except Exception as e:  # handed to the consumer, which raises it
      self._q.put((None, e))

  def __iter__(self):
    return self

  def __next__(self):
    if self._error is not None:
      raise self._error
    if self._thread is None:
      self._thread = threading.Thread(target=self._run, daemon=True)
      self._thread.start()
    with tracing.counted("data.wait", "data.next"):
      batch, error = self._q.get()
    if error is not None:
      self._error = error
      raise error
    return batch


class _SkippableIterator:
  """A batch generator behind a prefetcher, with ``skip``.

  The generator (``_batches``) yields None in place of each batch while
  ``_to_skip`` is positive, after making only that batch's random draws.
  ``skip`` runs it so in the caller's thread, before the prefetcher starts.
  ``decoded`` counts the images read into batches."""

  def _start(self):
    self.decoded = 0
    self._to_skip = 0
    self._stream = self._batches()
    self._it = _Prefetcher(self._stream)

  def skip(self, k: int) -> None:
    """Pass over the next ``k`` batches: the batch after is the one ``k``
    calls of ``next`` would have reached, bit for bit."""
    if self._it.started:
      raise RuntimeError("skip() is taken before the first batch is drawn")
    self._to_skip = k
    for _ in range(k):
      next(self._stream)

  def __iter__(self):
    return self

  def __next__(self) -> Array:
    return next(self._it)


class DatasetIterator(_SkippableIterator):
  """Infinite epoch-shuffled batch iterator over an in-memory uint8 array.

  Yields float32 NHWC batches in [0,1]: optional horizontal flip (train
  only) and uniform dequantization ``(u + 255·x)/256``; the remainder of an
  epoch is dropped, so an epoch is ``batches_per_epoch`` batches."""

  def __init__(self, images: Array, batch_size: int, *, random_flip: bool,
               uniform_dequantization: bool, shuffle: bool, seed: int):
    if images.dtype != np.uint8 or images.ndim != 4:
      raise ValueError(f"DatasetIterator takes uint8 NHWC images, got "
                       f"{images.dtype} of shape {images.shape}")
    self.images = images
    self.batch_size = batch_size
    self.random_flip = random_flip
    self.uniform_dequantization = uniform_dequantization
    self.shuffle = shuffle
    self.seed = seed
    self.batches_per_epoch = images.shape[0] // batch_size
    self._start()

  def _batches(self):
    rng = np.random.default_rng(self.seed)
    n = self.images.shape[0]
    shape = (self.batch_size,) + self.images.shape[1:]
    if n < self.batch_size:
      raise ValueError(f"{n} images make no batch of {self.batch_size}")
    while True:
      order = rng.permutation(n) if self.shuffle else np.arange(n)
      for start in range(0, n - self.batch_size + 1, self.batch_size):
        if self._to_skip:
          self._to_skip -= 1
          _augment_draws(rng, shape, self.random_flip,
                         self.uniform_dequantization)
          yield None
          continue
        idx = order[start:start + self.batch_size]
        self.decoded += len(idx)
        yield _augment(self.images[idx].astype(np.float32), rng,
                       self.random_flip, self.uniform_dequantization)


class StreamingDatasetIterator(_SkippableIterator):
  """Infinite batch iterator over a StreamingSource with bounded memory.

  The reference tf.data pipeline's shape repeat→shuffle(10000)→map→
  batch(drop_remainder)→prefetch: a reservoir shuffle of record handles
  (capped both by ``shuffle_buffer`` items and by ``buffer_bytes`` of
  decoded images), per-epoch restart of the stream, remainder batches
  dropped at epoch boundaries, and a background prefetch thread that
  decodes each batch's images. Peak RSS ≈ a few batches, independent of
  the dataset's size.
  """

  def __init__(self, source: StreamingSource, batch_size: int, *,
               random_flip: bool = False,
               uniform_dequantization: bool = False,
               shuffle: bool = True, seed: int = 0,
               shuffle_buffer: int = 10000,
               buffer_bytes: int = 512 << 20):
    self.source = source
    self.batch_size = batch_size
    self.random_flip = random_flip
    self.uniform_dequantization = uniform_dequantization
    self.shuffle = shuffle
    self.seed = seed
    self.shuffle_buffer = shuffle_buffer
    self.buffer_bytes = buffer_bytes
    self._image_shape = None
    self._start()

  @property
  def batches_per_epoch(self) -> Optional[int]:
    n = self.source.count  # may trigger a lazy (non-decoding) count pass
    return None if n is None else n // self.batch_size

  def _first_shape(self, first) -> tuple:
    """The decoded shape of the stream's first image, ``first`` (the
    stream restarts in the same order, so it is read once). It sets the
    reservoir's cap, as the first image does in the JAX package, and the
    dequantization draws a skipped batch advances over (a batch stacks
    images of one shape)."""
    if self._image_shape is None:
      self._image_shape = tuple(self.source.shape(first))
    return self._image_shape

  def _examples(self, rng):
    """One epoch of handles, reservoir-shuffled under a memory cap."""
    stream = self.source.handles()
    if not self.shuffle:
      yield from stream
      return
    buf = []
    cap = None
    for handle in stream:
      if cap is None:
        nbytes = math.prod(self._first_shape(handle))
        cap = max(2 * self.batch_size,
                  min(self.shuffle_buffer, self.buffer_bytes // max(nbytes, 1)))
      if len(buf) < cap:
        buf.append(handle)
        continue
      j = rng.integers(len(buf))
      out, buf[j] = buf[j], handle
      yield out
    rng.shuffle(buf)
    yield from buf

  def _batches(self):
    rng = np.random.default_rng(self.seed)
    while True:  # repeat
      batch, made = [], 0
      for handle in self._examples(rng):
        batch.append(handle)
        if len(batch) < self.batch_size:
          continue
        made += 1
        if self._to_skip:
          self._to_skip -= 1
          _augment_draws(rng, (len(batch),) + self._first_shape(batch[0]),
                         self.random_flip, self.uniform_dequantization)
          batch = []
          yield None
          continue
        images = [self.source.decode(h) for h in batch]
        self.decoded += len(images)
        batch = []
        yield _augment(np.stack(images).astype(np.float32), rng,
                       self.random_flip, self.uniform_dequantization)
      # leftover < batch_size dropped: drop_remainder=True semantics
      if not made:
        raise ValueError(f"the source has fewer images than one batch of "
                         f"{self.batch_size}")


def _make_iterator(images, batch_size: int, *, random_flip: bool,
                   uniform_dequantization: bool, shuffle: bool, seed: int,
                   backend: str):
  """Streaming for a StreamingSource; for an array the native C++ loader
  with ``backend='native'``, else the numpy iterator."""
  if isinstance(images, StreamingSource):
    return StreamingDatasetIterator(
        images, batch_size, random_flip=random_flip,
        uniform_dequantization=uniform_dequantization, shuffle=shuffle,
        seed=seed)
  if backend == "native":
    return native.NativeDataLoader(
        images, batch_size, shuffle=shuffle, random_flip=random_flip,
        uniform_dequantization=uniform_dequantization, seed=seed)
  return DatasetIterator(
      images, batch_size, random_flip=random_flip,
      uniform_dequantization=uniform_dequantization, shuffle=shuffle,
      seed=seed)


def _process() -> tuple:
  """``(index, count)`` of this process: torch.distributed's rank and world
  size where it is initialized, else 0 of 1."""
  import torch.distributed as dist
  if dist.is_available() and dist.is_initialized():
    return dist.get_rank(), dist.get_world_size()
  return 0, 1


def get_dataset(config, *, uniform_dequantization: bool = False,
                evaluation: bool = False, process_index: Optional[int] = None,
                process_count: Optional[int] = None):
  """``(train_iter, eval_iter)`` of this process (JAX datasets.py:485-530).

  Batches are ``training.batch_size`` images, or ``eval.batch_size`` with
  ``evaluation``, split over the processes: each process reads a disjoint
  strided shard and yields local batches of ``batch_size //
  process_count`` (a ValueError where it does not divide), with the seed
  ``config.seed + 7919·process_index``. ``process_index``/``count`` default
  to torch.distributed's rank and world size, or 0 of 1.
  ``uniform_dequantization`` turns dequantization on whatever the config
  says (the bits/dim stage asks for it). Each iterator has
  ``batches_per_epoch`` and, but the native loader, ``skip``.

  ``config.data.loader_backend`` ∈ {auto, native, python}: 'native' runs
  the C++ loader on in-memory sets (it raises where the host library
  cannot be built); 'auto' and 'python' the numpy iterator."""
  backend = config.data.get("loader_backend", "auto")
  if backend not in BACKENDS:
    raise ValueError(f"data.loader_backend={backend!r}: expected one of "
                     f"{BACKENDS}")
  if process_index is None or process_count is None:
    process_index, process_count = _process()
  batch_size = (config.eval.batch_size if evaluation
                else config.training.batch_size)
  if batch_size % process_count != 0:
    raise ValueError(f"batch_size ({batch_size}) must be divisible by the "
                     f"process count ({process_count})")
  local_batch = batch_size // process_count
  dequant = uniform_dequantization or config.data.uniform_dequantization
  seed = config.seed + 7919 * process_index
  train_imgs = shard_for_process(load_raw_dataset(config, "train"),
                                 process_index, process_count)
  eval_imgs = shard_for_process(load_raw_dataset(config, "test"),
                                process_index, process_count)
  train_it = _make_iterator(
      train_imgs, local_batch, random_flip=config.data.random_flip,
      uniform_dequantization=dequant, shuffle=True, seed=seed,
      backend=backend)
  eval_it = _make_iterator(
      eval_imgs, local_batch, random_flip=False,
      uniform_dequantization=dequant, shuffle=False, seed=seed + 1,
      backend=backend)
  return train_it, eval_it
