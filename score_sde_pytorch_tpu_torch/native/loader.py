"""Python wrapper of the C++ batch producer (a copy of the JAX package's
native/loader.py on the port's build)."""
from __future__ import annotations

import numpy as np

from score_sde_pytorch_tpu_torch.native import build

FLAG_SHUFFLE = 1
FLAG_FLIP = 2
FLAG_DEQUANT = 4


class NativeDataLoader:
  """Infinite float32 [0,1] NHWC batch iterator backed by C++ worker threads.

  Semantics match ``datasets.DatasetIterator`` (shuffle per epoch, drop
  remainder, optional flip / uniform dequantization) with the library's
  own random numbers, except that with ``nthreads > 1`` batch delivery
  order may interleave across epoch boundaries. It has no ``skip``: a
  resumed run restarts its stream (``run_lib.train``).
  """

  def __init__(self, images: np.ndarray, batch_size: int, *,
               shuffle: bool = True, random_flip: bool = False,
               uniform_dequantization: bool = False, seed: int = 0,
               nthreads: int = 2, ring_depth: int = 4):
    if images.dtype != np.uint8 or images.ndim != 4:
      raise ValueError(f"NativeDataLoader takes uint8 NHWC images, got "
                       f"{images.dtype} of shape {images.shape}")
    lib = build.load()
    self._lib = lib
    self._images = np.ascontiguousarray(images)  # keep alive
    n, h, w, c = images.shape
    self.batch_shape = (batch_size, h, w, c)
    self.batches_per_epoch = n // batch_size
    flags = ((FLAG_SHUFFLE if shuffle else 0)
             | (FLAG_FLIP if random_flip else 0)
             | (FLAG_DEQUANT if uniform_dequantization else 0))
    self._out = np.empty(self.batch_shape, np.float32)
    self._handle = lib.dl_create(
        self._images.ctypes.data, n, h, w, c, batch_size, flags, seed,
        nthreads, ring_depth)
    if not self._handle:
      raise RuntimeError("dl_create failed")

  def __iter__(self):
    return self

  def __next__(self) -> np.ndarray:
    self._lib.dl_next(self._handle, self._out.ctypes.data)
    return self._out.copy()

  def close(self):
    if getattr(self, "_handle", None):
      self._lib.dl_destroy(self._handle)
      self._handle = None

  def __del__(self):
    self.close()
