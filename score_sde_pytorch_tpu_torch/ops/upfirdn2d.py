"""upfirdn2d and FIR resampling as depthwise ``F.conv2d`` (NCHW).

Counterpart of score_sde_pytorch_tpu/ops/upfirdn2d.py, whose functions are
XLA convolutions, not Pallas kernels; here they are PyTorch/cuDNN
convolutions. Semantics are the reference's ``upfirdn2d_native``: upsample
by zero insertion, pad (possibly negatively), convolve with the FIR kernel
(correlate with the flipped kernel), then subsample. 1-D kernels take two
separable passes (H, then W), as in the JAX package.

Tensors are NCHW here; the JAX package's are NHWC.

The FIR functions take a ``group``: a space group
(``parallel/spatial.py``) over which the height is split, or None. With a group, ``x`` is the rank's
slab of rows and so is the result: the padding of H on the slab's inner
edges becomes halo rows from the neighbours (zeros only past the image's
top and bottom edge), and the rows the slab's output needs are worked out
from the filter's pad, up and down factors (:func:`_slab_rows`), so each
output slab starts on its own rows whatever the stride.
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from score_sde_pytorch_tpu_torch.parallel import distributed, spatial
from score_sde_pytorch_tpu_torch.utils import tracing

KernelLike = Union[Sequence[float], np.ndarray]


def setup_kernel(k: KernelLike) -> np.ndarray:
  """Normalize a FIR kernel to unit sum; 1-D kernels stay 1-D (separable)."""
  k = np.asarray(k, dtype=np.float32)
  k = k / np.sum(k)
  if k.ndim == 2 and k.shape[0] != k.shape[1]:
    raise ValueError(f"2-D FIR kernels must be square, got {k.shape}")
  if k.ndim not in (1, 2):
    raise ValueError(f"FIR kernel must be 1-D or 2-D, got {k.ndim}-D")
  return k


# Unbounded: a captured CUDA graph (models/graphs.py) reads these weights
# by address, so none may be dropped and reallocated.
@functools.lru_cache(maxsize=None)
def _depthwise_weight(taps: tuple, channels: int,
                      axis: int, device: torch.device,
                      dtype: torch.dtype) -> torch.Tensor:
  """[C, 1, kh, kw] weight that correlates each channel with the flipped
  taps. ``axis`` 2 or 3 lays a 1-D kernel along H or W; 0 means 2-D."""
  k = torch.tensor(taps, dtype=torch.float32)
  if axis == 2:
    k = k.reshape(-1, 1)
  elif axis == 3:
    k = k.reshape(1, -1)
  w = torch.flip(k, (0, 1))[None, None].expand(channels, 1, *k.shape)
  return w.contiguous().to(device=device, dtype=dtype)


def _zero_insert(x: torch.Tensor, up: int, dim: int) -> torch.Tensor:
  """Insert ``up - 1`` zeros after every element along ``dim`` (2 or 3)."""
  if up == 1:
    return x
  shape = list(x.shape)
  x = F.pad(x.unsqueeze(dim + 1), (0, 0) * (3 - dim) + (0, up - 1))
  shape[dim] *= up
  return x.reshape(shape)


def _filter(x, taps: np.ndarray, axis: int, stride: Tuple[int, int]):
  key = tuple(map(tuple, taps.tolist())) if taps.ndim == 2 else tuple(
      taps.tolist())
  w = _depthwise_weight(key, x.shape[1], axis, x.device, x.dtype)
  return F.conv2d(x, w, stride=stride, groups=x.shape[1])


def _upfirdn(x: torch.Tensor, k: np.ndarray, up: int, down: int,
             pad_h: Tuple[int, int], pad_w: Tuple[int, int]) -> torch.Tensor:
  """upfirdn with its own ``(lo, hi)`` pad on each axis, as the
  ``op.fir`` span (``utils/tracing.py``): every FIR path runs through it."""
  with tracing.span("op.fir"):
    if k.ndim == 1:
      x = _zero_insert(x, up, 2)
      x = F.pad(x, (0, 0) + tuple(pad_h))
      x = _filter(x, k, 2, (down, 1))
      x = _zero_insert(x, up, 3)
      x = F.pad(x, tuple(pad_w) + (0, 0))
      return _filter(x, k, 3, (1, down))
    x = _zero_insert(_zero_insert(x, up, 2), up, 3)
    x = F.pad(x, tuple(pad_w) + tuple(pad_h))
    return _filter(x, k, 0, (down, down))


def _slab_rows(z0: int, z1: int, taps: int, up: int, down: int,
               lo: int) -> tuple:
  """For output rows ``[z0, z1)`` of an upfirdn along H with ``taps``
  taps: the input rows ``[a, b)`` they read and the H pad ``(lo, hi)``
  that makes the filter give exactly those rows from the zero-inserted
  rows ``[a·up, b·up)`` (``hi`` <= 0: a crop). Output row y reads the
  zero-inserted, padded rows ``[y·down, y·down + taps)``, which are input
  rows ``(y·down + j - lo) / up`` where that divides."""
  first = z0 * down - lo
  last = (z1 - 1) * down + taps - 1 - lo
  a = -(-first // up)
  b = last // up + 1
  return a, b, (a * up - first, last + 1 - b * up)


def _upfirdn_slab(x: torch.Tensor, k: np.ndarray, up: int, down: int,
                  pad: Tuple[int, int], z0: int, z1: int,
                  group) -> torch.Tensor:
  """Rows ``[z0, z1)`` of upfirdn over the whole image, from the rank's
  slab ``x`` and the halo rows its neighbours hold."""
  h0, h1 = _in_slab(x, group)
  a, b, pad_h = _slab_rows(z0, z1, k.shape[0], up, down, pad[0])
  x = spatial.rows(x, group, h0 - a, b - h1)
  return _upfirdn(x, k, up, down, pad_h, pad)


def _in_slab(x: torch.Tensor, group) -> tuple:
  """The global rows ``[h0, h1)`` the rank's slab ``x`` holds."""
  h = x.shape[2]
  h0 = distributed.group_rank(group) * h
  return h0, h0 + h


def upfirdn2d(x: torch.Tensor, kernel: KernelLike, up: int = 1, down: int = 1,
              pad: Tuple[int, int] = (0, 0), group=None) -> torch.Tensor:
  """Upsample, FIR-filter and downsample an NCHW batch (a slab of rows with
  a space ``group``).

  ``pad`` is ``(lo, hi)`` on both spatial axes; entries may be negative.
  Output size per axis: ``(in * up + lo + hi - k) // down + 1``."""
  k = np.asarray(kernel, dtype=np.float32)
  if group is None:
    return _upfirdn(x, k, up, down, pad, pad)
  n = distributed.group_size(group)
  out_rows = (x.shape[2] * n * up + sum(pad) - k.shape[0]) // down + 1
  if out_rows % n:
    raise ValueError(f"upfirdn2d: {out_rows} output rows (from "
                     f"{x.shape[2] * n}) do not divide over {n} space ranks")
  z0 = distributed.group_rank(group) * (out_rows // n)
  return _upfirdn_slab(x, k, up, down, pad, z0, z0 + out_rows // n, group)


def upsample_2d(x: torch.Tensor, k: KernelLike = None, factor: int = 2,
                gain: float = 1.0, group=None) -> torch.Tensor:
  """FIR upsampling by ``factor`` (reference up_or_down_sampling.py:195-226)."""
  k = setup_kernel([1.0] * factor if k is None else k)
  p = k.shape[0] - factor
  scale = gain * (factor ** 2)
  k = k * (scale if k.ndim == 2 else np.sqrt(scale))
  return upfirdn2d(x, k, up=factor, pad=((p + 1) // 2 + factor - 1, p // 2),
                   group=group)


def downsample_2d(x: torch.Tensor, k: KernelLike = None, factor: int = 2,
                  gain: float = 1.0, group=None) -> torch.Tensor:
  """FIR downsampling by ``factor`` (reference up_or_down_sampling.py:229-257)."""
  k = setup_kernel([1.0] * factor if k is None else k)
  p = k.shape[0] - factor
  k = k * (gain if k.ndim == 2 else np.sqrt(gain))
  return upfirdn2d(x, k, down=factor, pad=((p + 1) // 2, p // 2), group=group)


def conv_downsample_2d(x: torch.Tensor, w: torch.Tensor, k: KernelLike = None,
                       factor: int = 2, gain: float = 1.0,
                       group=None) -> torch.Tensor:
  """FIR filter then strided conv (reference up_or_down_sampling.py:144-178).

  ``w`` is OIHW ``[outC, inC, convH, convW]``. On a slab, the conv's output
  rows ``[h0, h1) / factor`` read the filtered rows ``[h0, h1 + convH -
  factor)``, which the slab's filter gives with its halo."""
  _, _, convh, convw = w.shape
  if convh != convw:
    raise ValueError(f"conv kernel must be square, got {convh}x{convw}")
  k = setup_kernel([1.0] * factor if k is None else k)
  p = (k.shape[0] - factor) + (convw - 1)
  k = k * (gain if k.ndim == 2 else np.sqrt(gain))
  pad = ((p + 1) // 2, p // 2)
  if group is None:
    x = upfirdn2d(x, k, pad=pad)
  else:
    h0, h1 = _in_slab(x, group)
    if h0 % factor:
      raise ValueError(f"conv_downsample_2d: a slab of {h1 - h0} rows does "
                       f"not start on the stride {factor}")
    x = _upfirdn_slab(x, k, 1, 1, pad, h0, h1 + convw - factor, group)
  return F.conv2d(x, w, stride=factor)


def naive_upsample_2d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
  """Nearest-neighbour upsample (reference up_or_down_sampling.py:59-63)."""
  n, c, h, w = x.shape
  x = x.reshape(n, c, h, 1, w, 1).expand(n, c, h, factor, w, factor)
  return x.reshape(n, c, h * factor, w * factor)


def naive_downsample_2d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
  """Mean-pool downsample (reference up_or_down_sampling.py:66-69)."""
  n, c, h, w = x.shape
  x = x.reshape(n, c, h // factor, factor, w // factor, factor)
  return x.mean(dim=(3, 5))


def upsample_conv_2d(x: torch.Tensor, w: torch.Tensor, k: KernelLike = None,
                     factor: int = 2, gain: float = 1.0,
                     group=None) -> torch.Tensor:
  """Transposed conv with stride ``factor``, then FIR filtering
  (reference up_or_down_sampling.py:72-141; JAX upfirdn2d.py:152-181).

  ``w`` is OIHW ``[outC, inC, convH, convW]``; ``conv_transpose2d`` takes it
  as ``[inC, outC, ...]`` and convolves the zero-inserted input with the
  flipped kernel, as the JAX package's dilated conv does.

  On a slab: the output rows ``[f·h0, f·h1)`` read the transposed conv's
  rows ``[a, b)`` (:func:`_slab_rows`), row t of which sums the input rows
  i with ``0 <= t - f·i < convH``. The transposed conv runs on the slab
  with the input rows those need (zeros past the image's edges, which give
  the zero rows the whole image's pad would), its rows ``[a, b)`` are cut
  out, and the filter runs on them without H padding."""
  _, _, convh, convw = w.shape
  if convh != convw:
    raise ValueError(f"conv kernel must be square, got {convh}x{convw}")
  k = setup_kernel([1.0] * factor if k is None else k)
  p = (k.shape[0] - factor) - (convw - 1)
  scale = gain * (factor ** 2)
  k = k * (scale if k.ndim == 2 else np.sqrt(scale))
  pad = ((p + 1) // 2 + factor - 1, p // 2 + 1)
  w = w.transpose(0, 1).to(x.dtype)
  if group is None:
    return upfirdn2d(F.conv_transpose2d(x, w, stride=factor), k, pad=pad)
  h0, h1 = _in_slab(x, group)
  a, b, _ = _slab_rows(factor * h0, factor * h1, k.shape[0], 1, 1, pad[0])
  i0 = -(-(a - convh + 1) // factor)   # the input rows [i0, i1) they read
  i1 = (b - 1) // factor + 1
  y = F.conv_transpose2d(spatial.rows(x, group, h0 - i0, i1 - h1), w,
                         stride=factor)
  return _upfirdn(y[:, :, a - factor * i0:b - factor * i0], k, 1, 1, (0, 0),
                  pad)
