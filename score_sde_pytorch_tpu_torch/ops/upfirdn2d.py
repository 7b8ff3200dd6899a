"""upfirdn2d and FIR resampling as depthwise ``F.conv2d`` (NCHW).

Counterpart of score_sde_pytorch_tpu/ops/upfirdn2d.py, whose functions are
XLA convolutions, not Pallas kernels; here they are PyTorch/cuDNN
convolutions. Semantics are the reference's ``upfirdn2d_native``: upsample
by zero insertion, pad (possibly negatively), convolve with the FIR kernel
(correlate with the flipped kernel), then subsample. 1-D kernels take two
separable passes (H, then W), as in the JAX package.

Tensors are NCHW here; the JAX package's are NHWC.
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

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


@functools.lru_cache(maxsize=64)
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


def upfirdn2d(x: torch.Tensor, kernel: KernelLike, up: int = 1, down: int = 1,
              pad: Tuple[int, int] = (0, 0)) -> torch.Tensor:
  """Upsample, FIR-filter and downsample an NCHW batch.

  ``pad`` is ``(lo, hi)`` on both spatial axes; entries may be negative.
  Output size per axis: ``(in * up + lo + hi - k) // down + 1``."""
  k = np.asarray(kernel, dtype=np.float32)
  lo, hi = pad
  if k.ndim == 1:
    x = _zero_insert(x, up, 2)
    x = F.pad(x, (0, 0, lo, hi))
    x = _filter(x, k, 2, (down, 1))
    x = _zero_insert(x, up, 3)
    x = F.pad(x, (lo, hi, 0, 0))
    return _filter(x, k, 3, (1, down))
  x = _zero_insert(_zero_insert(x, up, 2), up, 3)
  x = F.pad(x, (lo, hi, lo, hi))
  return _filter(x, k, 0, (down, down))


def upsample_2d(x: torch.Tensor, k: KernelLike = None, factor: int = 2,
                gain: float = 1.0) -> torch.Tensor:
  """FIR upsampling by ``factor`` (reference up_or_down_sampling.py:195-226)."""
  k = setup_kernel([1.0] * factor if k is None else k)
  p = k.shape[0] - factor
  scale = gain * (factor ** 2)
  k = k * (scale if k.ndim == 2 else np.sqrt(scale))
  return upfirdn2d(x, k, up=factor, pad=((p + 1) // 2 + factor - 1, p // 2))


def downsample_2d(x: torch.Tensor, k: KernelLike = None, factor: int = 2,
                  gain: float = 1.0) -> torch.Tensor:
  """FIR downsampling by ``factor`` (reference up_or_down_sampling.py:229-257)."""
  k = setup_kernel([1.0] * factor if k is None else k)
  p = k.shape[0] - factor
  k = k * (gain if k.ndim == 2 else np.sqrt(gain))
  return upfirdn2d(x, k, down=factor, pad=((p + 1) // 2, p // 2))


def conv_downsample_2d(x: torch.Tensor, w: torch.Tensor, k: KernelLike = None,
                       factor: int = 2, gain: float = 1.0) -> torch.Tensor:
  """FIR filter then strided conv (reference up_or_down_sampling.py:144-178).

  ``w`` is OIHW ``[outC, inC, convH, convW]``."""
  _, _, convh, convw = w.shape
  if convh != convw:
    raise ValueError(f"conv kernel must be square, got {convh}x{convw}")
  k = setup_kernel([1.0] * factor if k is None else k)
  p = (k.shape[0] - factor) + (convw - 1)
  k = k * (gain if k.ndim == 2 else np.sqrt(gain))
  x = upfirdn2d(x, k, pad=((p + 1) // 2, p // 2))
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
                     factor: int = 2, gain: float = 1.0) -> torch.Tensor:
  """Transposed conv with stride ``factor``, then FIR filtering
  (reference up_or_down_sampling.py:72-141; JAX upfirdn2d.py:152-181).

  ``w`` is OIHW ``[outC, inC, convH, convW]``; ``conv_transpose2d`` takes it
  as ``[inC, outC, ...]`` and convolves the zero-inserted input with the
  flipped kernel, as the JAX package's dilated conv does."""
  _, _, convh, convw = w.shape
  if convh != convw:
    raise ValueError(f"conv kernel must be square, got {convh}x{convw}")
  k = setup_kernel([1.0] * factor if k is None else k)
  p = (k.shape[0] - factor) - (convw - 1)
  y = F.conv_transpose2d(x, w.transpose(0, 1).to(x.dtype), stride=factor)
  scale = gain * (factor ** 2)
  k = k * (scale if k.ndim == 2 else np.sqrt(scale))
  return upfirdn2d(y, k, pad=((p + 1) // 2 + factor - 1, p // 2 + 1))
