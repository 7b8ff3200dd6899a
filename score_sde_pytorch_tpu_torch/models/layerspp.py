"""NCSN++ layers (NCHW).

Counterpart of score_sde_pytorch_tpu/models/layerspp.py for the modules of
the shipped NCSN++ and DDPM++ configs. Submodule names and registration
order follow the torch reference (yang-song/score_sde_pytorch
models/layerspp.py), so parameters load from its ``.pth`` files and from
``score_sde_pytorch_tpu.interop.flax_params_to_torch_state_dict`` with
``strict=True``, and ``model.parameters()`` order matches the EMA
``shadow_params`` of those checkpoints.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from score_sde_pytorch_tpu_torch.models import layers
from score_sde_pytorch_tpu_torch.ops import upfirdn2d

_SQRT2 = math.sqrt(2.0)


def _groups(channels: int) -> int:
  return min(channels // 4, 32)


def _not_ported(what: str) -> NotImplementedError:
  return NotImplementedError(
      f"{what} is not ported yet; see ROADMAP.md queue 1 item 2 (no shipped "
      "config uses it)")


class GaussianFourierProjection(nn.Module):
  """Gaussian Fourier features of the noise level (JAX layerspp.py:25-40).

  ``W`` is a fixed random projection: a parameter with
  ``requires_grad=False``, as in the torch reference, so it is in the
  state_dict but not among the EMA's shadow parameters."""

  def __init__(self, embedding_size: int = 256, scale: float = 1.0, *,
               generator: torch.Generator):
    super().__init__()
    w = torch.randn(embedding_size, generator=generator) * scale
    self.W = nn.Parameter(w, requires_grad=False)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    x_proj = x[:, None] * self.W[None, :] * 2 * math.pi
    return torch.cat([torch.sin(x_proj), torch.cos(x_proj)], dim=-1)


class AttnBlockpp(layers.AttnBlock):
  """Channel-wise self-attention with skip rescale (JAX layerspp.py:59-88):
  the legacy block with ``min(C/4, 32)`` groups, ``NIN_3`` drawn at
  ``init_scale`` and, with ``skip_rescale``, ``(x + out)/√2``. Its
  contraction runs the Hopper kernel on CUDA tensors, at every grid size."""

  def __init__(self, channels: int, *, generator: torch.Generator,
               skip_rescale: bool = False, init_scale: float = 0.0):
    super().__init__(channels, generator=generator, groups=_groups(channels),
                     init_scale=init_scale, skip_rescale=skip_rescale)


class Combine(nn.Module):
  """Combine the input pyramid with the trunk (JAX layerspp.py:43-56): a
  1x1 conv ``Conv_0`` of the pyramid, then concatenated before the trunk
  (``'cat'``) or added to it (``'sum'``)."""

  def __init__(self, dim1: int, dim2: int, method: str = "cat", *,
               generator: torch.Generator):
    super().__init__()
    if method not in ("cat", "sum"):
      raise ValueError(f"Method {method} not recognized.")
    self.Conv_0 = layers.ddpm_conv1x1(dim1, dim2, generator=generator)
    self.method = method

  def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    h = self.Conv_0(x)
    if self.method == "cat":
      return torch.cat([h, y], dim=1)
    return h + y


class Conv2dFused(nn.Module):
  """StyleGAN2 conv with fused FIR down-sampling
  (reference up_or_down_sampling.py:23-56), with bias. Weight layout OIHW.

  Only the down form is on a shipped config's path; the up and plain forms
  (and ``upsample_conv_2d``, for ``progressive='residual'``) are not ported
  yet."""

  def __init__(self, in_ch: int, out_ch: int, kernel: int, *,
               generator: torch.Generator, up: bool = False,
               down: bool = False,
               resample_kernel: Sequence[int] = (1, 3, 3, 1)):
    super().__init__()
    if up or not down:
      raise _not_ported("Conv2dFused without down=True")
    self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel))
    rf = kernel * kernel
    layers.default_init()(self.weight, in_ch * rf, out_ch * rf, generator)
    self.bias = nn.Parameter(torch.zeros(out_ch))
    self.resample_kernel = tuple(resample_kernel)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    x = upfirdn2d.conv_downsample_2d(x, self.weight, k=self.resample_kernel)
    return x + self.bias.reshape(1, -1, 1, 1)


class Upsample(nn.Module):
  """2x upsample (JAX layerspp.py:127-151): nearest, then an optional 3x3
  conv ``Conv_0``; or FIR without a conv (the output pyramid's). FIR with a
  fused conv (``progressive='residual'``) is not ported yet."""

  def __init__(self, in_ch: int, out_ch: Optional[int] = None, *,
               generator: torch.Generator, with_conv: bool = False,
               fir: bool = False,
               fir_kernel: Sequence[int] = (1, 3, 3, 1)):
    super().__init__()
    if fir and with_conv:
      raise _not_ported("Upsample with fir=True and with_conv=True")
    if with_conv:
      self.Conv_0 = layers.ddpm_conv3x3(in_ch, out_ch or in_ch,
                                        generator=generator)
    self.with_conv, self.fir = with_conv, fir
    self.fir_kernel = tuple(fir_kernel)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    if self.fir:
      return upfirdn2d.upsample_2d(x, self.fir_kernel, factor=2)
    h = F.interpolate(x, scale_factor=2, mode="nearest")
    return self.Conv_0(h) if self.with_conv else h


class Downsample(nn.Module):
  """2x downsample (JAX layerspp.py:154-180): FIR with a fused conv
  ``Conv2d_0`` (the residual input pyramid's) or without one (the
  ``input_skip`` pyramid's); else a stride-2 3x3 conv ``Conv_0`` after
  padding the bottom and right by one, or a 2x2 average pool."""

  def __init__(self, in_ch: int, out_ch: Optional[int] = None, *,
               generator: torch.Generator, with_conv: bool = False,
               fir: bool = False,
               fir_kernel: Sequence[int] = (1, 3, 3, 1)):
    super().__init__()
    out_ch = out_ch or in_ch
    if fir and with_conv:
      self.Conv2d_0 = Conv2dFused(in_ch, out_ch, 3, generator=generator,
                                  down=True, resample_kernel=fir_kernel)
    elif with_conv:
      self.Conv_0 = layers.ddpm_conv3x3(in_ch, out_ch, generator=generator,
                                        stride=2, padding=0)
    self.with_conv, self.fir = with_conv, fir
    self.fir_kernel = tuple(fir_kernel)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    if self.fir:
      if self.with_conv:
        return self.Conv2d_0(x)
      return upfirdn2d.downsample_2d(x, self.fir_kernel, factor=2)
    if self.with_conv:
      return self.Conv_0(F.pad(x, (0, 1, 0, 1)))
    return F.avg_pool2d(x, 2, stride=2)


class ResnetBlockBigGANpp(nn.Module):
  """BigGAN-style resblock with in-block resampling (JAX layerspp.py:222-272)."""

  def __init__(self, act: Callable, in_ch: int, out_ch: Optional[int] = None,
               temb_dim: Optional[int] = None, *,
               generator: torch.Generator, up: bool = False,
               down: bool = False, dropout: float = 0.1, fir: bool = False,
               fir_kernel: Sequence[int] = (1, 3, 3, 1),
               skip_rescale: bool = True, init_scale: float = 0.0):
    super().__init__()
    if up and down:
      raise ValueError("a resblock resamples up or down, not both")
    out_ch = out_ch or in_ch
    self.GroupNorm_0 = layers.GroupNorm(_groups(in_ch), in_ch, eps=1e-6)
    self.Conv_0 = layers.ddpm_conv3x3(in_ch, out_ch, generator=generator)
    if temb_dim is not None:
      self.Dense_0 = layers.dense(temb_dim, out_ch, generator=generator)
    self.GroupNorm_1 = layers.GroupNorm(_groups(out_ch), out_ch, eps=1e-6)
    self.Dropout_0 = nn.Dropout(dropout)
    self.Conv_1 = layers.ddpm_conv3x3(out_ch, out_ch, generator=generator,
                                      init_scale=init_scale)
    if in_ch != out_ch or up or down:
      self.Conv_2 = layers.ddpm_conv1x1(in_ch, out_ch, generator=generator)
    self.act = act
    self.up, self.down, self.fir = up, down, fir
    self.fir_kernel = tuple(fir_kernel)
    self.skip_rescale = skip_rescale
    self.has_shortcut = in_ch != out_ch or up or down

  def _resample(self, x: torch.Tensor) -> torch.Tensor:
    if self.up:
      if self.fir:
        return upfirdn2d.upsample_2d(x, self.fir_kernel, factor=2)
      return upfirdn2d.naive_upsample_2d(x, factor=2)
    if self.down:
      if self.fir:
        return upfirdn2d.downsample_2d(x, self.fir_kernel, factor=2)
      return upfirdn2d.naive_downsample_2d(x, factor=2)
    return x

  def forward(self, x: torch.Tensor,
              temb: Optional[torch.Tensor] = None) -> torch.Tensor:
    h = self.act(self.GroupNorm_0(x))
    h = self._resample(h)
    x = self._resample(x)
    h = self.Conv_0(h)
    if temb is not None:
      h = h + self.Dense_0(self.act(temb))[:, :, None, None]
    h = self.act(self.GroupNorm_1(h))
    h = self.Dropout_0(h)
    h = self.Conv_1(h)
    if self.has_shortcut:
      x = self.Conv_2(x)
    if not self.skip_rescale:
      return x + h
    return (x + h) / _SQRT2
