"""NCSN++ layers (NCHW).

Counterpart of score_sde_pytorch_tpu/models/layerspp.py for the modules on
the flagship path. Submodule names and registration order follow the torch
reference (yang-song/score_sde_pytorch models/layerspp.py), so parameters
load from its ``.pth`` files and from
``score_sde_pytorch_tpu.interop.flax_params_to_torch_state_dict`` with
``strict=True``, and ``model.parameters()`` order matches the EMA
``shadow_params`` of those checkpoints.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
from torch import nn

from score_sde_pytorch_tpu_torch.models import layers
from score_sde_pytorch_tpu_torch.ops import attention as attention_ops
from score_sde_pytorch_tpu_torch.ops import upfirdn2d

_SQRT2 = math.sqrt(2.0)


def _groups(channels: int) -> int:
  return min(channels // 4, 32)


def _not_ported(what: str) -> NotImplementedError:
  return NotImplementedError(
      f"{what} is not ported yet; see ROADMAP.md queue 1 items 3 and 11")


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


class AttnBlockpp(nn.Module):
  """Channel-wise self-attention with skip rescale (JAX layerspp.py:59-88).

  The [B, H·W, C] contraction goes through ``ops.attention.attention``: the
  plain version on CPU tensors, the Hopper kernel on CUDA tensors, at every
  grid size."""

  def __init__(self, channels: int, *, generator: torch.Generator,
               skip_rescale: bool = False, init_scale: float = 0.0):
    super().__init__()
    self.GroupNorm_0 = layers.GroupNorm(_groups(channels), channels, eps=1e-6)
    self.NIN_0 = layers.NIN(channels, channels, generator=generator)
    self.NIN_1 = layers.NIN(channels, channels, generator=generator)
    self.NIN_2 = layers.NIN(channels, channels, generator=generator)
    self.NIN_3 = layers.NIN(channels, channels, generator=generator,
                            init_scale=init_scale)
    self.skip_rescale = skip_rescale

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    b, c, h, w = x.shape
    hid = self.GroupNorm_0(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
    q, k, v = self.NIN_0(hid), self.NIN_1(hid), self.NIN_2(hid)
    out = attention_ops.attention(q, k, v)
    out = self.NIN_3(out).reshape(b, h, w, c).permute(0, 3, 1, 2)
    if not self.skip_rescale:
      return x + out
    return (x + out) / _SQRT2


class Conv2dFused(nn.Module):
  """StyleGAN2 conv with fused FIR down-sampling
  (reference up_or_down_sampling.py:23-56), with bias. Weight layout OIHW.

  Only the down form is on the flagship path; the up and plain forms (and
  ``upsample_conv_2d``) are not ported yet."""

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


class Downsample(nn.Module):
  """2x FIR downsample with a fused conv (JAX layerspp.py:154-180), the
  residual input pyramid's; the other forms are not ported yet."""

  def __init__(self, in_ch: int, out_ch: Optional[int] = None, *,
               generator: torch.Generator, with_conv: bool = False,
               fir: bool = False,
               fir_kernel: Sequence[int] = (1, 3, 3, 1)):
    super().__init__()
    if not (fir and with_conv):
      raise _not_ported("Downsample without fir=True and with_conv=True")
    self.Conv2d_0 = Conv2dFused(in_ch, out_ch or in_ch, 3,
                                generator=generator, down=True,
                                resample_kernel=fir_kernel)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return self.Conv2d_0(x)


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
