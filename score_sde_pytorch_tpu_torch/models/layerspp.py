"""NCSN++ layers (NCHW).

Counterpart of score_sde_pytorch_tpu/models/layerspp.py. Submodule names
and registration order follow the torch reference (yang-song/score_sde_pytorch
models/layerspp.py), so parameters load from its ``.pth`` files and from
``score_sde_pytorch_tpu.interop.flax_params_to_torch_state_dict`` with
``strict=True``, and ``model.parameters()`` order matches the EMA
``shadow_params`` of those checkpoints. ``dtype`` is the computation dtype
of the convs, ``Dense`` and ``NIN`` layers (see models/layers.py), passed
where the JAX package passes it (JAX layerspp.py:43-272).

On a slab of rows (``parallel/spatial.py``) the FIR resamplers and fused
convs go through the slab forms of ``ops/upfirdn2d.py`` and the non-FIR
``Downsample`` pads the image's bottom row on the last space rank only,
taking a halo row elsewhere; the naive resamplers, the nearest upsample and
the average pool are local to a slab whose rows start on the stride.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from score_sde_pytorch_tpu_torch.models import layers
from score_sde_pytorch_tpu_torch.ops import upfirdn2d
from score_sde_pytorch_tpu_torch.parallel import spatial

_SQRT2 = math.sqrt(2.0)


def _groups(channels: int) -> int:
  return min(channels // 4, 32)


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
               skip_rescale: bool = False, init_scale: float = 0.0,
               dtype: Optional[torch.dtype] = None):
    super().__init__(channels, generator=generator, groups=_groups(channels),
                     init_scale=init_scale, skip_rescale=skip_rescale,
                     dtype=dtype)


class Combine(nn.Module):
  """Combine the input pyramid with the trunk (JAX layerspp.py:43-56): a
  1x1 conv ``Conv_0`` of the pyramid, then concatenated before the trunk
  (``'cat'``) or added to it (``'sum'``), in the trunk's dtype."""

  def __init__(self, dim1: int, dim2: int, method: str = "cat", *,
               generator: torch.Generator,
               dtype: Optional[torch.dtype] = None):
    super().__init__()
    if method not in ("cat", "sum"):
      raise ValueError(f"Method {method} not recognized.")
    self.Conv_0 = layers.ddpm_conv1x1(dim1, dim2, generator=generator,
                                      dtype=dtype)
    self.method = method

  def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    h = self.Conv_0(x).to(y.dtype)
    if self.method == "cat":
      return torch.cat([h, y], dim=1)
    return h + y


class Conv2dFused(nn.Module):
  """StyleGAN2 conv with fused FIR up- or down-sampling, or neither
  (reference up_or_down_sampling.py:23-56; JAX layerspp.py:91-122), with
  bias. Weight layout OIHW. With ``dtype`` the input and weight are cast to
  it; the fp32 bias is added after the conv, so the output is fp32, as in
  the JAX package (its callers cast it back to the trunk's dtype)."""

  def __init__(self, in_ch: int, out_ch: int, kernel: int, *,
               generator: torch.Generator, up: bool = False,
               down: bool = False,
               resample_kernel: Sequence[int] = (1, 3, 3, 1),
               dtype: Optional[torch.dtype] = None):
    super().__init__()
    if up and down:
      raise ValueError("Conv2dFused resamples up or down, not both")
    if kernel < 1 or kernel % 2 != 1:
      raise ValueError(f"Conv2dFused wants an odd kernel, got {kernel}")
    self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel))
    rf = kernel * kernel
    layers.default_init()(self.weight, in_ch * rf, out_ch * rf, generator)
    self.bias = nn.Parameter(torch.zeros(out_ch))
    self.up, self.down = up, down
    self.resample_kernel = tuple(resample_kernel)
    self.dtype = dtype

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    w = self.weight
    if self.dtype is not None:
      x, w = x.to(self.dtype), w.to(self.dtype)
    group = spatial.group()
    if self.up:
      x = upfirdn2d.upsample_conv_2d(x, w, k=self.resample_kernel,
                                     group=group)
    elif self.down:
      x = upfirdn2d.conv_downsample_2d(x, w, k=self.resample_kernel,
                                       group=group)
    elif group is None:
      x = F.conv2d(x, w.to(x.dtype), padding=w.shape[-1] // 2)
    else:
      p = w.shape[-1] // 2
      x = F.conv2d(spatial.rows(x, group, p, p), w.to(x.dtype),
                   padding=(0, p))
    return x + self.bias.reshape(1, -1, 1, 1)


class Upsample(nn.Module):
  """2x upsample (JAX layerspp.py:127-151): nearest, then an optional 3x3
  conv ``Conv_0``; or FIR, alone (the output pyramid's) or fused with a
  transposed conv ``Conv2d_0`` (the residual output pyramid's)."""

  def __init__(self, in_ch: int, out_ch: Optional[int] = None, *,
               generator: torch.Generator, with_conv: bool = False,
               fir: bool = False,
               fir_kernel: Sequence[int] = (1, 3, 3, 1),
               dtype: Optional[torch.dtype] = None):
    super().__init__()
    out_ch = out_ch or in_ch
    if fir and with_conv:
      self.Conv2d_0 = Conv2dFused(in_ch, out_ch, 3, generator=generator,
                                  up=True, resample_kernel=fir_kernel,
                                  dtype=dtype)
    elif with_conv:
      self.Conv_0 = layers.ddpm_conv3x3(in_ch, out_ch, generator=generator,
                                        dtype=dtype)
    self.with_conv, self.fir = with_conv, fir
    self.fir_kernel = tuple(fir_kernel)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    if self.fir:
      if self.with_conv:
        return self.Conv2d_0(x)
      return upfirdn2d.upsample_2d(x, self.fir_kernel, factor=2,
                                   group=spatial.group())
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
               fir_kernel: Sequence[int] = (1, 3, 3, 1),
               dtype: Optional[torch.dtype] = None):
    super().__init__()
    out_ch = out_ch or in_ch
    if fir and with_conv:
      self.Conv2d_0 = Conv2dFused(in_ch, out_ch, 3, generator=generator,
                                  down=True, resample_kernel=fir_kernel,
                                  dtype=dtype)
    elif with_conv:
      self.Conv_0 = layers.ddpm_conv3x3(in_ch, out_ch, generator=generator,
                                        stride=2, padding=0, dtype=dtype)
    self.with_conv, self.fir = with_conv, fir
    self.fir_kernel = tuple(fir_kernel)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    if self.fir:
      if self.with_conv:
        return self.Conv2d_0(x)
      return upfirdn2d.downsample_2d(x, self.fir_kernel, factor=2,
                                     group=spatial.group())
    if self.with_conv:
      group = spatial.group()
      if group is None:
        return self.Conv_0(F.pad(x, (0, 1, 0, 1)))
      # The bottom row of padding is the next rank's first row, and zeros
      # on the last rank only.
      return self.Conv_0.conv(F.pad(spatial.rows(x, group, 0, 1), (0, 1)),
                              self.Conv_0.padding)
    return F.avg_pool2d(x, 2, stride=2)


class ResnetBlockBigGANpp(nn.Module):
  """BigGAN-style resblock with in-block resampling (JAX layerspp.py:222-272)."""

  def __init__(self, act: Callable, in_ch: int, out_ch: Optional[int] = None,
               temb_dim: Optional[int] = None, *,
               generator: torch.Generator, up: bool = False,
               down: bool = False, dropout: float = 0.1, fir: bool = False,
               fir_kernel: Sequence[int] = (1, 3, 3, 1),
               skip_rescale: bool = True, init_scale: float = 0.0,
               dtype: Optional[torch.dtype] = None):
    super().__init__()
    if up and down:
      raise ValueError("a resblock resamples up or down, not both")
    out_ch = out_ch or in_ch
    g = generator
    self.GroupNorm_0 = layers.GroupNorm(_groups(in_ch), in_ch, eps=1e-6)
    self.Conv_0 = layers.ddpm_conv3x3(in_ch, out_ch, generator=g, dtype=dtype)
    if temb_dim is not None:
      self.Dense_0 = layers.dense(temb_dim, out_ch, generator=g, dtype=dtype)
    self.GroupNorm_1 = layers.GroupNorm(_groups(out_ch), out_ch, eps=1e-6)
    self.Dropout_0 = nn.Dropout(dropout)
    self.Conv_1 = layers.ddpm_conv3x3(out_ch, out_ch, generator=g,
                                      init_scale=init_scale, dtype=dtype)
    if in_ch != out_ch or up or down:
      self.Conv_2 = layers.ddpm_conv1x1(in_ch, out_ch, generator=g,
                                        dtype=dtype)
    self.act = act
    self.up, self.down, self.fir = up, down, fir
    self.fir_kernel = tuple(fir_kernel)
    self.skip_rescale = skip_rescale
    self.has_shortcut = in_ch != out_ch or up or down

  def _resample(self, x: torch.Tensor) -> torch.Tensor:
    if self.up:
      if self.fir:
        return upfirdn2d.upsample_2d(x, self.fir_kernel, factor=2,
                                     group=spatial.group())
      return upfirdn2d.naive_upsample_2d(x, factor=2)
    if self.down:
      if self.fir:
        return upfirdn2d.downsample_2d(x, self.fir_kernel, factor=2,
                                       group=spatial.group())
      return upfirdn2d.naive_downsample_2d(x, factor=2)
    return x

  def forward(self, x: torch.Tensor,
              temb: Optional[torch.Tensor] = None) -> torch.Tensor:
    h = layers.norm_act(self.GroupNorm_0, x, self.act)
    h = self._resample(h)
    x = self._resample(x)
    h = self.Conv_0(h)
    if temb is not None:
      h = h + self.Dense_0(self.act(temb))[:, :, None, None]
    h = layers.norm_act(self.GroupNorm_1, h, self.act)
    h = self.Dropout_0(h)
    h = self.Conv_1(h)
    if self.has_shortcut:
      x = self.Conv_2(x)
    h = h.to(x.dtype)
    if not self.skip_rescale:
      return x + h
    return (x + h) / layers.weak_scalar(_SQRT2, x.dtype)


class ResnetBlockDDPMpp(nn.Module):
  """DDPM-style resblock of NCSN++ ``resblock_type='ddpm'`` (JAX
  layerspp.py:183-220): GroupNorm with ``min(C/4, 32)`` groups, the temb
  ``Dense_0``, and a 3x3 conv (``Conv_2``) or ``NIN_0`` shortcut where the
  width changes. ``Dense_0`` exists whenever ``temb_dim`` is given, as in
  the reference; the forward adds it only with a ``temb``."""

  def __init__(self, act: Callable, in_ch: int, out_ch: Optional[int] = None,
               temb_dim: Optional[int] = None, *,
               generator: torch.Generator, conv_shortcut: bool = False,
               dropout: float = 0.1, skip_rescale: bool = False,
               init_scale: float = 0.0, dtype: Optional[torch.dtype] = None):
    super().__init__()
    out_ch = out_ch or in_ch
    g = generator
    self.GroupNorm_0 = layers.GroupNorm(_groups(in_ch), in_ch, eps=1e-6)
    self.Conv_0 = layers.ddpm_conv3x3(in_ch, out_ch, generator=g, dtype=dtype)
    if temb_dim is not None:
      self.Dense_0 = layers.dense(temb_dim, out_ch, generator=g, dtype=dtype)
    self.GroupNorm_1 = layers.GroupNorm(_groups(out_ch), out_ch, eps=1e-6)
    self.Dropout_0 = nn.Dropout(dropout)
    self.Conv_1 = layers.ddpm_conv3x3(out_ch, out_ch, generator=g,
                                      init_scale=init_scale, dtype=dtype)
    self.conv_shortcut = in_ch != out_ch and conv_shortcut
    self.nin_shortcut = in_ch != out_ch and not conv_shortcut
    if self.conv_shortcut:
      self.Conv_2 = layers.ddpm_conv3x3(in_ch, out_ch, generator=g,
                                        dtype=dtype)
    if self.nin_shortcut:
      self.NIN_0 = layers.NIN(in_ch, out_ch, generator=g, dtype=dtype)
    self.act = act
    self.skip_rescale = skip_rescale

  def forward(self, x: torch.Tensor,
              temb: Optional[torch.Tensor] = None) -> torch.Tensor:
    h = self.Conv_0(layers.norm_act(self.GroupNorm_0, x, self.act))
    if temb is not None:
      h = h + self.Dense_0(self.act(temb))[:, :, None, None]
    h = self.Dropout_0(layers.norm_act(self.GroupNorm_1, h, self.act))
    h = self.Conv_1(h)
    if self.conv_shortcut:
      x = self.Conv_2(x)
    elif self.nin_shortcut:
      x = self.NIN_0(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
    h = h.to(x.dtype)
    if not self.skip_rescale:
      return x + h
    return (x + h) / layers.weak_scalar(_SQRT2, x.dtype)
