"""Common layers of the NCSN++ and DDPM score networks (NCHW).

Counterpart of score_sde_pytorch_tpu/models/layers.py for the modules NCSN++
and the legacy DDPM U-Net use. Parameter names and shapes follow the torch
reference (yang-song/score_sde_pytorch), so its ``.pth`` files and
``score_sde_pytorch_tpu.interop.flax_params_to_torch_state_dict`` load with
``strict=True``. Every initializer draws from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from score_sde_pytorch_tpu_torch.ops import attention as attention_ops


def get_act(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
  """Activation from config name (JAX layers.py:40-51)."""
  name = name.lower()
  if name == "elu":
    return F.elu
  if name == "relu":
    return F.relu
  if name == "lrelu":
    return lambda x: F.leaky_relu(x, negative_slope=0.2)
  if name == "swish":
    return F.silu
  raise NotImplementedError(f"activation function {name} does not exist!")


def default_init(scale: float = 1.0):
  """DDPM initializer: variance_scaling(scale, fan_avg, uniform).

  Returns ``init(tensor, fan_in, fan_out, generator)``, which fills
  ``tensor`` in place. The caller gives the fans, because NIN weights are
  [in, out] while conv and linear weights are [out, in, ...]."""
  scale = 1e-10 if scale == 0 else scale

  def init(tensor: torch.Tensor, fan_in: int, fan_out: int,
           generator: torch.Generator) -> None:
    limit = math.sqrt(3.0 * scale / ((fan_in + fan_out) / 2.0))
    with torch.no_grad():
      tensor.uniform_(-limit, limit, generator=generator)

  return init


def _ddpm_conv(in_planes: int, out_planes: int, kernel: int,
               generator: torch.Generator, init_scale: float, stride: int = 1,
               padding: int = None) -> nn.Conv2d:
  """Conv with DDPM init and zero bias, 'SAME' padding unless ``padding``
  is given (reference layers.py:108-131)."""
  conv = nn.utils.skip_init(nn.Conv2d, in_planes, out_planes, kernel,
                            stride=stride,
                            padding=kernel // 2 if padding is None else padding)
  rf = kernel * kernel
  default_init(init_scale)(conv.weight, in_planes * rf, out_planes * rf,
                           generator)
  nn.init.zeros_(conv.bias)
  return conv


def ddpm_conv3x3(in_planes: int, out_planes: int, *,
                 generator: torch.Generator, init_scale: float = 1.0,
                 stride: int = 1, padding: int = None) -> nn.Conv2d:
  return _ddpm_conv(in_planes, out_planes, 3, generator, init_scale, stride,
                    padding)


def ddpm_conv1x1(in_planes: int, out_planes: int, *,
                 generator: torch.Generator,
                 init_scale: float = 1.0) -> nn.Conv2d:
  return _ddpm_conv(in_planes, out_planes, 1, generator, init_scale)


def dense(in_features: int, out_features: int, *,
          generator: torch.Generator) -> nn.Linear:
  """Linear layer with DDPM init and zero bias (reference ncsnpp.py:81-88)."""
  layer = nn.utils.skip_init(nn.Linear, in_features, out_features)
  default_init()(layer.weight, in_features, out_features, generator)
  nn.init.zeros_(layer.bias)
  return layer


def legacy_groups(channels: int) -> int:
  """GroupNorm groups of the legacy DDPM blocks: 32, or gcd(c, 32) where c
  is not a multiple of 32 (small test widths; JAX layers.py:128-133)."""
  return 32 if channels % 32 == 0 else math.gcd(channels, 32)


def get_timestep_embedding(timesteps: torch.Tensor, embedding_dim: int,
                           max_positions: int = 10000) -> torch.Tensor:
  """Sinusoidal embedding of (possibly integer) timesteps [B] (JAX
  layers.py:180-192)."""
  if timesteps.dim() != 1:
    raise ValueError(f"timesteps must be [B], got {tuple(timesteps.shape)}")
  half_dim = embedding_dim // 2
  emb = math.log(max_positions) / (half_dim - 1)
  emb = torch.exp(torch.arange(half_dim, dtype=torch.float32,
                               device=timesteps.device) * -emb)
  emb = timesteps.float()[:, None] * emb[None, :]
  emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=1)
  if embedding_dim % 2 == 1:
    emb = F.pad(emb, (0, 1))
  return emb


class GroupNorm(nn.Module):
  """GroupNorm with fp32 statistics and a clamped variance.

  Reproduces the JAX package's GroupNorm (layers.py:136-177): mean and
  E[x²] − mean² in fp32 over each group's channels and pixels, the variance
  clamped at 0 before the rsqrt, the affine folded into one per-(batch,
  channel) ``x * a + b`` in fp32, and the result cast back to the input
  dtype. Parameters are ``weight`` and ``bias``, as in ``nn.GroupNorm``."""

  def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-6):
    super().__init__()
    if num_channels % num_groups:
      raise ValueError(f"{num_channels} channels in {num_groups} groups")
    self.num_groups = num_groups
    self.eps = eps
    self.weight = nn.Parameter(torch.ones(num_channels))
    self.bias = nn.Parameter(torch.zeros(num_channels))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    b, c = x.shape[:2]
    g = self.num_groups
    xg = x.reshape(b, g, -1).float()
    mean = xg.mean(dim=-1, keepdim=True)
    var = (xg * xg).mean(dim=-1, keepdim=True) - mean * mean
    rstd = torch.rsqrt(var.clamp_min(0.0) + self.eps)          # [B, G, 1]
    scale = self.weight.float().reshape(g, c // g)
    a = rstd * scale                                            # [B, G, C/G]
    shift = self.bias.float().reshape(g, c // g) - mean * rstd * scale
    shape = (b, c) + (1,) * (x.dim() - 2)
    return (x.float() * a.reshape(shape) + shift.reshape(shape)).to(x.dtype)


class NIN(nn.Module):
  """1x1 'network-in-network' over the LAST axis: ``x @ W + b``.

  Channels-last, as the JAX package's NIN ("...c,cd->...d"); the torch
  reference applies the same [in, out] ``W`` after permuting NCHW to NHWC."""

  def __init__(self, in_dim: int, num_units: int, *,
               generator: torch.Generator, init_scale: float = 0.1):
    super().__init__()
    self.W = nn.Parameter(torch.empty(in_dim, num_units))
    self.b = nn.Parameter(torch.zeros(num_units))
    default_init(init_scale)(self.W, in_dim, num_units, generator)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, self.W) + self.b


class AttnBlock(nn.Module):
  """Legacy DDPM channel-wise self-attention over the H·W grid (JAX
  layers.py:211-233, which computes it densely). The [B, H·W, C]
  contraction goes through ``ops.attention.attention``: the plain version
  on CPU tensors, the Hopper kernel on CUDA tensors, at every grid size.
  ``layerspp.AttnBlockpp`` is this block with its own groups, ``NIN_3``
  scale and skip rescale."""

  def __init__(self, channels: int, *, generator: torch.Generator,
               groups: int = None, init_scale: float = 0.0,
               skip_rescale: bool = False):
    super().__init__()
    groups = legacy_groups(channels) if groups is None else groups
    self.GroupNorm_0 = GroupNorm(groups, channels, eps=1e-6)
    self.NIN_0 = NIN(channels, channels, generator=generator)
    self.NIN_1 = NIN(channels, channels, generator=generator)
    self.NIN_2 = NIN(channels, channels, generator=generator)
    self.NIN_3 = NIN(channels, channels, generator=generator,
                     init_scale=init_scale)
    self.skip_rescale = skip_rescale

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    b, c, h, w = x.shape
    hid = self.GroupNorm_0(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
    out = attention_ops.attention(self.NIN_0(hid), self.NIN_1(hid),
                                  self.NIN_2(hid))
    out = self.NIN_3(out).reshape(b, h, w, c).permute(0, 3, 1, 2)
    if not self.skip_rescale:
      return x + out
    return (x + out) / math.sqrt(2.0)


class Upsample(nn.Module):
  """Nearest-neighbour 2x upsample, then an optional 3x3 conv (JAX
  layers.py:236-246)."""

  def __init__(self, channels: int, with_conv: bool = False, *,
               generator: torch.Generator):
    super().__init__()
    if with_conv:
      self.Conv_0 = ddpm_conv3x3(channels, channels, generator=generator)
    self.with_conv = with_conv

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    h = F.interpolate(x, scale_factor=2, mode="nearest")
    return self.Conv_0(h) if self.with_conv else h


class Downsample(nn.Module):
  """2x downsample: a stride-2 3x3 conv after padding the bottom and right
  by one (torch's ``F.pad(x, (0, 1, 0, 1))``), or a 2x2 average pool (JAX
  layers.py:249-263)."""

  def __init__(self, channels: int, with_conv: bool = False, *,
               generator: torch.Generator):
    super().__init__()
    if with_conv:
      self.Conv_0 = ddpm_conv3x3(channels, channels, generator=generator,
                                 stride=2, padding=0)
    self.with_conv = with_conv

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    if self.with_conv:
      return self.Conv_0(F.pad(x, (0, 1, 0, 1)))
    return F.avg_pool2d(x, 2, stride=2)


class ResnetBlockDDPM(nn.Module):
  """Legacy DDPM resblock (JAX layers.py:266-293). ``Dense_0`` exists
  whenever ``temb_dim`` is given, as in the reference, whose DDPM model
  passes it even when unconditional; the forward adds it only with a
  ``temb``."""

  def __init__(self, act: Callable, in_ch: int, out_ch: int = None,
               temb_dim: int = None, conv_shortcut: bool = False,
               dropout: float = 0.1, *, generator: torch.Generator):
    super().__init__()
    out_ch = out_ch or in_ch
    self.GroupNorm_0 = GroupNorm(legacy_groups(in_ch), in_ch, eps=1e-6)
    self.act = act
    self.Conv_0 = ddpm_conv3x3(in_ch, out_ch, generator=generator)
    if temb_dim is not None:
      self.Dense_0 = dense(temb_dim, out_ch, generator=generator)
    self.GroupNorm_1 = GroupNorm(legacy_groups(out_ch), out_ch, eps=1e-6)
    self.Dropout_0 = nn.Dropout(dropout)
    self.Conv_1 = ddpm_conv3x3(out_ch, out_ch, generator=generator,
                               init_scale=0.0)
    self.conv_shortcut = in_ch != out_ch and conv_shortcut
    self.nin_shortcut = in_ch != out_ch and not conv_shortcut
    if self.conv_shortcut:
      self.Conv_2 = ddpm_conv3x3(in_ch, out_ch, generator=generator)
    if self.nin_shortcut:
      self.NIN_0 = NIN(in_ch, out_ch, generator=generator)

  def forward(self, x: torch.Tensor,
              temb: torch.Tensor = None) -> torch.Tensor:
    h = self.act(self.GroupNorm_0(x))
    h = self.Conv_0(h)
    if temb is not None:
      h = h + self.Dense_0(self.act(temb))[:, :, None, None]
    h = self.act(self.GroupNorm_1(h))
    h = self.Dropout_0(h)
    h = self.Conv_1(h)
    if self.conv_shortcut:
      x = self.Conv_2(x)
    elif self.nin_shortcut:
      x = self.NIN_0(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
    return x + h
