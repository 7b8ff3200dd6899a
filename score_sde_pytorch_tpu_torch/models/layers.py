"""Common layers of the NCSN++ path (NCHW).

Counterpart of score_sde_pytorch_tpu/models/layers.py for the modules the
flagship NCSN++ uses. Parameter names and shapes follow the torch reference
(yang-song/score_sde_pytorch), so its ``.pth`` files and
``score_sde_pytorch_tpu.interop.flax_params_to_torch_state_dict`` load with
``strict=True``. Every initializer draws from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn


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
               generator: torch.Generator, init_scale: float) -> nn.Conv2d:
  """'SAME' conv with DDPM init and zero bias (reference layers.py:108-131)."""
  conv = nn.utils.skip_init(nn.Conv2d, in_planes, out_planes, kernel,
                            padding=kernel // 2)
  rf = kernel * kernel
  default_init(init_scale)(conv.weight, in_planes * rf, out_planes * rf,
                           generator)
  nn.init.zeros_(conv.bias)
  return conv


def ddpm_conv3x3(in_planes: int, out_planes: int, *,
                 generator: torch.Generator,
                 init_scale: float = 1.0) -> nn.Conv2d:
  return _ddpm_conv(in_planes, out_planes, 3, generator, init_scale)


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
