"""Normalization layers of the NCSN family (NCHW).

Counterpart of score_sde_pytorch_tpu/models/normalization.py:18-258.
Instance statistics are over the spatial axes, per (batch, channel): the
mean and E[x²] − E[x]² in fp32, the variance clamped at 0 against
cancellation, eps 1e-5. Each norm is then applied as one ``x·a + b`` with
per-(batch, channel) fp32 coefficients, and its output is in the input's
dtype (JAX normalization.py:23-41), so a bf16 network keeps bf16
activations while its statistics stay fp32.

Parameter names follow the torch reference (yang-song/score_sde_pytorch
models/normalization.py): ``alpha``/``gamma``/``beta`` vectors, and
``embed.weight`` of shape [num_classes, k·C] for the conditional norms,
whose row is picked by the noise level through
:func:`models.utils.gather_clamped` (JAX clamps an out-of-range index where
torch raises). Constructors take ``num_features`` (and ``num_classes``) and
draw their initial values from an explicit ``torch.Generator``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from score_sde_pytorch_tpu_torch.models import layers, utils


def _spatial_stats(x: torch.Tensor, eps: float = 1e-5):
  """Per-(batch, channel) spatial mean and rstd, fp32 [B, C] (JAX :23-34)."""
  xf = x.float()
  mean = xf.mean(dim=(2, 3))
  var = (xf * xf).mean(dim=(2, 3)) - mean * mean
  return mean, torch.rsqrt(var.clamp_min(0.0) + eps)


def _apply_scale_shift(x: torch.Tensor, a: torch.Tensor,
                       b: torch.Tensor) -> torch.Tensor:
  """``x·a + b`` with [B, C] fp32 coefficients, in the input's dtype."""
  return (x.float() * a[:, :, None, None] + b[:, :, None, None]).to(x.dtype)


def _normalized_means(mean: torch.Tensor) -> torch.Tensor:
  """InstanceNorm++'s channel means, standardized across channels with the
  unbiased variance (JAX :93-95)."""
  m = mean.mean(dim=-1, keepdim=True)
  v = mean.var(dim=-1, keepdim=True, unbiased=True)
  return (mean - m) * torch.rsqrt(v + 1e-5)


def _scale_init(shape, generator: torch.Generator) -> torch.Tensor:
  """N(1, 0.02), the reference's ``normal_(1, 0.02)``."""
  return 1.0 + 0.02 * torch.randn(shape, generator=generator)


def _embedding(num_classes: int, width: int,
               weight: torch.Tensor) -> nn.Embedding:
  embed = nn.utils.skip_init(nn.Embedding, num_classes, width)
  with torch.no_grad():
    embed.weight.copy_(weight)
  return embed


def _uniform_gamma_zero_beta(num_classes: int, c: int, bias: bool,
                             generator: torch.Generator) -> nn.Embedding:
  """[K, 2C] with gamma ~ U[0, 1) and beta = 0, or [K, C] of gamma alone."""
  gamma = torch.rand((num_classes, c), generator=generator)
  if not bias:
    return _embedding(num_classes, c, gamma)
  return _embedding(num_classes, 2 * c,
                    torch.cat([gamma, torch.zeros_like(gamma)], dim=1))


def _rows(embed: nn.Embedding, y: torch.Tensor) -> torch.Tensor:
  return utils.gather_clamped(embed.weight, y).float()


class InstanceNorm2d(nn.Module):
  """Non-affine instance norm, torch ``InstanceNorm2d`` semantics."""

  def __init__(self, num_features: int, bias: bool = True, *,
               generator: Optional[torch.Generator] = None):
    super().__init__()

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    mean, rstd = _spatial_stats(x)
    return _apply_scale_shift(x, rstd, -mean * rstd)


class VarianceNorm2d(nn.Module):
  """Scale-only variance normalization, ``x·alpha/std`` (JAX :58-72)."""

  def __init__(self, num_features: int, bias: bool = False, *,
               generator: torch.Generator):
    super().__init__()
    self.alpha = nn.Parameter(_scale_init((num_features,), generator))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    _, rstd = _spatial_stats(x)
    return _apply_scale_shift(x, rstd * self.alpha[None, :],
                              torch.zeros_like(rstd))


class NoneNorm2d(nn.Module):
  """The identity."""

  def __init__(self, num_features: int, bias: bool = True, *,
               generator: Optional[torch.Generator] = None):
    super().__init__()

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return x


class InstanceNorm2dPlus(nn.Module):
  """NCSN's InstanceNorm++ (JAX :83-105): instance norm with the
  standardized channel means put back, ``gamma·((x − mean)/std +
  means_n·alpha) + beta``, folded into one ``x·a + b``."""

  def __init__(self, num_features: int, bias: bool = True, *,
               generator: torch.Generator):
    super().__init__()
    self.alpha = nn.Parameter(_scale_init((num_features,), generator))
    self.gamma = nn.Parameter(_scale_init((num_features,), generator))
    self.bias = bias
    if bias:
      self.beta = nn.Parameter(torch.zeros(num_features))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    mean, rstd = _spatial_stats(x)
    means_n = _normalized_means(mean)
    gamma = self.gamma[None, :]
    a = gamma * rstd
    b = gamma * (means_n * self.alpha[None, :] - mean * rstd)
    if self.bias:
      b = b + self.beta[None, :]
    return _apply_scale_shift(x, a, b)


class ConditionalInstanceNorm2dPlus(nn.Module):
  """InstanceNorm++ with gamma, alpha (and beta) read from the row of
  ``embed`` at the noise level (JAX :108-143): [K, 3C], the first 2C
  columns drawn N(1, 0.02) and the last C zero."""

  def __init__(self, num_features: int, num_classes: int, bias: bool = True,
               *, generator: torch.Generator):
    super().__init__()
    c = num_features
    scales = _scale_init((num_classes, 2 * c), generator)
    if bias:
      scales = torch.cat([scales, torch.zeros(num_classes, c)], dim=1)
    self.embed = _embedding(num_classes, scales.shape[1], scales)
    self.num_features, self.bias = c, bias

  def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    c = self.num_features
    e = _rows(self.embed, y)
    mean, rstd = _spatial_stats(x)
    means_n = _normalized_means(mean)
    gamma, alpha = e[:, :c], e[:, c:2 * c]
    a = gamma * rstd
    b = gamma * (means_n * alpha - mean * rstd)
    if self.bias:
      b = b + e[:, 2 * c:]
    return _apply_scale_shift(x, a, b)


class _BatchStats(nn.Module):
  """The running statistics of a non-affine batch norm, under the buffer
  names of torch's ``BatchNorm2d``."""

  def __init__(self, num_features: int):
    super().__init__()
    self.register_buffer("running_mean", torch.zeros(num_features))
    self.register_buffer("running_var", torch.ones(num_features))
    self.register_buffer("num_batches_tracked",
                         torch.tensor(0, dtype=torch.long))


class ConditionalBatchNorm2d(nn.Module):
  """Class-conditional batch norm (JAX :146-172): a non-affine batch norm,
  then ``gamma·h + beta`` from the row of ``embed`` (gamma ~ U[0, 1), beta
  zero).

  In training mode the statistics are the batch's (over batch and space,
  the biased variance E[x²] − E[x]² clamped at 0, as flax's BatchNorm
  computes them), and the running ones move by flax's momentum of 0.99;
  in eval mode the running statistics normalize. eps 1e-5."""

  momentum = 0.99
  eps = 1e-5

  def __init__(self, num_features: int, num_classes: int, bias: bool = True,
               *, generator: torch.Generator):
    super().__init__()
    self.bn = _BatchStats(num_features)
    self.embed = _uniform_gamma_zero_beta(num_classes, num_features, bias,
                                          generator)
    self.num_features, self.bias = num_features, bias

  def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    if self.training:
      mean = xf.mean(dim=(0, 2, 3))
      var = ((xf * xf).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
      with torch.no_grad():
        m = self.momentum
        self.bn.running_mean.mul_(m).add_((1 - m) * mean)
        self.bn.running_var.mul_(m).add_((1 - m) * var)
        self.bn.num_batches_tracked += 1
    else:
      mean, var = self.bn.running_mean, self.bn.running_var
    h = (xf - mean[None, :, None, None]) * torch.rsqrt(
        var + self.eps)[None, :, None, None]
    e = _rows(self.embed, y)
    c = self.num_features
    out = e[:, :c, None, None] * h
    if self.bias:
      out = out + e[:, c:, None, None]
    return out.to(x.dtype)


class ConditionalInstanceNorm2d(nn.Module):
  """Conditional instance norm (JAX :175-196): ``gamma·(x − mean)/std +
  beta`` with gamma ~ U[0, 1) and beta zero in ``embed``."""

  def __init__(self, num_features: int, num_classes: int, bias: bool = True,
               *, generator: torch.Generator):
    super().__init__()
    self.embed = _uniform_gamma_zero_beta(num_classes, num_features, bias,
                                          generator)
    self.num_features, self.bias = num_features, bias

  def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    c = self.num_features
    e = _rows(self.embed, y)
    mean, rstd = _spatial_stats(x)
    gamma = e[:, :c]
    shift = -gamma * mean * rstd
    if self.bias:
      shift = shift + e[:, c:]
    return _apply_scale_shift(x, gamma * rstd, shift)


class ConditionalVarianceNorm2d(nn.Module):
  """Conditional variance norm (JAX :199-214): ``x·embed[y]/std``, embed
  drawn N(1, 0.02)."""

  def __init__(self, num_features: int, num_classes: int, bias: bool = False,
               *, generator: torch.Generator):
    super().__init__()
    self.embed = _embedding(num_classes, num_features, _scale_init(
        (num_classes, num_features), generator))

  def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    _, rstd = _spatial_stats(x)
    return _apply_scale_shift(x, _rows(self.embed, y) * rstd,
                              torch.zeros_like(rstd))


class ConditionalNoneNorm2d(nn.Module):
  """No normalization, only the affine ``gamma·x + beta`` from ``embed``
  (JAX :217-235)."""

  def __init__(self, num_features: int, num_classes: int, bias: bool = True,
               *, generator: torch.Generator):
    super().__init__()
    self.embed = _uniform_gamma_zero_beta(num_classes, num_features, bias,
                                          generator)
    self.num_features, self.bias = num_features, bias

  def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    c = self.num_features
    e = _rows(self.embed, y)
    out = e[:, :c, None, None] * x
    if self.bias:
      out = out + e[:, c:, None, None]
    return out


def _group_norm(num_features: int, bias: bool = True, *,
                generator: Optional[torch.Generator] = None
                ) -> layers.GroupNorm:
  """The JAX package's GroupNorm at its defaults: 32 groups, eps 1e-6."""
  return layers.GroupNorm(32, num_features, eps=1e-6)


def get_normalization(config, conditional: bool = False):
  """The constructor of ``config.model.normalization`` (JAX :238-258):
  ``norm(num_features, generator=g)``, or with ``conditional``
  ``norm(num_features, num_classes, generator=g)``, which exists for
  InstanceNorm++ only."""
  norm = config.model.normalization
  if conditional:
    if norm == "InstanceNorm++":
      return ConditionalInstanceNorm2dPlus
    raise NotImplementedError(f"{norm} not implemented yet.")
  if norm == "InstanceNorm":
    return InstanceNorm2d
  if norm == "InstanceNorm++":
    return InstanceNorm2dPlus
  if norm == "VarianceNorm":
    return VarianceNorm2d
  if norm == "GroupNorm":
    return _group_norm
  raise ValueError(f"Unknown normalization: {norm}")
