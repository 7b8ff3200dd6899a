"""Common layers of the score networks (NCHW): NCSN++, the legacy DDPM
U-Net and the NCSN/NCSNv2 RefineNet family.

Counterpart of score_sde_pytorch_tpu/models/layers.py. Parameter names and
shapes follow the torch reference (yang-song/score_sde_pytorch), so its
``.pth`` files and the state_dicts of
``score_sde_pytorch_tpu.interop.flax_params_to_torch_state_dict`` load
with ``strict=True``. Every initializer draws from an explicit
``torch.Generator``.

Computation dtype (``model.dtype``), as the JAX package applies it: a conv,
``Dense`` or ``NIN`` built with ``dtype`` casts its input and weight to it
(and its bias to the input's new dtype), so with ``torch.bfloat16`` it
computes and returns bf16 while its parameters stay fp32. One built without
runs in the promoted dtype of its input and weight, as flax's ``dtype=None``
does: a bf16 input meets an fp32 conv in fp32. Norms compute their
statistics in fp32 and return the input's dtype. The dtype is passed down
explicitly; the JAX package sets it for the RefineNet convs through a
context variable (JAX layers.py:20-37).
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from score_sde_pytorch_tpu_torch.ops import attention as attention_ops


def _swish(x: torch.Tensor) -> torch.Tensor:
  """``x·sigmoid(x)``. Below fp32 it is computed as JAX's ``jax.nn.silu``
  lowers, ``x · (1 / (1 + exp(-x)))`` with every step rounded to ``x``'s
  dtype."""
  if x.dtype == torch.float32:
    return F.silu(x)
  return x * (1 / (1 + torch.exp(-x)))


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
    return _swish
  raise NotImplementedError(f"activation function {name} does not exist!")


@functools.lru_cache(maxsize=None)
def weak_scalar(value: float, dtype: torch.dtype) -> float:
  """``value`` as JAX applies a Python scalar to an array of ``dtype``: a
  weakly typed scalar takes the array's dtype, so against a bf16 array it
  is rounded to bf16 first."""
  return torch.tensor(value, dtype=dtype).item()


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


def _compute_dtype(x: torch.Tensor, param: torch.Tensor,
                   dtype: Optional[torch.dtype]) -> torch.dtype:
  return dtype if dtype is not None else torch.promote_types(x.dtype,
                                                             param.dtype)


class Conv2d(nn.Conv2d):
  """``nn.Conv2d`` with a computation dtype ``compute_dtype``, as flax's
  ``nn.Conv(dtype=...)`` (see the module docstring). Its state_dict is
  ``nn.Conv2d``'s."""

  def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None,
               device=None, **kwargs):
    super().__init__(*args, device=device, **kwargs)
    self.compute_dtype = compute_dtype

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    dtype = _compute_dtype(x, self.weight, self.compute_dtype)
    if dtype == torch.float32 or self.bias is None:
      return self._conv_forward(x.to(dtype), self.weight.to(dtype),
                                self.bias)
    # flax adds the bias after the conv's result is rounded to bf16
    out = self._conv_forward(x.to(dtype), self.weight.to(dtype), None)
    return out + self.bias.to(dtype)[:, None, None]


class Linear(nn.Linear):
  """``nn.Linear`` with a computation dtype, as flax's
  ``nn.Dense(dtype=...)``."""

  def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None,
               device=None, **kwargs):
    super().__init__(*args, device=device, **kwargs)
    self.compute_dtype = compute_dtype

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    dtype = _compute_dtype(x, self.weight, self.compute_dtype)
    if dtype == torch.float32:
      return F.linear(x, self.weight, self.bias)
    return F.linear(x.to(dtype), self.weight.to(dtype)) + self.bias.to(dtype)


def _ddpm_conv(in_planes: int, out_planes: int, kernel: int,
               generator: torch.Generator, init_scale: float, stride: int = 1,
               padding: int = None,
               dtype: Optional[torch.dtype] = None) -> Conv2d:
  """Conv with DDPM init and zero bias, 'SAME' padding unless ``padding``
  is given (reference layers.py:108-131)."""
  conv = nn.utils.skip_init(Conv2d, in_planes, out_planes, kernel,
                            stride=stride,
                            padding=kernel // 2 if padding is None else padding,
                            compute_dtype=dtype)
  rf = kernel * kernel
  default_init(init_scale)(conv.weight, in_planes * rf, out_planes * rf,
                           generator)
  nn.init.zeros_(conv.bias)
  return conv


def ddpm_conv3x3(in_planes: int, out_planes: int, *,
                 generator: torch.Generator, init_scale: float = 1.0,
                 stride: int = 1, padding: int = None,
                 dtype: Optional[torch.dtype] = None) -> Conv2d:
  return _ddpm_conv(in_planes, out_planes, 3, generator, init_scale, stride,
                    padding, dtype)


def ddpm_conv1x1(in_planes: int, out_planes: int, *,
                 generator: torch.Generator, init_scale: float = 1.0,
                 dtype: Optional[torch.dtype] = None) -> Conv2d:
  return _ddpm_conv(in_planes, out_planes, 1, generator, init_scale,
                    dtype=dtype)


def dense(in_features: int, out_features: int, *,
          generator: torch.Generator,
          dtype: Optional[torch.dtype] = None) -> Linear:
  """Linear layer with DDPM init and zero bias (reference ncsnpp.py:81-88)."""
  layer = nn.utils.skip_init(Linear, in_features, out_features,
                             compute_dtype=dtype)
  default_init()(layer.weight, in_features, out_features, generator)
  nn.init.zeros_(layer.bias)
  return layer


def ncsn_init(scale: float = 1.0):
  """NCSN conv init: torch's default conv init, U(±1/√fan_in), times
  ``scale`` (JAX layers.py:64-72). Returns ``init(tensor, fan_in,
  generator)``."""
  scale = 1e-10 if scale == 0 else scale

  def init(tensor: torch.Tensor, fan_in: int,
           generator: torch.Generator) -> None:
    limit = scale / math.sqrt(fan_in)
    with torch.no_grad():
      tensor.uniform_(-limit, limit, generator=generator)

  return init


def _ncsn_conv(in_planes: int, out_planes: int, kernel: int,
               generator: torch.Generator, stride: int, bias: bool,
               dilation: int, init_scale: float, padding: Optional[int],
               dtype: Optional[torch.dtype]) -> Conv2d:
  """Conv with NCSN init and zero bias; 'SAME' padding (the dilation on each
  side of a 3x3) unless ``padding`` is given (JAX layers.py:101-125)."""
  if padding is None:
    padding = dilation * (kernel - 1) // 2
  conv = nn.utils.skip_init(Conv2d, in_planes, out_planes, kernel,
                            stride=stride, dilation=dilation, padding=padding,
                            bias=bias, compute_dtype=dtype)
  ncsn_init(init_scale)(conv.weight, in_planes * kernel * kernel, generator)
  if bias:
    nn.init.zeros_(conv.bias)
  return conv


def ncsn_conv3x3(in_planes: int, out_planes: int, *,
                 generator: torch.Generator, stride: int = 1,
                 bias: bool = True, dilation: int = 1,
                 init_scale: float = 1.0,
                 dtype: Optional[torch.dtype] = None) -> Conv2d:
  return _ncsn_conv(in_planes, out_planes, 3, generator, stride, bias,
                    dilation, init_scale, None, dtype)


def ncsn_conv1x1(in_planes: int, out_planes: int, *,
                 generator: torch.Generator, stride: int = 1,
                 bias: bool = True, init_scale: float = 1.0,
                 dtype: Optional[torch.dtype] = None) -> Conv2d:
  return _ncsn_conv(in_planes, out_planes, 1, generator, stride, bias, 1,
                    init_scale, None, dtype)


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
  reference applies the same [in, out] ``W`` after permuting NCHW to NHWC.
  With ``dtype``, ``x`` and ``W`` are cast to it and ``b`` to ``x``'s new
  dtype (JAX layers.py:195-208)."""

  def __init__(self, in_dim: int, num_units: int, *,
               generator: torch.Generator, init_scale: float = 0.1,
               dtype: Optional[torch.dtype] = None):
    super().__init__()
    self.W = nn.Parameter(torch.empty(in_dim, num_units))
    self.b = nn.Parameter(torch.zeros(num_units))
    default_init(init_scale)(self.W, in_dim, num_units, generator)
    self.dtype = dtype

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    w = self.W
    if self.dtype is not None:
      x, w = x.to(self.dtype), w.to(self.dtype)
    b = self.b.to(x.dtype)
    dtype = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(dtype), w.to(dtype)) + b


class AttnBlock(nn.Module):
  """Legacy DDPM channel-wise self-attention over the H·W grid (JAX
  layers.py:211-233, which computes it densely). The [B, H·W, C]
  contraction goes through ``ops.attention.attention``: the plain version
  on CPU tensors, the Hopper kernel on CUDA tensors, at every grid size.
  ``layerspp.AttnBlockpp`` is this block with its own groups, ``NIN_3``
  scale and skip rescale."""

  def __init__(self, channels: int, *, generator: torch.Generator,
               groups: int = None, init_scale: float = 0.0,
               skip_rescale: bool = False,
               dtype: Optional[torch.dtype] = None):
    super().__init__()
    groups = legacy_groups(channels) if groups is None else groups
    self.GroupNorm_0 = GroupNorm(groups, channels, eps=1e-6)
    self.NIN_0 = NIN(channels, channels, generator=generator, dtype=dtype)
    self.NIN_1 = NIN(channels, channels, generator=generator, dtype=dtype)
    self.NIN_2 = NIN(channels, channels, generator=generator, dtype=dtype)
    self.NIN_3 = NIN(channels, channels, generator=generator,
                     init_scale=init_scale, dtype=dtype)
    self.skip_rescale = skip_rescale

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    b, c, h, w = x.shape
    hid = self.GroupNorm_0(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
    out = attention_ops.attention(self.NIN_0(hid), self.NIN_1(hid),
                                  self.NIN_2(hid))
    out = self.NIN_3(out).reshape(b, h, w, c).permute(0, 3, 1, 2)
    out = out.to(x.dtype)
    if not self.skip_rescale:
      return x + out
    return (x + out) / weak_scalar(math.sqrt(2.0), x.dtype)


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


# ---------------------------------------------------------------------------
# NCSN / NCSNv2 (RefineNet) blocks, JAX layers.py:300-650. Submodule names
# and registration order are the torch reference's (its layers.py:133-507),
# so its NCSN checkpoints load with ``strict=True``. A norm argument is a
# constructor from models.normalization: ``norm(C, generator=g)``, or for
# the conditional blocks ``norm(C, num_classes, generator=g)``.
# ---------------------------------------------------------------------------


def _mean_pool2(x: torch.Tensor) -> torch.Tensor:
  """2x2 mean pool as four strided slices summed, in the JAX package's order
  (JAX layers.py:502-503)."""
  return (x[:, :, ::2, ::2] + x[:, :, 1::2, ::2] + x[:, :, ::2, 1::2]
          + x[:, :, 1::2, 1::2]) / 4.0


def _bilinear_resize(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
  """Bilinear resize with align_corners=True (JAX layers.py:382-399). JAX
  weighs the bf16 pixels with fp32 weights, so a resized bf16 tensor comes
  out fp32; an unresized one keeps its dtype."""
  if tuple(x.shape[2:]) == tuple(shape):
    return x
  return F.interpolate(x.float(), size=tuple(shape), mode="bilinear",
                       align_corners=True)


class CRPBlock(nn.Module):
  """Chained residual pooling (JAX layers.py:300-316): ``n_stages`` rounds
  of a 5x5 stride-1 pool (max pool padded with -inf, or an average pool
  that counts the zero padding, as flax's and torch's defaults do) and a
  bias-free 3x3 conv, each added to the running sum."""

  def __init__(self, features: int, n_stages: int, act: Callable = F.relu,
               maxpool: bool = True, *, generator: torch.Generator,
               dtype: Optional[torch.dtype] = None):
    super().__init__()
    self.convs = nn.ModuleList([
        ncsn_conv3x3(features, features, bias=False, generator=generator,
                     dtype=dtype) for _ in range(n_stages)])
    self.pool = (nn.MaxPool2d(5, stride=1, padding=2) if maxpool
                 else nn.AvgPool2d(5, stride=1, padding=2))
    self.act = act

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    x = self.act(x)
    path = x
    for conv in self.convs:
      path = conv(self.pool(path))
      x = path + x
    return x


class CondCRPBlock(nn.Module):
  """Conditional CRP (JAX layers.py:319-337): a conditional norm before each
  stage's average pool."""

  def __init__(self, features: int, n_stages: int, num_classes: int,
               normalizer, act: Callable = F.relu, *,
               generator: torch.Generator,
               dtype: Optional[torch.dtype] = None):
    super().__init__()
    self.convs = nn.ModuleList()
    self.norms = nn.ModuleList()
    for _ in range(n_stages):
      self.norms.append(normalizer(features, num_classes, bias=True,
                                   generator=generator))
      self.convs.append(ncsn_conv3x3(features, features, bias=False,
                                     generator=generator, dtype=dtype))
    self.pool = nn.AvgPool2d(5, stride=1, padding=2)
    self.act = act

  def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    x = self.act(x)
    path = x
    for norm, conv in zip(self.norms, self.convs):
      path = conv(self.pool(norm(path, y)))
      x = path + x
    return x


class RCUBlock(nn.Module):
  """Residual conv units (JAX layers.py:340-356): ``n_blocks`` residual
  units of ``n_stages`` (act, bias-free 3x3 conv) each; convs
  ``{i}_{j}_conv``."""

  def __init__(self, features: int, n_blocks: int, n_stages: int,
               act: Callable = F.relu, *, generator: torch.Generator,
               dtype: Optional[torch.dtype] = None):
    super().__init__()
    for i in range(n_blocks):
      for j in range(n_stages):
        setattr(self, f"{i + 1}_{j + 1}_conv", ncsn_conv3x3(
            features, features, bias=False, generator=generator,
            dtype=dtype))
    self.n_blocks, self.n_stages, self.act = n_blocks, n_stages, act

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    for i in range(self.n_blocks):
      residual = x
      for j in range(self.n_stages):
        x = getattr(self, f"{i + 1}_{j + 1}_conv")(self.act(x))
      x = x + residual
    return x


class CondRCUBlock(nn.Module):
  """Conditional RCU (JAX layers.py:359-379): ``{i}_{j}_norm`` before each
  act."""

  def __init__(self, features: int, n_blocks: int, n_stages: int,
               num_classes: int, normalizer, act: Callable = F.relu, *,
               generator: torch.Generator,
               dtype: Optional[torch.dtype] = None):
    super().__init__()
    for i in range(n_blocks):
      for j in range(n_stages):
        setattr(self, f"{i + 1}_{j + 1}_norm", normalizer(
            features, num_classes, bias=True, generator=generator))
        setattr(self, f"{i + 1}_{j + 1}_conv", ncsn_conv3x3(
            features, features, bias=False, generator=generator,
            dtype=dtype))
    self.n_blocks, self.n_stages, self.act = n_blocks, n_stages, act

  def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    for i in range(self.n_blocks):
      residual = x
      for j in range(self.n_stages):
        x = getattr(self, f"{i + 1}_{j + 1}_norm")(x, y)
        x = getattr(self, f"{i + 1}_{j + 1}_conv")(self.act(x))
      x = x + residual
    return x


class MSFBlock(nn.Module):
  """Multi-scale fusion (JAX layers.py:402-413): each input through a 3x3
  conv with bias, resized bilinearly to ``shape``, and summed."""

  def __init__(self, in_planes: Sequence[int], features: int, *,
               generator: torch.Generator,
               dtype: Optional[torch.dtype] = None):
    super().__init__()
    self.convs = nn.ModuleList([
        ncsn_conv3x3(c, features, bias=True, generator=generator,
                     dtype=dtype) for c in in_planes])

  def forward(self, xs: Sequence[torch.Tensor],
              shape: Sequence[int]) -> torch.Tensor:
    total = None
    for conv, x in zip(self.convs, xs):
      h = _bilinear_resize(conv(x), shape)
      total = h if total is None else total + h
    return total


class CondMSFBlock(nn.Module):
  """Conditional MSF (JAX layers.py:416-432): a conditional norm before
  each conv."""

  def __init__(self, in_planes: Sequence[int], features: int,
               num_classes: int, normalizer, *, generator: torch.Generator,
               dtype: Optional[torch.dtype] = None):
    super().__init__()
    self.convs = nn.ModuleList()
    self.norms = nn.ModuleList()
    for c in in_planes:
      self.convs.append(ncsn_conv3x3(c, features, bias=True,
                                     generator=generator, dtype=dtype))
      self.norms.append(normalizer(c, num_classes, bias=True,
                                   generator=generator))

  def forward(self, xs: Sequence[torch.Tensor], y: torch.Tensor,
              shape: Sequence[int]) -> torch.Tensor:
    total = None
    for conv, norm, x in zip(self.convs, self.norms, xs):
      h = _bilinear_resize(conv(norm(x, y)), shape)
      total = h if total is None else total + h
    return total


class RefineBlock(nn.Module):
  """RefineNet block (JAX layers.py:435-456): an RCU per input, MSF fusion
  when there is more than one, CRP, then an output RCU (3 units at the
  ``end``). ``start`` blocks have no MSF."""

  def __init__(self, in_planes: Sequence[int], features: int,
               act: Callable = F.relu, start: bool = False,
               end: bool = False, maxpool: bool = True, *,
               generator: torch.Generator,
               dtype: Optional[torch.dtype] = None):
    super().__init__()
    g = generator
    self.adapt_convs = nn.ModuleList([
        RCUBlock(c, 2, 2, act, generator=g, dtype=dtype) for c in in_planes])
    self.output_convs = RCUBlock(features, 3 if end else 1, 2, act,
                                 generator=g, dtype=dtype)
    if not start:
      self.msf = MSFBlock(in_planes, features, generator=g, dtype=dtype)
    self.crp = CRPBlock(features, 2, act, maxpool=maxpool, generator=g,
                        dtype=dtype)

  def forward(self, xs: Sequence[torch.Tensor],
              output_shape: Sequence[int]) -> torch.Tensor:
    hs = [adapt(x) for adapt, x in zip(self.adapt_convs, xs)]
    h = self.msf(hs, output_shape) if len(hs) > 1 else hs[0]
    return self.output_convs(self.crp(h))


class CondRefineBlock(nn.Module):
  """Conditional RefineNet block (JAX layers.py:459-485)."""

  def __init__(self, in_planes: Sequence[int], features: int,
               num_classes: int, normalizer, act: Callable = F.relu,
               start: bool = False, end: bool = False, *,
               generator: torch.Generator,
               dtype: Optional[torch.dtype] = None):
    super().__init__()
    g = generator
    self.adapt_convs = nn.ModuleList([
        CondRCUBlock(c, 2, 2, num_classes, normalizer, act, generator=g,
                     dtype=dtype) for c in in_planes])
    self.output_convs = CondRCUBlock(features, 3 if end else 1, 2,
                                     num_classes, normalizer, act,
                                     generator=g, dtype=dtype)
    if not start:
      self.msf = CondMSFBlock(in_planes, features, num_classes, normalizer,
                              generator=g, dtype=dtype)
    self.crp = CondCRPBlock(features, 2, num_classes, normalizer, act,
                            generator=g, dtype=dtype)

  def forward(self, xs: Sequence[torch.Tensor], y: torch.Tensor,
              output_shape: Sequence[int]) -> torch.Tensor:
    hs = [adapt(x, y) for adapt, x in zip(self.adapt_convs, xs)]
    h = self.msf(hs, y, output_shape) if len(hs) > 1 else hs[0]
    return self.output_convs(self.crp(h, y), y)


class ConvMeanPool(nn.Module):
  """Conv, then a 2x2 mean pool (JAX layers.py:488-504). With
  ``adjust_padding`` the input is first padded by one row on top and one
  column on the left, and the conv sits behind that pad as ``conv.1`` (the
  reference's ``nn.Sequential(nn.ZeroPad2d((1, 0, 1, 0)), conv)``)."""

  def __init__(self, input_dim: int, output_dim: int, kernel_size: int = 3,
               biases: bool = True, adjust_padding: bool = False, *,
               generator: torch.Generator,
               dtype: Optional[torch.dtype] = None):
    super().__init__()
    conv = _ncsn_conv(input_dim, output_dim, kernel_size, generator, 1,
                      biases, 1, 1.0, kernel_size // 2, dtype)
    self.conv = (nn.Sequential(nn.ZeroPad2d((1, 0, 1, 0)), conv)
                 if adjust_padding else conv)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return _mean_pool2(self.conv(x))


class MeanPoolConv(nn.Module):
  """A 2x2 mean pool, then a conv (JAX layers.py:507-518)."""

  def __init__(self, input_dim: int, output_dim: int, kernel_size: int = 3,
               biases: bool = True, *, generator: torch.Generator,
               dtype: Optional[torch.dtype] = None):
    super().__init__()
    self.conv = _ncsn_conv(input_dim, output_dim, kernel_size, generator, 1,
                           biases, 1, 1.0, None, dtype)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return self.conv(_mean_pool2(x))


class UpsampleConv(nn.Module):
  """A 2x nearest upsample, then a conv (JAX layers.py:521-535, whose four
  channel copies and depth-to-space are that upsample)."""

  def __init__(self, input_dim: int, output_dim: int, kernel_size: int = 3,
               biases: bool = True, *, generator: torch.Generator,
               dtype: Optional[torch.dtype] = None):
    super().__init__()
    self.conv = _ncsn_conv(input_dim, output_dim, kernel_size, generator, 1,
                           biases, 1, 1.0, None, dtype)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


def _residual_convs(input_dim: int, output_dim: int, resample, dilation: int,
                    adjust_padding: bool, generator: torch.Generator,
                    dtype: Optional[torch.dtype]) -> Tuple:
  """The convs of a (conditional) residual block and the width of its
  second norm (JAX layers.py:549-590): ``(conv1, norm2_width, conv2,
  shortcut)``, ``shortcut`` None where the block adds its input."""
  g = generator

  def conv3(cin, cout):
    return ncsn_conv3x3(cin, cout, dilation=dilation, generator=g,
                        dtype=dtype)

  if resample == "down":
    if dilation > 1:
      return (conv3(input_dim, input_dim), input_dim,
              conv3(input_dim, output_dim), conv3(input_dim, output_dim))
    return (ncsn_conv3x3(input_dim, input_dim, generator=g, dtype=dtype),
            input_dim,
            ConvMeanPool(input_dim, output_dim, 3,
                         adjust_padding=adjust_padding, generator=g,
                         dtype=dtype),
            ConvMeanPool(input_dim, output_dim, 1,
                         adjust_padding=adjust_padding, generator=g,
                         dtype=dtype))
  if resample is not None:
    raise ValueError("invalid resample value")
  shortcut = None
  if output_dim != input_dim:
    shortcut = (conv3(input_dim, output_dim) if dilation > 1 else
                ncsn_conv1x1(input_dim, output_dim, generator=g, dtype=dtype))
  return (conv3(input_dim, output_dim), output_dim,
          conv3(output_dim, output_dim), shortcut)


class ResidualBlock(nn.Module):
  """NCSNv2 residual block (JAX layers.py:538-591): norm, act, conv, norm,
  act, conv, plus the input or its shortcut conv. ``resample='down'``
  halves the size through ConvMeanPool, or, with ``dilation`` > 1, keeps it
  (the dilated convs pad by their dilation, JAX's "SAME")."""

  def __init__(self, input_dim: int, output_dim: int, normalization,
               resample: Optional[str] = None, act: Callable = F.elu,
               adjust_padding: bool = False, dilation: int = 1, *,
               generator: torch.Generator,
               dtype: Optional[torch.dtype] = None):
    super().__init__()
    conv1, width2, conv2, shortcut = _residual_convs(
        input_dim, output_dim, resample, dilation, adjust_padding, generator,
        dtype)
    self.conv1 = conv1
    self.normalize2 = normalization(width2, generator=generator)
    self.conv2 = conv2
    if shortcut is not None:
      self.shortcut = shortcut
    self.normalize1 = normalization(input_dim, generator=generator)
    self.act = act

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    h = self.conv1(self.act(self.normalize1(x)))
    h = self.conv2(self.act(self.normalize2(h)))
    shortcut = self.shortcut(x) if hasattr(self, "shortcut") else x
    return shortcut + h


class ConditionalResidualBlock(nn.Module):
  """NCSNv1's residual block (JAX layers.py:594-650): ResidualBlock with
  conditional norms."""

  def __init__(self, input_dim: int, output_dim: int, num_classes: int,
               normalization, resample: Optional[str] = None,
               act: Callable = F.elu, adjust_padding: bool = False,
               dilation: int = 1, *, generator: torch.Generator,
               dtype: Optional[torch.dtype] = None):
    super().__init__()
    conv1, width2, conv2, shortcut = _residual_convs(
        input_dim, output_dim, resample, dilation, adjust_padding, generator,
        dtype)
    self.conv1 = conv1
    self.normalize2 = normalization(width2, num_classes, generator=generator)
    self.conv2 = conv2
    if shortcut is not None:
      self.shortcut = shortcut
    self.normalize1 = normalization(input_dim, num_classes,
                                    generator=generator)
    self.act = act

  def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    h = self.conv1(self.act(self.normalize1(x, y)))
    h = self.conv2(self.act(self.normalize2(h, y)))
    shortcut = self.shortcut(x) if hasattr(self, "shortcut") else x
    return shortcut + h
