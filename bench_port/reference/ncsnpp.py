"""NCSN++ in plain PyTorch: the benchmark's reference score network.

The layer equations of NCSN++ (Song et al., "Score-Based Generative
Modeling through Stochastic Differential Equations", ICLR 2021; the
published yang-song/score_sde models/ncsnpp.py and layerspp.py), written
out with ``torch.nn.functional`` alone: convolutions and dense layers as
``F.conv2d`` / ``F.linear``, GroupNorm as ``F.group_norm``, attention as
``softmax(q kᵀ / √C) v`` on materialized logits, and FIR resampling as
StyleGAN2's ``upfirdn2d_native`` (zero insertion, padding, one 2-D
convolution with the outer product of the taps, subsampling) run per
channel. It imports nothing of the program under test.

Parameter names follow the published module tree (one flat
``all_modules`` list), so the benchmark hands one set of seeded tensors to
this model and to the program's. Only the branches the benchmark's
configurations use are written: Fourier time embedding, conditional
BigGAN resblocks with FIR, DDPM attention, ``progressive`` 'none' or
'output_skip', ``progressive_input`` 'residual' or 'input_skip' with a
'sum' combiner, skip rescale, scale by sigma, uncentered data. Anything
else raises.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_SQRT2 = math.sqrt(2.0)


def _groups(channels: int) -> int:
  return min(channels // 4, 32)


# --- leaves: each says how the benchmark draws its parameters -------------

class Conv(nn.Module):
  """A k×k convolution with bias (weight OIHW)."""

  def __init__(self, cin, cout, k, stride=1, padding=None):
    super().__init__()
    self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
    self.bias = nn.Parameter(torch.empty(cout))
    self.stride = stride
    self.padding = k // 2 if padding is None else padding
    self.role = "main"

  def init_kinds(self):
    rf = self.weight.shape[2] * self.weight.shape[3]
    fans = (self.weight.shape[1] * rf, self.weight.shape[0] * rf, self.role)
    return {"weight": ("fan", fans), "bias": ("bias", None)}

  def forward(self, x):
    return F.conv2d(x, self.weight, self.bias, self.stride, self.padding)


class Dense(nn.Module):
  def __init__(self, cin, cout):
    super().__init__()
    self.weight = nn.Parameter(torch.empty(cout, cin))
    self.bias = nn.Parameter(torch.empty(cout))
    self.role = "main"

  def init_kinds(self):
    return {"weight": ("fan", (self.weight.shape[1], self.weight.shape[0],
                               self.role)),
            "bias": ("bias", None)}

  def forward(self, x):
    return F.linear(x, self.weight, self.bias)


class NIN(nn.Module):
  """``x @ W + b`` over the last axis (W is [in, out])."""

  def __init__(self, cin, cout):
    super().__init__()
    self.W = nn.Parameter(torch.empty(cin, cout))
    self.b = nn.Parameter(torch.empty(cout))
    self.role = "main"

  def init_kinds(self):
    return {"W": ("fan", (*self.W.shape, self.role)),
            "b": ("bias", None)}

  def forward(self, x):
    return x @ self.W + self.b


class GroupNorm(nn.Module):
  def __init__(self, channels):
    super().__init__()
    self.groups = _groups(channels)
    self.weight = nn.Parameter(torch.empty(channels))
    self.bias = nn.Parameter(torch.empty(channels))

  def init_kinds(self):
    return {"weight": ("norm_weight", None), "bias": ("bias", None)}

  def forward(self, x):
    return F.group_norm(x, self.groups, self.weight, self.bias, eps=1e-6)


class Fourier(nn.Module):
  """Gaussian Fourier features of log(sigma); W is fixed (no gradient)."""

  def __init__(self, size, scale):
    super().__init__()
    self.W = nn.Parameter(torch.empty(size), requires_grad=False)
    self.scale = scale

  def init_kinds(self):
    return {"W": ("normal", self.scale)}

  def forward(self, log_sigma):
    proj = log_sigma[:, None] * self.W[None, :] * 2 * math.pi
    return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


# --- FIR resampling ----------------------------------------------------------

def _fir_kernel(taps, gain):
  k = np.asarray(taps, dtype=np.float64)
  k = np.outer(k, k)
  return k / k.sum() * gain


def upfirdn2d(x, kernel, up=1, down=1, pad=(0, 0)):
  """StyleGAN2's ``upfirdn2d_native`` on NCHW: every channel zero-inserted
  by ``up``, padded by ``pad`` = (lo, hi) on both axes, convolved with the
  2-D ``kernel`` (correlation with the flipped kernel), then subsampled by
  ``down``."""
  n, c, h, w = x.shape
  x = x.reshape(n * c, 1, h, 1, w, 1)
  x = F.pad(x, (0, up - 1, 0, 0, 0, up - 1))
  x = x.reshape(n * c, 1, h * up, w * up)
  lo, hi = pad
  x = F.pad(x, (max(lo, 0), max(hi, 0), max(lo, 0), max(hi, 0)))
  x = x[:, :, max(-lo, 0):x.shape[2] - max(-hi, 0),
        max(-lo, 0):x.shape[3] - max(-hi, 0)]
  k = torch.tensor(kernel[::-1, ::-1].copy(), dtype=x.dtype,
                   device=x.device)[None, None]
  x = F.conv2d(x, k)[:, :, ::down, ::down]
  return x.reshape(n, c, x.shape[2], x.shape[3])


def fir_up(x, taps):
  k = _fir_kernel(taps, 4.0)  # gain · factor²
  p = k.shape[0] - 2
  return upfirdn2d(x, k, up=2, pad=((p + 1) // 2 + 1, p // 2))


def fir_down(x, taps):
  k = _fir_kernel(taps, 1.0)
  p = k.shape[0] - 2
  return upfirdn2d(x, k, down=2, pad=((p + 1) // 2, p // 2))


class FusedDown(nn.Module):
  """FIR filter then a stride-2 3×3 convolution (the residual input
  pyramid's downsampler)."""

  def __init__(self, cin, cout, taps):
    super().__init__()
    self.Conv2d_0 = Conv(cin, cout, 3, stride=2, padding=0)
    self.taps = taps

  def forward(self, x):
    k = _fir_kernel(self.taps, 1.0)
    p = (k.shape[0] - 2) + 2
    x = upfirdn2d(x, k, pad=((p + 1) // 2, p // 2))
    return self.Conv2d_0(x)


# --- blocks -----------------------------------------------------------------

class ResBlock(nn.Module):
  """BigGAN resblock with FIR up or down, time embedding, dropout and a
  1×1 shortcut where the width or the size changes; (x + h)/√2."""

  def __init__(self, cin, cout, temb_dim, dropout, taps, up=False,
               down=False):
    super().__init__()
    cout = cout or cin
    self.GroupNorm_0 = GroupNorm(cin)
    self.Conv_0 = Conv(cin, cout, 3)
    self.Dense_0 = Dense(temb_dim, cout)
    self.Dense_0.role = "time"
    self.GroupNorm_1 = GroupNorm(cout)
    self.Conv_1 = Conv(cout, cout, 3)
    self.Conv_1.role = "branch_out"
    if cin != cout or up or down:
      self.Conv_2 = Conv(cin, cout, 1)
    self.up, self.down, self.taps, self.dropout = up, down, taps, dropout

  def _resample(self, x):
    if self.up:
      return fir_up(x, self.taps)
    if self.down:
      return fir_down(x, self.taps)
    return x

  def forward(self, x, temb):
    h = F.silu(self.GroupNorm_0(x))
    h = self._resample(h)
    x = self._resample(x)
    h = self.Conv_0(h)
    h = h + self.Dense_0(F.silu(temb))[:, :, None, None]
    h = F.silu(self.GroupNorm_1(h))
    h = F.dropout(h, self.dropout, self.training)
    h = self.Conv_1(h)
    if hasattr(self, "Conv_2"):
      x = self.Conv_2(x)
    return (x + h) / _SQRT2


class AttnBlock(nn.Module):
  """softmax(q kᵀ/√C) v over the H·W grid, projections over channels."""

  def __init__(self, channels):
    super().__init__()
    self.GroupNorm_0 = GroupNorm(channels)
    self.NIN_0 = NIN(channels, channels)
    self.NIN_1 = NIN(channels, channels)
    self.NIN_2 = NIN(channels, channels)
    self.NIN_3 = NIN(channels, channels)
    self.NIN_3.role = "branch_out"

  def forward(self, x):
    b, c, h, w = x.shape
    hid = self.GroupNorm_0(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
    q, k, v = self.NIN_0(hid), self.NIN_1(hid), self.NIN_2(hid)
    attn = torch.softmax(q @ k.transpose(1, 2) / math.sqrt(c), dim=-1)
    out = self.NIN_3(attn @ v).reshape(b, h, w, c).permute(0, 3, 1, 2)
    return (x + out) / _SQRT2


class Combine(nn.Module):
  def __init__(self, cin, cout):
    super().__init__()
    self.Conv_0 = Conv(cin, cout, 1)

  def forward(self, pyramid, h):
    return self.Conv_0(pyramid) + h


# --- the network -------------------------------------------------------------

def check_supported(model_cfg: dict, data_cfg: dict) -> None:
  want = {"name": "ncsnpp", "normalization": "GroupNorm",
          "nonlinearity": "swish", "resblock_type": "biggan",
          "attention_type": "ddpm", "embedding_type": "fourier",
          "conditional": True, "fir": True, "skip_rescale": True,
          "scale_by_sigma": True, "resamp_with_conv": True,
          "progressive_combine": "sum", "conv_size": 3}
  for key, value in want.items():
    if model_cfg[key] != value:
      raise NotImplementedError(f"reference NCSN++: model.{key}="
                                f"{model_cfg[key]!r} is not written")
  if model_cfg["progressive"] not in ("none", "output_skip"):
    raise NotImplementedError(f"progressive={model_cfg['progressive']!r}")
  if model_cfg["progressive_input"] not in ("residual", "input_skip"):
    raise NotImplementedError(
        f"progressive_input={model_cfg['progressive_input']!r}")
  if data_cfg["centered"]:
    raise NotImplementedError("centered data")


class NCSNpp(nn.Module):
  """The network; ``forward(x, sigma)`` takes NCHW images in [0, 1] (plus
  noise) and the noise levels, and returns the score."""

  def __init__(self, config: dict):
    super().__init__()
    m, data = config["model"], config["data"]
    check_supported(m, data)
    nf, ch_mult = m["nf"], tuple(m["ch_mult"])
    self.nrb = nrb = m["num_res_blocks"]
    self.attn_res = tuple(m["attn_resolutions"])
    self.nres = nres = len(ch_mult)
    self.progressive = m["progressive"]
    self.progressive_input = m["progressive_input"]
    self.taps = taps = tuple(m["fir_kernel"])
    res = [data["image_size"] // 2 ** i for i in range(nres)]
    channels = data["num_channels"]
    temb = nf * 4

    def block(cin, cout=None, up=False, down=False):
      return ResBlock(cin, cout, temb, m["dropout"], taps, up, down)

    mods = [Fourier(nf, m["fourier_scale"]), Dense(nf * 2, temb),
            Dense(temb, temb), Conv(channels, nf, 3)]
    hs_c, cin, pyr_ch = [nf], nf, channels
    for i in range(nres):
      for _ in range(nrb):
        mods.append(block(cin, nf * ch_mult[i]))
        cin = nf * ch_mult[i]
        if res[i] in self.attn_res:
          mods.append(AttnBlock(cin))
        hs_c.append(cin)
      if i != nres - 1:
        mods.append(block(cin, down=True))
        if self.progressive_input == "input_skip":
          mods.append(Combine(pyr_ch, cin))
        else:
          mods.append(FusedDown(pyr_ch, cin, taps))
          pyr_ch = cin
        hs_c.append(cin)
    mods += [block(cin), AttnBlock(cin), block(cin)]
    for i in reversed(range(nres)):
      for _ in range(nrb + 1):
        mods.append(block(cin + hs_c.pop(), nf * ch_mult[i]))
        cin = nf * ch_mult[i]
      if res[i] in self.attn_res:
        mods.append(AttnBlock(cin))
      if self.progressive == "output_skip":
        mods += [GroupNorm(cin), Conv(cin, channels, 3)]
        mods[-1].role = "branch_out"
      if i != 0:
        mods.append(block(cin, up=True))
    if self.progressive == "none":
      mods += [GroupNorm(cin), Conv(cin, channels, 3)]
      mods[-1].role = "branch_out"
    self.all_modules = nn.ModuleList(mods)

  def forward(self, x, sigma):
    mods = iter(self.all_modules)
    temb = next(mods)(torch.log(sigma))
    temb = next(mods)(temb)
    temb = next(mods)(F.silu(temb))
    x = 2 * x - 1.0
    pyramid_in = x
    hs = [next(mods)(x)]
    for i in range(self.nres):
      for _ in range(self.nrb):
        h = next(mods)(hs[-1], temb)
        if h.shape[-1] in self.attn_res:
          h = next(mods)(h)
        hs.append(h)
      if i != self.nres - 1:
        h = next(mods)(hs[-1], temb)
        if self.progressive_input == "input_skip":
          pyramid_in = fir_down(pyramid_in, self.taps)
          h = next(mods)(pyramid_in, h)
        else:
          pyramid_in = (next(mods)(pyramid_in) + h) / _SQRT2
          h = pyramid_in
        hs.append(h)
    h = next(mods)(hs[-1], temb)
    h = next(mods)(h)
    h = next(mods)(h, temb)
    pyramid = None
    for i in reversed(range(self.nres)):
      for _ in range(self.nrb + 1):
        h = next(mods)(torch.cat([h, hs.pop()], dim=1), temb)
      if h.shape[-1] in self.attn_res:
        h = next(mods)(h)
      if self.progressive == "output_skip":
        norm, conv = next(mods), next(mods)
        p = conv(F.silu(norm(h)))
        pyramid = p if pyramid is None else fir_up(pyramid, self.taps) + p
      if i != 0:
        h = next(mods)(h, temb)
    if self.progressive == "output_skip":
      h = pyramid
    else:
      norm, conv = next(mods), next(mods)
      h = conv(F.silu(norm(h)))
    assert not hs and next(mods, None) is None
    return h / sigma[:, None, None, None]


def param_kinds(model: NCSNpp) -> dict:
  """``{parameter name: (kind, detail)}`` for every parameter."""
  out = {}
  for mod_name, mod in model.named_modules():
    if hasattr(mod, "init_kinds"):
      for leaf, kind in mod.init_kinds().items():
        out[f"{mod_name}.{leaf}"] = kind
  missing = {n for n, _ in model.named_parameters()} - set(out)
  if missing:
    raise RuntimeError(f"parameters without an init kind: {sorted(missing)}")
  return out
