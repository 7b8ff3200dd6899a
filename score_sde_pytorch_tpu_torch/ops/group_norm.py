"""GroupNorm with an optional swish after it: plain version and kernels.

The JAX package's GroupNorm (``models/layers.py:136-177``) keeps its
statistics in fp32 as E[x²] − mean², clamps the variance at 0 before the
rsqrt, folds the affine into one per-(batch, channel) ``x·a + b`` in fp32
and casts back to the input's dtype; NCSN++, DDPM++ and DDPM apply swish
after it. No TPU kernel computes it (XLA fuses it); here it is the largest
layer of NCSN++'s device time, so it has Hopper kernels of its own.

- :func:`group_norm_act_forward` is the plain PyTorch version (the CPU's
  path), :func:`group_norm_stats` its statistics and
  :func:`group_norm_act_backward` the plain version of the backward
  kernels: the formula they implement, for one process.
- :func:`group_norm_act` is the wrapper. A CPU tensor takes the plain
  version (its gradient is autograd's); a CUDA tensor takes the kernels in
  ``csrc/group_norm.cu``, forward and backward, or the call raises.
- The kernels take one of two paths, from what the call shows: a group
  of at most :data:`ONCHIP_MAX_VECTORS` vectors of 4 elements and no space
  group runs **on-chip**, one block a group holding it in registers (1
  read and 1 write forward; 2 reads and 1 write backward); a larger group,
  or any under a space group, runs **split**, many blocks a group
  (forward: statistics, then normalise; backward: reductions, then dx),
  with the space group's all-reduce of the statistics between the two
  passes.
- The counters ``kernel.group_norm.{onchip,split}_{fwd,bwd}`` of
  ``utils/tracing.py`` count the calls of each path that launched its
  kernels (on-chip: 1 kernel forward, 2 backward; split: 2 forward, 4
  backward).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from score_sde_pytorch_tpu_torch.ops import build
from score_sde_pytorch_tpu_torch.parallel import distributed, spatial
from score_sde_pytorch_tpu_torch.utils import tracing

ACTS = (None, "swish")
# Elements of one vector: the kernels load and store 4 at a time, so H·W
# is a multiple of 4 and every buffer is aligned to a vector.
VECTOR = 4
# One on-chip block: 512 threads of 8 vectors each, in registers.
ONCHIP_MAX_VECTORS = 4096
# Elements of a group (or of a channel, backward) per split block.
CHUNK = 16384

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def swish(x: torch.Tensor) -> torch.Tensor:
  """``x·sigmoid(x)``. Below fp32 it is computed as JAX's ``jax.nn.silu``
  lowers, ``x · (1 / (1 + exp(-x)))`` with every step rounded to ``x``'s
  dtype."""
  if x.dtype == torch.float32:
    return F.silu(x)
  return x * (1 / (1 + torch.exp(-x)))


def group_norm_stats(x: torch.Tensor, num_groups: int, group=None) -> tuple:
  """Each group's fp32 mean and E[x²] − mean² (unclamped), [B, G] each,
  over the whole image when the rows are split over the space group
  ``group``."""
  xg = x.reshape(x.shape[0], num_groups, -1).float()
  if group is None:
    mean = xg.mean(dim=-1)
    return mean, (xg * xg).mean(dim=-1) - mean * mean
  # A slab: each group's sum and sum of squares over the whole image.
  sums = spatial.all_reduce_sum(
      torch.stack([xg.sum(dim=-1), (xg * xg).sum(dim=-1)]), group)
  count = xg.shape[-1] * distributed.group_size(group)
  mean = sums[0] / count
  return mean, sums[1] / count - mean * mean


def _affine(x, weight, bias, num_groups, mean, var, eps) -> tuple:
  """The per-(batch, channel) ``a`` and ``b`` of ``x·a + b``, shaped to
  broadcast over ``x``, and ``rstd`` [B, G, 1]."""
  b, c = x.shape[:2]
  g = num_groups
  rstd = torch.rsqrt(var[..., None].clamp_min(0.0) + eps)      # [B, G, 1]
  scale = weight.float().reshape(g, c // g)
  a = rstd * scale                                              # [B, G, C/G]
  shift = bias.float().reshape(g, c // g) - mean[..., None] * rstd * scale
  shape = (b, c) + (1,) * (x.dim() - 2)
  return a.reshape(shape), shift.reshape(shape), rstd


def group_norm_act_forward(x: torch.Tensor, weight: torch.Tensor,
                           bias: torch.Tensor, num_groups: int, eps: float,
                           act: Optional[str] = None,
                           group=None) -> torch.Tensor:
  """Plain version: ``act(GroupNorm(x))`` in the JAX package's rounding
  (the module docstring), ``act`` None or ``"swish"``."""
  mean, var = group_norm_stats(x, num_groups, group)
  a, shift, _ = _affine(x, weight, bias, num_groups, mean, var, eps)
  h = (x.float() * a + shift).to(x.dtype)
  return h if act is None else swish(h)


def _swish_grad(v: torch.Tensor) -> torch.Tensor:
  s = torch.sigmoid(v)
  return s * (1 + v * (1 - s))


def group_norm_act_backward(x: torch.Tensor, weight: torch.Tensor,
                            bias: torch.Tensor, num_groups: int, eps: float,
                            act: Optional[str], mean: torch.Tensor,
                            var: torch.Tensor,
                            grad_out: torch.Tensor) -> tuple:
  """Plain version of the backward kernels, for one process: ``(dx,
  dweight, dbias)`` of :func:`group_norm_act_forward` at ``x`` with the
  statistics ``mean``, ``var`` [B, G] of :func:`group_norm_stats`.

  In fp32, with ``dyu = grad_out · act'(u)`` (``act'`` taken at ``u``
  cast to ``x``'s dtype) and ``x̂ = (x − mean)·rstd``: ``dbias`` and
  ``dweight`` sum ``dyu`` and ``dyu·x̂`` over the batch and pixels, and
  ``dx = rstd·(w·dyu − mean_g(w·dyu) − x̂·mean_g(w·dyu·x̂))``, the last
  term only where the variance was not clamped (the clamp's gradient)."""
  b, c = x.shape[:2]
  g = num_groups
  xf = x.float().reshape(b, g, c // g, -1)
  dy = grad_out.float().reshape(b, g, c // g, -1)
  a, shift, rstd = _affine(x, weight, bias, num_groups, mean, var, eps)
  if act == "swish":
    u = (x.float() * a + shift).to(x.dtype).float()
    dy = dy * _swish_grad(u).reshape(dy.shape)
  rstd = rstd[..., None]                                        # [B,G,1,1]
  xhat = (xf - mean[..., None, None]) * rstd
  dxhat = dy * weight.float().reshape(1, g, c // g, 1)
  n = xhat[0, 0].numel()
  m1 = dxhat.sum(dim=(2, 3), keepdim=True) / n
  m2 = (dxhat * xhat).sum(dim=(2, 3), keepdim=True) / n
  m2 = m2 * (var >= 0)[..., None, None]
  dx = rstd * (dxhat - m1 - xhat * m2)
  dbias = dy.sum(dim=(0, 3)).reshape(c)
  dweight = (dy * xhat).sum(dim=(0, 3)).reshape(c)
  return (dx.reshape(x.shape).to(x.dtype), dweight.to(weight.dtype),
          dbias.to(bias.dtype))


def check_inputs(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 num_groups: int) -> None:
  """Raise unless the kernels take the call: ``x`` a float32 or bfloat16
  [B, C, ...] tensor with C a multiple of ``num_groups`` and H·W a
  multiple of :data:`VECTOR`, and ``weight`` and ``bias`` contiguous
  float32 [C] on its device."""
  if x.dtype not in _DTYPE_CODES:
    raise TypeError(f"group_norm_act takes float32 or bfloat16, got "
                    f"{x.dtype}")
  if x.dim() < 2 or x.numel() == 0 or x.shape[1] % num_groups:
    raise ValueError(f"group_norm_act wants a non-empty [B, C, ...] tensor "
                     f"with C a multiple of {num_groups} groups, got shape "
                     f"{tuple(x.shape)}")
  if math.prod(x.shape[2:]) % VECTOR:
    raise ValueError(f"group_norm_act wants H·W a multiple of {VECTOR}, got "
                     f"shape {tuple(x.shape)}")
  if x.numel() // (x.shape[0] * num_groups) >= 2 ** 30:
    raise ValueError(f"a group of {tuple(x.shape)} over {num_groups} groups "
                     f"holds 2**30 elements or more")
  for name, p in (("weight", weight), ("bias", bias)):
    if (p.shape != (x.shape[1],) or p.dtype != torch.float32
        or p.device != x.device or not p.is_contiguous()):
      raise ValueError(f"{name} of shape {tuple(p.shape)}, {p.dtype} on "
                       f"{p.device}; want contiguous float32 [C] on "
                       f"{x.device}")


@functools.lru_cache(maxsize=None)
def kernel_library() -> build.Library:
  """Build (first call only) and bind csrc/group_norm.cu."""
  lib = build.load("group_norm")
  ptr, i64, i32, f32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_float)
  fwd = lib.handle.group_norm_forward
  fwd.argtypes = [i32, ptr, ptr, ptr, ptr, ptr, ptr, i64, i32, i32, i32, i32,
                  i32, f32, f32, i32, i32, ptr]
  fwd.restype = ctypes.c_int
  bwd = lib.handle.group_norm_backward
  bwd.argtypes = [i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                  i64, i32, i32, i32, i32, i32, f32, f32, i32, i32, ptr]
  bwd.restype = ctypes.c_int
  return lib


def _aligned(t: torch.Tensor) -> torch.Tensor:
  """``t`` as contiguous NCHW whose pointer holds whole vectors: a view
  that starts inside a vector is copied (a fresh buffer always is
  aligned)."""
  t = t.contiguous()
  return t if t.data_ptr() % (VECTOR * t.element_size()) == 0 else t.clone()


def _layout(x: torch.Tensor, num_groups: int) -> tuple:
  """(B, G, C/G, H·W) of ``x``."""
  b, c = x.shape[:2]
  return b, num_groups, c // num_groups, math.prod(x.shape[2:])


def _onchip(x: torch.Tensor, num_groups: int, group) -> bool:
  _, _, cg, s = _layout(x, num_groups)
  return group is None and cg * s // VECTOR <= ONCHIP_MAX_VECTORS


def _check(err: int, what: str, x: torch.Tensor) -> None:
  if err != 0:
    raise RuntimeError(f"group_norm {what} kernel launch failed with CUDA "
                       f"error {err} at shape {tuple(x.shape)}, {x.dtype}")


def _chunks(n: int) -> int:
  return -(-n // CHUNK)


def _count(x: torch.Tensor, num_groups: int, group) -> float:
  _, _, cg, s = _layout(x, num_groups)
  return float(cg * s * (1 if group is None else
                         distributed.group_size(group)))


def _launch_forward(x, weight, bias, num_groups, eps, act, group) -> tuple:
  b, g, cg, s = _layout(x, num_groups)
  y = torch.empty_like(x)
  stats = torch.empty(b, g, 2, device=x.device, dtype=torch.float32)
  fn = kernel_library().handle.group_norm_forward
  common = (b * g, g, cg, s, CHUNK)
  tail = (_count(x, num_groups, group), eps, int(act == "swish"),
          _DTYPE_CODES[x.dtype])
  with torch.cuda.device(x.device):
    stream = torch.cuda.current_stream(x.device).cuda_stream
    args = (x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
            stats.data_ptr())
    if _onchip(x, num_groups, group):
      _check(fn(0, *args, None, *common, 1, *tail, stream), "forward", x)
      tracing.count("kernel.group_norm.onchip_fwd")
      return y, stats
    parts = _chunks(cg * s)
    partial = torch.empty(b, g, parts, 2, device=x.device,
                          dtype=torch.float32)
    _check(fn(1, *args, partial.data_ptr(), *common, parts, *tail, stream),
           "statistics", x)
    if group is not None:
      partial = spatial.all_reduce_sum(partial, group)
      stream = torch.cuda.current_stream(x.device).cuda_stream
    _check(fn(2, *args, partial.data_ptr(), *common, parts, *tail, stream),
           "forward", x)
  tracing.count("kernel.group_norm.split_fwd")
  return y, stats


def _launch_backward(x, weight, bias, num_groups, eps, act, group, stats,
                     grad) -> tuple:
  b, g, cg, s = _layout(x, num_groups)
  c = g * cg
  dx = torch.empty_like(x)
  dweight = torch.empty_like(weight)
  dbias = torch.empty_like(bias)
  chan = torch.empty(b, c, 2, device=x.device, dtype=torch.float32)
  fn = kernel_library().handle.group_norm_backward
  tail = (_count(x, num_groups, group), eps, int(act == "swish"),
          _DTYPE_CODES[x.dtype])
  with torch.cuda.device(x.device):
    stream = torch.cuda.current_stream(x.device).cuda_stream
    head = (x.data_ptr(), grad.data_ptr(), weight.data_ptr(),
            bias.data_ptr(), stats.data_ptr(), dx.data_ptr(),
            chan.data_ptr())
    params = (dweight.data_ptr(), dbias.data_ptr(), b, g, cg, s, CHUNK)
    if _onchip(x, num_groups, group):
      _check(fn(0, *head, None, None, *params, 1, *tail, stream), "backward",
             x)
      tracing.count("kernel.group_norm.onchip_bwd")
      return dx, dweight, dbias
    parts = _chunks(s)
    part = torch.empty(b, c, parts, 2, device=x.device, dtype=torch.float32)
    gsum = torch.empty(b, g, 2, device=x.device, dtype=torch.float32)
    _check(fn(1, *head, part.data_ptr(), gsum.data_ptr(), *params, parts,
              *tail, stream), "backward reduction", x)
    if group is not None:
      gsum = spatial.all_reduce_sum(gsum, group)
      stream = torch.cuda.current_stream(x.device).cuda_stream
    _check(fn(2, *head, part.data_ptr(), gsum.data_ptr(), *params, parts,
              *tail, stream), "backward", x)
  tracing.count("kernel.group_norm.split_bwd")
  return dx, dweight, dbias


class _GroupNormAct(torch.autograd.Function):
  """The kernels as an autograd node (CUDA tensors only). It saves ``x``,
  the parameters and each group's (mean, var), never the output."""

  @staticmethod
  def forward(ctx, x, weight, bias, num_groups, eps, act, group):
    y, stats = _launch_forward(x, weight, bias, num_groups, eps, act, group)
    ctx.save_for_backward(x, weight, bias, stats)
    ctx.num_groups, ctx.eps, ctx.act, ctx.group = num_groups, eps, act, group
    return y

  @staticmethod
  def backward(ctx, grad):
    x, weight, bias, stats = ctx.saved_tensors
    dx, dweight, dbias = _launch_backward(
        x, weight, bias, ctx.num_groups, ctx.eps, ctx.act, ctx.group, stats,
        _aligned(grad.to(x.dtype)))
    need = ctx.needs_input_grad
    return (dx if need[0] else None, dweight if need[1] else None,
            dbias if need[2] else None, None, None, None, None)


def group_norm_act(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   num_groups: int, eps: float, act: Optional[str] = None,
                   group=None) -> torch.Tensor:
  """``act(GroupNorm(x))`` over NCHW ``x``, ``act`` None or ``"swish"``,
  the statistics over the whole image when the rows are split over the
  space group ``group``.

  CPU (and meta) tensors take :func:`group_norm_act_forward`, CUDA
  tensors the Hopper kernels (:func:`check_inputs` says what they take),
  which read ``x`` as contiguous NCHW aligned to a vector: another layout
  (``channels_last``, which a convolution of a permuted input returns),
  or a view that starts inside a vector, is copied to it first. Anything
  else raises."""
  if act not in ACTS:
    raise ValueError(f"group_norm_act applies no activation or 'swish', "
                     f"got {act!r}")
  if x.device.type in ("cpu", "meta"):  # meta: shapes only
    return group_norm_act_forward(x, weight, bias, num_groups, eps, act,
                                  group)
  if x.device.type == "cuda":
    check_inputs(x, weight, bias, num_groups)
    return _GroupNormAct.apply(_aligned(x), weight, bias, num_groups,
                               float(eps), act, group)
  raise ValueError(f"no group_norm_act path for device {x.device}")
