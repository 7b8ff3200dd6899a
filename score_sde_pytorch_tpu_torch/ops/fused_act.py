"""Fused bias + leaky ReLU + gain: plain version and kernels.

Counterpart of score_sde_pytorch_tpu/ops/fused_act.py. Computes
``leaky_relu(x + bias, negative_slope) * scale`` with the bias broadcast over
the channel dim. The port's layout is NCHW, so the bias runs over dim 1, as
in the torch reference's op (the JAX package is NHWC, over the last dim).

- :func:`fused_leaky_relu` is the plain PyTorch version and
  :func:`fused_leaky_relu_backward` the plain version of the backward
  kernel (``grad_x``).
- :func:`fused_bias_act` is the wrapper. A CPU tensor goes to the plain
  version (its gradient is autograd's); a CUDA tensor goes to the Hopper
  kernels in ``csrc/fused_act.cu`` (forward, and ``grad_x`` in the
  backward; the bias gradient is ``torch.sum`` of ``grad_x``), or the call
  raises. No model of the repository calls it.
- ``fused_leaky_relu_launches`` and ``fused_leaky_relu_backward_launches``
  count kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from score_sde_pytorch_tpu_torch.ops import build

# Kernel launches in this process; only the two launchers below add to them.
fused_leaky_relu_launches = 0
fused_leaky_relu_backward_launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SQRT2 = math.sqrt(2.0)


def _with_bias(x: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
  if bias is None:
    return x
  return x + bias.reshape((1, -1) + (1,) * (x.dim() - 2))


def fused_leaky_relu(x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                     negative_slope: float = 0.2,
                     scale: float = _SQRT2) -> torch.Tensor:
  """Plain version: ``leaky_relu(x + bias) * scale`` (JAX fused_act.py:24-30,
  with the bias over dim 1)."""
  v = _with_bias(x, bias)
  return torch.where(v >= 0, v, v * negative_slope) * scale


def fused_leaky_relu_backward(x: torch.Tensor, bias: Optional[torch.Tensor],
                              grad_out: torch.Tensor,
                              negative_slope: float = 0.2,
                              scale: float = _SQRT2) -> torch.Tensor:
  """Plain version of the backward kernel:
  ``grad_out * scale * (x + bias >= 0 ? 1 : negative_slope)``."""
  g = grad_out * scale
  return torch.where(_with_bias(x, bias) >= 0, g, g * negative_slope)


def check_inputs(x: torch.Tensor, bias: Optional[torch.Tensor]) -> None:
  """Raise unless ``x`` is a contiguous float32 or bfloat16 tensor of rank
  >= 2 and ``bias`` is None or a contiguous [C] tensor of its dtype and
  device. The CPU path is held to the same contract."""
  if x.dtype not in _DTYPE_CODES:
    raise TypeError(f"fused_bias_act takes float32 or bfloat16, got {x.dtype}")
  if x.dim() < 2 or x.numel() == 0:
    raise ValueError(f"fused_bias_act wants a non-empty [N, C, ...] tensor, "
                     f"got shape {tuple(x.shape)}")
  if not x.is_contiguous():
    raise ValueError("fused_bias_act wants a contiguous x")
  if bias is None:
    return
  if bias.shape != (x.shape[1],) or bias.dtype != x.dtype:
    raise ValueError(f"bias of shape {tuple(bias.shape)} and dtype "
                     f"{bias.dtype} for x of shape {tuple(x.shape)} and "
                     f"dtype {x.dtype}; want [C] of x's dtype")
  if bias.device != x.device or not bias.is_contiguous():
    raise ValueError("bias must be contiguous and on x's device")


@functools.lru_cache(maxsize=None)
def kernel_library() -> build.Library:
  """Build (first call only) and bind csrc/fused_act.cu."""
  lib = build.load("fused_act")
  ptr, i64, i32, f32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_float)
  fwd = lib.handle.fused_leaky_relu_forward
  fwd.argtypes = [ptr, ptr, ptr, i64, i64, i32, f32, f32, i32, ptr]
  fwd.restype = ctypes.c_int
  bwd = lib.handle.fused_leaky_relu_backward
  bwd.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i32, f32, f32, i32, ptr]
  bwd.restype = ctypes.c_int
  return lib


def _layout(x: torch.Tensor):
  return x.numel(), math.prod(x.shape[2:]), x.shape[1]


def _launch(fn, x, bias, tensors, slope, scale) -> None:
  with torch.cuda.device(x.device):
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), None if bias is None else bias.data_ptr(),
             *(t.data_ptr() for t in tensors), *_layout(x), slope, scale,
             _DTYPE_CODES[x.dtype], stream)
  if err != 0:
    raise RuntimeError(f"fused_leaky_relu kernel launch failed with CUDA "
                       f"error {err} at shape {tuple(x.shape)}, {x.dtype}")


def _launch_forward(x, bias, slope, scale) -> torch.Tensor:
  global fused_leaky_relu_launches
  out = torch.empty_like(x)
  _launch(kernel_library().handle.fused_leaky_relu_forward, x, bias, (out,),
          slope, scale)
  fused_leaky_relu_launches += 1
  return out


def _launch_backward(x, bias, grad_out, slope, scale) -> torch.Tensor:
  global fused_leaky_relu_backward_launches
  grad_out = grad_out.contiguous()
  grad_x = torch.empty_like(x)
  _launch(kernel_library().handle.fused_leaky_relu_backward, x, bias,
          (grad_out, grad_x), slope, scale)
  fused_leaky_relu_backward_launches += 1
  return grad_x


class FusedLeakyReLU(torch.autograd.Function):
  """The kernels as an autograd node (CUDA tensors only)."""

  @staticmethod
  def forward(ctx, x, bias, negative_slope, scale):
    ctx.save_for_backward(x, bias)
    ctx.negative_slope, ctx.scale = negative_slope, scale
    return _launch_forward(x, bias, negative_slope, scale)

  @staticmethod
  def backward(ctx, grad_out):
    x, bias = ctx.saved_tensors
    grad_x = _launch_backward(x, bias, grad_out.to(x.dtype), ctx.negative_slope,
                              ctx.scale)
    grad_bias = None
    if bias is not None and ctx.needs_input_grad[1]:
      dims = [0] + list(range(2, x.dim()))
      grad_bias = grad_x.sum(dim=dims, dtype=torch.float32).to(bias.dtype)
    return (grad_x if ctx.needs_input_grad[0] else None, grad_bias, None,
            None)


def fused_bias_act(x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                   negative_slope: float = 0.2,
                   scale: float = _SQRT2) -> torch.Tensor:
  """``leaky_relu(x + bias, negative_slope) * scale`` over NCHW ``x``.

  CPU tensors take :func:`fused_leaky_relu`, CUDA tensors the Hopper
  kernels. Anything else raises."""
  check_inputs(x, bias)
  if x.device.type == "cpu":
    return fused_leaky_relu(x, bias, negative_slope, scale)
  if x.device.type == "cuda":
    return FusedLeakyReLU.apply(x, bias, float(negative_slope), float(scale))
  raise ValueError(f"no fused_bias_act path for device {x.device}")
