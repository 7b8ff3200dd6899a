"""Single-head self-attention over the H·W grid: plain version and kernel.

Counterpart of score_sde_pytorch_tpu/ops/attention.py. Layout is [B, N, C]
with N = H·W and C the channel width, as in the JAX kernel.

- :func:`dense_attention` is the plain PyTorch version; it mirrors the JAX
  package's ``dense_attention`` (fp32 softmax, probabilities cast back to
  ``v.dtype`` before the second product).
- :func:`attention` is the wrapper every caller uses. A CPU tensor goes to
  ``dense_attention``; a CUDA tensor goes to the hand-written Hopper kernel
  ``csrc/flash_attention.cu`` (built on first use by :mod:`.build`), or the
  call raises. It never falls back from one to the other, and unlike the JAX
  package's ``attention_auto`` it has no size threshold: every attention call
  on the card runs the kernel.
- ``flash_attention_launches`` counts kernel launches, so a run can show
  that its attention went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from score_sde_pytorch_tpu_torch.ops import build

# Kernel launches in this process; `_launch_flash_attention` adds one per
# launch and nothing else in the package touches it.
flash_attention_launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_C = 256


def dense_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
  """Plain version: materialized [B, N, N] logits (JAX attention.py:37-42)."""
  c = q.shape[-1]
  logits = torch.einsum("bnc,bmc->bnm", q, k) * (c ** -0.5)
  attn = torch.softmax(logits.float(), dim=-1)
  return torch.einsum("bnm,bmc->bnc", attn.to(v.dtype), v)


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
  """Raise unless q, k, v are what the kernel takes: contiguous [B, N, C]
  tensors of one shape, dtype (float32 or bfloat16) and device, with C a
  multiple of 8 up to 256. The CPU path is held to the same contract."""
  if q.dim() != 3 or not q.shape == k.shape == v.shape:
    raise ValueError(f"attention wants q, k, v of one [B, N, C] shape, got "
                     f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
  if not q.dtype == k.dtype == v.dtype or q.dtype not in _DTYPE_CODES:
    raise TypeError(f"attention takes float32 or bfloat16 q, k, v of one "
                    f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
  if not q.device == k.device == v.device:
    raise ValueError(f"q, k, v on different devices: {q.device}, {k.device}, "
                     f"{v.device}")
  b, n, c = q.shape
  if b < 1 or n < 1 or c % 8 or not 8 <= c <= _MAX_C:
    raise ValueError(f"attention wants B, N >= 1 and C a multiple of 8 in "
                     f"[8, {_MAX_C}], got [B, N, C] = {list(q.shape)}")
  if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
    raise ValueError("attention wants contiguous q, k, v")


@functools.lru_cache(maxsize=None)
def kernel_library() -> build.Library:
  """Build (first call only) and bind csrc/flash_attention.cu."""
  lib = build.load("flash_attention")
  fn = lib.handle.flash_attention_forward
  fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
  fn.restype = ctypes.c_int
  return lib


def _launch_flash_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor) -> torch.Tensor:
  global flash_attention_launches
  fn = kernel_library().handle.flash_attention_forward
  b, n, c = q.shape
  out = torch.empty_like(q)
  for t in (q, k, v, out):
    if t.data_ptr() % 16:
      raise ValueError("the attention kernel reads 16-byte aligned rows; got "
                       "a tensor whose storage offset breaks that")
  with torch.cuda.device(q.device):
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, n,
             c, c ** -0.5, _DTYPE_CODES[q.dtype], stream)
  if err != 0:
    raise RuntimeError(f"flash_attention kernel launch failed with CUDA error "
                       f"{err} at [B, N, C] = {[b, n, c]}, {q.dtype}")
  flash_attention_launches += 1
  return out


class FlashAttention(torch.autograd.Function):
  """The kernel as an autograd node. Sampling needs only the forward."""

  @staticmethod
  def forward(ctx, q, k, v):
    return _launch_flash_attention(q, k, v)

  @staticmethod
  def backward(ctx, grad_out):
    raise NotImplementedError(
        "the flash-attention backward kernel belongs to the training slice "
        "(ROADMAP.md, queue 2 item 1, and queue 1 item 4); this port only "
        "samples so far")


def attention(q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
  """softmax(q kᵀ / √C) v over [B, N, C]; output in q's dtype.

  CPU tensors take :func:`dense_attention`, CUDA tensors the Hopper kernel.
  Anything else raises."""
  check_inputs(q, k, v)
  if q.device.type == "cpu":
    return dense_attention(q, k, v)
  if q.device.type == "cuda":
    return FlashAttention.apply(q, k, v)
  raise ValueError(f"no attention path for device {q.device}")
