"""Single-head self-attention over the H·W grid: plain version and kernel.

Counterpart of score_sde_pytorch_tpu/ops/attention.py. Layout is [B, N, C]
with N = H·W and C the channel width, as in the JAX kernel. The queries may
be fewer than the keys: q is [B, N_q, C] and k, v are [B, N_kv, C], which
is how a slab of the image attends under the space axis (its own rows'
queries against the keys and values gathered from every rank,
``parallel/spatial.py``); the JAX kernel takes one N.

- :func:`dense_attention` is the plain PyTorch version; it mirrors the JAX
  package's ``dense_attention`` (fp32 softmax, probabilities cast back to
  ``v.dtype`` before the second product).
- :func:`attention` is the wrapper every caller uses. A CPU tensor goes to
  ``dense_attention``; a CUDA tensor goes to the hand-written Hopper kernel
  ``csrc/flash_attention.cu`` (built on first use by :mod:`.build`), or the
  call raises. It never falls back from one to the other, and unlike the JAX
  package's ``attention_auto`` it has no size threshold: every attention call
  on the card runs the kernel.
- On the card the gradient goes through the hand-written backward in the
  same source (three launches per call: D = rowsum(dO∘O), then dK/dV, then
  dQ); :func:`dense_attention_backward` is its plain version, mirroring the
  JAX package's ``_flash_bwd_impl``. On the CPU the gradient is autograd
  through :func:`dense_attention`.
- The counters ``kernel.attention.fwd`` (a forward launch) and
  ``kernel.attention.bwd`` (a backward call, its three kernels) of
  ``utils/tracing.py`` show that a run's attention went through the
  kernels.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from score_sde_pytorch_tpu_torch.ops import build
from score_sde_pytorch_tpu_torch.utils import tracing

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_C = 512  # the widest attention of any shipped config (16 x 32, 128 x 4)


def dense_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
  """Plain version: materialized [B, N_q, N_kv] logits (JAX
  attention.py:37-42).
  The scale 1/√C multiplies the logits in their dtype, rounded to it first
  (JAX's weakly typed scalar)."""
  c = q.shape[-1]
  scale = torch.tensor(c ** -0.5, dtype=q.dtype).item()
  logits = torch.einsum("bnc,bmc->bnm", q, k) * scale
  attn = torch.softmax(logits.float(), dim=-1)
  return torch.einsum("bnm,bmc->bnc", attn.to(v.dtype), v)


def dense_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             dout: torch.Tensor):
  """Plain version of the backward kernel, with materialized [B, N_q, N_kv]
  probabilities. Mirrors JAX ``_flash_bwd_impl`` (attention.py:129-161):
  every input widened to fp32, ``D = rowsum(dO∘O)``, ``dS = P∘(dP − D)``,
  ``dq = scale·dS·k``, ``dk = scale·dSᵀ·q``, ``dv = Pᵀ·dO``; the gradients
  are returned in the inputs' dtype."""
  c = q.shape[-1]
  scale = c ** -0.5
  wide = torch.promote_types(q.dtype, torch.float32)
  qf, kf, vf, of, dof = (t.to(wide) for t in (q, k, v, out, dout))
  p = torch.softmax(torch.einsum("bnc,bmc->bnm", qf, kf) * scale, dim=-1)
  d_row = (dof * of).sum(-1, keepdim=True)
  ds = p * (torch.einsum("bnc,bmc->bnm", dof, vf) - d_row)
  dq = scale * torch.einsum("bnm,bmc->bnc", ds, kf)
  dk = scale * torch.einsum("bnm,bnc->bmc", ds, qf)
  dv = torch.einsum("bnm,bnc->bmc", p, dof)
  return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
  """Raise unless q, k, v are what the kernel takes: contiguous q of
  [B, N_q, C] and k, v of one [B, N_kv, C] shape, of one dtype (float32 or
  bfloat16) and device, with C a multiple of 8 up to 512. The CPU path is
  held to the same contract."""
  if (q.dim() != 3 or k.dim() != 3 or k.shape != v.shape
      or q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2]):
    raise ValueError(f"attention wants q of [B, N_q, C] and k, v of one "
                     f"[B, N_kv, C] shape, got {tuple(q.shape)}, "
                     f"{tuple(k.shape)}, {tuple(v.shape)}")
  if not q.dtype == k.dtype == v.dtype or q.dtype not in _DTYPE_CODES:
    raise TypeError(f"attention takes float32 or bfloat16 q, k, v of one "
                    f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
  if not q.device == k.device == v.device:
    raise ValueError(f"q, k, v on different devices: {q.device}, {k.device}, "
                     f"{v.device}")
  b, n_q, c = q.shape
  if b < 1 or n_q < 1 or k.shape[1] < 1 or c % 8 or not 8 <= c <= _MAX_C:
    raise ValueError(f"attention wants B, N_q, N_kv >= 1 and C a multiple of "
                     f"8 in [8, {_MAX_C}], got q {list(q.shape)}, k "
                     f"{list(k.shape)}")
  if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
    raise ValueError("attention wants contiguous q, k, v")


@functools.lru_cache(maxsize=None)
def kernel_library() -> build.Library:
  """Build (first call only) and bind csrc/flash_attention.cu."""
  lib = build.load("flash_attention")
  ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
  fwd = lib.handle.flash_attention_forward
  fwd.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, f32, i32,
                  ptr]
  fwd.restype = ctypes.c_int
  bwd = lib.handle.flash_attention_backward
  bwd.argtypes = [ptr] * 10 + [i32, i32, i32, i32, f32, i32, ptr]
  bwd.restype = ctypes.c_int
  scratch = lib.handle.flash_attention_backward_scratch
  scratch.argtypes = [i32, i32, i32]
  scratch.restype = ctypes.c_longlong
  return lib


def _check_aligned(*tensors: torch.Tensor) -> None:
  for t in tensors:
    if t.data_ptr() % 16:
      raise ValueError("the attention kernels read 16-byte aligned rows; got "
                       "a tensor whose storage offset breaks that")


def _raise_on(err: int, what: str, q, k) -> None:
  if err != 0:
    raise RuntimeError(f"{what} kernel launch failed with CUDA error {err} at "
                       f"q {list(q.shape)}, k {list(k.shape)}, {q.dtype}")


def _launch_flash_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, with_lse: bool = False):
  """Forward kernel; returns ``(out, lse)``, with ``lse`` the fp32
  [B, N_q] row log-sum-exp when ``with_lse`` (the backward needs it), else
  None."""
  fn = kernel_library().handle.flash_attention_forward
  b, n_q, c = q.shape
  out = torch.empty_like(q)
  lse = (torch.empty((b, n_q), dtype=torch.float32, device=q.device)
         if with_lse else None)
  _check_aligned(q, k, v, out)
  with torch.cuda.device(q.device):
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr() if with_lse else None, b, n_q, k.shape[1], c,
             c ** -0.5, _DTYPE_CODES[q.dtype], stream)
  _raise_on(err, "flash_attention", q, k)
  tracing.count("kernel.attention.fwd")
  return out, lse


def _launch_flash_attention_backward(q, k, v, out, lse, dout):
  """Backward kernels; returns ``(dq, dk, dv)`` in the inputs' dtype."""
  lib = kernel_library().handle
  b, n_q, c = q.shape
  n_kv = k.shape[1]
  if dout.dtype != q.dtype or dout.shape != q.shape:
    raise ValueError(f"attention backward wants a gradient of the output's "
                     f"shape and dtype {list(q.shape)} {q.dtype}, got "
                     f"{list(dout.shape)} {dout.dtype}")
  dout = dout.contiguous()  # AttnBlockpp hands a permuted gradient
  # dS ([B, N_q, N_kv rounded up to 32]) for the dQ product, then
  # D = rowsum(dO∘O).
  scratch = torch.empty(lib.flash_attention_backward_scratch(b, n_q, n_kv),
                        dtype=torch.float32, device=q.device)
  dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
  _check_aligned(q, k, v, out, dout, dq, dk, dv)
  with torch.cuda.device(q.device):
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_backward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), scratch.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, n_q, n_kv, c, c ** -0.5,
        _DTYPE_CODES[q.dtype], stream)
  _raise_on(err, "flash_attention backward", q, k)
  tracing.count("kernel.attention.bwd")
  return dq, dk, dv


class FlashAttention(torch.autograd.Function):
  """The kernels as an autograd node. The forward saves what the backward
  needs (q, k, v, the output and the row log-sum-exp) only when a gradient
  is wanted, so sampling keeps its one launch and no extra store."""

  @staticmethod
  def forward(ctx, q, k, v):
    with_grad = any(ctx.needs_input_grad)
    out, lse = _launch_flash_attention(q, k, v, with_lse=with_grad)
    if with_grad:
      ctx.save_for_backward(q, k, v, out, lse)
    return out

  @staticmethod
  def backward(ctx, grad_out):
    q, k, v, out, lse = ctx.saved_tensors
    return _launch_flash_attention_backward(q, k, v, out, lse, grad_out)


def attention(q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
  """softmax(q kᵀ / √C) v for q of [B, N_q, C] and k, v of [B, N_kv, C];
  output [B, N_q, C] in q's dtype.

  CPU tensors take :func:`dense_attention`, CUDA tensors the Hopper kernel.
  Anything else raises. The call is the ``op.attention`` span
  (``utils/tracing.py``)."""
  with tracing.span("op.attention"):
    check_inputs(q, k, v)
    if q.device.type == "cpu":
      return dense_attention(q, k, v)
    if q.device.type == "cuda":
      return FlashAttention.apply(q, k, v)
    raise ValueError(f"no attention path for device {q.device}")
