"""Time the port's hand-written kernels alone on the card.

    python -m score_sde_pytorch_tpu_torch.ops.bench_kernels \\
        [--other PATH/flash_attention.cu] [--iters 30]

One row per kernel, direction and shape, as the kernel table of PERF.md
§6 lists them:

- attention (``csrc/flash_attention.cu``), forward and backward: the main
  path's shapes, C = 512, the bf16 files' shapes in bf16, and the space
  axis's slabs (N_q = N / 2 queries against N_kv = N keys);
- fused bias + leaky ReLU (``csrc/fused_act.cu``), forward and ``grad_x``;
- GroupNorm + swish (``csrc/group_norm.cu``), forward and backward, at
  the largest calls of each benchmark cell, on-chip and split.

Each row prints the ms of one call as the port makes it, of its plain
PyTorch version and of the library's call that computes the same thing
(``F.scaled_dot_product_attention`` on [B, 1, N, C]; ``F.silu`` of
``F.group_norm``; none for fused act; the port calls neither), the card's
bound (operations at the tensor cores' peak for the dtype, TF32 for fp32,
or bytes at HBM's rate, whichever is larger) and the share of it the
kernel reaches, and the largest |kernel - plain|, the kernel's side taken
through the port's wrapper (``attention.attention``,
``fused_act.fused_bias_act``, ``group_norm.group_norm_act``; the
backward rows through autograd of it). The attention backward's
row also gives forward + backward of the kernels and of the library's
call, since no library call computes the backward alone. TF32 is off for
the plain fp32 products.

With ``--other``, a second build of an attention source with the same C
entry points (for example a parent commit's) is timed in turns with this
checkout's (other, this, this, other) at every attention row, and their
outputs (forward, lse, dq, dk, dv) are compared bit for bit; the run
fails unless every output is equal.

It needs a CUDA card and nvcc; nothing here runs on the CPU.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import math
import subprocess
import sys

import torch
import torch.nn.functional as F

from score_sde_pytorch_tpu_torch.ops import attention as attn
from score_sde_pytorch_tpu_torch.ops import build
from score_sde_pytorch_tpu_torch.ops import fused_act as act
from score_sde_pytorch_tpu_torch.ops import group_norm as gn

# H100 SXM, dense tensor-core peaks by input dtype, and HBM (NVIDIA's data
# sheet): TF32 for fp32 inputs, bf16 for bf16.
PEAK_FLOPS = {torch.float32: 495e12, torch.bfloat16: 989e12}
HBM_BYTES_PER_S = 3.35e12
F32, BF16 = torch.float32, torch.bfloat16
# (B, N_q, N_kv, C, dtype). Forward: sampling (64), training (128) and the
# eval batch (1024) at 16², the 4² bottleneck, the multiattn file's 32²,
# C = 512 (the 256² DDPM, the 1024² NCSN++), and the bf16 files (church at
# 32, 1024² at 8); backward: the train path's. Then the space axis's
# slabs, both directions.
SPACE_SHAPES = [(4, 128, 256, 256, F32), (4, 8, 16, 256, F32),
                (8, 128, 256, 256, F32), (2, 128, 256, 512, F32),
                (2, 32, 64, 512, F32), (32, 128, 256, 256, BF16),
                (32, 8, 16, 256, BF16), (8, 128, 256, 512, BF16)]
ATTENTION_FORWARD = [
    (64, 256, 256, 256, F32), (128, 256, 256, 256, F32),
    (1024, 256, 256, 256, F32), (64, 16, 16, 256, F32),
    (2, 1024, 1024, 256, F32), (64, 256, 256, 256, BF16),
    (64, 256, 256, 512, F32), (8, 256, 256, 512, F32),
    (8, 64, 64, 512, F32), (32, 256, 256, 256, BF16),
    (32, 16, 16, 256, BF16), (8, 256, 256, 512, BF16),
    (8, 64, 64, 512, BF16)] + SPACE_SHAPES
ATTENTION_BACKWARD = [
    (128, 256, 256, 256, F32), (128, 16, 16, 256, F32),
    (2, 1024, 1024, 256, F32), (128, 256, 256, 256, BF16),
    (64, 256, 256, 512, F32), (8, 256, 256, 512, F32),
    (8, 64, 64, 512, F32), (32, 256, 256, 256, BF16),
    (32, 16, 16, 256, BF16), (8, 256, 256, 512, BF16),
    (8, 64, 64, 512, BF16)] + SPACE_SHAPES
FUSED_ACT = [(128, 256, 16, 16)]
# The largest GroupNorm + swish calls of each benchmark cell, 32 groups:
# cell 3 (PC at 1024, 32² and 16²), cell 1 (train at 128) and cell 2
# (church 256² train at 24: split at 256², 128², 64²; on chip at 32²).
GROUP_NORM = [(1024, 128, 32, 32), (1024, 256, 16, 16), (128, 256, 32, 32),
              (128, 256, 8, 8), (24, 256, 256, 256), (24, 128, 128, 128),
              (24, 256, 64, 64), (24, 512, 32, 32)]
GROUPS, EPS = 32, 1e-6
# With ``--other``, compared bit for bit only (not timed), in fp32 and
# bf16: ragged N, N = 1024 at a narrow C, and C = 384.
EQUALITY_SHAPES = [(4, 200, 200, 256), (1, 1024, 1024, 128),
                   (2, 200, 200, 384)]


def time_ms(fn, iters: int = 30) -> float:
  """Mean ms of ``fn()`` over ``iters`` calls after 3 warm-up calls, on
  the card's clock (CUDA events)."""
  for _ in range(3):
    fn()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(iters):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float, dtype=F32) -> tuple:
  """The least ms the card could take and what bounds it: the larger of
  the operations at the tensor cores' peak for ``dtype`` and the bytes at
  HBM's rate."""
  ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
  bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
  return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                            "bytes")


def errors(got, want) -> dict:
  """Kernel outputs ``got`` against the plain ones ``want``, over all the
  pairs: the largest |got - want| (``max_abs_err``); the same as a share
  of each tensor's largest |want| entry (``scaled_err``); and the largest
  |got - want| / (1 + |want|) (``abs_rel_err``: at most t is
  ``torch.allclose`` at rtol = atol = t)."""
  out = dict(max_abs_err=0.0, scaled_err=0.0, abs_rel_err=0.0)
  for g, w in zip(got, want):
    g, w = g.detach().double(), w.detach().double()
    diff = (g - w).abs()
    largest = diff.max().item()
    out["max_abs_err"] = max(out["max_abs_err"], largest)
    out["scaled_err"] = max(out["scaled_err"], largest / max(
        w.abs().max().item(), 1e-30))
    out["abs_rel_err"] = max(out["abs_rel_err"],
                             (diff / (1 + w.abs())).max().item())
  return out


def _row(name: str, shape: str, dtype, ms: float, plain_ms: float,
         library_ms, flops: float, nbytes: float, errs: dict,
         **extra) -> dict:
  bound_ms, bound_by = bound(flops, nbytes, dtype)
  return dict(name=name, shape=shape, dtype=str(dtype)[6:], ms=ms,
              plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
              bound_by=bound_by, **errs, **extra)


def _through_autograd(fn, inputs, grad_out) -> list:
  """The gradients of ``fn(*inputs)`` at ``grad_out``, by autograd."""
  leaves = [t.detach().clone().requires_grad_() for t in inputs]
  return list(torch.autograd.grad(fn(*leaves), leaves, grad_out))


def _qkv(b, n_q, n_kv, c, dtype, count=3, seed=0) -> list:
  """Standard-normal q [B, N_q, C], k and v [B, N_kv, C] (and with
  ``count`` 4, dO of q's shape) of ``dtype`` on the card."""
  gen = torch.Generator(device="cuda").manual_seed(seed)
  return [torch.randn(b, n, c, device="cuda", generator=gen).to(dtype)
          for n in (n_q, n_kv, n_kv, n_q)[:count]]


def _lengths(b, n_q, n_kv, c) -> str:
  n = n_q if n_q == n_kv else f"{n_q}|{n_kv}"
  return f"{b},{n},{c}"


def attention_forward(b, n_q, n_kv, c, dtype=F32, iters=30) -> dict:
  """The forward kernel through ``attention.attention`` (no gradient)."""
  q, k, v = _qkv(b, n_q, n_kv, c, dtype)
  q4, k4, v4 = (t[:, None] for t in (q, k, v))
  errs = errors([attn.attention(q, k, v)], [attn.dense_attention(q, k, v)])
  return _row(
      "attention fwd", _lengths(b, n_q, n_kv, c), dtype,
      time_ms(lambda: attn.attention(q, k, v), iters),
      time_ms(lambda: attn.dense_attention(q, k, v), iters),
      time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4), iters),
      4.0 * b * n_q * n_kv * c, 2.0 * b * (n_q + n_kv) * c * q.element_size(),
      errs)


def attention_backward(b, n_q, n_kv, c, dtype=F32, iters=30) -> dict:
  """The backward kernels (one call: D, then dK/dV, then dQ), beside the
  forward and backward of the kernels and of the library's call."""
  q, k, v, dout = _qkv(b, n_q, n_kv, c, dtype, count=4)
  errs = errors(_through_autograd(attn.attention, (q, k, v), dout),
                attn.dense_attention_backward(
                    q, k, v, attn.dense_attention(q, k, v), dout))
  out, lse = attn._launch_flash_attention(q, k, v, with_lse=True)
  leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
  wide, dout4 = [t[:, None] for t in leaves], dout[:, None]
  return _row(
      "attention bwd", _lengths(b, n_q, n_kv, c), dtype,
      time_ms(lambda: attn._launch_flash_attention_backward(
          q, k, v, out, lse, dout), iters),
      time_ms(lambda: attn.dense_attention_backward(q, k, v, out, dout),
              iters),
      None, 10.0 * b * n_q * n_kv * c,
      4.0 * b * (n_q + n_kv) * c * q.element_size() + 4.0 * b * n_q, errs,
      fwd_bwd_ms=time_ms(lambda: torch.autograd.grad(
          attn.attention(*leaves), leaves, dout), iters),
      library_fwd_bwd_ms=time_ms(lambda: torch.autograd.grad(
          F.scaled_dot_product_attention(*wide), leaves, dout4), iters))


def fused_act_forward(shape, iters=30) -> dict:
  x = torch.randn(shape, device="cuda")
  bias = torch.randn(shape[1], device="cuda")
  kernel = lambda: act._launch_forward(x, bias, 0.2, math.sqrt(2))
  plain = lambda: act.fused_leaky_relu(x, bias)
  # Reads x and the bias, writes one tensor; a few operations an element.
  return _row("fused_act fwd", ",".join(map(str, shape)), F32,
              time_ms(kernel, iters), time_ms(plain, iters), None,
              4.0 * x.numel(), (2 * x.numel() + bias.numel()) * 4,
              errors([act.fused_bias_act(x, bias)], [plain()]))


def fused_act_backward(shape, iters=30) -> dict:
  x, g = torch.randn(shape, device="cuda"), torch.randn(shape, device="cuda")
  bias = torch.randn(shape[1], device="cuda")
  kernel = lambda: act._launch_backward(x, bias, g, 0.2, math.sqrt(2))
  plain = lambda: act.fused_leaky_relu_backward(x, bias, g)
  return _row("fused_act bwd", ",".join(map(str, shape)), F32,
              time_ms(kernel, iters), time_ms(plain, iters), None,
              4.0 * x.numel(), (3 * x.numel() + bias.numel()) * 4,
              errors(_through_autograd(lambda x: act.fused_bias_act(x, bias),
                                       (x,), g), [plain()]))


def _gn_inputs(shape) -> tuple:
  gen = torch.Generator(device="cuda").manual_seed(9)
  x = torch.randn(shape, device="cuda", generator=gen) * 1.5 + 0.5
  dy = torch.randn(shape, device="cuda", generator=gen)
  w = 1 + 0.3 * torch.randn(shape[1], device="cuda", generator=gen)
  b = 0.3 * torch.randn(shape[1], device="cuda", generator=gen)
  return x, w, b, dy


def _gn_name(x, direction: str) -> str:
  path = "on-chip" if gn._onchip(x, GROUPS, None) else "split"
  return f"group_norm {direction} ({path})"


def group_norm_forward(shape, iters=30) -> dict:
  """GroupNorm + swish, 32 groups: the kernels' forward (one launch on
  chip, two split). Bound: the bytes of x read and y written."""
  x, w, b, _ = _gn_inputs(shape)
  kernel = lambda: gn._launch_forward(x, w, b, GROUPS, EPS, "swish", None)[0]
  plain = lambda: gn.group_norm_act_forward(x, w, b, GROUPS, EPS, "swish")
  return _row(_gn_name(x, "fwd"), ",".join(map(str, shape)), F32,
              time_ms(kernel, iters), time_ms(plain, iters),
              time_ms(lambda: F.silu(F.group_norm(x, GROUPS, w, b, EPS)),
                      iters),
              0.0, 2.0 * x.numel() * x.element_size(),
              errors([gn.group_norm_act(x, w, b, GROUPS, EPS, "swish")],
                     [plain()]))


def group_norm_backward(shape, iters=30) -> dict:
  """The kernels' backward (dx, dweight, dbias; two launches on chip, four
  split) from the forward's statistics. The plain and library rows are
  their forward and backward less their forward. Bound: the bytes of x
  and dy read and dx written."""
  x, w, b, dy = _gn_inputs(shape)
  _, stats = gn._launch_forward(x, w, b, GROUPS, EPS, "swish", None)
  kernel = lambda: gn._launch_backward(x, w, b, GROUPS, EPS, "swish", None,
                                       stats, dy)
  mean, var = gn.group_norm_stats(x, GROUPS)
  errs = errors(_through_autograd(
      lambda *t: gn.group_norm_act(*t, GROUPS, EPS, "swish"), (x, w, b), dy),
      gn.group_norm_act_backward(x, w, b, GROUPS, EPS, "swish", mean, var,
                                 dy))
  leaves = [t.clone().requires_grad_() for t in (x, w, b)]
  ms = {}
  for name, fn in (
      ("plain", lambda *t: gn.group_norm_act_forward(*t, GROUPS, EPS,
                                                     "swish")),
      ("library", lambda x, w, b: F.silu(F.group_norm(x, GROUPS, w, b,
                                                      EPS)))):
    forward = time_ms(lambda: fn(x, w, b), iters)
    ms[name] = time_ms(lambda: torch.autograd.grad(fn(*leaves), leaves, dy),
                       iters) - forward
  return _row(_gn_name(x, "bwd"), ",".join(map(str, shape)), F32,
              time_ms(kernel, iters), ms["plain"], ms["library"], 0.0,
              3.0 * x.numel() * x.element_size(), errs)


def say(row: dict) -> None:
  library = "none" if row["library_ms"] is None else (
      f"{row['library_ms']:.4f}")
  both = ""
  if "fwd_bwd_ms" in row:
    both = (f" | fwd+bwd kernels {row['fwd_bwd_ms']:.4f} library "
            f"{row['library_fwd_bwd_ms']:.4f}")
  print(f"{row['name']} {row['shape']} {row['dtype']}: ms {row['ms']:.4f} "
        f"| plain {row['plain_ms']:.4f} | library {library}{both} | bound "
        f"{row['bound_ms']:.4f} ({row['bound_by']}), share "
        f"{row['bound_ms'] / row['ms']:.3f} | max |kernel - plain| "
        f"{row['max_abs_err']:.3g}", flush=True)


def compile_library(source_path, tag: str) -> ctypes.CDLL:
  """nvcc a source file with the port's flags into the build directory."""
  data = open(source_path, "rb").read()
  digest = hashlib.sha256(data + " ".join(build.NVCC_FLAGS).encode())
  out = build.BUILD_DIR / f"lib{tag}-{digest.hexdigest()[:12]}.so"
  if not out.is_file():
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = build.nvcc_command(build.find_nvcc(), source_path, out)
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode:
      raise RuntimeError(f"nvcc failed for {source_path}:\n{proc.stderr}")
  return ctypes.CDLL(str(out))


class Bound:
  """A built flash_attention library's forward and backward entry points
  (taking N_q and N_kv)."""

  def __init__(self, lib: ctypes.CDLL):
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_forward.argtypes = [ptr] * 5 + [i32] * 4 + [
        f32, i32, ptr]
    lib.flash_attention_forward.restype = i32
    lib.flash_attention_backward.argtypes = [ptr] * 10 + [i32] * 4 + [
        f32, i32, ptr]
    lib.flash_attention_backward.restype = i32
    self.lib = lib

  def forward(self, q, k, v, o, lse) -> None:
    b, n_q, c = q.shape
    _check(self.lib.flash_attention_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(), b, n_q, k.shape[1], c,
        c ** -0.5, attn._DTYPE_CODES[q.dtype],
        torch.cuda.current_stream().cuda_stream))

  def backward(self, q, k, v, out, dout, lse, grads) -> None:
    b, n_q, c = q.shape
    n_kv = k.shape[1]
    # Both sources lay the scratch out as this checkout's does.
    scratch = torch.empty(
        attn.kernel_library().handle.flash_attention_backward_scratch(
            b, n_q, n_kv), device="cuda")
    _check(self.lib.flash_attention_backward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), scratch.data_ptr(),
        *(g.data_ptr() for g in grads), b, n_q, n_kv, c, c ** -0.5,
        attn._DTYPE_CODES[q.dtype], torch.cuda.current_stream().cuda_stream))


def _check(err: int) -> None:
  if err:
    raise RuntimeError(f"attention kernel launch failed: CUDA error {err}")


def bit_equal(this: Bound, other: Bound, q, k, v, dout) -> bool:
  """Whether the two builds' forward (output, lse) and backward (dq, dk,
  dv) give the same bits."""
  outs = []
  for lib in (this, other):
    o, lse = torch.empty_like(q), torch.empty(q.shape[:2], device="cuda")
    lib.forward(q, k, v, o, lse)
    grads = [torch.empty_like(t) for t in (q, k, v)]
    lib.backward(q, k, v, o, dout, lse, grads)
    outs.append([o, lse] + grads)
  torch.cuda.synchronize()
  return all(torch.equal(a, b) for a, b in zip(*outs))


def in_turns(this: Bound, other: Bound, shape, backward: bool,
             iters: int) -> bool:
  """The two builds' entry points at ``shape`` timed in turns (other,
  this, this, other), printed; returns whether their outputs are
  bit-equal."""
  b, n_q, n_kv, c, dtype = shape
  q, k, v, dout = _qkv(b, n_q, n_kv, c, dtype, count=4)
  equal = bit_equal(this, other, q, k, v, dout)
  out, lse = attn._launch_flash_attention(q, k, v, with_lse=True)
  grads = [torch.empty_like(t) for t in (q, k, v)]
  order = (("other", other), ("this", this), ("this", this),
           ("other", other))
  times = [(who, time_ms(
      (lambda lib=lib: lib.backward(q, k, v, out, dout, lse, grads))
      if backward else (lambda lib=lib: lib.forward(q, k, v, out, None)),
      iters)) for who, lib in order]
  print(f"  entry points in turns: "
        + ", ".join(f"{who} {ms:.4f}" for who, ms in times)
        + f"; outputs bit-equal to the other source's: {equal}", flush=True)
  return equal


def main(argv=None) -> int:
  parser = argparse.ArgumentParser()
  parser.add_argument("--other", help="a second flash_attention.cu to time "
                      "in turns with this checkout's")
  parser.add_argument("--iters", type=int, default=30)
  args = parser.parse_args(argv)
  if not torch.cuda.is_available():
    raise SystemExit("bench_kernels needs a CUDA card")
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  card = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True, check=False).stdout.strip()
  print(f"card: {card}; torch {torch.__version__}", flush=True)
  this = Bound(attn.kernel_library().handle)
  other = Bound(compile_library(args.other, "other_attention")) \
      if args.other else None
  all_equal = True
  for shapes, row, backward in ((ATTENTION_FORWARD, attention_forward,
                                 False),
                                (ATTENTION_BACKWARD, attention_backward,
                                 True)):
    for shape in shapes:
      say(row(*shape, iters=args.iters))
      if other:
        all_equal &= in_turns(this, other, shape, backward, args.iters)
  for shape in FUSED_ACT:
    say(fused_act_forward(shape, args.iters))
    say(fused_act_backward(shape, args.iters))
  for shape in GROUP_NORM:
    say(group_norm_forward(shape, args.iters))
    say(group_norm_backward(shape, args.iters))
    torch.cuda.empty_cache()
  if other:
    for b, n_q, n_kv, c in EQUALITY_SHAPES:
      for dtype in (F32, BF16):
        equal = bit_equal(this, other,
                          *_qkv(b, n_q, n_kv, c, dtype, count=4))
        all_equal &= equal
        print(f"attention {_lengths(b, n_q, n_kv, c)} {str(dtype)[6:]}: "
              f"forward and backward bit-equal to the other source's: "
              f"{equal}", flush=True)
    print(f"every output bit-equal to the other source's: {all_equal}",
          flush=True)
    return 0 if all_equal else 1
  return 0


if __name__ == "__main__":
  sys.exit(main())
