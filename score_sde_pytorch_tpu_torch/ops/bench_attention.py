"""Time the attention kernels on the card, at the main path's shapes.

    python -m score_sde_pytorch_tpu_torch.ops.bench_attention \\
        [--other PATH/flash_attention.cu] [--iters 30]

Prints, per shape (fp32, and the first shape in bf16 too): the kernel of
this checkout, its plain PyTorch version, F.scaled_dot_product_attention on
[B, 1, N, C] (the library's one call, timed only: the port never calls it)
and the card's bound (operations at the tensor cores' peak for the dtype,
TF32 for fp32, or bytes at HBM's rate, whichever is larger), with TF32 off
for the plain fp32 products. With ``--other``, a second build of a kernel source with the same C
entry points (for example a parent commit's) is timed in turns with this
one (other, this, this, other), so that two versions compare on one card
in one process. It also measures the rate of mma.sync m16n8k8 TF32 on the
card, the instruction the kernels' products run on, and the device time of
each backward launch (profiler). ``--variants`` times diagnostic edits of
this checkout's source (wrong results, for timing only; see VARIANTS): the
products issued as chains, no logits, no mma in the other products, the
forward with neither, no split ALU work, no prefetch of the next tile.

It needs a CUDA card and nvcc; nothing here runs on the CPU.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import subprocess
import sys

import torch

from score_sde_pytorch_tpu_torch.ops import attention as attn
from score_sde_pytorch_tpu_torch.ops import build

# H100 SXM, dense tensor-core peaks by input dtype (NVIDIA's data sheet):
# TF32 for fp32 inputs, bf16 for bf16.
PEAK_FLOPS = {torch.float32: 495e12, torch.bfloat16: 989e12}
HBM_BYTES_PER_S = 3.35e12
FWD_SHAPES = [(64, 256, 256), (128, 256, 256), (1024, 256, 256),
              (2, 1024, 256)]
BWD_SHAPES = [(128, 256, 256), (2, 1024, 256)]
# (shape, dtype) pairs timed: every shape in fp32, the first also in bf16.
FWD_CASES = [(s, torch.float32) for s in FWD_SHAPES] + [
    (FWD_SHAPES[0], torch.bfloat16)]
BWD_CASES = [(s, torch.float32) for s in BWD_SHAPES] + [
    (BWD_SHAPES[0], torch.bfloat16)]
# Diagnostic edits of csrc/flash_attention.cu, (old text, new text) pairs:
# each removes one part of the work (wrong results, for timing only), and
# "ungrouped" issues each tile's products back to back, as a chain.
_CONST_LOGITS = ("for (int j = 0; j < 2; ++j) for (int e = 0; e < 4; ++e) "
                 "{}[j][e] = 0.01f * (j + e + t);")
_NO_FWD_LOGITS = ("    logits<T, 2>(q_s, k_s, ld, c, m0, 16 * half, s);",
                  "    " + _CONST_LOGITS.format("s"))
_NO_BWD_LOGITS = [
    ("      logits<T, 2>(q_s, k_s, ld, c, sm, sn, x);",
     "      " + _CONST_LOGITS.format("x")),
    ("      logits<T, 2>(do_s, v_s, ld, c, sm, sn, x);",
     "      " + _CONST_LOGITS.format("x"))]
_NO_PRODUCT_MMA = [  # the mma of P V, dV, dK and dQ; their loads stay
    ("""        mma_tf32(acc[i0 + u], a[0].lo, a[1].lo, a[2].lo, a[3].lo, b[u][0].hi,
                 b[u][1].hi);""",
     "        acc[i0 + u][0] += __uint_as_float(a[0].lo ^ b[u][0].hi);"),
    ("""          mma_tf32(acc[i0 + u], a[0].hi, a[1].hi, a[2].hi, a[3].hi,
                   b[u][0].lo, b[u][1].lo);""",
     "          acc[i0 + u][1] += __uint_as_float(a[0].hi ^ b[u][0].lo);"),
    ("""        mma_tf32(acc[i0 + u], a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[u][0].hi,
                 b[u][1].hi);""",
     "        acc[i0 + u][2] += __uint_as_float(a[1].hi ^ b[u][1].hi);")]
_NO_FWD_PV = ("""        mma_tiles<true, kTileGroup>(
            acc, a, [&](int i) { return 8 * (2 * i + half) < c; },
            [&](int i, Split (&b)[2]) {
              load_b_perm<true>(v_s, ld, kk, 8 * (2 * i + half), b);
            });""", "        acc[kk / 8][0] += __uint_as_float(a[0].hi ^ a[3].lo);")
_NO_PREFETCH = [("    if (tile + 1 < tiles) stage_kv(tile + 1);", ""),
                ("    if (tile + 1 < tiles) stage_query_tile(tile + 1);", "")]
VARIANTS = {
    "ungrouped": [
        ("constexpr int kTileGroup = 2;", "constexpr int kTileGroup = 1;"),
        ("constexpr int kLogitSteps = 2;", "constexpr int kLogitSteps = 1;")],
    "no_logits": [_NO_FWD_LOGITS] + _NO_BWD_LOGITS,
    "no_product_mma": _NO_PRODUCT_MMA,
    "no_logits_no_product_mma": [_NO_FWD_LOGITS] + _NO_BWD_LOGITS
                                + _NO_PRODUCT_MMA,
    "forward_skeleton": [_NO_FWD_LOGITS, _NO_FWD_PV],
    "forward_skeleton_no_prefetch": [_NO_FWD_LOGITS, _NO_FWD_PV]
                                    + _NO_PREFETCH,
    "no_split_alu": [(
        "    const uint32_t hi = to_tf32(x);\n"
        "    return {hi, __float_as_uint(x - __uint_as_float(hi))};",
        "    return {__float_as_uint(x), __float_as_uint(x)};")],
    "no_prefetch": _NO_PREFETCH,
}

_MMA_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void mma_loop(float* out, int iters) {
  float d[8][4] = {};
  const uint32_t a = __float_as_uint(1e-3f) & 0xffffe000u;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %4, %4, %4}, {%4, %4}, {%0, %1, %2, %3};"
          : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
          : "r"(a));
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  if (s == 1234.5f) out[0] = s;
}
extern "C" int mma_rate_run(float* out, int blocks, int threads, int iters) {
  mma_loop<<<blocks, threads>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}
"""


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


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
  ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
  lib.flash_attention_forward.argtypes = [ptr] * 5 + [i32, i32, i32, f32,
                                                      i32, ptr]
  lib.flash_attention_forward.restype = i32
  lib.flash_attention_backward.argtypes = [ptr] * 10 + [i32, i32, i32, f32,
                                                        i32, ptr]
  lib.flash_attention_backward.restype = i32
  return lib


def time_ms(fn, iters: int) -> float:
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


def bound_ms(flops: float, nbytes: float, dtype=torch.float32) -> str:
  ops, mem = flops / PEAK_FLOPS[dtype] * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
  return f"{max(ops, mem):.4f} ({'operations' if ops >= mem else 'bytes'})"


def mma_rate(iters: int = 4096) -> float:
  """TFLOP/s of independent mma.sync m16n8k8 TF32 over the whole card."""
  import os
  import tempfile
  with tempfile.NamedTemporaryFile("w", suffix=".cu", delete=False) as f:
    f.write(_MMA_SOURCE)
  try:
    lib = compile_library(f.name, "mma_rate")
  finally:
    os.remove(f.name)
  run = lib.mma_rate_run
  run.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
  out = torch.zeros(1, device="cuda")
  blocks = torch.cuda.get_device_properties(0).multi_processor_count * 4
  threads = 256

  def go():
    err = run(out.data_ptr(), blocks, threads, iters)
    if err:
      raise RuntimeError(f"mma_rate launch failed: {err}")

  ms = time_ms(go, 5)
  flops = blocks * threads / 32 * iters * 8 * 2 * 16 * 8 * 8
  return flops / ms / 1e9


def main(argv=None) -> int:
  parser = argparse.ArgumentParser()
  parser.add_argument("--other", help="a second flash_attention.cu to time "
                      "in turns with this checkout's")
  parser.add_argument("--iters", type=int, default=30)
  parser.add_argument("--variants", action="store_true",
                      help="also time the diagnostic source edits")
  args = parser.parse_args(argv)
  if not torch.cuda.is_available():
    raise SystemExit("bench_attention needs a CUDA card")
  torch.backends.cuda.matmul.allow_tf32 = False
  card = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True, check=False).stdout.strip()
  print(f"card: {card}; torch {torch.__version__}", flush=True)
  this = bind(attn.kernel_library().handle)
  other = bind(compile_library(args.other, "other_attention")) \
      if args.other else None
  print(f"mma.sync m16n8k8 TF32: {mma_rate():.1f} TFLOP/s over the card",
        flush=True)
  stream = torch.cuda.current_stream().cuda_stream
  sdpa = torch.nn.functional.scaled_dot_product_attention
  gen = torch.Generator(device="cuda").manual_seed(0)
  it = args.iters

  def forward(lib, q, k, v, o):
    b, n, c = q.shape
    return lambda: lib.flash_attention_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None, b, n,
        c, c ** -0.5, attn._DTYPE_CODES[q.dtype], stream)

  for (b, n, c), dtype in FWD_CASES:
    q, k, v = (torch.randn(b, n, c, device="cuda", generator=gen).to(dtype)
               for _ in range(3))
    o = torch.empty_like(q)
    row = {"kernel": [], "other": []}
    order = ["other", "kernel", "kernel", "other"] if other else ["kernel"]
    for who in order:
      row[who].append(time_ms(forward(this if who == "kernel" else other,
                                      q, k, v, o), it))
    plain = time_ms(lambda: attn.dense_attention(q, k, v), it)
    q4, k4, v4 = (t[:, None] for t in (q, k, v))
    lib_ms = time_ms(lambda: sdpa(q4, k4, v4), it)
    text = " ".join(f"{x:.4f}" for x in row["kernel"])
    if other:
      text += " | other " + " ".join(f"{x:.4f}" for x in row["other"])
    bound = bound_ms(4.0 * b * n * n * c, 4.0 * b * n * c * q.element_size(),
                     dtype)
    print(f"forward {b},{n},{c} {str(dtype)[6:]}: kernel {text} | plain "
          f"{plain:.4f} | sdpa {lib_ms:.4f} | bound {bound} ms", flush=True)

  for (b, n, c), dtype in BWD_CASES:
    q, k, v, dout = (torch.randn(b, n, c, device="cuda", generator=gen)
                     .to(dtype) for _ in range(4))
    out, lse = attn._launch_flash_attention(q, k, v, with_lse=True)
    ld = (n + 31) // 32 * 32
    scratch = torch.empty(b * n * (ld + 1), device="cuda")
    grads = [torch.empty_like(q) for _ in range(3)]

    def backward(lib):
      return lambda: lib.flash_attention_backward(
          q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
          dout.data_ptr(), lse.data_ptr(), scratch.data_ptr(),
          *(g.data_ptr() for g in grads), b, n, c, c ** -0.5,
          attn._DTYPE_CODES[dtype], stream)

    row = {"kernel": [], "other": []}
    order = ["other", "kernel", "kernel", "other"] if other else ["kernel"]
    for who in order:
      row[who].append(time_ms(backward(this if who == "kernel" else other),
                              it))
    plain = time_ms(lambda: attn.dense_attention_backward(q, k, v, out, dout),
                    it)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    wide = [t[:, None] for t in leaves]
    both = time_ms(lambda: torch.autograd.grad(attn.attention(*leaves),
                                               leaves, dout), it)
    lib_both = time_ms(lambda: torch.autograd.grad(sdpa(*wide), leaves,
                                                   dout[:, None]), it)
    text = " ".join(f"{x:.4f}" for x in row["kernel"])
    if other:
      text += " | other " + " ".join(f"{x:.4f}" for x in row["other"])
    bound = bound_ms(10.0 * b * n * n * c,
                     8.0 * b * n * c * q.element_size() + 4.0 * b * n, dtype)
    print(f"backward {b},{n},{c} {str(dtype)[6:]}: kernel {text} | plain "
          f"{plain:.4f} | bound {bound} ms | forward+backward: kernels "
          f"{both:.4f} sdpa {lib_both:.4f}", flush=True)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
      for _ in range(10):
        backward(this)()
      torch.cuda.synchronize()
    for evt in prof.key_averages():
      us = getattr(evt, "self_device_time_total", 0)
      if us:
        print(f"  backward launch {evt.key[:70]}: {us / 10 / 1e3:.4f} ms",
              flush=True)
  if args.variants:
    time_variants(stream, it)
  return 0


def time_variants(stream, iters: int) -> None:
  """Forward at 64,256,256 and backward at 128,256,256 of each diagnostic
  edit of this checkout's source, beside the unedited source."""
  import os
  import tempfile
  source = build.source_path("flash_attention").read_text()
  gen = torch.Generator(device="cuda").manual_seed(1)
  q, k, v = (torch.randn(64, 256, 256, device="cuda", generator=gen)
             for _ in range(3))
  o = torch.empty_like(q)
  qb, kb, vb, dob = (torch.randn(128, 256, 256, device="cuda", generator=gen)
                     for _ in range(4))
  out, lse = attn._launch_flash_attention(qb, kb, vb, with_lse=True)
  scratch = torch.empty(128 * 256 * 257, device="cuda")
  grads = [torch.empty_like(qb) for _ in range(3)]
  for name, edits in [("unedited", [])] + list(VARIANTS.items()):
    text = source
    for old, new in edits:
      if old not in text:
        print(f"variant {name}: edit no longer applies; skipped")
        break
      text = text.replace(old, new)
    else:
      with tempfile.NamedTemporaryFile("w", suffix=".cu",
                                       delete=False) as f:
        f.write(text)
      try:
        lib = bind(compile_library(f.name, f"variant_{name}"))
      finally:
        os.remove(f.name)
      fwd = time_ms(lambda: lib.flash_attention_forward(
          q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None, 64,
          256, 256, 1 / 16, 0, stream), iters)
      bwd = time_ms(lambda: lib.flash_attention_backward(
          qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), out.data_ptr(),
          dob.data_ptr(), lse.data_ptr(), scratch.data_ptr(),
          *(g.data_ptr() for g in grads), 128, 256, 256, 1 / 16, 0, stream),
          iters)
      print(f"variant {name}: forward 64,256,256 {fwd:.4f} ms, backward "
            f"128,256,256 {bwd:.4f} ms", flush=True)


if __name__ == "__main__":
  sys.exit(main())
