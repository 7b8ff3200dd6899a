#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (score_sde_pytorch_tpu_torch) on one
NVIDIA GPU. Run it from the root of a checkout:

    python3 chip_smoke.py

It needs a CUDA device and the CUDA toolkit (nvcc), and imports nothing of
JAX or of the JAX package. Phases, each of which fails the run if it fails:

1. the card's name and power limit; the kernels built from
   score_sde_pytorch_tpu_torch/ops/csrc/ (flash_attention.cu, fused_act.cu;
   one nvcc each, started together), with build times and ptxas reports;
   no attention kernel may spill registers, and each must hold tensor-core
   (HMMA) instructions where cuobjdump can show them;
2. [kernel] the attention forward kernel against the plain PyTorch
   attention on the card, at the main path's shapes and a few more: fp32
   (TF32 off), bf16, logits x30; the times of the kernel, the plain version
   and F.scaled_dot_product_attention (the library's one call, timed only)
   beside the card's bound;
3. [kernel-bwd] the attention backward kernels against the plain backward
   (and autograd through the plain attention) at the train path's shapes
   and a few more, the same three cases, bitwise repeatability, and times
   (with forward + backward of the kernels and of the library's call);
4. [fused-act] the fused bias + leaky ReLU kernels (forward, backward)
   against their plain versions, fp32 and bf16, and times;
5. [forward] the full-width flagship NCSN++
   (score_sde_pytorch_tpu_torch/configs/ve/cifar10_ncsnpp_continuous.py)
   forward on the card through the kernel against through the plain
   attention, and against the CPU;
6. [grad] one loss of that model (injected t and z) and its parameter
   gradients through the kernels against through the plain attention, and
   the loss against the CPU's;
7. [sample] the user's entry point: a reference-schema checkpoint of that
   model in a temporary workdir, then ``main --mode sample`` in process at
   full width (num_scales cut to 100), the samples checked, and the count
   of kernel launches held to 6 attention calls x NFE x rounds; then
   [sample-profile], the sampler at batch 64: ms per NFE, device idle share
   and the attention kernel's share of device time;
8. [train] ``main --mode train`` in process at full width and batch 128
   (10 steps with snapshot sampling, then a resume to step 20), its
   checkpoints, samples and launch counts checked; then the train step's
   time, images/s, peak memory and device idle share at batch 128.

The last three lines of standard output are the kernels' JSON record, the
card's ``nvidia-smi`` name and power limit, and ``{"ok": true, ...}``.
"""
from __future__ import annotations

import concurrent.futures
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from unittest import mock

ROOT = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = os.path.join(ROOT, "score_sde_pytorch_tpu_torch", "configs", "ve",
                        "cifar10_ncsnpp_continuous.py")
KERNEL_SOURCE = "score_sde_pytorch_tpu_torch/ops/csrc/flash_attention.cu"
TPU_KERNEL = "score_sde_pytorch_tpu/ops/attention.py:77"
ACT_SOURCE = "score_sde_pytorch_tpu_torch/ops/csrc/fused_act.cu"
TPU_BWD = "score_sde_pytorch_tpu/ops/attention.py:129"   # _flash_bwd_impl
TPU_ACT = "score_sde_pytorch_tpu/ops/fused_act.py:33"
SMOKE_SCALES = 100           # cut from 1000 for the smoke's time
SMOKE_BATCH = 16
SMOKE_ROUNDS = 2
ATTN_PER_FORWARD = 6         # 5 blocks at 16x16 and the 4x4 bottleneck
# The path's shapes first: sampling (batch 64), training (batch 128), the
# configs' eval batch (1024), the 4x4 bottleneck, then the 32x32 and
# ragged shapes of other configs.
ATTN_SHAPES = [(64, 256, 256), (128, 256, 256), (1024, 256, 256),
               (64, 16, 256), (2, 1024, 256), (4, 200, 256), (1, 4096, 256)]
FP32_TOL = 2e-5
FORWARD_RTOL = 1e-4
BWD_SHAPES = [(128, 256, 256), (128, 16, 256), (2, 1024, 256),
              (1, 1024, 128), (4, 200, 256)]
BWD_TOL = 5e-4               # the JAX package's gradient bound
ACT_SHAPES = [(128, 256, 16, 16), (128, 128, 32, 32)]
ACT_TOL = 1e-6
# Published peaks of one H100 SXM (NVIDIA's data sheet, dense): the
# tensor cores' TF32 rate, the card's fastest on fp32 inputs, and HBM.
TF32_FLOPS = 495e12
HBM_BYTES_PER_S = 3.35e12
PROFILE_BATCH = 64           # the sampler's profiled window
PROFILE_SCALES = 10          # 20 NFE
GRAD_BATCH = 8
GRAD_RTOL = 1e-4
LOSS_RTOL = 1e-5
TRAIN_BATCH = 128
TRAIN_FLAGS = {"training.batch_size": TRAIN_BATCH, "training.log_freq": 5,
               "training.eval_freq": 5,
               "training.snapshot_freq_for_preemption": 5,
               "training.snapshot_freq": 10,
               "model.num_scales": SMOKE_SCALES}
TIMED_STEPS = 10
PROFILED_STEPS = 5


def check(ok: bool, what: str) -> None:
  if not ok:
    raise RuntimeError(f"chip_smoke check failed: {what}")


def say(*parts) -> None:
  print(*parts, flush=True)


def card() -> str:
  return subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 50) -> float:
  for _ in range(5):
    fn()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(iters):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float) -> tuple:
  """The least time the card could take, in ms, and what bounds it: the
  larger of the operations at the TF32 peak and the bytes at HBM's rate."""
  ops_ms = flops / TF32_FLOPS * 1e3
  bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
  return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def _sass_mma_counts(lib_path) -> dict:
  """HMMA (tensor-core) instructions per kernel in the built library, or {}
  where cuobjdump is not beside nvcc."""
  from score_sde_pytorch_tpu_torch.ops import build
  tool = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
  if not os.path.isfile(tool):
    return {}
  sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                        text=True, check=True).stdout
  counts, name = {}, None
  for line in sass.splitlines():
    if "Function :" in line:
      name = line.split(":", 1)[1].strip()
      counts[name] = 0
    elif name is not None and re.search(r"\bHMMA\b", line):
      counts[name] += 1
  return counts


def phase_build(*modules) -> None:
  """One nvcc per kernel source, all started together. Fails if an
  attention kernel spills registers or has no tensor-core instruction."""
  with concurrent.futures.ThreadPoolExecutor(len(modules)) as pool:
    libs = list(pool.map(lambda m: m.kernel_library(), modules))
  for lib in libs:
    say(f"[build] {lib.path.name}: nvcc {lib.build_seconds:.2f} s")
    kernel = None
    for line in lib.compiler_log.splitlines():
      if "Compiling entry function" in line:
        kernel = line.split("'")[1]
      if "registers" in line or "spill" in line or "Compiling" in line:
        say("[build]  ", line.strip())
      spills = re.search(r"(\d+) bytes spill stores", line)
      if spills and kernel and "flash_attention" in kernel:
        check(int(spills.group(1)) == 0, f"{kernel} spills registers")
    if lib.name == "flash_attention":
      mma = {k: v for k, v in _sass_mma_counts(lib.path).items()
             if re.search(r"flash_attention_(fwd|bwd_dkdv|bwd_dq)", k)}
      for name, count in mma.items():
        say(f"[build]   {count} HMMA (mma.sync) in {name[:100]}")
        check(count > 0, f"{name} has no tensor-core instruction")
      if not mma:
        say("[build]   cuobjdump not found: tensor-core use not checked")


def sdpa_backend(torch, fn) -> str:
  """The device kernels one call of ``fn`` launches (which backend
  F.scaled_dot_product_attention picked)."""
  from torch.profiler import ProfilerActivity, profile
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    fn()
    torch.cuda.synchronize()
  names = sorted({evt.key for evt in prof.key_averages()
                  if str(getattr(evt, "device_type", "")).endswith("CUDA")})
  return "; ".join(n[:60] for n in names) or "not measured"


def phase_kernel(torch, attn) -> dict:
  """Kernel vs plain attention on standard-normal q, k, v. Returns the
  record of the path's first shape.

  - fp32 (TF32 off): max |kernel - plain| <= 2e-5.
  - bf16: error against the fp64 result no worse than the plain bf16
    path's, x1.5 + 1e-3 (tests/test_attention.py's rule).
  - logits x30: finite, and error against the fp64 result no worse than the
    plain fp32 path's, x1.5 + 2e-5. Against the plain path itself no fp32
    bound below fp32's own error applies: at x30 the plain path is up to
    1.2e-4 from the fp64 result on these inputs, because logits of ~100
    carry fp32 rounding of ~1e-5 that the peaked softmax amplifies.

  Times: the kernel, the plain version, and the library's one call that
  computes the same function, F.scaled_dot_product_attention on
  [B, 1, N, C] (timed only: the port never calls it), beside the bound."""
  sdpa = torch.nn.functional.scaled_dot_product_attention
  gen = torch.Generator(device="cuda").manual_seed(0)
  worst = 0.0
  record = None
  for b, n, c in ATTN_SHAPES:
    q, k, v = (torch.randn(b, n, c, device="cuda", generator=gen)
               for _ in range(3))
    out = attn.attention(q, k, v)
    plain = attn.dense_attention(q, k, v)
    exact = attn.dense_attention(*(t.double() for t in (q, k, v)))
    torch.cuda.synchronize()
    err = (out - plain).abs().max().item()
    err_exact = (out.double() - exact).abs().max().item()
    err_plain_exact = (plain.double() - exact).abs().max().item()
    check(math.isfinite(err) and err <= FP32_TOL,
          f"fp32 kernel vs plain at {(b, n, c)}: {err:.3g} > {FP32_TOL}")
    worst = max(worst, err)
    del exact

    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    exact16 = attn.dense_attention(*(t.double() for t in (qb, kb, vb)))
    err_bf16 = (attn.attention(qb, kb, vb).double() - exact16).abs().max().item()
    err_bf16_plain = (attn.dense_attention(qb, kb, vb).double()
                      - exact16).abs().max().item()
    check(err_bf16 <= err_bf16_plain * 1.5 + 1e-3,
          f"bf16 at {(b, n, c)}: kernel {err_bf16:.3g} vs plain "
          f"{err_bf16_plain:.3g}")
    del exact16

    q30 = q * 30  # logits far past exp's range unless the softmax is online
    out30 = attn.attention(q30, k, v)
    plain30 = attn.dense_attention(q30, k, v)
    exact30 = attn.dense_attention(q30.double(), k.double(), v.double())
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out30).all()),
          f"x30 logits: kernel output not finite at {(b, n, c)}")
    err30 = (out30 - plain30).abs().max().item()
    err30_exact = (out30.double() - exact30).abs().max().item()
    err30_plain_exact = (plain30.double() - exact30).abs().max().item()
    check(err30_exact <= 1.5 * err30_plain_exact + FP32_TOL,
          f"x30 at {(b, n, c)}: kernel-exact {err30_exact:.3g}, plain-exact "
          f"{err30_plain_exact:.3g}")
    del exact30, out30, plain30, q30

    q4, k4, v4 = (t[:, None] for t in (q, k, v))
    ms = time_ms(torch, lambda: attn.attention(q, k, v))
    plain_ms = time_ms(torch, lambda: attn.dense_attention(q, k, v))
    library_ms = time_ms(torch, lambda: sdpa(q4, k4, v4))
    ms_again = time_ms(torch, lambda: attn.attention(q, k, v))
    bound_ms, bound_by = bound(4.0 * b * n * n * c, 4.0 * b * n * c * 4)
    say(f"[kernel] B,N,C={b},{n},{c}: fp32 kernel-plain {err:.3g}, vs fp64 "
        f"kernel {err_exact:.3g} plain {err_plain_exact:.3g} | bf16 vs fp64 "
        f"kernel {err_bf16:.3g} plain {err_bf16_plain:.3g} | x30 kernel-plain "
        f"{err30:.3g}, vs fp64 kernel {err30_exact:.3g} plain "
        f"{err30_plain_exact:.3g}")
    say(f"[kernel]   fp32 ms: kernel {ms:.4f} (again {ms_again:.4f}) plain "
        f"{plain_ms:.4f} sdpa {library_ms:.4f} bound {bound_ms:.4f} "
        f"({bound_by}); share of bound {bound_ms / ms:.3f}")
    if record is None:
      record = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": bound_ms, "bound_by": bound_by}
      say(f"[kernel]   sdpa backend: "
          f"{sdpa_backend(torch, lambda: sdpa(q4, k4, v4))}")
  record["max_abs_err"] = worst
  return record


def unit_gain_(torch, model, layers, seed: int) -> None:
  """Every parameter drawn at unit gain, including those the real init
  zeroes (NIN_3, Conv_1, conv_out), so attention moves the output."""
  gen = torch.Generator().manual_seed(seed)
  with torch.no_grad():
    for module in model.modules():
      for name, p in module.named_parameters(recurse=False):
        if not p.requires_grad:
          continue  # the Fourier projection keeps its N(0, 16^2) draw
        if isinstance(module, layers.GroupNorm) and name == "weight":
          value = 1 + 0.1 * torch.randn(p.shape, generator=gen)
        elif p.dim() >= 2:
          fan_in = p.shape[0] if name == "W" else p[0].numel()
          value = torch.randn(p.shape, generator=gen) / math.sqrt(fan_in)
        else:
          value = 0.1 * torch.randn(p.shape, generator=gen)
        p.copy_(value)


def phase_forward(torch, attn, config, model) -> None:
  from score_sde_pytorch_tpu_torch import sde as sde_lib
  gen = torch.Generator(device="cuda").manual_seed(1)
  size = config.data.image_size
  x = torch.rand(SMOKE_BATCH, 3, size, size, device="cuda", generator=gen)
  t = torch.rand(SMOKE_BATCH, device="cuda", generator=gen)
  labels = sde_lib.build_sde(config).sigma_t(t)
  with torch.no_grad():
    before = attn.flash_attention_launches
    through_kernel = model(x, labels)
    torch.cuda.synchronize()
    launches = attn.flash_attention_launches - before
    with mock.patch.object(attn, "attention", attn.dense_attention):
      through_plain = model(x, labels)
      on_cpu = model.to("cpu")(x[:2].cpu(), labels[:2].cpu())
      model.to("cuda")
  check(launches == ATTN_PER_FORWARD,
        f"{launches} kernel launches in one forward, want {ATTN_PER_FORWARD}")
  check(bool(torch.isfinite(through_kernel).all()), "forward not finite")
  scale = through_plain.abs().max().item()
  rel = (through_kernel - through_plain).abs().max().item() / scale
  rel_cpu = ((through_kernel[:2].cpu() - on_cpu).abs().max().item()
             / on_cpu.abs().max().item())
  say(f"[forward] full-width NCSN++ B={SMOKE_BATCH}: max|out| {scale:.4g}, "
      f"kernel vs plain rel err {rel:.3g}, card vs CPU rel err {rel_cpu:.3g} "
      f"({launches} kernel launches)")
  check(rel <= FORWARD_RTOL, f"kernel vs plain forward rel err {rel:.3g}")
  check(rel_cpu <= FORWARD_RTOL, f"card vs CPU forward rel err {rel_cpu:.3g}")


def phase_sample(torch, attn, config, model, card_line: str) -> int:
  import numpy as np
  from score_sde_pytorch_tpu_torch import checkpoint, main
  overrides = [f"--config.model.num_scales={SMOKE_SCALES}",
               f"--config.eval.batch_size={SMOKE_BATCH}"]
  say(f"[sample] num_scales cut from 1000 to {SMOKE_SCALES} for the smoke's "
      f"time: NFE {SMOKE_SCALES * 2} per round instead of 2000")
  with tempfile.TemporaryDirectory() as workdir:
    checkpoint.save_checkpoint(checkpoint.numbered_path(workdir, 1), model,
                               config, step=1)
    attn.flash_attention_launches = 0
    rounds = main.main(["--config", FLAGSHIP, "--workdir", workdir,
                        "--mode", "sample",
                        "--num_samples", str(SMOKE_BATCH * SMOKE_ROUNDS)]
                       + overrides)
    launches = attn.flash_attention_launches
    for r in range(SMOKE_ROUNDS):
      path = os.path.join(workdir, "generated", f"samples_{r}.npz")
      check(os.path.isfile(path), f"{path} missing")
      samples = np.load(path)["samples"]
      size = config.data.image_size
      check(samples.dtype == np.uint8
            and samples.shape == (SMOKE_BATCH, size, size, 3),
            f"samples_{r}.npz is {samples.dtype} {samples.shape}")
  nfe = SMOKE_SCALES * (config.sampling.n_steps_each + 1)
  check([r["nfe"] for r in rounds] == [nfe] * SMOKE_ROUNDS,
        f"rounds {rounds}, want NFE {nfe}")
  want = ATTN_PER_FORWARD * nfe * SMOKE_ROUNDS
  check(launches == want, f"{launches} kernel launches while sampling, want "
        f"{want} = {ATTN_PER_FORWARD} x NFE {nfe} x {SMOKE_ROUNDS} rounds")
  for r, rec in enumerate(rounds):
    say(f"[sample] round {r}: {rec['samples']} samples in {rec['seconds']:.3f}"
        f" s = {rec['samples'] / rec['seconds']:.3f} samples/s, "
        f"{rec['seconds'] * 1e3 / rec['nfe']:.3f} ms/NFE at batch "
        f"{SMOKE_BATCH} ({card_line})")
  say(f"[sample] {launches} kernel launches = {ATTN_PER_FORWARD} x NFE {nfe} "
      f"x {SMOKE_ROUNDS} rounds")
  return launches


def _max_err(a, b) -> float:
  return (a.double() - b.double()).abs().max().item()


def phase_kernel_bwd(torch, attn) -> dict:
  """Backward kernels vs the plain backward on standard-normal q, k, v, dO.
  Returns the record of the train path's shape (128, 256, 256).

  - fp32 (TF32 off): dq, dk, dv within 5e-4 (absolute and relative) of
    ``dense_attention_backward`` and of autograd through
    ``dense_attention``.
  - bf16: error against the fp64 gradients no worse than the plain bf16
    path's, x1.5 + 1e-3.
  - logits x30: finite, and error against the fp64 gradients no worse than
    the plain fp32 path's, x1.5 + 5e-4."""
  gen = torch.Generator(device="cuda").manual_seed(2)
  worst = 0.0
  record = None

  def through_kernel(q, k, v, dout):
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    attn.attention(*leaves).backward(dout)
    return [t.grad for t in leaves]

  def plain(q, k, v, dout):
    return attn.dense_attention_backward(q, k, v,
                                         attn.dense_attention(q, k, v), dout)

  def close(got, want):
    return all(bool(((g - w).abs() <= BWD_TOL + BWD_TOL * w.abs()).all())
               for g, w in zip(got, want))

  for b, n, c in BWD_SHAPES:
    q, k, v, dout = (torch.randn(b, n, c, device="cuda", generator=gen)
                     for _ in range(4))
    got = through_kernel(q, k, v, dout)
    want = plain(q, k, v, dout)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    attn.dense_attention(*leaves).backward(dout)
    auto = [t.grad for t in leaves]
    torch.cuda.synchronize()
    err = max(_max_err(g, w) for g, w in zip(got, want))
    err_auto = max(_max_err(g, w) for g, w in zip(got, auto))
    check(math.isfinite(err) and close(got, want) and close(got, auto),
          f"fp32 backward kernel vs plain at {(b, n, c)}: {err:.3g}, vs "
          f"autograd {err_auto:.3g} (bound {BWD_TOL} abs + rel)")
    worst = max(worst, err)

    def exact_of(*args):
      wide = [a.double() for a in args]
      return plain(*wide)

    args16 = [t.bfloat16() for t in (q, k, v, dout)]
    exact16 = exact_of(*args16)
    err16 = max(_max_err(g, e) for g, e in zip(through_kernel(*args16),
                                                exact16))
    err16_plain = max(_max_err(g, e) for g, e in zip(plain(*args16), exact16))
    check(err16 <= 1.5 * err16_plain + 1e-3,
          f"bf16 backward at {(b, n, c)}: kernel {err16:.3g} vs plain "
          f"{err16_plain:.3g}")

    args30 = [q * 30, k, v, dout]
    exact30 = exact_of(*args30)
    got30 = through_kernel(*args30)
    check(all(bool(torch.isfinite(g).all()) for g in got30),
          f"x30 logits: backward not finite at {(b, n, c)}")
    err30 = max(_max_err(g, e) for g, e in zip(got30, exact30))
    err30_plain = max(_max_err(g, e) for g, e in zip(plain(*args30), exact30))
    check(err30 <= 1.5 * err30_plain + BWD_TOL,
          f"x30 backward at {(b, n, c)}: kernel-exact {err30:.3g}, "
          f"plain-exact {err30_plain:.3g}")

    again = through_kernel(q, k, v, dout)
    check(all(torch.equal(x, y) for x, y in zip(got, again)),
          f"backward not bitwise repeatable at {(b, n, c)}")

    out, lse = attn._launch_flash_attention(q, k, v, with_lse=True)
    ms = time_ms(torch, lambda: attn._launch_flash_attention_backward(
        q, k, v, out, lse, dout), iters=20)
    plain_ms = time_ms(torch, lambda: attn.dense_attention_backward(
        q, k, v, out, dout), iters=20)
    # Forward + backward of the kernels and of the library's call
    # (F.scaled_dot_product_attention on [B, 1, N, C]; no single library
    # call computes the backward alone).
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    wide = [t[:, None] for t in leaves]
    dout4 = dout[:, None]
    both_ms = time_ms(torch, lambda: torch.autograd.grad(
        attn.attention(*leaves), leaves, dout), iters=20)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa_both_ms = time_ms(torch, lambda: torch.autograd.grad(
        sdpa(*wide), leaves, dout4), iters=20)
    ms_again = time_ms(torch, lambda: attn._launch_flash_attention_backward(
        q, k, v, out, lse, dout), iters=20)
    bound_ms, bound_by = bound(10.0 * b * n * n * c,
                               (8.0 * b * n * c + b * n) * 4)
    say(f"[kernel-bwd] B,N,C={b},{n},{c}: fp32 kernel-plain {err:.3g}, "
        f"kernel-autograd {err_auto:.3g} | bf16 vs fp64 kernel {err16:.3g} "
        f"plain {err16_plain:.3g} | x30 vs fp64 kernel {err30:.3g} plain "
        f"{err30_plain:.3g} | bitwise repeatable")
    say(f"[kernel-bwd]   fp32 ms: kernel {ms:.4f} (again {ms_again:.4f}) "
        f"plain {plain_ms:.4f} bound {bound_ms:.4f} ({bound_by}); share of "
        f"bound {bound_ms / ms:.3f} | forward+backward: kernels "
        f"{both_ms:.4f} sdpa {sdpa_both_ms:.4f}")
    if record is None:
      record = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
                "bound_ms": bound_ms, "bound_by": bound_by}
      say(f"[kernel-bwd]   sdpa backend (forward+backward): "
          + sdpa_backend(torch, lambda: torch.autograd.grad(
              sdpa(*wide), leaves, dout4)))
  record["max_abs_err"] = worst
  return record


def phase_fused_act(torch, act) -> tuple:
  """Fused bias + leaky ReLU kernels vs their plain versions, forward and
  backward (grad_x): fp32 within 1e-6; bf16 no further from the fp64
  result than the plain bf16 path (x1.5 + 1e-6). Returns the forward's and
  the backward's records at the first shape."""
  gen = torch.Generator(device="cuda").manual_seed(3)
  records = [None, None]
  worst = [0.0, 0.0]
  for shape in ACT_SHAPES:
    x, g = (torch.randn(shape, device="cuda", generator=gen)
            for _ in range(2))
    bias = torch.randn(shape[1], device="cuda", generator=gen)
    pairs = [(lambda x, b, g: act._launch_forward(x, b, 0.2, math.sqrt(2)),
              lambda x, b, g: act.fused_leaky_relu(x, b)),
             (lambda x, b, g: act._launch_backward(x, b, g, 0.2,
                                                   math.sqrt(2)),
              act.fused_leaky_relu_backward)]
    for i, (kernel, plain) in enumerate(pairs):
      err = _max_err(kernel(x, bias, g), plain(x, bias, g))
      check(err <= ACT_TOL, f"fused act {('forward', 'backward')[i]} fp32 at "
            f"{shape}: {err:.3g} > {ACT_TOL}")
      worst[i] = max(worst[i], err)
      args16 = [t.bfloat16() for t in (x, bias, g)]
      exact = plain(*(t.double() for t in args16))
      err16 = _max_err(kernel(*args16), exact)
      err16_plain = _max_err(plain(*args16), exact)
      check(err16 <= 1.5 * err16_plain + 1e-6,
            f"fused act {('forward', 'backward')[i]} bf16 at {shape}: kernel "
            f"{err16:.3g} vs plain {err16_plain:.3g}")
      ms = time_ms(torch, lambda: kernel(x, bias, g))
      plain_ms = time_ms(torch, lambda: plain(x, bias, g))
      # Reads x (and g in the backward) and the bias, writes one tensor; a
      # few operations per element, far under the bytes' time.
      bound_ms, bound_by = bound(4.0 * x.numel(),
                                 ((2 + i) * x.numel() + bias.numel()) * 4)
      say(f"[fused-act] {('forward', 'backward')[i]} {shape}: fp32 "
          f"kernel-plain {err:.3g} | bf16 vs fp64 kernel {err16:.3g} plain "
          f"{err16_plain:.3g} | fp32 ms kernel {ms:.4f} plain "
          f"{plain_ms:.4f} bound {bound_ms:.4f} ({bound_by}); share of "
          f"bound {bound_ms / ms:.3f}")
      if records[i] is None:
        # No single PyTorch call computes leaky_relu(x + b, 0.2) * sqrt(2).
        records[i] = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
                      "bound_ms": bound_ms, "bound_by": bound_by}
  for record, err in zip(records, worst):
    record["max_abs_err"] = err
  return tuple(records)


def phase_grad(torch, attn, config, model) -> None:
  """Loss and parameter gradients of the full-width model with injected t
  and z (dropout off): through the kernels vs through the plain attention,
  and the loss on the card vs on the CPU."""
  from score_sde_pytorch_tpu_torch import losses, sde as sde_lib
  core = losses.get_sde_loss_core(
      sde_lib.build_sde(config), train=False,
      reduce_mean=config.training.reduce_mean,
      likelihood_weighting=config.training.likelihood_weighting)
  gen = torch.Generator(device="cuda").manual_seed(4)
  size = config.data.image_size
  batch = torch.rand(GRAD_BATCH, 3, size, size, device="cuda", generator=gen)
  t, z = losses.draw_t_z(batch, gen, 1e-5, 1.0)
  params = [p for p in model.parameters() if p.requires_grad]

  def loss_and_grads():
    model.zero_grad(set_to_none=True)
    loss = core(model, batch, t, z)
    loss.backward()
    return loss.item(), [p.grad.clone() for p in params]

  attn.flash_attention_backward_launches = 0
  loss, grads = loss_and_grads()
  torch.cuda.synchronize()
  launches = attn.flash_attention_backward_launches
  with mock.patch.object(attn, "attention", attn.dense_attention):
    loss_plain, grads_plain = loss_and_grads()
  model.zero_grad(set_to_none=True)
  with torch.no_grad():
    loss_cpu = core(model.to("cpu"), batch.cpu(), t.cpu(), z.cpu()).item()
  model.to("cuda")
  scale = max(g.abs().max().item() for g in grads_plain)
  rel = max((g - w).abs().max().item() for g, w in zip(grads, grads_plain))
  rel /= scale
  rel_cpu = abs(loss - loss_cpu) / abs(loss_cpu)
  say(f"[grad] full-width NCSN++ B={GRAD_BATCH}: loss {loss:.6g} (plain "
      f"attention {loss_plain:.6g}, CPU {loss_cpu:.6g}); max|dg|/max|g| "
      f"kernel vs plain {rel:.3g} over {len(params)} tensors; loss card vs "
      f"CPU rel {rel_cpu:.3g}; {launches} backward calls")
  check(launches == ATTN_PER_FORWARD,
        f"{launches} backward calls in one step, want {ATTN_PER_FORWARD}")
  check(math.isfinite(loss) and rel <= GRAD_RTOL,
        f"gradients kernel vs plain: {rel:.3g} > {GRAD_RTOL}")
  check(rel_cpu <= LOSS_RTOL, f"loss card vs CPU rel {rel_cpu:.3g}")


def _ckpt_checks(torch, path, step, initial, ema_rate) -> None:
  ckpt = torch.load(path, map_location="cpu", weights_only=True)
  check({"model", "ema", "optimizer", "step"} <= set(ckpt)
        and ckpt["step"] == step, f"{path}: keys {sorted(ckpt)}")
  ema = ckpt["ema"]
  check(ema["num_updates"] == step and ema["decay"] == ema_rate,
        f"{path}: EMA num_updates {ema['num_updates']}, want {step}")
  check(len(ckpt["optimizer"]["state"]) == len(ema["shadow_params"]),
        f"{path}: {len(ckpt['optimizer']['state'])} Adam states for "
        f"{len(ema['shadow_params'])} trainable params")
  weights = [v for k, v in ckpt["model"].items()
             if not k.endswith(("sigmas", "all_modules.0.W"))]
  check(len(weights) == len(ema["shadow_params"]) == len(initial),
        f"{path}: parameter lists of different lengths")
  check(any(not torch.equal(w, e) for w, e in zip(weights,
                                                  ema["shadow_params"])),
        f"{path}: the EMA equals the weights")
  check(any(not torch.equal(w0, e) for w0, e in zip(initial,
                                                    ema["shadow_params"])),
        f"{path}: the EMA equals the initial weights")
  check(all(bool(torch.isfinite(w).all()) for w in weights),
        f"{path}: non-finite weights")


def _kernel_category(name: str) -> str:
  if "flash_attention_fwd" in name:
    return "attention forward"
  if "flash_attention_bwd" in name or "attention_bwd_delta" in name:
    return "attention backward"
  if re.search(r"conv|cudnn|fprop|dgrad|wgrad|implicit", name, re.I):
    return "convolutions (cuDNN)"
  if re.search(r"gemm|cutlass|sgemm", name, re.I):
    return "matmuls (dense, NIN)"
  if re.search(r"multi_tensor|foreach", name, re.I):
    return "optimizer and EMA (foreach)"
  return "GroupNorm, elementwise, reductions, copies"


def _device_us_by_kernel(prof) -> dict:
  """Device time (us) by kernel name: device-side events, less the ranges
  the optimizer annotates on the device's timeline (they span kernels that
  are counted already)."""
  by_kernel = {}
  for evt in prof.key_averages():
    if (str(getattr(evt, "device_type", "")).endswith("CUDA")
        and not getattr(evt, "is_user_annotation", False)
        and not evt.key.startswith(("Optimizer.", "ProfilerStep"))):
      us = getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0))
      by_kernel[evt.key] = by_kernel.get(evt.key, 0) + us
  return by_kernel


def _report_families(tag: str, by_kernel: dict, count: int,
                     unit: str) -> None:
  busy_us = sum(by_kernel.values())
  families = {}
  for name, us in by_kernel.items():
    cat = _kernel_category(name)
    families[cat] = families.get(cat, 0) + us
  for cat, us in sorted(families.items(), key=lambda kv: -kv[1]):
    say(f"{tag}   {cat}: {us / 1e3 / count:.3f} ms/{unit} "
        f"({us / busy_us:.1%} of device time)")
  for name, us in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]:
    say(f"{tag}     {us / 1e3 / count:8.3f} ms/{unit}  {name[:110]}")


def phase_sample_profile(torch, model, card_line: str) -> None:
  """The PC sampler at batch 64 over PROFILE_SCALES steps (2 NFE each), as
  ``run_lib.sample`` builds it with no device given (the model's device):
  ms per NFE unprofiled, then a profiled run for the device's busy time,
  the attention kernel's share of it and the idle share."""
  from torch.profiler import ProfilerActivity, profile
  from score_sde_pytorch_tpu_torch import configs, datasets, sampling
  from score_sde_pytorch_tpu_torch import sde as sde_lib
  config = configs.load_config(FLAGSHIP, [f"model.num_scales={PROFILE_SCALES}"])
  size = config.data.image_size
  sampler = sampling.get_sampling_fn(
      config, sde_lib.build_sde(config), model,
      (PROFILE_BATCH, size, size, config.data.num_channels),
      datasets.get_data_inverse_scaler(config))
  gen = torch.Generator(device="cuda").manual_seed(6)
  samples, nfe = sampler(gen)  # warm-up
  check(samples.device.type == "cuda", "the sampler ran off the card")
  torch.cuda.synchronize()
  start = time.perf_counter()
  sampler(gen)
  torch.cuda.synchronize()
  ms_nfe = (time.perf_counter() - start) * 1e3 / nfe
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    start = time.perf_counter()
    sampler(gen)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - start) * 1e3
  by_kernel = _device_us_by_kernel(prof)
  busy_ms = sum(by_kernel.values()) / 1e3
  attn_ms = sum(us for name, us in by_kernel.items()
                if _kernel_category(name) == "attention forward") / 1e3
  say(f"[sample-profile] batch {PROFILE_BATCH}, {nfe} NFE: {ms_nfe:.3f} "
      f"ms/NFE = {PROFILE_BATCH * 1e3 / (ms_nfe * nfe):.2f} samples/s at "
      f"this NFE ({card_line})")
  if busy_ms <= 0:
    say("[sample-profile] profiler: no device time recorded; shares not "
        "measured")
    return
  say(f"[sample-profile] device busy {busy_ms / nfe:.3f} ms/NFE: idle share "
      f"{1 - busy_ms / (ms_nfe * nfe):.3f} of the unprofiled wall, "
      f"{1 - busy_ms / wall_ms:.3f} of the profiled; attention kernel "
      f"{attn_ms / nfe:.4f} ms/NFE = {attn_ms / busy_ms:.1%} of device time")
  _report_families("[sample-profile]", by_kernel, nfe, "NFE")


def phase_train_time(torch, config, card_line: str) -> None:
  """The train step at batch 128 as the loop runs it (one n-step call of
  ``training.n_jitted_steps`` steps at a time): wall ms per step over
  TIMED_STEPS steps, images/s, peak device memory, and a profiled window
  of PROFILED_STEPS steps for the device's busy time by kernel family."""
  from score_sde_pytorch_tpu_torch import losses, sde as sde_lib
  from score_sde_pytorch_tpu_torch.models import utils as mutils
  device = torch.device("cuda")
  model = mutils.create_model(config, device,
                              torch.Generator().manual_seed(config.seed))
  state = losses.init_train_state(config, model, device)
  tcfg = config.training
  step_fn = losses.get_step_fn(
      sde_lib.build_sde(config), train=True,
      optimize_fn=losses.optimization_manager(config),
      reduce_mean=tcfg.reduce_mean, continuous=tcfg.continuous,
      likelihood_weighting=tcfg.likelihood_weighting)
  gen = torch.Generator(device=device).manual_seed(5)
  size = config.data.image_size
  batch = torch.rand(TRAIN_BATCH, 3, size, size, device=device, generator=gen)

  def steps(n):
    for _ in range(n):
      step_fn(state, batch, state["generator"])
    torch.cuda.synchronize()

  torch.cuda.empty_cache()
  torch.cuda.reset_peak_memory_stats()
  steps(3)  # warm-up: cuDNN's first-call set-up, Adam's state
  start = time.perf_counter()
  steps(TIMED_STEPS)
  ms = (time.perf_counter() - start) * 1e3 / TIMED_STEPS
  peak = torch.cuda.max_memory_allocated() / 2 ** 30
  say(f"[train] step at batch {TRAIN_BATCH}: {ms:.2f} ms/step = "
      f"{TRAIN_BATCH * 1e3 / ms:.1f} images/s over {TIMED_STEPS} steps; peak "
      f"max_memory_allocated {peak:.2f} GiB ({card_line})")

  from torch.profiler import ProfilerActivity, profile
  activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
  with profile(activities=activities) as prof:
    start = time.perf_counter()
    steps(PROFILED_STEPS)
    wall_us = (time.perf_counter() - start) * 1e6
  by_kernel = _device_us_by_kernel(prof)
  busy_us = sum(by_kernel.values())
  if busy_us <= 0:
    say("[train] profiler: no device time recorded; idle share not measured")
    return
  busy_ms = busy_us / 1e3 / PROFILED_STEPS
  say(f"[train] device busy {busy_ms:.2f} ms/step (profiled, "
      f"{PROFILED_STEPS} steps): idle share {1 - busy_ms / ms:.3f} of the "
      f"unprofiled {ms:.2f} ms/step, {1 - busy_us / wall_us:.3f} of the "
      f"profiled window's wall {wall_us / 1e3 / PROFILED_STEPS:.2f} ms/step "
      f"({card_line})")
  _report_families("[train]", by_kernel, PROFILED_STEPS, "step")


def phase_train(torch, attn, card_line: str) -> tuple:
  """``main --mode train`` in process at full width: 10 steps with a
  snapshot sample grid, then a resume to step 20. Returns the forward and
  backward kernel launch counts of the two runs."""
  import numpy as np
  from score_sde_pytorch_tpu_torch import checkpoint, configs, main
  from score_sde_pytorch_tpu_torch.models import utils as mutils
  config = configs.load_config(
      FLAGSHIP, [f"{k}={v}" for k, v in TRAIN_FLAGS.items()])
  n_jitted = config.training.n_jitted_steps
  say(f"[train] num_scales cut from 1000 to {SMOKE_SCALES} for the smoke's "
      f"time: snapshot sampling at NFE {SMOKE_SCALES * 2} instead of 2000; "
      f"n_jitted_steps {n_jitted}")
  flags = [f"--config.{k}={v}" for k, v in TRAIN_FLAGS.items()]
  initial = [p.detach() for p in mutils.create_model(
      config, "cpu", torch.Generator().manual_seed(config.seed)).parameters()
             if p.requires_grad]
  with tempfile.TemporaryDirectory() as workdir:
    attn.flash_attention_launches = 0
    attn.flash_attention_backward_launches = 0
    runs = []
    for n_iters, sampling_on in ((10, True), (20, False)):
      start = time.perf_counter()
      runs.append(main.main(
          ["--config", FLAGSHIP, "--workdir", workdir, "--mode", "train",
           f"--config.training.n_iters={n_iters}",
           f"--config.training.snapshot_sampling={sampling_on}"] + flags))
      say(f"[train] run to step {n_iters} from step "
          f"{runs[-1]['initial_step']}: {time.perf_counter() - start:.1f} s "
          f"wall (checkpoints, eval and sampling included)")
    launches = (attn.flash_attention_launches,
                attn.flash_attention_backward_launches)
    log = open(os.path.join(workdir, "stdout.txt")).read()
    check("Starting training loop at step 10" in log,
          "the resumed run did not start at step 10")
    losses_seen = [v for run in runs
                   for v in run["train_losses"] + run["eval_losses"]]
    for run in runs:
      say(f"[train] logged train losses {run['train_losses']}, eval losses "
          f"{run['eval_losses']}")
    check(len(losses_seen) == 8
          and all(math.isfinite(v) for _, v in losses_seen),
          f"logged losses {losses_seen}")
    for n in (1, 2):
      _ckpt_checks(torch, checkpoint.numbered_path(workdir, n), 10 * n,
                   initial, config.model.ema_rate)
    restored = mutils.create_model(config, "cpu",
                                   torch.Generator().manual_seed(0))
    check(checkpoint.restore_ema(checkpoint.numbered_path(workdir, 2),
                                 restored) == 20,
          "checkpoint_2.pth did not restore through restore_ema")
    grid = os.path.join(workdir, "samples", "iter_10")
    check(os.path.isfile(os.path.join(grid, "sample.png")),
          "samples/iter_10/sample.png missing")
    samples = np.load(os.path.join(grid, "sample.np"))
    size = config.data.image_size
    check(samples.shape == (TRAIN_BATCH, size, size, 3)
          and np.isfinite(samples).all(),
          f"snapshot samples {samples.shape}")
  evals = 4                    # steps 5, 10, 15 and 20
  steps = 20
  nfe = SMOKE_SCALES * (config.sampling.n_steps_each + 1)
  want = (ATTN_PER_FORWARD * (steps + n_jitted * evals + nfe),
          ATTN_PER_FORWARD * steps)
  say(f"[train] kernel launches: forward {launches[0]} = {ATTN_PER_FORWARD} x "
      f"({steps} train steps + {n_jitted} x {evals} eval calls + {nfe} "
      f"sampling NFE), backward calls {launches[1]} = {ATTN_PER_FORWARD} x "
      f"{steps} train steps")
  check(launches == want, f"train launches {launches}, want {want}")
  phase_train_time(torch, config, card_line)
  return launches


def main() -> int:
  import torch
  if not torch.cuda.is_available():
    raise SystemExit("chip_smoke.py needs a CUDA device: "
                     "torch.cuda.is_available() is False")
  from score_sde_pytorch_tpu_torch import configs
  from score_sde_pytorch_tpu_torch.models import layers
  from score_sde_pytorch_tpu_torch.models import utils as mutils
  from score_sde_pytorch_tpu_torch.ops import attention as attn
  from score_sde_pytorch_tpu_torch.ops import fused_act as act

  card_line = card()
  say(f"[card] {card_line}; torch {torch.__version__}, CUDA "
      f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
  phase_build(attn, act)

  defaults = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  record = phase_kernel(torch, attn)
  record_bwd = phase_kernel_bwd(torch, attn)
  record_act, record_act_bwd = phase_fused_act(torch, act)

  config = configs.load_config(
      FLAGSHIP, [f"model.num_scales={SMOKE_SCALES}",
                 f"eval.batch_size={SMOKE_BATCH}"])
  model = mutils.create_model(config, "cuda",
                              torch.Generator().manual_seed(config.seed))
  unit_gain_(torch, model, layers, seed=config.seed)
  phase_forward(torch, attn, config, model)
  phase_grad(torch, attn, config, model)

  # Sampling and training run as a user runs them: PyTorch's default TF32
  # settings.
  (torch.backends.cuda.matmul.allow_tf32,
   torch.backends.cudnn.allow_tf32) = defaults
  launches = phase_sample(torch, attn, config, model, card_line)
  attn.flash_attention_launches = 0
  phase_sample_profile(torch, model, card_line)
  profile_launches = attn.flash_attention_launches
  check(profile_launches == ATTN_PER_FORWARD * PROFILE_SCALES * 2 * 3,
        f"{profile_launches} kernel launches in 3 sampler runs of "
        f"{PROFILE_SCALES * 2} NFE")
  del model
  act.fused_leaky_relu_launches = act.fused_leaky_relu_backward_launches = 0
  train_fwd, train_bwd = phase_train(torch, attn, card_line)
  act_launches = (act.fused_leaky_relu_launches,
                  act.fused_leaky_relu_backward_launches)
  # The card's machine has jax installed, so an import of it would not fail;
  # nor would one of the JAX package, which sits beside the port.
  leaked = sorted(m for m in sys.modules if m.split(".")[0] in (
      "jax", "jaxlib", "flax", "score_sde_pytorch_tpu"))
  check(not leaked, f"the port imported JAX or the JAX package: "
        f"{leaked[:5]}")

  kernels = [
      ("flash_attention_forward", KERNEL_SOURCE, TPU_KERNEL,
       launches + train_fwd, record),
      ("flash_attention_backward", KERNEL_SOURCE, TPU_BWD, train_bwd,
       record_bwd),
      # On no model's path: the sample and train runs launch it 0 times.
      ("fused_leaky_relu_forward", ACT_SOURCE, TPU_ACT, act_launches[0],
       record_act),
      ("fused_leaky_relu_backward", ACT_SOURCE, TPU_ACT, act_launches[1],
       record_act_bwd),
  ]
  say(json.dumps({"kernels": [{
      "name": name, "route": "cuda", "source": source, "replaces": replaces,
      "launches": n, "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
      "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
      "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]}
      for name, source, replaces, n, rec in kernels]}))
  say(card_line)
  say(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
