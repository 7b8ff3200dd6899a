#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (score_sde_pytorch_tpu_torch) on one
NVIDIA GPU. Run it from the root of a checkout:

    python3 chip_smoke.py

It needs a CUDA device and the CUDA toolkit (nvcc), and imports nothing of
JAX. Phases, each of which fails the run if it fails:

1. the card's name and power limit; the flash-attention kernel built from
   score_sde_pytorch_tpu_torch/ops/csrc/flash_attention.cu, with its build
   time and ptxas report;
2. the kernel against the plain PyTorch attention on the card, at the main
   path's shapes and a few more: fp32 (TF32 off), bf16, logits x30, and the
   time of each;
3. the full-width flagship NCSN++ (configs/ve/cifar10_ncsnpp_continuous.py)
   forward on the card through the kernel against through the plain
   attention, and against the same model on the CPU;
4. the user's entry point end to end: a reference-schema checkpoint of that
   model in a temporary workdir, then ``main --mode sample`` in process at
   full width (num_scales cut to 100), the samples checked, and the count
   of kernel launches held to 6 attention calls x NFE x rounds.

The last three lines of standard output are the kernels' JSON record, the
card's ``nvidia-smi`` name and power limit, and ``{"ok": true, ...}``.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
from unittest import mock

ROOT = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = os.path.join(ROOT, "score_sde_pytorch_tpu", "configs", "ve",
                        "cifar10_ncsnpp_continuous.py")
KERNEL_SOURCE = "score_sde_pytorch_tpu_torch/ops/csrc/flash_attention.cu"
TPU_KERNEL = "score_sde_pytorch_tpu/ops/attention.py:77"
SMOKE_SCALES = 100           # cut from 1000 for the smoke's time
SMOKE_BATCH = 16
SMOKE_ROUNDS = 2
ATTN_PER_FORWARD = 6         # 5 blocks at 16x16 and the 4x4 bottleneck
ATTN_SHAPES = [(64, 256, 256), (64, 16, 256), (2, 1024, 256), (4, 200, 256),
               (1, 4096, 256)]
FP32_TOL = 2e-5
FORWARD_RTOL = 1e-4


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


def phase_build(attn) -> None:
  lib = attn.kernel_library()
  say(f"[build] {lib.path.name}: nvcc {lib.build_seconds:.2f} s")
  for line in lib.compiler_log.splitlines():
    if "registers" in line or "spill" in line:
      say("[build]  ", line.strip())


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
    carry fp32 rounding of ~1e-5 that the peaked softmax amplifies."""
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

    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    err_bf16 = (attn.attention(qb, kb, vb).double() - exact).abs().max().item()
    err_bf16_plain = (attn.dense_attention(qb, kb, vb).double()
                      - exact).abs().max().item()
    check(err_bf16 <= err_bf16_plain * 1.5 + 1e-3,
          f"bf16 at {(b, n, c)}: kernel {err_bf16:.3g} vs plain "
          f"{err_bf16_plain:.3g}")

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

    ms = time_ms(torch, lambda: attn.attention(q, k, v))
    plain_ms = time_ms(torch, lambda: attn.dense_attention(q, k, v))
    say(f"[kernel] B,N,C={b},{n},{c}: fp32 kernel-plain {err:.3g}, vs fp64 "
        f"kernel {err_exact:.3g} plain {err_plain_exact:.3g} | bf16 vs fp64 "
        f"kernel {err_bf16:.3g} plain {err_bf16_plain:.3g} | x30 kernel-plain "
        f"{err30:.3g}, vs fp64 kernel {err30_exact:.3g} plain "
        f"{err30_plain_exact:.3g} | fp32 ms kernel {ms:.4f} plain "
        f"{plain_ms:.4f}")
    if record is None:
      record = {"ms": ms, "plain_ms": plain_ms}
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


def main() -> int:
  import torch
  if not torch.cuda.is_available():
    raise SystemExit("chip_smoke.py needs a CUDA device: "
                     "torch.cuda.is_available() is False")
  from score_sde_pytorch_tpu_torch import configs
  from score_sde_pytorch_tpu_torch.models import layers
  from score_sde_pytorch_tpu_torch.models import utils as mutils
  from score_sde_pytorch_tpu_torch.ops import attention as attn

  card_line = card()
  say(f"[card] {card_line}; torch {torch.__version__}, CUDA "
      f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
  phase_build(attn)

  defaults = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  record = phase_kernel(torch, attn)

  config = configs.load_config(
      FLAGSHIP, [f"model.num_scales={SMOKE_SCALES}",
                 f"eval.batch_size={SMOKE_BATCH}"])
  model = mutils.create_model(config, "cuda",
                              torch.Generator().manual_seed(config.seed))
  unit_gain_(torch, model, layers, seed=config.seed)
  phase_forward(torch, attn, config, model)

  # Sampling runs as a user runs it: PyTorch's default TF32 settings.
  (torch.backends.cuda.matmul.allow_tf32,
   torch.backends.cudnn.allow_tf32) = defaults
  launches = phase_sample(torch, attn, config, model, card_line)
  # The card's machine has jax installed, so an import of it would not fail.
  leaked = sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "flax"))
  check(not leaked, f"the port imported JAX: {leaked[:5]}")

  say(json.dumps({"kernels": [{
      "name": "flash_attention_forward", "route": "cuda",
      "source": KERNEL_SOURCE, "replaces": TPU_KERNEL, "launches": launches,
      "max_abs_err": record["max_abs_err"], "ms": record["ms"],
      "plain_ms": record["plain_ms"]}]}))
  say(card_line)
  say(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
