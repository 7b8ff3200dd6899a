#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (score_sde_pytorch_tpu_torch) on one
NVIDIA GPU. Run it from the root of a checkout:

    python3 chip_smoke.py

It needs a CUDA device, the CUDA toolkit (nvcc) and g++, and imports
nothing of JAX, of the JAX package or of TensorFlow. Phases, each of which
fails the run if it fails (about 17 to 19 minutes on one H100):

1. the card's name and power limit; the kernels built from
   score_sde_pytorch_tpu_torch/ops/csrc/ (flash_attention.cu, fused_act.cu;
   one nvcc each) and the host library from
   score_sde_pytorch_tpu_torch/native/ (g++), all started together, with
   build times and ptxas reports;
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
   then [kernel-512] and [kernel-bwd-512], both again at C = 512 (the
   256² DDPM's and the 1024² NCSN++'s attention) and C = 384;
4. [fused-act] the fused bias + leaky ReLU kernels (forward, backward)
   against their plain versions, fp32 and bf16, and times;
5. [forward] the full-width flagship NCSN++
   (score_sde_pytorch_tpu_torch/configs/ve/cifar10_ncsnpp_continuous.py)
   forward on the card through the kernel against through the plain
   attention, and against the CPU;
6. [grad] one loss of that model (injected t and z) and its parameter
   gradients through the kernels against through the plain attention, and
   the loss against the CPU's;
6a. [learn] (PyTorch's default TF32 settings from here on): the
   gaussian learning proof of score_sde_pytorch_tpu_torch/tools/
   learning_proof.py cut to 500 of its 3000 steps: the flagship at full
   width and batch 128 trained on N(0.5, 0.2²) pixels by the tool's own
   functions, the last 10 losses' mean under half the first step's, the
   EMA score's rel-L2 against the closed form at t = 0.5 and 0.9 under
   1.5 x the full run's at step 500, and 6 forward and 6 backward
   attention calls per train step;
7. [sample] the user's entry point: a reference-schema checkpoint of that
   model in a temporary workdir, then ``main --mode sample`` in process at
   full width (num_scales cut to 50), the samples checked, and the count
   of kernel launches held to 6 attention calls x NFE x rounds; then
   [sample-profile], the sampler at batch 64: ms per NFE, device idle share
   and the attention kernel's share of device time;
8. [train] ``main --mode train`` in process at full width and batch 128
   (10 steps with snapshot sampling, then a resume to step 20), its
   checkpoints, samples and launch counts checked; then the train step's
   time, images/s, peak memory and device idle share at batch 128;
9. [eval] ``main --mode eval`` in process at full width on the checkpoint
   that [train] wrote, with the eval loss, bits/dim (probability-flow ODE,
   Hutchinson divergence by vjp through both attention kernels) and
   sampling (the ODE sampler) -> InceptionV3 -> FID/IS/KID, on a small
   ``.npz`` test split, seeded random Inception weights and dataset
   statistics made from that split: its files, finite scores, and the
   kernel launches (6 forward and 6 backward attention calls per drift
   evaluation of the bits/dim stage) checked; then, with TF32 off, the
   divergence through the kernels against through the plain attention and
   the card's Inception features against the CPU's; the time of one
   augmented drift evaluation (forward + vjp) against the plain forward,
   the attention kernels' share of its device time, the peak memory of a
   chunked evaluation at batch 1024, and the bits/dim with TF32 on vs off;
   then [stats]: tools/compute_dataset_stats.py on that split with those
   weights, its mu and sigma within 1e-5 of run_inception's on the card;
   [debug]: debug.py on [train]'s checkpoint (PYTHONBREAKPOINT=0), the step
   and finite score statistics;
9a. [uri]: ``myfs://`` registered onto a temporary directory, then the
   flagship's ``main --mode train`` at full width and batch 32 on a
   ``myfs://`` workdir (2 steps with snapshot sampling and
   ``training.trace_steps=2``, a traced resume to 4), ``--mode eval`` (the
   loss) and ``--mode sample``: every artifact under the mirror root, none
   under a local ``myfs:``, both traces naming the attention forward and
   backward kernels, and an unregistered ``gs://`` workdir raising before
   any step; [demo]: ``score_sde_pytorch_tpu_torch.demo`` at the flagship's
   full width with random weights (num_scales 50): PC, ODE, DPM-Solver++,
   bits/dim, inpainting and colorization, its five PNGs and finite
   bits/dim;
9b. data parallelism over torch.distributed, each rank a process of this
   script (``--ddp-worker``) that reports its counts, started by torchrun
   for [ddp-nccl] and with torchrun's environment for the two-rank phases:
   [ddp-2rank] two gloo ranks sharing cuda:0, started from an
   empty kernel build directory (both ranks build at once), TF32 off: (a)
   2 flagship train steps at global batch 128 held to one process's on the
   same batches (weights within 1e-5, losses within 1e-5 relative) with
   the ranks' weights bit-equal, the step's time and the gloo all-reduce
   of the gradients; (b) PC sampling at global batch 16 and (c) one RK45
   bits/dim batch of 16, each held to one process's (samples within 1e-4
   of their largest magnitude, bits/dim within 1e-4, the same NFE); (d)
   the church NCSN++ with remat, 2 steps at global batch 8, finite and
   bit-equal across the ranks; [ddp-nccl] ``main --mode train`` under
   torchrun on NCCL at world size 1, the flagship at batch 128, 4 steps
   and a resume to 6, its logged ms/step beside the same run's without a
   group in the smoke's process and [train]'s; [ddp-cli] two
   gloo ranks on the card run the flagship's ``main --mode train`` (rank
   0's sample grid), a resume, ``--mode eval`` (loss, bits/dim, PC
   sampling; the samples gathered to the whole global batch) and ``--mode
   sample``. Every rank's attention launches are held to 6 per evaluation
   (4 on the church) and the backward calls to as many per train step and
   drift evaluation;
10. [vp-forward], [vp-grad] (TF32 off, beside 5 and 6): the full-width
   DDPM++ of score_sde_pytorch_tpu_torch/configs/vp/
   cifar10_ddpmpp_continuous.py through the kernels against through the
   plain attention and the CPU, and a VP and a subVP loss's gradients;
11. [vp-train], [vp-sample], [vp-eval]: ``main --mode train`` on that
   config at batch 128 (10 steps, Euler-Maruyama snapshot grid, step time
   and profile), ``--mode sample`` and ``--mode eval`` (loss, bits/dim over
   the one batch of the train split) on its checkpoint;
12. [ddpm]: the full-width DDPM of vp/ddpm/cifar10.py through the kernel
   against the plain attention (TF32 off), then ``main --mode sample`` with
   ancestral sampling from its seeded checkpoint;
13. [samplers]: PC reverse diffusion + Langevin, PC none + ALD, heun and
   DPM-Solver++ (deterministic and stochastic) on the DDPM++ at batch 64;
14. [vp-profile]: Euler-Maruyama at batch 64: ms per network evaluation,
   the idle share and the attention kernel's share of device time;
15. [ddpm-256*]: the full-width vp/ddpm/church.py (attention at C = 512):
   forward and DDPM-loss gradient through the kernels against the plain
   attention (TF32 off), ``main --mode train`` at batch 8 for 5 steps and
   ``--mode sample`` (ancestral, num_scales 25) on its checkpoint;
16. [hires-*], [controllable]: the full-width
   ve/church_ncsnpp_continuous.py (output and input pyramids, remat):
   ``main --mode sample``; at unit gain, inpainting and colorization at
   batch 4 (known half and gray channel kept within 1e-3), and the forward
   and gradient through the kernels against the plain attention (TF32
   off); the multiattn file's forward (attention at 32² too); ``main
   --mode train`` at its batch of 64 for 2 steps and a resume to 4; and
   the train step's peak memory with remat at batch 64 and without it at
   the largest batch that fits;
17. [hires-1024]: the full-width ve/celebahq_ncsnpp_continuous.py (1024²,
   attention at C = 512): forward through the kernels against the plain
   attention, and the train step with remat at its batch of 8 with its
   peak memory, driven directly;
18. [kernel-bf16] (with the kernel phases, TF32 off): the attention
   kernels in bf16 at the bf16 files' shapes, forward and backward, held
   to the plain bf16 version and fp64 and timed against SDPA and the
   bound at bf16's peak;
19. [ncsn*], [ncsnv2*]: NCSN v1 (ve/ncsn/cifar10.py) and NCSNv2
   (ve/ncsnv2/cifar10.py, bedroom.py, an ncsnv2_256 override) at full
   width: forwards against the CPU, ``main --mode train`` and ALD
   ``main --mode sample`` (NCSN v1 at 10 scales x 20 steps, cut from 100),
   one sampler step's peak memory at batch 1024 (30 Langevin steps),
   the 128² train step;
20. [bf16-church*], [bf16-1024]: the two bf16 files: ``main --mode
   train`` and a resume, ``--mode sample``, the train step's time and
   memory in bf16 and fp32, the bf16 forward's distance from fp32; the
   1024² remat train step; [h100-leaves]: the two configs/h100/ leaves'
   train steps at their batches (ms/step, images/s, peak memory against
   the card's total) and one profiled step each (idle share, families);
21. [data-*]: the data sources, on files written from a seed under a
   temporary directory: [data-church] ve/church_ncsnpp_continuous.py (LSUN
   256²) on a folder of 320x256 JPEGs, ``main --mode train`` at its batch
   of 64 and a resume that skips its streams across an epoch boundary, the
   loader's images/s alone against the step's demand and ``skip`` over
   10⁵ batches with no image decoded; [data-ffhq]
   ve/ffhq_ncsnpp_continuous.py (1024², batch 8) on TFRecords of
   3x1024x1024 in 2 shards, train and resume, the reader's MB/s with both
   CRCs and the CRC's GB/s; [data-celeba] ve/celeba_ncsnpp.py (CELEBA 64²)
   on 178x218 PNGs, train and resume at batch 128, then ``main --mode
   eval`` with the loss over the streamed test split and bits/dim over the
   streamed train split (one batch of 128);
   [data-native] the C++ loader against the python pipeline in images/s
   (SVHN from a ``.mat`` at 32², the church folder in memory at 256²).

Network evaluations are counted with a forward hook (the PC sampler's NFE
is N·(n_steps + 1) whatever the corrector; the "none" predictor evaluates
nothing), and every run above holds the attention launches per evaluation
to 6 (NCSN++/DDPM++ at 32², the CelebA NCSN++ at 64²), 4 (the DDPM at
32² and 256², the church NCSN++ in fp32 and bf16), 7 (multiattn), 3
(1024², fp32 and bf16) and 0 (NCSN, NCSNv2), and the backward calls to
as many per train step (remat recomputes the resblocks, not the
attention) and per bits/dim drift evaluation.

The last three lines of standard output are the kernels' JSON record, the
card's ``nvidia-smi`` name and power limit, and ``{"ok": true, ...}``.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from unittest import mock

_STARTED = time.perf_counter()  # a --ddp-worker rank's own start

ROOT = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = os.path.join(ROOT, "score_sde_pytorch_tpu_torch", "configs", "ve",
                        "cifar10_ncsnpp_continuous.py")
CONFIGS = os.path.join(ROOT, "score_sde_pytorch_tpu_torch", "configs")
VP_CONFIG = os.path.join(CONFIGS, "vp", "cifar10_ddpmpp_continuous.py")
DDPM_CONFIG = os.path.join(CONFIGS, "vp", "ddpm", "cifar10.py")
KERNEL_SOURCE = "score_sde_pytorch_tpu_torch/ops/csrc/flash_attention.cu"
TPU_KERNEL = "score_sde_pytorch_tpu/ops/attention.py:77"
ACT_SOURCE = "score_sde_pytorch_tpu_torch/ops/csrc/fused_act.cu"
TPU_BWD = "score_sde_pytorch_tpu/ops/attention.py:129"   # _flash_bwd_impl
TPU_ACT = "score_sde_pytorch_tpu/ops/fused_act.py:33"
SMOKE_SCALES = 25            # cut from 1000 for the smoke's time
SMOKE_BATCH = 16
SMOKE_ROUNDS = 2
ATTN_PER_FORWARD = 6         # 5 blocks at 16x16 and the 4x4 bottleneck
DDPM_ATTN_PER_FORWARD = 4    # DDPM: 3 blocks at 16x16 and the bottleneck
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
# tensor cores' TF32 rate, the card's fastest on fp32 inputs, their bf16
# rate, and HBM.
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
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
EVAL_BATCH = 32              # eval.batch_size cut from 1024 for the time
EVAL_TRAIN_IMAGES = 64       # the .npz split sizes
DIV_BATCH = 8
DIV_RTOL = 1e-4
INCEPTION_CHECK = 4          # images through the card's and the CPU's
INCEPTION_TOL = 1e-4         # of max |pool_3|
DRIFT_BATCH = 64
DRIFT_BIG_BATCH = 1024       # the configs' eval.batch_size
VP_TRAIN_STEPS = 10
SAMPLERS_BATCH = 64
SAMPLERS_SCALES = 25         # discrete VP rules need num_scales > beta_max
FLOW_STEPS = 10              # heun and dpmpp steps
VP_PROFILE_SCALES = 20       # Euler-Maruyama: 20 network evaluations
# C = 512 (the 256² DDPM's and the 1024² NCSN++'s attention) and a C that
# is neither 256 nor 512.
ATTN_512_SHAPES = [(64, 256, 512), (8, 256, 512), (8, 64, 512),
                   (2, 256, 512), (4, 200, 512), (1, 1024, 384)]
CHURCH_CONFIG = os.path.join(CONFIGS, "ve", "church_ncsnpp_continuous.py")
MULTIATTN_CONFIG = os.path.join(CONFIGS, "tpu",
                                "church_ncsnpp_continuous_multiattn.py")
DDPM256_CONFIG = os.path.join(CONFIGS, "vp", "ddpm", "church.py")
HQ1024_CONFIG = os.path.join(CONFIGS, "ve", "celebahq_ncsnpp_continuous.py")
HIRES_ATTN_PER_FORWARD = 4   # church: 2 at 16² down, the 4² bottleneck, 1 up
MULTIATTN_PER_FORWARD = 7    # and 2 down + 1 up at 32² ([B, 1024, 256])
DDPM256_ATTN_PER_FORWARD = 4  # 3 at 16² ([B, 256, 512]) and 1 at 8²
HQ1024_ATTN_PER_FORWARD = 3  # 2 at 16² ([B, 256, 512]) and 1 at 8²
HIRES_BATCH = 4              # 256² and 1024² forwards and samplers
HIRES_GRAD_BATCH = 2
HIRES_SCALES = 10            # num_scales cut from 2000 (church) for the time
HIRES_TRAIN_STEPS = 5        # the 256² DDPM's train: one n_jitted_steps call
DDPM256_TRAIN_BATCH = 8      # a batch that fits without remat (config: 64)
DDPM256_SCALES = 25          # discrete VP rules need num_scales > beta_max
HQ1024_TRAIN_BATCH = 8       # the config's own
NO_REMAT_BATCHES = (32, 24, 16, 8, 4)
# The bf16 attention of the bf16 files: church (train batch 32) and 1024²
# (batch 8), at their 16² and bottleneck grids.
BF16_SHAPES = [(32, 256, 256), (32, 16, 256), (8, 256, 512), (8, 64, 512)]
NCSN_CONFIG = os.path.join(CONFIGS, "ve", "ncsn", "cifar10.py")
NCSNV2_CONFIG = os.path.join(CONFIGS, "ve", "ncsnv2", "cifar10.py")
BEDROOM_CONFIG = os.path.join(CONFIGS, "ve", "ncsnv2", "bedroom.py")
BF16_CHURCH_CONFIG = os.path.join(CONFIGS, "tpu", "church_256_ncsnpp_tpu.py")
BF16_1024_CONFIG = os.path.join(CONFIGS, "tpu", "celebahq_1024_ncsnpp_tpu.py")
NCSN_SAMPLE_BATCH = 64
NCSN_SAMPLE_STEPS = 20       # ALD steps per scale, cut from 100 for the time
NCSN_STEP_STEPS = 30         # [ncsn-step]'s Langevin steps, cut from 100
NCSN_TRAIN_STEPS = 5         # then a resume to 10
NCSNV2_SCALES = 20           # num_scales cut from 232 for the time
BEDROOM_BATCHES = (128, 64, 32)
V2_256_BATCH = 4
BF16_CHURCH_ATTN = 4         # 3 x [B, 256, 256] and 1 x [B, 16, 256]
BF16_1024_ATTN = 3           # 2 x [B, 256, 512] and 1 x [B, 64, 512]
CHURCH_FP32_TRAIN_BATCH = 64  # [hires-memory]'s remat step, for comparison
# The short train runs (the data phases, [hires-train], [bf16-church-train]):
# ``main --mode train`` for 2 steps of one batch each and a resume to 4, so
# the resume skips 2 train batches and 1 eval batch.
SHORT_STEPS = 2
# The data phases: files written from a seed, read through the port's
# sources.
FFHQ_CONFIG = os.path.join(CONFIGS, "ve", "ffhq_ncsnpp_continuous.py")
CELEBA_CONFIG = os.path.join(CONFIGS, "ve", "celeba_ncsnpp.py")
CHURCH_SPLITS = {"train": 96, "test": 64}  # one batch of 64 per epoch
CHURCH_JPEG_WH = (320, 256)  # LSUN's layout: the short side 256
FFHQ_RECORDS = 24            # 3 batches of 8 per epoch, in 2 shards
CELEBA_SPLITS = {"train": 128, "test": 128}
CELEBA_PNG_WH = (178, 218)   # aligned CelebA
CELEBA_ATTN_PER_FORWARD = 6  # 4 down blocks at 16², the 8² bottleneck, 1 up
CELEBA_EVAL_BATCH = 128      # each split in one batch (config 1024)
SKIP_BATCHES = 100_000
DDP_STEPS = 2                # [ddp-2rank] train steps (flagship and church)
DDP_ALLREDUCE_REPEATS = 3
DDP_SAMPLE_BATCH = 16        # [ddp-2rank] PC and bits/dim: 8 rows a rank
DDP_ODE_TOL = 1e-3           # the bits/dim integration's rtol and atol
DDP_CHURCH_BATCH = 8
DDP_PARAM_TOL = 1e-5         # 2 ranks vs one process after 2 Adam steps
DDP_SAMPLE_RTOL = 1e-4       # of the largest |sample|
DDP_BPD_TOL = 1e-4           # bits/dim, absolute
DDP_NCCL_STEPS = (4, 6)      # [ddp-nccl]: train to 4, resume to 6
DDP_CLI_SCALES = 10          # [ddp-cli] num_scales: 20 NFE a sampler run
DDP_EVAL_BATCH = 32          # [ddp-cli] eval.batch_size, 16 a rank
DDP_TIMEOUT = 600
STEP_DEMAND = (64, 2.2)      # church: 64 images per 2.2 s step (PERF.md §5)
URI_BATCH = 32               # [uri]: the flagship's train, eval and sample
URI_SCALES = 10              # [uri] snapshot and sample: 20 NFE
DEMO_SCALES = 50             # [demo]: PC, inpainting, colorization 100 NFE
STATS_TOL = 1e-5             # [stats]: mu and sigma against run_inception's
LEAF_STEPS = 2               # [h100-leaves] timed steps after one warm-up
# [learn]: the gaussian learning proof (tools/learning_proof.py) cut to
# LEARN_STEPS of its 3000 steps. Its full fp32 run on one H100 80GB HBM3 at
# 700 W took 213.16 ms/step; its loss was 0.467 of the first step's at step
# 500 and its EMA score's rel-L2 at t = 0.5 and 0.9 was 0.4468 and 0.5288
# there (1.0 untrained, 0.0184 and 0.0215 at step 3000). The bounds are
# 1.5 x those two values.
LEARN_STEPS = 500
LEARN_LOSS_SHARE = 0.5       # the last 10 losses' mean under 0.5 x the first
LEARN_REL_BOUND = {"0.5": 1.5 * 0.4468, "0.9": 1.5 * 0.5288}
H100_LEAVES = [
    (os.path.join(CONFIGS, "h100", "church_256_ncsnpp_h100.py"),
     HIRES_ATTN_PER_FORWARD),
    (os.path.join(CONFIGS, "h100", "celebahq_1024_ncsnpp_h100.py"),
     HQ1024_ATTN_PER_FORWARD)]
SVHN_IMAGES = {"train": 4096, "test": 512}
NATIVE_BATCHES = 50


def check(ok: bool, what: str) -> None:
  if not ok:
    raise RuntimeError(f"chip_smoke check failed: {what}")


def say(*parts) -> None:
  print(*parts, flush=True)


@contextlib.contextmanager
def network_evals(torch):
  """Counts score-network evaluations (forwards of an NCSN++, a DDPM or a
  RefineNet of the NCSN family) while it is open, as ``count[0]``: the
  real evaluations behind a sampler's reported NFE."""
  from score_sde_pytorch_tpu_torch.models import ddpm, ncsnpp, ncsnv2
  count = [0]

  def hook(module, args):
    if isinstance(module, (ncsnpp.NCSNpp, ddpm.DDPM, ncsnv2._RefineNet)):
      count[0] += 1

  handle = torch.nn.modules.module.register_module_forward_pre_hook(hook)
  try:
    yield count
  finally:
    handle.remove()


def card() -> str:
  return subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def _tf32_off(torch):
  """Turns TF32 off for matmuls and cuDNN; returns PyTorch's settings."""
  defaults = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  return defaults


def _tf32_restore(torch, defaults) -> None:
  (torch.backends.cuda.matmul.allow_tf32,
   torch.backends.cudnn.allow_tf32) = defaults


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


def bound(flops: float, nbytes: float, peak: float = TF32_FLOPS) -> tuple:
  """The least time the card could take, in ms, and what bounds it: the
  larger of the operations at ``peak`` (the TF32 peak unless given) and
  the bytes at HBM's rate."""
  ops_ms = flops / peak * 1e3
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


def _host_build() -> tuple:
  from score_sde_pytorch_tpu_torch.native import build
  start = time.perf_counter()
  path = build.build()
  return path, time.perf_counter() - start


def phase_build(*modules) -> None:
  """One nvcc per kernel source and the g++ of the host library (native
  loader, CRC-32C), all started together. Fails if an attention kernel
  spills registers or has no tensor-core instruction."""
  with concurrent.futures.ThreadPoolExecutor(len(modules) + 1) as pool:
    host = pool.submit(_host_build)
    libs = list(pool.map(lambda m: m.kernel_library(), modules))
    host_path, host_seconds = host.result()
  say(f"[build] {host_path.name}: g++ {host_seconds:.2f} s (dataloader.cpp, "
      "crc32c.cpp)")
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


def phase_kernel(torch, attn, shapes=ATTN_SHAPES,
                 tag: str = "[kernel]") -> dict:
  """Kernel vs plain attention on standard-normal q, k, v at ``shapes``.
  Returns the record of the first shape.

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
  for b, n, c in shapes:
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
    say(f"{tag} B,N,C={b},{n},{c}: fp32 kernel-plain {err:.3g}, vs fp64 "
        f"kernel {err_exact:.3g} plain {err_plain_exact:.3g} | bf16 vs fp64 "
        f"kernel {err_bf16:.3g} plain {err_bf16_plain:.3g} | x30 kernel-plain "
        f"{err30:.3g}, vs fp64 kernel {err30_exact:.3g} plain "
        f"{err30_plain_exact:.3g}")
    say(f"{tag}   fp32 ms: kernel {ms:.4f} (again {ms_again:.4f}) plain "
        f"{plain_ms:.4f} sdpa {library_ms:.4f} bound {bound_ms:.4f} "
        f"({bound_by}); share of bound {bound_ms / ms:.3f}")
    if record is None:
      record = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": bound_ms, "bound_by": bound_by}
      say(f"{tag}   sdpa backend: "
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


def _labels(config, t):
  """The network's labels at times ``t``, as the continuous score function
  gives them: sigma(t) for VE, t·999 for VP/subVP."""
  from score_sde_pytorch_tpu_torch import sde as sde_lib
  sde = sde_lib.build_sde(config)
  if isinstance(sde, sde_lib.VESDE):
    return sde.sigma_t(t)
  return t * 999


def phase_forward(torch, attn, config, model, tag: str = "[forward]",
                  per_forward: int = ATTN_PER_FORWARD,
                  batch: int = SMOKE_BATCH, cpu_batch: int = 2) -> None:
  """The full-width forward through the kernel against through the plain
  attention and (its first ``cpu_batch`` images) against the CPU, and its
  attention launches."""
  gen = torch.Generator(device="cuda").manual_seed(1)
  size = config.data.image_size
  x = torch.rand(batch, 3, size, size, device="cuda", generator=gen)
  t = torch.rand(batch, device="cuda", generator=gen)
  labels = _labels(config, t)
  with torch.no_grad():
    before = attn.flash_attention_launches
    through_kernel = model(x, labels)
    torch.cuda.synchronize()
    launches = attn.flash_attention_launches - before
    with mock.patch.object(attn, "attention", attn.dense_attention):
      through_plain = model(x, labels)
      on_cpu = model.to("cpu")(x[:cpu_batch].cpu(), labels[:cpu_batch].cpu())
      model.to("cuda")
  check(launches == per_forward,
        f"{tag} {launches} kernel launches in one forward, want {per_forward}")
  check(bool(torch.isfinite(through_kernel).all()), f"{tag} not finite")
  scale = through_plain.abs().max().item()
  rel = (through_kernel - through_plain).abs().max().item() / scale
  rel_cpu = ((through_kernel[:cpu_batch].cpu() - on_cpu).abs().max().item()
             / on_cpu.abs().max().item())
  say(f"{tag} full-width {config.model.name} B={batch}: max|out| "
      f"{scale:.4g}, kernel vs plain rel err {rel:.3g}, card vs CPU rel err "
      f"{rel_cpu:.3g} ({launches} kernel launches)")
  check(rel <= FORWARD_RTOL, f"{tag} kernel vs plain rel err {rel:.3g}")
  check(rel_cpu <= FORWARD_RTOL, f"{tag} card vs CPU rel err {rel_cpu:.3g}")


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


def phase_kernel_bwd(torch, attn, shapes=BWD_SHAPES,
                     tag: str = "[kernel-bwd]") -> dict:
  """Backward kernels vs the plain backward on standard-normal q, k, v, dO
  at ``shapes``. Returns the record of the first shape.

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

  for b, n, c in shapes:
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
    say(f"{tag} B,N,C={b},{n},{c}: fp32 kernel-plain {err:.3g}, "
        f"kernel-autograd {err_auto:.3g} | bf16 vs fp64 kernel {err16:.3g} "
        f"plain {err16_plain:.3g} | x30 vs fp64 kernel {err30:.3g} plain "
        f"{err30_plain:.3g} | bitwise repeatable")
    say(f"{tag}   fp32 ms: kernel {ms:.4f} (again {ms_again:.4f}) "
        f"plain {plain_ms:.4f} bound {bound_ms:.4f} ({bound_by}); share of "
        f"bound {bound_ms / ms:.3f} | forward+backward: kernels "
        f"{both_ms:.4f} sdpa {sdpa_both_ms:.4f}")
    if record is None:
      record = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
                "bound_ms": bound_ms, "bound_by": bound_by}
      say(f"{tag}   sdpa backend (forward+backward): "
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


def phase_grad(torch, attn, config, model, sde=None,
               tag: str = "[grad]", per_forward: int = ATTN_PER_FORWARD,
               batch_size: int = GRAD_BATCH) -> None:
  """Loss and parameter gradients of the full-width model with injected
  draws (dropout off), for ``sde`` (default: the config's): through the
  kernels vs through the plain attention, and the loss on the card vs on
  the CPU. The loss is the config's: the continuous SDE loss, or the DDPM
  loss at integer timesteps of a discrete VP config. Under ``model.remat``
  the resblocks are recomputed in the backward and the attention is not:
  ``per_forward`` forward launches and backward calls per gradient."""
  from score_sde_pytorch_tpu_torch import losses, sde as sde_lib
  sde = sde or sde_lib.build_sde(config)
  gen = torch.Generator(device="cuda").manual_seed(4)
  size = config.data.image_size
  batch = torch.rand(batch_size, 3, size, size, device="cuda", generator=gen)
  if config.training.continuous:
    core = losses.get_sde_loss_core(
        sde, train=False,
        reduce_mean=config.training.reduce_mean,
        likelihood_weighting=config.training.likelihood_weighting)
    draws = losses.draw_t_z(batch, gen, 1e-5, 1.0)
  else:
    core = losses.get_ddpm_loss_core(
        sde, train=False, reduce_mean=config.training.reduce_mean)
    draws = losses.draw_labels_z(batch, gen, sde.N)
  params = [p for p in model.parameters() if p.requires_grad]

  def loss_and_grads():
    model.zero_grad(set_to_none=True)
    loss = core(model, batch, *draws)
    loss.backward()
    return loss.item(), [p.grad.clone() for p in params]

  attn.flash_attention_launches = 0
  attn.flash_attention_backward_launches = 0
  loss, grads = loss_and_grads()
  torch.cuda.synchronize()
  launches = attn.flash_attention_backward_launches
  forward_launches = attn.flash_attention_launches
  with mock.patch.object(attn, "attention", attn.dense_attention):
    loss_plain, grads_plain = loss_and_grads()
  model.zero_grad(set_to_none=True)
  with torch.no_grad():
    loss_cpu = core(model.to("cpu"), batch.cpu(),
                    *(d.cpu() for d in draws)).item()
  model.to("cuda")
  scale = max(g.abs().max().item() for g in grads_plain)
  rel = max((g - w).abs().max().item() for g, w in zip(grads, grads_plain))
  rel /= scale
  rel_cpu = abs(loss - loss_cpu) / abs(loss_cpu)
  say(f"{tag} full-width {config.model.name}, {type(sde).__name__} loss, "
      f"B={batch_size}: loss {loss:.6g} (plain "
      f"attention {loss_plain:.6g}, CPU {loss_cpu:.6g}); max|dg|/max|g| "
      f"kernel vs plain {rel:.3g} over {len(params)} tensors; loss card vs "
      f"CPU rel {rel_cpu:.3g}; {forward_launches} forward launches, "
      f"{launches} backward calls (remat {config.model.get('remat', False)})")
  check((forward_launches, launches) == (per_forward, per_forward),
        f"{tag} {forward_launches} forward launches and {launches} backward "
        f"calls in one gradient, want {per_forward} each")
  check(math.isfinite(loss) and rel <= GRAD_RTOL,
        f"{tag} gradients kernel vs plain: {rel:.3g} > {GRAD_RTOL}")
  check(rel_cpu <= LOSS_RTOL, f"{tag} loss card vs CPU rel {rel_cpu:.3g}")


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
  if ema_rate > 0:
    check(any(not torch.equal(w, e) for w, e in zip(weights,
                                                    ema["shadow_params"])),
          f"{path}: the EMA equals the weights")
  else:  # the NCSN v1 files' rate 0: the weights, up to the update's rounding
    check(all(torch.allclose(w, e, rtol=1e-5, atol=1e-6) for w, e in zip(
        weights, ema["shadow_params"])), f"{path}: an EMA of rate 0 is not "
          "the weights")
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


def phase_sample_profile(torch, model, card_line: str, config_path=FLAGSHIP,
                         scales: int = PROFILE_SCALES,
                         tag: str = "[sample-profile]") -> int:
  """The config's sampler at batch 64 over ``scales`` steps, as
  ``run_lib.sample`` builds it with no device given (the model's device):
  ms per network evaluation unprofiled, then a profiled run for the
  device's busy time, the attention kernel's share of it and the idle
  share. Evaluations are counted, not read off the sampler's NFE (the PC
  sampler reports N·(n_steps + 1) whatever its corrector). Returns the
  evaluations of one run."""
  from torch.profiler import ProfilerActivity, profile
  from score_sde_pytorch_tpu_torch import configs, datasets, sampling
  from score_sde_pytorch_tpu_torch import sde as sde_lib
  config = configs.load_config(config_path, [f"model.num_scales={scales}"])
  size = config.data.image_size
  sampler = sampling.get_sampling_fn(
      config, sde_lib.build_sde(config), model,
      (PROFILE_BATCH, size, size, config.data.num_channels),
      datasets.get_data_inverse_scaler(config))
  gen = torch.Generator(device="cuda").manual_seed(6)
  with network_evals(torch) as evals:
    samples, nfe = sampler(gen)  # warm-up
  evals = evals[0]
  check(samples.device.type == "cuda", f"{tag} the sampler ran off the card")
  check(bool(torch.isfinite(samples).all()), f"{tag} samples not finite")
  torch.cuda.synchronize()
  start = time.perf_counter()
  sampler(gen)
  torch.cuda.synchronize()
  ms_eval = (time.perf_counter() - start) * 1e3 / evals
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
  say(f"{tag} {config.sampling.method} {config.sampling.predictor}/"
      f"{config.sampling.corrector} at batch {PROFILE_BATCH}, {evals} network"
      f" evaluations (reported NFE {nfe}): {ms_eval:.3f} ms/evaluation = "
      f"{PROFILE_BATCH * 1e3 / (ms_eval * evals):.2f} samples/s at this "
      f"count ({card_line})")
  if busy_ms <= 0:
    say(f"{tag} profiler: no device time recorded; shares not measured")
    return evals
  say(f"{tag} device busy {busy_ms / evals:.3f} ms/evaluation: idle share "
      f"{1 - busy_ms / (ms_eval * evals):.3f} of the unprofiled wall, "
      f"{1 - busy_ms / wall_ms:.3f} of the profiled; attention kernel "
      f"{attn_ms / evals:.4f} ms/evaluation = {attn_ms / busy_ms:.1%} of "
      f"device time")
  _report_families(tag, by_kernel, evals, "evaluation")
  return evals


def _train_step(torch, config, batch_size: int):
  """``step(n)``: n train steps of a fresh seeded model of ``config`` on one
  random batch of ``batch_size`` on the card, then a synchronize."""
  from score_sde_pytorch_tpu_torch import losses, sde as sde_lib
  from score_sde_pytorch_tpu_torch.models import utils as mutils
  model = mutils.create_model(config, "cuda",
                              torch.Generator().manual_seed(config.seed))
  state = losses.init_train_state(config, model, "cuda")
  tcfg = config.training
  step_fn = losses.get_step_fn(
      sde_lib.build_sde(config), train=True,
      optimize_fn=losses.optimization_manager(config),
      reduce_mean=tcfg.reduce_mean, continuous=tcfg.continuous,
      likelihood_weighting=tcfg.likelihood_weighting)
  size = config.data.image_size
  batch = torch.rand(batch_size, 3, size, size, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(5))

  def steps(n):
    for _ in range(n):
      loss = step_fn(state, batch, state["generator"])
    torch.cuda.synchronize()
    check(math.isfinite(loss.item()), f"train step loss {loss.item()}")

  return steps


def phase_train_time(torch, config, card_line: str,
                     tag: str = "[train]") -> float:
  """The train step at batch 128 as the loop runs it (one n-step call of
  ``training.n_jitted_steps`` steps at a time): wall ms per step over
  TIMED_STEPS steps, images/s, peak device memory, and a profiled window
  of PROFILED_STEPS steps for the device's busy time by kernel family.
  Returns the wall ms per step."""
  torch.cuda.empty_cache()
  torch.cuda.reset_peak_memory_stats()
  steps = _train_step(torch, config, TRAIN_BATCH)
  steps(3)  # warm-up: cuDNN's first-call set-up, Adam's state
  start = time.perf_counter()
  steps(TIMED_STEPS)
  ms = (time.perf_counter() - start) * 1e3 / TIMED_STEPS
  peak = torch.cuda.max_memory_allocated() / 2 ** 30
  say(f"{tag} step at batch {TRAIN_BATCH}: {ms:.2f} ms/step = "
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
    say(f"{tag} profiler: no device time recorded; idle share not "
        "measured")
    return ms
  busy_ms = busy_us / 1e3 / PROFILED_STEPS
  say(f"{tag} device busy {busy_ms:.2f} ms/step (profiled, "
      f"{PROFILED_STEPS} steps): idle share {1 - busy_ms / ms:.3f} of the "
      f"unprofiled {ms:.2f} ms/step, {1 - busy_us / wall_us:.3f} of the "
      f"profiled window's wall {wall_us / 1e3 / PROFILED_STEPS:.2f} ms/step "
      f"({card_line})")
  _report_families(tag, by_kernel, PROFILED_STEPS, "step")
  return ms


def phase_train(torch, attn, card_line: str, workdir: str) -> tuple:
  """``main --mode train`` in process at full width in ``workdir``: 10
  steps with a snapshot sample grid, then a resume to step 20. Returns the
  forward and backward kernel launch counts of the two runs and the train
  step's wall ms at batch 128."""
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
  return launches + (phase_train_time(torch, config, card_line),)


def _write_eval_data(root: str, size: int,
                     train: int = EVAL_TRAIN_IMAGES) -> str:
  """A small ``.npz`` dataset (train and test splits of uint8 NHWC images
  from a seed); returns its directory."""
  import numpy as np
  rng = np.random.default_rng(7)
  os.makedirs(root)
  for split, n in (("train", train), ("test", EVAL_BATCH)):
    np.savez(os.path.join(root, f"{split}.npz"),
             images=rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8))
  return root


def phase_eval(torch, attn, workdir: str, card_line: str) -> tuple:
  """``main --mode eval`` in process on [train]'s checkpoint_2 with all
  three stages and the ODE sampler, in a working directory that holds the
  dataset statistics (``assets/stats/``), then [stats] on its split.
  Returns the eval run's forward and backward kernel launches."""
  with tempfile.TemporaryDirectory() as base:
    launches = _run_eval(torch, attn, workdir, base, card_line)
    phase_stats(torch, base, card_line)
    return launches


def _run_eval(torch, attn, workdir: str, base: str, card_line: str) -> tuple:
  import numpy as np
  from score_sde_pytorch_tpu_torch import inception, main
  size = 32
  data_dir = _write_eval_data(os.path.join(base, "data"), size)
  weights = inception.write_random_npz(os.path.join(base, "inception.npz"),
                                       seed=0)
  # Dataset statistics made from the test split through the same (random)
  # Inception, in the key layout that gives FID and KID.
  with np.load(os.path.join(data_dir, "test.npz")) as z:
    test_images = z["images"]
  features = inception.InceptionV3Features(weights, device="cuda")
  os.makedirs(os.path.join(base, "assets", "stats"))
  np.savez(os.path.join(base, "assets", "stats", f"npz_{size}_stats.npz"),
           pool_3=features(test_images)["pool_3"])
  del features
  say(f"[eval] cuts: eval.batch_size {EVAL_BATCH} (config 1024), a .npz "
      f"test split of {EVAL_BATCH} random images (one batch, so bits/dim "
      f"integrates 5 batches: the test split repeated 5 times), "
      f"num_samples {EVAL_BATCH} (config 50000), sampling.method ode "
      f"(config pc), random Inception weights (seed 0) and statistics of "
      f"the test split through them: FID/IS/KID below are random-weights "
      f"values, not CIFAR-10 scores")
  overrides = {"eval.begin_ckpt": 2, "eval.end_ckpt": 2,
               "eval.batch_size": EVAL_BATCH, "eval.enable_loss": True,
               "eval.enable_bpd": True, "eval.enable_sampling": True,
               "eval.num_samples": EVAL_BATCH, "sampling.method": "ode",
               "data.dataset": "NPZ", "data.data_dir": data_dir,
               "model.num_scales": SMOKE_SCALES}
  cwd = os.getcwd()
  os.environ["INCEPTION_WEIGHTS_NPZ"] = weights
  os.chdir(base)
  try:
    attn.flash_attention_launches = 0
    attn.flash_attention_backward_launches = 0
    start = time.perf_counter()
    (record,) = main.main(["--config", FLAGSHIP, "--workdir", workdir,
                           "--mode", "eval", "--device", "cuda"]
                          + [f"--config.{k}={v}" for k, v in overrides.items()])
    seconds = time.perf_counter() - start
    launches = (attn.flash_attention_launches,
                attn.flash_attention_backward_launches)
  finally:
    os.chdir(cwd)
    del os.environ["INCEPTION_WEIGHTS_NPZ"]
  eval_dir = os.path.join(workdir, "eval")
  want_keys = {"ckpt_2_loss.npz": {"all_losses", "mean_loss"},
               "test_ckpt_2_bpd.npz": {"bpd"},
               "ckpt_2_samples_0.npz": {"samples"},
               "ckpt_2_statistics_0.npz": {"pool_3", "logits"},
               "report_2.npz": {"inception_score", "fid", "kid"}}
  for name, keys in want_keys.items():
    path = os.path.join(eval_dir, name)
    check(os.path.isfile(path), f"{path} missing")
    with np.load(path) as z:
      check(set(z.files) == keys, f"{name} keys {sorted(z.files)}")
      check(all(np.isfinite(z[k]).all() for k in keys if k != "samples"),
            f"{name}: non-finite values")
  with np.load(os.path.join(eval_dir, "test_ckpt_2_bpd.npz")) as z:
    check(z["bpd"].shape == (5 * EVAL_BATCH,), f"bpd shape {z['bpd'].shape}")
  check(len(record["bpd_nfe"]) == 5 and max(record["bpd_nfe"]) < 10000 * 6,
        f"bpd integrations {record['bpd_nfe']}")
  drift_evals = sum(record["bpd_nfe"])
  want = (ATTN_PER_FORWARD * (1 + drift_evals + sum(record["sampling_nfe"])),
          ATTN_PER_FORWARD * drift_evals)
  say(f"[eval] main --mode eval: {seconds:.1f} s wall; eval loss "
      f"{record['mean_loss']:.6g}; bits/dim {record['bpd']:.6f} (mean of "
      f"{5 * EVAL_BATCH}), RK45 NFE per integration {record['bpd_nfe']}, "
      f"seconds per bpd batch "
      f"{[round(x, 3) for x in record['bpd_seconds']]} ({card_line})")
  say(f"[eval] ODE sampler: NFE {record['sampling_nfe']} in "
      f"{[round(x, 3) for x in record['sampling_seconds']]} s at batch "
      f"{EVAL_BATCH}; Inception stage {record['inception_seconds'][0]:.3f} s "
      f"(weights load included); random-weights scores {record['scores']}")
  say(f"[eval] kernel launches: forward {launches[0]} = {ATTN_PER_FORWARD} x "
      f"(1 loss batch + {drift_evals} bpd drift evaluations + "
      f"{sum(record['sampling_nfe'])} sampling NFE), backward calls "
      f"{launches[1]} = {ATTN_PER_FORWARD} x {drift_evals} bpd drift "
      f"evaluations")
  check(launches[1] > 0, "no attention backward launch in the bpd stage")
  check(launches == want, f"eval launches {launches}, want {want}")
  check(all(math.isfinite(v) for v in record["scores"].values()),
        f"scores {record['scores']}")
  return launches



def phase_eval_checks(torch, attn, config, model, workdir: str,
                      card_line: str) -> None:
  """With TF32 off: the divergence of the full-width drift through the
  kernels vs through the plain attention (``model`` at unit gain), and the
  card's Inception features vs the CPU's. Then, at PyTorch's defaults, the
  time of one augmented drift evaluation (forward + vjp) vs the plain
  forward at batch 64 and the attention kernels' share of its device time,
  the peak memory of a chunked evaluation at batch 1024, and the bits/dim
  of one batch with TF32 on vs off at one fixed probe."""
  import numpy as np
  from torch.profiler import ProfilerActivity, profile
  from score_sde_pytorch_tpu_torch import checkpoint, datasets, inception
  from score_sde_pytorch_tpu_torch import likelihood, sde as sde_lib
  from score_sde_pytorch_tpu_torch.models import utils as mutils
  sde = sde_lib.build_sde(config)
  size = config.data.image_size
  gen = torch.Generator(device="cuda").manual_seed(8)
  defaults = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)

  def set_tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on and defaults[0]
    torch.backends.cudnn.allow_tf32 = on and defaults[1]

  def probe(batch):
    x = torch.rand(batch, 3, size, size, device="cuda", generator=gen) * 2 - 1
    eps = likelihood.draw_epsilon(x.shape, gen, "Rademacher", "cuda")
    return (x, torch.zeros(batch, device="cuda")), eps

  set_tf32(False)
  y, eps = probe(DIV_BATCH)
  with likelihood.frozen(model):
    aug = likelihood.get_augmented_drift(sde, model, eps)
    attn.flash_attention_backward_launches = 0
    drift_k, div_k = aug(y, 0.5)
    torch.cuda.synchronize()
    bwd = attn.flash_attention_backward_launches
    with mock.patch.object(attn, "attention", attn.dense_attention):
      drift_p, div_p = aug(y, 0.5)
  rel = (div_k - div_p).abs().max().item() / div_p.abs().max().item()
  rel_drift = ((drift_k - drift_p).abs().max().item()
               / drift_p.abs().max().item())
  say(f"[eval-check] divergence (Hutchinson, vjp) of the full-width drift at "
      f"B={DIV_BATCH}, TF32 off: kernels vs plain attention rel err "
      f"{rel:.3g} (max |div| {div_p.abs().max().item():.4g}), drift rel err "
      f"{rel_drift:.3g}; {bwd} backward calls")
  check(bwd == ATTN_PER_FORWARD, f"{bwd} backward calls in one drift "
        f"evaluation, want {ATTN_PER_FORWARD}")
  check(math.isfinite(rel) and rel <= DIV_RTOL,
        f"divergence kernels vs plain rel {rel:.3g} > {DIV_RTOL}")

  images = np.random.default_rng(9).integers(
      0, 256, (INCEPTION_CHECK, size, size, 3), dtype=np.uint8)
  params = inception.random_params(0)
  on_card = inception.InceptionV3Features("", device="cuda",
                                          params=params)(images)
  on_cpu = inception.InceptionV3Features("", device="cpu",
                                         params=params)(images)
  err = {k: np.abs(on_card[k] - on_cpu[k]).max() / np.abs(on_cpu[k]).max()
         for k in on_cpu}
  say(f"[eval-check] Inception on the card vs the port's CPU Inception, "
      f"{INCEPTION_CHECK} images, TF32 off: max err / max |.| "
      + ", ".join(f"{k} {v:.3g}" for k, v in err.items()))
  check(all(v <= INCEPTION_TOL for v in err.values()),
        f"Inception card vs CPU {err}")
  set_tf32(True)
  feats = inception.InceptionV3Features("", device="cuda", params=params)
  many = np.random.default_rng(10).integers(
      0, 256, (4 * feats.batch, size, size, 3), dtype=np.uint8)
  feats(many[:feats.batch])  # warm-up: cuDNN's first-call set-up
  torch.cuda.synchronize()
  start = time.perf_counter()
  feats(many)
  rate = many.shape[0] / (time.perf_counter() - start)
  say(f"[eval-time] Inception (pool_3 + logits, {size}x{size} -> 299x299) on "
      f"the card: {rate:.1f} images/s over {many.shape[0]} images at batch "
      f"{feats.batch}, PyTorch's default TF32 ({card_line})")
  del feats
  set_tf32(False)

  # Bits/dim of one batch with TF32 off and on, one probe, [train]'s
  # checkpoint (EMA weights), the eval split's first dequantized batch.
  trained = mutils.create_model(config, "cuda",
                                torch.Generator().manual_seed(config.seed))
  checkpoint.restore_ema(checkpoint.numbered_path(workdir, 2), trained)
  data = torch.rand(EVAL_BATCH, 3, size, size, device="cuda", generator=gen)
  eps_fixed = likelihood.draw_epsilon(data.shape, gen, "Rademacher", "cuda")
  lik = likelihood.get_likelihood_fn(
      sde, trained, datasets.get_data_inverse_scaler(config))
  bpds = {}
  for on in (False, True):
    set_tf32(on)
    bpd, _, nfe = lik(trained, data, None, epsilon=eps_fixed)
    bpds[on] = (bpd.double().cpu(), nfe)
  diff = (bpds[True][0] - bpds[False][0]).abs()
  say(f"[eval-check] bits/dim of {EVAL_BATCH} images at one probe: TF32 off "
      f"{bpds[False][0].mean().item():.7f} (NFE {bpds[False][1]}), PyTorch's "
      f"defaults (cuDNN TF32 {defaults[1]}, matmul TF32 {defaults[0]}) "
      f"{bpds[True][0].mean().item():.7f} (NFE {bpds[True][1]}): max |diff| "
      f"{diff.max().item():.3g}, mean diff "
      f"{(bpds[True][0] - bpds[False][0]).mean().item():.3g} bits/dim")
  check(all(bool(torch.isfinite(b[0]).all()) for b in bpds.values()),
        "bits/dim not finite")
  del trained

  # As a user runs it: PyTorch's default TF32 settings.
  set_tf32(True)
  y, eps = probe(DRIFT_BATCH)
  score_fn = mutils.get_score_fn(sde, model, train=False, continuous=True)
  t = torch.full((DRIFT_BATCH,), 0.5, device="cuda")
  with likelihood.frozen(model):
    aug = likelihood.get_augmented_drift(sde, model, eps)
    ms = time_ms(torch, lambda: aug(y, 0.5), iters=10)
    with torch.no_grad():
      fwd_ms = time_ms(torch, lambda: sde.reverse(
          score_fn, probability_flow=True).sde(y[0], t)[0], iters=10)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
      start = time.perf_counter()
      for _ in range(3):
        aug(y, 0.5)
      torch.cuda.synchronize()
      wall_ms = (time.perf_counter() - start) * 1e3 / 3
    by_kernel = _device_us_by_kernel(prof)
    busy_ms = sum(by_kernel.values()) / 1e3 / 3
    attn_ms = {cat: sum(us for name, us in by_kernel.items()
                        if _kernel_category(name) == cat) / 1e3 / 3
               for cat in ("attention forward", "attention backward")}
    say(f"[eval-time] augmented drift (forward + vjp) at batch {DRIFT_BATCH}: "
        f"{ms:.2f} ms vs the drift's forward alone {fwd_ms:.2f} ms "
        f"({ms / fwd_ms:.2f}x) ({card_line})")
    if busy_ms > 0:
      say(f"[eval-time] profiled: device busy {busy_ms:.2f} ms per "
          f"evaluation, idle share {1 - busy_ms / ms:.3f} of the unprofiled "
          f"{ms:.2f} ms ({1 - busy_ms / wall_ms:.3f} of the profiled); "
          f"attention forward {attn_ms['attention forward']:.3f} ms + "
          f"backward {attn_ms['attention backward']:.3f} ms = "
          f"{sum(attn_ms.values()) / busy_ms:.1%} of device time")
      _report_families("[eval-time]", by_kernel, 3, "evaluation")
    else:
      say("[eval-time] profiler: no device time recorded; shares not "
          "measured")
    y, eps = probe(DRIFT_BIG_BATCH)
    aug = likelihood.get_augmented_drift(sde, model, eps)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    start = time.perf_counter()
    drift, div = aug(y, 0.5)
    torch.cuda.synchronize()
    big_ms = (time.perf_counter() - start) * 1e3
    peak = torch.cuda.max_memory_allocated()
  check(bool(torch.isfinite(div).all()) and drift.shape == y[0].shape,
        "batch-1024 drift evaluation not finite")
  say(f"[eval-time] one augmented drift evaluation at batch "
      f"{DRIFT_BIG_BATCH} in chunks of {likelihood.DRIFT_CHUNK}: {big_ms:.1f} "
      f"ms (first call at this batch), peak max_memory_allocated "
      f"{peak / 2 ** 30:.2f} GiB ({(peak - base) / 2 ** 30:.2f} GiB above "
      f"the {base / 2 ** 30:.2f} GiB held before it)")
  (torch.backends.cuda.matmul.allow_tf32,
   torch.backends.cudnn.allow_tf32) = defaults


def phase_vp_train(torch, attn, card_line: str, workdir: str) -> tuple:
  """``main --mode train`` in process on the VP DDPM++ config at full width
  and batch 128: VP_TRAIN_STEPS steps with an Euler-Maruyama snapshot grid
  (num_scales 50, one network evaluation a step), its checkpoint and the
  launches checked; then the step's time, peak memory and device profile.
  Returns the run's forward and backward kernel launches."""
  import numpy as np
  from score_sde_pytorch_tpu_torch import checkpoint, configs, main
  from score_sde_pytorch_tpu_torch.models import utils as mutils
  flags = dict(TRAIN_FLAGS, **{"training.snapshot_freq": VP_TRAIN_STEPS,
                               "training.n_iters": VP_TRAIN_STEPS})
  config = configs.load_config(VP_CONFIG,
                               [f"{k}={v}" for k, v in flags.items()])
  n_jitted = config.training.n_jitted_steps
  initial = [p.detach() for p in mutils.create_model(
      config, "cpu", torch.Generator().manual_seed(config.seed)).parameters()]
  attn.flash_attention_launches = 0
  attn.flash_attention_backward_launches = 0
  start = time.perf_counter()
  with network_evals(torch) as evals:
    run = main.main(["--config", VP_CONFIG, "--workdir", workdir,
                     "--mode", "train"]
                    + [f"--config.{k}={v}" for k, v in flags.items()])
  launches = (attn.flash_attention_launches,
              attn.flash_attention_backward_launches)
  say(f"[vp-train] main --mode train, {VP_TRAIN_STEPS} steps at batch "
      f"{TRAIN_BATCH}, snapshot sampling Euler-Maruyama at num_scales "
      f"{SMOKE_SCALES}: {time.perf_counter() - start:.1f} s wall; losses "
      f"{run['train_losses']}, eval {run['eval_losses']}")
  seen = [v for _, v in run["train_losses"] + run["eval_losses"]]
  check(len(seen) == 4 and all(math.isfinite(v) for v in seen),
        f"[vp-train] logged losses {seen}")
  _ckpt_checks(torch, checkpoint.numbered_path(workdir, 1), VP_TRAIN_STEPS,
               initial, config.model.ema_rate)
  samples = np.load(os.path.join(workdir, "samples", f"iter_{VP_TRAIN_STEPS}",
                                 "sample.np"))
  size = config.data.image_size
  check(samples.shape == (TRAIN_BATCH, size, size, 3)
        and np.isfinite(samples).all(),
        f"[vp-train] snapshot samples {samples.shape}")
  eval_calls = VP_TRAIN_STEPS // config.training.eval_freq
  want_evals = VP_TRAIN_STEPS + n_jitted * eval_calls + SMOKE_SCALES
  want = (ATTN_PER_FORWARD * want_evals, ATTN_PER_FORWARD * VP_TRAIN_STEPS)
  say(f"[vp-train] kernel launches: forward {launches[0]} = "
      f"{ATTN_PER_FORWARD} x {evals[0]} network evaluations ("
      f"{VP_TRAIN_STEPS} train steps + {n_jitted} x {eval_calls} eval calls "
      f"+ {SMOKE_SCALES} sampling), backward calls {launches[1]} = "
      f"{ATTN_PER_FORWARD} x {VP_TRAIN_STEPS} train steps")
  check(evals[0] == want_evals, f"[vp-train] {evals[0]} network "
        f"evaluations, want {want_evals}")
  check(launches == want, f"[vp-train] launches {launches}, want {want}")
  phase_train_time(torch, config, card_line, tag="[vp-train]")
  return launches


def phase_vp_eval(torch, attn, workdir: str, card_line: str) -> tuple:
  """``main --mode eval`` in process on [vp-train]'s checkpoint_1 with the
  loss and bits/dim stages on the small ``.npz`` test split of [eval].
  Returns the forward and backward kernel launches."""
  import numpy as np
  from score_sde_pytorch_tpu_torch import main
  with tempfile.TemporaryDirectory() as base:
    data_dir = _write_eval_data(os.path.join(base, "data"), 32,
                                train=EVAL_BATCH)
    # Bits/dim over the train split (one batch) where [eval] takes the
    # test split 5 times: the smoke's time.
    overrides = {"eval.begin_ckpt": 1, "eval.end_ckpt": 1,
                 "eval.batch_size": EVAL_BATCH, "eval.enable_loss": True,
                 "eval.enable_bpd": True, "eval.bpd_dataset": "train",
                 "eval.enable_sampling": False,
                 "data.dataset": "NPZ", "data.data_dir": data_dir}
    attn.flash_attention_launches = 0
    attn.flash_attention_backward_launches = 0
    start = time.perf_counter()
    with network_evals(torch) as evals:
      (record,) = main.main(
          ["--config", VP_CONFIG, "--workdir", workdir, "--mode", "eval"]
          + [f"--config.{k}={v}" for k, v in overrides.items()])
    seconds = time.perf_counter() - start
  launches = (attn.flash_attention_launches,
              attn.flash_attention_backward_launches)
  with np.load(os.path.join(workdir, "eval", "train_ckpt_1_bpd.npz")) as z:
    bpd = z["bpd"]
  check(bpd.shape == (EVAL_BATCH,) and np.isfinite(bpd).all(),
        f"[vp-eval] bits/dim {bpd.shape}, finite {np.isfinite(bpd).all()}")
  drift_evals = sum(record["bpd_nfe"])
  check(evals[0] == 1 + drift_evals,
        f"[vp-eval] {evals[0]} network evaluations, want 1 + {drift_evals}")
  want = (ATTN_PER_FORWARD * (1 + drift_evals),
          ATTN_PER_FORWARD * drift_evals)
  say(f"[vp-eval] main --mode eval: {seconds:.1f} s wall; eval loss "
      f"{record['mean_loss']:.6g}; bits/dim {record['bpd']:.6f} (mean of "
      f"{bpd.size}), RK45 NFE per integration {record['bpd_nfe']}, seconds "
      f"per bpd batch {[round(x, 3) for x in record['bpd_seconds']]} "
      f"({card_line})")
  say(f"[vp-eval] kernel launches: forward {launches[0]} = {ATTN_PER_FORWARD}"
      f" x (1 loss batch + {drift_evals} drift evaluations), backward calls "
      f"{launches[1]} = {ATTN_PER_FORWARD} x {drift_evals}")
  check(launches == want, f"[vp-eval] launches {launches}, want {want}")
  return launches


def phase_ddpm(torch, attn, card_line: str) -> int:
  """vp/ddpm/cifar10.py at full width: a checkpoint of the seeded model,
  then (TF32 off) the unit-gain forward through the kernel against the
  plain attention and the CPU, then (PyTorch's defaults) ``main --mode
  sample`` with ancestral sampling, 4 attention calls per evaluation.
  Returns the sample run's forward kernel launches."""
  from score_sde_pytorch_tpu_torch import checkpoint, configs
  from score_sde_pytorch_tpu_torch.models import layers
  from score_sde_pytorch_tpu_torch.models import utils as mutils
  config = configs.load_config(DDPM_CONFIG,
                               [f"model.num_scales={SMOKE_SCALES}"])
  model = mutils.create_model(config, "cuda",
                              torch.Generator().manual_seed(config.seed))
  n_params = sum(p.numel() for p in model.parameters())
  with tempfile.TemporaryDirectory() as workdir:
    checkpoint.save_checkpoint(checkpoint.numbered_path(workdir, 1), model,
                               config, step=1)
    unit_gain_(torch, model, layers, seed=config.seed)
    defaults = _tf32_off(torch)
    try:
      phase_forward(torch, attn, config, model, tag="[ddpm]",
                    per_forward=DDPM_ATTN_PER_FORWARD)
    finally:
      _tf32_restore(torch, defaults)
    del model
    say(f"[ddpm] {n_params} parameters; ancestral sampling (discrete VP)")
    return phase_main_sample(
        torch, attn, DDPM_CONFIG, workdir,
        [f"model.num_scales={SMOKE_SCALES}"], DDPM_ATTN_PER_FORWARD,
        SMOKE_SCALES, SMOKE_BATCH, "[ddpm]", card_line)


def phase_samplers(torch, attn, model, card_line: str) -> int:
  """Every other sampling rule on the VP DDPM++ model at batch 64: finite
  samples, the network evaluations each rule makes, and 6 attention
  launches per evaluation. Returns the forward kernel launches."""
  from score_sde_pytorch_tpu_torch import configs, datasets, sampling
  from score_sde_pytorch_tpu_torch import sde as sde_lib
  n, k = SAMPLERS_SCALES, FLOW_STEPS
  cases = [
      ("pc reverse_diffusion + langevin",
       dict(predictor="reverse_diffusion", corrector="langevin"), 2 * n),
      ("pc none + ald", dict(predictor="none", corrector="ald"), n),
      ("heun", dict(method="heun", heun_steps=k), 2 * k + 1),
      ("dpmpp", dict(method="dpmpp", dpmpp_steps=k), k + 1),
      ("dpmpp stochastic",
       dict(method="dpmpp", dpmpp_steps=k, dpmpp_stochastic=True), k + 1)]
  total = 0
  for name, settings, want in cases:
    config = configs.load_config(VP_CONFIG, [f"model.num_scales={n}"] + [
        f"sampling.{key}={value}" for key, value in settings.items()])
    size = config.data.image_size
    sampler = sampling.get_sampling_fn(
        config, sde_lib.build_sde(config), model,
        (SAMPLERS_BATCH, size, size, 3),
        datasets.get_data_inverse_scaler(config))
    attn.flash_attention_launches = 0
    torch.cuda.synchronize()
    start = time.perf_counter()
    with network_evals(torch) as evals:
      samples, nfe = sampler(torch.Generator(device="cuda").manual_seed(11))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = attn.flash_attention_launches
    total += launches
    say(f"[samplers] {name}: reported NFE {nfe}, {evals[0]} network "
        f"evaluations, {launches} kernel launches; {seconds:.3f} s at batch "
        f"{SAMPLERS_BATCH} = {seconds * 1e3 / evals[0]:.3f} ms/evaluation; "
        f"max|sample| {samples.abs().max().item():.4g} ({card_line})")
    check(bool(torch.isfinite(samples).all()), f"[samplers] {name}: "
          "samples not finite")
    check(evals[0] == want, f"[samplers] {name}: {evals[0]} evaluations, "
          f"want {want}")
    check(launches == ATTN_PER_FORWARD * evals[0],
          f"[samplers] {name}: {launches} launches, want {ATTN_PER_FORWARD}"
          f" x {evals[0]}")
  return total


def phase_train_run(torch, attn, config_path: str, workdir: str, flags: dict,
                    per_forward: int, tag: str, resume_to: int = 0,
                    card_line: str = "") -> tuple:
  """``main --mode train`` in process with ``flags`` (snapshot sampling
  off), then, with ``resume_to``, a resume to that step: logged losses,
  numbered checkpoints, the resume, the network evaluations (train steps
  and eval forwards; remat recomputes resblocks, not the network) and the
  launches, ``per_forward`` forward launches per evaluation and backward
  calls per train step. Returns the forward and backward launches."""
  from score_sde_pytorch_tpu_torch import checkpoint, configs, main
  from score_sde_pytorch_tpu_torch.models import utils as mutils
  flags = dict(flags, **{"training.snapshot_sampling": False})
  config = configs.load_config(config_path,
                               [f"{k}={v}" for k, v in flags.items()])
  tcfg = config.training
  initial = [p.detach() for p in mutils.create_model(
      config, "cpu", torch.Generator().manual_seed(config.seed)).parameters()
             if p.requires_grad]
  attn.flash_attention_launches = 0
  attn.flash_attention_backward_launches = 0
  runs = []
  with network_evals(torch) as evals:
    for n_iters in (tcfg.n_iters,) + ((resume_to,) if resume_to else ()):
      start = time.perf_counter()
      runs.append(main.main(
          ["--config", config_path, "--workdir", workdir, "--mode", "train"]
          + [f"--config.{k}={v}" for k, v in flags.items()]
          + [f"--config.training.n_iters={n_iters}"]))
      say(f"{tag} main --mode train to step {n_iters} from step "
          f"{runs[-1]['initial_step']} at batch {tcfg.batch_size} (remat "
          f"{config.model.get('remat', False)}): "
          f"{time.perf_counter() - start:.1f} s wall (checkpoints and eval "
          f"included); losses {runs[-1]['train_losses']}, eval "
          f"{runs[-1]['eval_losses']} ({card_line})")
  launches = (attn.flash_attention_launches,
              attn.flash_attention_backward_launches)
  steps = resume_to or tcfg.n_iters
  if resume_to:
    log = open(os.path.join(workdir, "stdout.txt")).read()
    check(f"Starting training loop at step {tcfg.n_iters}" in log,
          f"{tag} the resumed run did not start at step {tcfg.n_iters}")
  seen = [v for run in runs for _, v in run["train_losses"]
          + run["eval_losses"]]
  check(len(seen) == 2 * len(runs) and all(math.isfinite(v) for v in seen),
        f"{tag} logged losses {seen}")
  for n in range(1, steps // tcfg.snapshot_freq + 1):
    _ckpt_checks(torch, checkpoint.numbered_path(workdir, n),
                 n * tcfg.snapshot_freq, initial, config.model.ema_rate)
  eval_forwards = tcfg.n_jitted_steps * (steps // tcfg.eval_freq)
  want = (per_forward * (steps + eval_forwards), per_forward * steps)
  say(f"{tag} {evals[0]} network evaluations ({steps} train steps + "
      f"{eval_forwards} eval forwards); kernel launches: forward "
      f"{launches[0]}, backward calls {launches[1]} = {per_forward} x "
      f"{steps} train steps")
  check(evals[0] == steps + eval_forwards,
        f"{tag} {evals[0]} network evaluations, want {steps} + "
        f"{eval_forwards}")
  check(launches == want, f"{tag} launches {launches}, want {want}")
  return launches


def phase_main_sample(torch, attn, config_path: str, workdir: str,
                      overrides: list, per_forward: int, want_evals: int,
                      batch: int, tag: str, card_line: str,
                      rounds: int = 1) -> int:
  """``main --mode sample`` in process on ``workdir``'s latest checkpoint,
  ``rounds`` rounds of ``batch``: the samples, ``want_evals`` counted
  network evaluations per round and ``per_forward`` launches per
  evaluation. Returns the launches."""
  import numpy as np
  from score_sde_pytorch_tpu_torch import configs, main
  size = configs.load_config(config_path, overrides).data.image_size
  attn.flash_attention_launches = 0
  with network_evals(torch) as evals:
    records = main.main(["--config", config_path, "--workdir", workdir,
                         "--mode", "sample", "--num_samples",
                         str(batch * rounds),
                         f"--config.eval.batch_size={batch}"]
                        + [f"--config.{o}" for o in overrides])
  launches = attn.flash_attention_launches
  for r in range(rounds):
    samples = np.load(os.path.join(workdir, "generated",
                                   f"samples_{r}.npz"))["samples"]
    check(samples.dtype == np.uint8
          and samples.shape == (batch, size, size, 3),
          f"{tag} samples_{r}.npz {samples.dtype} {samples.shape}")
  check(evals[0] == want_evals * rounds,
        f"{tag} {evals[0]} network evaluations, want {want_evals} x "
        f"{rounds}")
  check(launches == per_forward * evals[0],
        f"{tag} {launches} launches, want {per_forward} x {evals[0]}")
  for r, rec in enumerate(records):
    say(f"{tag} main --mode sample ({' '.join(overrides)}), round {r}: "
        f"{rec['samples']} samples in {rec['seconds']:.3f} s, reported NFE "
        f"{rec['nfe']}, {want_evals} network evaluations: "
        f"{rec['seconds'] * 1e3 / want_evals:.3f} ms/evaluation at batch "
        f"{batch} ({card_line})")
  say(f"{tag} {launches} kernel launches = {per_forward} x {evals[0]} "
      f"network evaluations")
  return launches


def train_step_peak(torch, attn, config, batch_size: int,
                    steps: int = 2) -> dict:
  """The train step of ``config`` at ``batch_size``: one warm-up step, then
  ``steps`` timed ones; wall ms per step, peak max_memory_allocated over
  all of them, and the attention launches per step."""
  torch.cuda.synchronize()
  torch.cuda.empty_cache()
  torch.cuda.reset_peak_memory_stats()
  run = _train_step(torch, config, batch_size)
  run(1)  # warm-up: cuDNN's first-call set-up, Adam's state
  attn.flash_attention_launches = 0
  attn.flash_attention_backward_launches = 0
  start = time.perf_counter()
  run(steps)
  ms = (time.perf_counter() - start) * 1e3 / steps
  return {"ms": ms, "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "launches": (attn.flash_attention_launches / steps,
                       attn.flash_attention_backward_launches / steps)}


def phase_remat_memory(torch, attn, config, card_line: str) -> None:
  """[hires-memory]: the church train step at its batch of 64 with remat,
  then without remat at the largest batch of NO_REMAT_BATCHES that fits
  (a batch that runs out of device memory is reported and the next smaller
  one tried)."""
  import gc
  from score_sde_pytorch_tpu_torch import configs
  batch = config.training.batch_size
  rec = train_step_peak(torch, attn, config, batch)
  say(f"[hires-memory] remat on, batch {batch}: {rec['ms']:.1f} ms/step, "
      f"peak max_memory_allocated {rec['peak_gib']:.2f} GiB; attention "
      f"{rec['launches'][0]:g} forward launches and {rec['launches'][1]:g} "
      f"backward calls per step ({card_line})")
  check(rec["launches"] == (HIRES_ATTN_PER_FORWARD, HIRES_ATTN_PER_FORWARD),
        f"[hires-memory] launches per step {rec['launches']}")
  plain = configs.load_config(CHURCH_CONFIG, ["model.remat=False"])
  for b in NO_REMAT_BATCHES:
    try:
      rec = train_step_peak(torch, attn, plain, b)
    except torch.cuda.OutOfMemoryError:
      rec = None
    gc.collect()
    torch.cuda.empty_cache()
    if rec is None:
      say(f"[hires-memory] remat off, batch {b}: out of device memory")
      continue
    say(f"[hires-memory] remat off, batch {b} (the largest of "
        f"{NO_REMAT_BATCHES} that fits): {rec['ms']:.1f} ms/step, peak "
        f"max_memory_allocated {rec['peak_gib']:.2f} GiB ({card_line})")
    return
  check(False, f"[hires-memory] no batch of {NO_REMAT_BATCHES} fits "
        "without remat")


def phase_controllable(torch, attn, config, model, card_line: str) -> int:
  """[controllable]: inpainting (the top half known) and colorization of a
  batch at full width with the config's PC sampler at its cut num_scales:
  the known half and the gray channel kept within 1e-3, finite images, and
  the attention launches per counted evaluation. Returns the launches."""
  from score_sde_pytorch_tpu_torch import controllable_generation as cg
  from score_sde_pytorch_tpu_torch import datasets, sampling
  from score_sde_pytorch_tpu_torch import sde as sde_lib
  scfg = config.sampling
  args = (sde_lib.build_sde(config), model,
          sampling.get_predictor(scfg.predictor),
          sampling.get_corrector(scfg.corrector),
          datasets.get_data_inverse_scaler(config), scfg.snr)
  kwargs = dict(n_steps=scfg.n_steps_each, continuous=True)
  gen = torch.Generator(device="cuda").manual_seed(12)
  size = config.data.image_size
  data = torch.rand(HIRES_BATCH, size, size, 3, device="cuda", generator=gen)
  mask = torch.zeros_like(data)
  mask[:, :size // 2] = 1.0
  gray = data[..., :1].expand(-1, -1, -1, 3)
  total = 0
  for name, run in (
      ("inpaint", lambda: cg.get_pc_inpainter(*args, **kwargs)(gen, data,
                                                               mask)),
      ("colorize", lambda: cg.get_pc_colorizer(*args, **kwargs)(gen, gray))):
    attn.flash_attention_launches = 0
    torch.cuda.synchronize()
    start = time.perf_counter()
    with network_evals(torch) as evals:
      out = run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = attn.flash_attention_launches
    total += launches
    check(out.shape == data.shape and bool(torch.isfinite(out).all()),
          f"[controllable] {name}: {tuple(out.shape)}, finite "
          f"{bool(torch.isfinite(out).all())}")
    if name == "inpaint":
      err = (out[:, :size // 2] - data[:, :size // 2]).abs().max().item()
    else:
      err = (cg.decouple(out.permute(0, 3, 1, 2))[:, 0]
             - cg.decouple(gray.permute(0, 3, 1, 2))[:, 0]).abs().max().item()
    want = (scfg.n_steps_each + 1) * config.model.num_scales
    say(f"[controllable] {name} at batch {HIRES_BATCH}, {size}x{size}, "
        f"{scfg.predictor} + {scfg.corrector}, num_scales "
        f"{config.model.num_scales}: {seconds:.3f} s, {evals[0]} network "
        f"evaluations ({seconds * 1e3 / evals[0]:.3f} ms each), "
        f"{launches} kernel launches; max |kept - given| {err:.3g} "
        f"({card_line})")
    check(err <= 1e-3, f"[controllable] {name}: kept region off by {err:.3g}")
    check(evals[0] == want, f"[controllable] {name}: {evals[0]} evaluations, "
          f"want {want}")
    check(launches == HIRES_ATTN_PER_FORWARD * evals[0],
          f"[controllable] {name}: {launches} launches, want "
          f"{HIRES_ATTN_PER_FORWARD} x {evals[0]}")
  return total


def phase_hires(torch, attn, card_line: str) -> tuple:
  """ve/church_ncsnpp_continuous.py at full width (output and input
  pyramids, remat): [hires-sample] from the seeded model's checkpoint;
  then at unit gain [controllable], and with TF32 off [hires-forward] and
  [hires-grad] through the kernels against the plain attention, and the
  multiattn file's forward
  (attention at 32² too); [hires-train] ``main --mode train`` at batch 64
  and a resume; [hires-memory]. Returns the forward and backward
  launches of the counted runs."""
  from score_sde_pytorch_tpu_torch import checkpoint, configs
  from score_sde_pytorch_tpu_torch.models import layers
  from score_sde_pytorch_tpu_torch.models import utils as mutils
  config = configs.load_config(CHURCH_CONFIG,
                               [f"model.num_scales={HIRES_SCALES}"])
  model = mutils.create_model(config, "cuda",
                              torch.Generator().manual_seed(config.seed))
  say(f"[hires] {CHURCH_CONFIG[len(ROOT) + 1:]}: "
      f"{sum(p.numel() for p in model.parameters())} parameters, "
      f"progressive {config.model.progressive}, progressive_input "
      f"{config.model.progressive_input}, remat {config.model.remat}; "
      f"num_scales cut from 2000 to {HIRES_SCALES}")
  with tempfile.TemporaryDirectory() as workdir:
    checkpoint.save_checkpoint(checkpoint.numbered_path(workdir, 1), model,
                               config, step=1)
    forward = phase_main_sample(
        torch, attn, CHURCH_CONFIG, workdir,
        [f"model.num_scales={HIRES_SCALES}"], HIRES_ATTN_PER_FORWARD,
        (config.sampling.n_steps_each + 1) * HIRES_SCALES, HIRES_BATCH,
        "[hires-sample]", card_line)
  # At its init the network's output convs are zero (init_scale 0), so the
  # Langevin step, scaled by 1/|score|², would throw the unknown channels
  # far out; at unit gain the score has the scale of a trained one.
  unit_gain_(torch, model, layers, seed=config.seed)
  forward += phase_controllable(torch, attn, config, model, card_line)
  defaults = _tf32_off(torch)
  try:
    phase_forward(torch, attn, config, model, tag="[hires-forward]",
                  per_forward=HIRES_ATTN_PER_FORWARD, batch=HIRES_BATCH,
                  cpu_batch=1)
    phase_grad(torch, attn, config, model, tag="[hires-grad]",
               per_forward=HIRES_ATTN_PER_FORWARD,
               batch_size=HIRES_GRAD_BATCH)
    del model
    multi = configs.load_config(MULTIATTN_CONFIG)
    model = mutils.create_model(multi, "cuda",
                                torch.Generator().manual_seed(multi.seed))
    unit_gain_(torch, model, layers, seed=multi.seed)
    phase_forward(torch, attn, multi, model, tag="[hires-multiattn]",
                  per_forward=MULTIATTN_PER_FORWARD, batch=HIRES_BATCH,
                  cpu_batch=1)
    del model
  finally:
    _tf32_restore(torch, defaults)
  with tempfile.TemporaryDirectory() as workdir:
    train = phase_train_run(torch, attn, CHURCH_CONFIG, workdir,
                            short_train_flags(), HIRES_ATTN_PER_FORWARD,
                            "[hires-train]", resume_to=2 * SHORT_STEPS,
                            card_line=card_line)
  phase_remat_memory(torch, attn, configs.load_config(CHURCH_CONFIG),
                     card_line)
  return forward + train[0], train[1]


def phase_ddpm256(torch, attn, card_line: str) -> tuple:
  """vp/ddpm/church.py at full width (attention at C = 512): [ddpm-256]
  the unit-gain forward and a DDPM-loss gradient through the kernels
  against the plain attention (TF32 off); ``main --mode train`` at batch 8
  (no remat in this model) and ``--mode sample`` (ancestral sampling at a
  cut num_scales) on its checkpoint. Returns the forward and backward
  launches of the counted runs."""
  from score_sde_pytorch_tpu_torch import configs
  from score_sde_pytorch_tpu_torch.models import layers
  from score_sde_pytorch_tpu_torch.models import utils as mutils
  config = configs.load_config(DDPM256_CONFIG)
  model = mutils.create_model(config, "cuda",
                              torch.Generator().manual_seed(config.seed))
  say(f"[ddpm-256] {DDPM256_CONFIG[len(ROOT) + 1:]}: "
      f"{sum(p.numel() for p in model.parameters())} parameters")
  unit_gain_(torch, model, layers, seed=config.seed)
  defaults = _tf32_off(torch)
  try:
    phase_forward(torch, attn, config, model, tag="[ddpm-256]",
                  per_forward=DDPM256_ATTN_PER_FORWARD, batch=HIRES_BATCH,
                  cpu_batch=1)
    phase_grad(torch, attn, config, model, tag="[ddpm-256-grad]",
               per_forward=DDPM256_ATTN_PER_FORWARD,
               batch_size=HIRES_GRAD_BATCH)
  finally:
    _tf32_restore(torch, defaults)
  del model
  flags = {"training.batch_size": DDPM256_TRAIN_BATCH,
           "training.n_iters": HIRES_TRAIN_STEPS, "training.log_freq": 5,
           "training.eval_freq": 5, "training.snapshot_freq": 5,
           "training.snapshot_freq_for_preemption": 5}
  with tempfile.TemporaryDirectory() as workdir:
    train = phase_train_run(torch, attn, DDPM256_CONFIG, workdir, flags,
                            DDPM256_ATTN_PER_FORWARD, "[ddpm-256-train]",
                            card_line=card_line)
    sample = phase_main_sample(
        torch, attn, DDPM256_CONFIG, workdir,
        [f"model.num_scales={DDPM256_SCALES}"], DDPM256_ATTN_PER_FORWARD,
        DDPM256_SCALES, HIRES_BATCH, "[ddpm-256-sample]", card_line)
  return train[0] + sample, train[1]


def phase_hires_1024(torch, attn, card_line: str) -> tuple:
  """ve/celebahq_ncsnpp_continuous.py at full width (1024², attention at
  C = 512): [hires-1024] the unit-gain forward through the kernels against
  the plain attention (TF32 off), then the train step with remat at its
  batch of 8, driven directly (the synthetic split at 1024² is 640 images
  of 3 MB), with its peak memory. Returns the forward and backward
  launches of the timed train steps."""
  from score_sde_pytorch_tpu_torch import configs
  from score_sde_pytorch_tpu_torch.models import layers
  from score_sde_pytorch_tpu_torch.models import utils as mutils
  config = configs.load_config(HQ1024_CONFIG)
  model = mutils.create_model(config, "cuda",
                              torch.Generator().manual_seed(config.seed))
  say(f"[hires-1024] {HQ1024_CONFIG[len(ROOT) + 1:]}: "
      f"{sum(p.numel() for p in model.parameters())} parameters, remat "
      f"{config.model.remat}")
  unit_gain_(torch, model, layers, seed=config.seed)
  defaults = _tf32_off(torch)
  try:
    phase_forward(torch, attn, config, model, tag="[hires-1024]",
                  per_forward=HQ1024_ATTN_PER_FORWARD, batch=2, cpu_batch=1)
  finally:
    _tf32_restore(torch, defaults)
  del model
  steps = 2
  rec = train_step_peak(torch, attn, config, HQ1024_TRAIN_BATCH, steps=steps)
  say(f"[hires-1024] train step with remat at batch {HQ1024_TRAIN_BATCH}: "
      f"{rec['ms']:.1f} ms/step, peak max_memory_allocated "
      f"{rec['peak_gib']:.2f} GiB; {rec['launches'][0]:g} forward launches "
      f"and {rec['launches'][1]:g} backward calls per step ({card_line})")
  check(rec["launches"] == (HQ1024_ATTN_PER_FORWARD,
                            HQ1024_ATTN_PER_FORWARD),
        f"[hires-1024] launches per step {rec['launches']}")
  return (HQ1024_ATTN_PER_FORWARD * steps, HQ1024_ATTN_PER_FORWARD * steps)


def phase_kernel_bf16(torch, attn, card_line: str) -> None:
  """[kernel-bf16]: the attention kernels in bf16 at the bf16 files' shapes
  (TF32 off): forward and backward against the plain bf16 version and
  against fp64, the kernel's error to fp64 no larger than the plain bf16
  version's (x1.5 + 1e-3, the bf16 gate of [kernel] and [kernel-bwd]); the
  times of the kernel, the plain version and
  F.scaled_dot_product_attention beside the bound at bf16's tensor-core
  peak. Comparison launches only: not counted toward the main path."""
  sdpa = torch.nn.functional.scaled_dot_product_attention
  gen = torch.Generator(device="cuda").manual_seed(7)

  def plain_bwd(q, k, v, dout):
    return attn.dense_attention_backward(q, k, v,
                                         attn.dense_attention(q, k, v), dout)

  for b, n, c in BF16_SHAPES:
    q, k, v, dout = (torch.randn(b, n, c, device="cuda", generator=gen)
                     .bfloat16() for _ in range(4))
    exact = attn.dense_attention(*(t.double() for t in (q, k, v)))
    err = _max_err(attn.attention(q, k, v).double(), exact)
    err_plain = _max_err(attn.dense_attention(q, k, v).double(), exact)
    check(err <= 1.5 * err_plain + 1e-3,
          f"[kernel-bf16] forward at {(b, n, c)}: kernel {err:.3g} vs plain "
          f"{err_plain:.3g} from fp64")
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    attn.attention(*leaves).backward(dout)
    got = [t.grad for t in leaves]
    wide = [t.double() for t in (q, k, v, dout)]
    exact_g = plain_bwd(*wide)
    err_b = max(_max_err(g.double(), e) for g, e in zip(got, exact_g))
    err_b_plain = max(_max_err(g.double(), e) for g, e in
                      zip(plain_bwd(q, k, v, dout), exact_g))
    check(err_b <= 1.5 * err_b_plain + 1e-3,
          f"[kernel-bf16] backward at {(b, n, c)}: kernel {err_b:.3g} vs "
          f"plain {err_b_plain:.3g} from fp64")
    del exact, exact_g, wide
    q4, k4, v4 = (t[:, None] for t in (q, k, v))
    ms = time_ms(torch, lambda: attn.attention(q, k, v))
    plain_ms = time_ms(torch, lambda: attn.dense_attention(q, k, v))
    library_ms = time_ms(torch, lambda: sdpa(q4, k4, v4))
    bound_ms, bound_by = bound(4.0 * b * n * n * c, 4.0 * b * n * c * 2,
                               BF16_FLOPS)
    out, lse = attn._launch_flash_attention(q, k, v, with_lse=True)
    bwd_ms = time_ms(torch, lambda: attn._launch_flash_attention_backward(
        q, k, v, out, lse, dout), iters=20)
    plain_bwd_ms = time_ms(torch, lambda: attn.dense_attention_backward(
        q, k, v, out, dout), iters=20)
    bwd_bound_ms, bwd_bound_by = bound(10.0 * b * n * n * c,
                                       8.0 * b * n * c * 2 + b * n * 4,
                                       BF16_FLOPS)
    grads = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    both_ms = time_ms(torch, lambda: torch.autograd.grad(
        attn.attention(*grads), grads, dout), iters=20)
    sdpa_both_ms = time_ms(torch, lambda: torch.autograd.grad(
        sdpa(*(t[:, None] for t in grads)), grads, dout[:, None]), iters=20)
    say(f"[kernel-bf16] B,N,C={b},{n},{c}: vs fp64 forward kernel {err:.3g} "
        f"plain {err_plain:.3g}, backward kernel {err_b:.3g} plain "
        f"{err_b_plain:.3g}")
    say(f"[kernel-bf16]   forward ms: kernel {ms:.4f} plain {plain_ms:.4f} "
        f"sdpa {library_ms:.4f} bound {bound_ms:.4f} ({bound_by}), share of "
        f"bound {bound_ms / ms:.3f} | backward ms: kernel {bwd_ms:.4f} plain "
        f"{plain_bwd_ms:.4f} bound {bwd_bound_ms:.4f} ({bwd_bound_by}), "
        f"share {bwd_bound_ms / bwd_ms:.3f} | forward+backward: kernels "
        f"{both_ms:.4f} sdpa {sdpa_both_ms:.4f} ({card_line})")


def _forward_card_vs_cpu(torch, config, model, labels, tag: str,
                         batch: int, cpu_batch: int) -> float:
  """The full-width forward on the card against the CPU forward of the same
  weights (TF32 off), with no attention launch; returns the card's
  output's max |value|."""
  from score_sde_pytorch_tpu_torch.ops import attention as attn
  gen = torch.Generator(device="cuda").manual_seed(1)
  size = config.data.image_size
  x = torch.rand(batch, 3, size, size, device="cuda", generator=gen)
  before = attn.flash_attention_launches
  with torch.no_grad():
    out = model(x, labels)
    torch.cuda.synchronize()
    on_cpu = model.to("cpu")(x[:cpu_batch].cpu(), labels[:cpu_batch].cpu())
  model.to("cuda")
  launches = attn.flash_attention_launches - before
  scale = on_cpu.abs().max().item()
  rel = (out[:cpu_batch].cpu() - on_cpu).abs().max().item() / scale
  say(f"{tag} full-width {config.model.name} B={batch}: max|out| "
      f"{out.abs().max().item():.4g}, card vs CPU rel err {rel:.3g} "
      f"({launches} attention launches)")
  check(bool(torch.isfinite(out).all()), f"{tag} not finite")
  check(launches == 0, f"{tag} {launches} attention launches, want 0")
  check(rel <= FORWARD_RTOL, f"{tag} card vs CPU rel err {rel:.3g}")
  return scale


def _ncsn_labels(torch, config, batch: int):
  gen = torch.Generator(device="cuda").manual_seed(3)
  return torch.randint(0, config.model.num_scales, (batch,), device="cuda",
                       generator=gen)


def phase_ncsn(torch, attn, card_line: str) -> None:
  """[ncsn]: ve/ncsn/cifar10.py (NCSN v1, conditional InstanceNorm++, 10
  scales, annealed Langevin dynamics with 100 steps per scale) at full
  width: the forward on the card against the CPU (TF32 off); ``main --mode
  train`` at the config's batch for 5 steps and a resume to 10; ``main
  --mode sample`` at the config's 10 scales x 20 steps (cut from 100) and
  batch 64; one sampler
  step (NCSN_STEP_STEPS Langevin steps, cut from 100) at the config's
  eval.batch_size, whose peak memory is held below a forward's plus half of
  the stacked noise the corrector used to draw.
  Every run counts its evaluations and holds the attention launches at
  0."""
  from score_sde_pytorch_tpu_torch import configs, datasets, sampling
  from score_sde_pytorch_tpu_torch import sde as sde_lib
  from score_sde_pytorch_tpu_torch.models import utils as mutils
  config = configs.load_config(NCSN_CONFIG)
  model = mutils.create_model(config, "cuda",
                              torch.Generator().manual_seed(config.seed))
  say(f"[ncsn] {NCSN_CONFIG[len(ROOT) + 1:]}: "
      f"{sum(p.numel() for p in model.parameters())} parameters, "
      f"{config.model.num_scales} scales, {config.sampling.corrector} x "
      f"{config.sampling.n_steps_each}")
  defaults = _tf32_off(torch)
  try:
    _forward_card_vs_cpu(torch, config, model,
                         _ncsn_labels(torch, config, SMOKE_BATCH), "[ncsn]",
                         SMOKE_BATCH, 2)
  finally:
    _tf32_restore(torch, defaults)
  flags = {"training.n_iters": NCSN_TRAIN_STEPS, "training.log_freq": 5,
           "training.eval_freq": 5, "training.snapshot_freq": 5,
           "training.snapshot_freq_for_preemption": 5}
  n_steps = NCSN_STEP_STEPS
  with tempfile.TemporaryDirectory() as workdir:
    phase_train_run(torch, attn, NCSN_CONFIG, workdir, flags, 0,
                    "[ncsn-train]", resume_to=2 * NCSN_TRAIN_STEPS,
                    card_line=card_line)
    # The "none" predictor evaluates nothing: num_scales x n_steps
    # evaluations under a reported NFE of num_scales x (n_steps + 1).
    phase_main_sample(torch, attn, NCSN_CONFIG, workdir,
                      [f"sampling.n_steps_each={NCSN_SAMPLE_STEPS}"], 0,
                      config.model.num_scales * NCSN_SAMPLE_STEPS,
                      NCSN_SAMPLE_BATCH, "[ncsn-sample]", card_line)
  # One sampler step (num_scales 1: NCSN_STEP_STEPS Langevin steps and the
  # "none" predictor) at the eval batch, after one forward at that batch
  # alone.
  batch = config.eval.batch_size
  size = config.data.image_size
  stacked_gib = n_steps * batch * 3 * size * size * 4 / 2 ** 30
  x = torch.rand(batch, 3, size, size, device="cuda")
  labels = torch.zeros(batch, dtype=torch.int32, device="cuda")
  torch.cuda.synchronize()
  torch.cuda.empty_cache()
  base = torch.cuda.memory_allocated()
  torch.cuda.reset_peak_memory_stats()
  with torch.no_grad():
    model(x, labels)
  torch.cuda.synchronize()
  forward_gib = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
  del x
  one = configs.load_config(NCSN_CONFIG, ["model.num_scales=1",
                                         f"sampling.n_steps_each={n_steps}"])
  shape = (batch, size, size, 3)
  sampler = sampling.get_sampling_fn(one, sde_lib.build_sde(one), model,
                                     shape,
                                     datasets.get_data_inverse_scaler(one))
  torch.cuda.synchronize()
  torch.cuda.empty_cache()
  base = torch.cuda.memory_allocated()
  torch.cuda.reset_peak_memory_stats()
  start = time.perf_counter()
  with network_evals(torch) as evals:
    samples, nfe = sampler(torch.Generator(device="cuda").manual_seed(9))
  torch.cuda.synchronize()
  seconds = time.perf_counter() - start
  step_gib = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
  say(f"[ncsn-step] one sampler step at eval batch {batch}: {evals[0]} "
      f"evaluations in {seconds:.2f} s ({seconds * 1e3 / evals[0]:.2f} "
      f"ms each); peak max_memory_allocated above the model {step_gib:.3f} "
      f"GiB, one forward alone {forward_gib:.3f} GiB; the stacked noise of "
      f"{n_steps} steps would be {stacked_gib:.3f} GiB ({card_line})")
  check(bool(torch.isfinite(samples).all()) and evals[0] == n_steps,
        f"[ncsn-step] {evals[0]} evaluations, finite "
        f"{bool(torch.isfinite(samples).all())}")
  check(step_gib < forward_gib + stacked_gib / 2,
        f"[ncsn-step] peak {step_gib:.3f} GiB: a stacked noise tensor?")


def phase_ncsnv2(torch, attn, card_line: str) -> None:
  """[ncsnv2]: ve/ncsnv2/cifar10.py (ncsnv2_64) at full width: the forward
  on the card against the CPU (TF32 off), ``main --mode train`` for 5
  steps and ``main --mode sample`` with annealed Langevin dynamics at 20
  scales; ve/ncsnv2/bedroom.py (ncsnv2_128, 128²): the train step at its
  batch of 128 or the largest of BEDROOM_BATCHES that fits, ms/step and
  peak memory; an ncsnv2_256 forward at 256² and batch 4 (the bedroom file
  with model.name=ncsnv2_256 and data.image_size=256) against the CPU.
  No attention launch anywhere."""
  import gc
  from score_sde_pytorch_tpu_torch import configs
  from score_sde_pytorch_tpu_torch.models import utils as mutils
  config = configs.load_config(NCSNV2_CONFIG)
  model = mutils.create_model(config, "cuda",
                              torch.Generator().manual_seed(config.seed))
  say(f"[ncsnv2] {NCSNV2_CONFIG[len(ROOT) + 1:]}: "
      f"{sum(p.numel() for p in model.parameters())} parameters")
  defaults = _tf32_off(torch)
  try:
    _forward_card_vs_cpu(torch, config, model,
                         _ncsn_labels(torch, config, SMOKE_BATCH),
                         "[ncsnv2]", SMOKE_BATCH, 2)
  finally:
    _tf32_restore(torch, defaults)
  del model
  flags = {"training.n_iters": NCSN_TRAIN_STEPS, "training.log_freq": 5,
           "training.eval_freq": 5, "training.snapshot_freq": 5,
           "training.snapshot_freq_for_preemption": 5}
  with tempfile.TemporaryDirectory() as workdir:
    phase_train_run(torch, attn, NCSNV2_CONFIG, workdir, flags, 0,
                    "[ncsnv2-train]", card_line=card_line)
    phase_main_sample(
        torch, attn, NCSNV2_CONFIG, workdir,
        [f"model.num_scales={NCSNV2_SCALES}"], 0,
        NCSNV2_SCALES * config.sampling.n_steps_each,
        NCSN_SAMPLE_BATCH, "[ncsnv2-sample]", card_line)
  bedroom = configs.load_config(BEDROOM_CONFIG)
  for b in BEDROOM_BATCHES:
    try:
      rec = train_step_peak(torch, attn, bedroom, b)
    except torch.cuda.OutOfMemoryError:
      rec = None
    gc.collect()
    torch.cuda.empty_cache()
    if rec is None:
      say(f"[ncsnv2-bedroom] train step at batch {b}: out of device memory")
      continue
    say(f"[ncsnv2-bedroom] {BEDROOM_CONFIG[len(ROOT) + 1:]} (ncsnv2_128, "
        f"128²) train step at batch {b} (the config's: "
        f"{bedroom.training.batch_size}): {rec['ms']:.1f} ms/step, peak "
        f"max_memory_allocated {rec['peak_gib']:.2f} GiB ({card_line})")
    check(rec["launches"] == (0, 0),
          f"[ncsnv2-bedroom] attention launches {rec['launches']}")
    break
  else:
    check(False, f"[ncsnv2-bedroom] no batch of {BEDROOM_BATCHES} fits")
  v256 = configs.load_config(BEDROOM_CONFIG, ["model.name=ncsnv2_256",
                                              "data.image_size=256"])
  model = mutils.create_model(v256, "cuda",
                              torch.Generator().manual_seed(v256.seed))
  say(f"[ncsnv2-256] ncsnv2_256 at 256²: "
      f"{sum(p.numel() for p in model.parameters())} parameters")
  defaults = _tf32_off(torch)
  try:
    _forward_card_vs_cpu(torch, v256, model,
                         _ncsn_labels(torch, v256, V2_256_BATCH),
                         "[ncsnv2-256]", V2_256_BATCH, 1)
  finally:
    _tf32_restore(torch, defaults)


def phase_bf16_church(torch, attn, card_line: str) -> tuple:
  """[bf16-church]: tpu/church_256_ncsnpp_tpu.py (model.dtype bfloat16,
  remat, batch 32) at full width: ``main --mode train`` for 2 steps and a
  resume to 4 (4 forward launches and 4 backward calls per step), then
  ``main --mode sample`` (PC, num_scales 10, batch 4) on its checkpoint; the
  train step's ms and peak memory at batch 32, beside the fp32 file's at
  the same batch; and at unit gain, the bf16 forward's relative L2
  distance from the fp32 forward of the same weights, with its 4
  launches. Returns the forward and backward launches of the counted
  runs."""
  from score_sde_pytorch_tpu_torch import configs
  from score_sde_pytorch_tpu_torch.models import layers
  from score_sde_pytorch_tpu_torch.models import utils as mutils
  config = configs.load_config(BF16_CHURCH_CONFIG)
  with tempfile.TemporaryDirectory() as workdir:
    train = phase_train_run(torch, attn, BF16_CHURCH_CONFIG, workdir,
                            short_train_flags(), BF16_CHURCH_ATTN,
                            "[bf16-church-train]", resume_to=2 * SHORT_STEPS,
                            card_line=card_line)
    sample = phase_main_sample(
        torch, attn, BF16_CHURCH_CONFIG, workdir,
        [f"model.num_scales={HIRES_SCALES}"], BF16_CHURCH_ATTN,
        (config.sampling.n_steps_each + 1) * HIRES_SCALES, HIRES_BATCH,
        "[bf16-church-sample]", card_line)
  batch = config.training.batch_size
  for cfg, what in ((config, "bf16"), (configs.load_config(
      BF16_CHURCH_CONFIG, ["model.dtype=float32"]), "fp32")):
    rec = train_step_peak(torch, attn, cfg, batch)
    say(f"[bf16-church] train step with remat at batch {batch}, {what}: "
        f"{rec['ms']:.1f} ms/step, peak max_memory_allocated "
        f"{rec['peak_gib']:.2f} GiB; {rec['launches'][0]:g} forward "
        f"launches and {rec['launches'][1]:g} backward calls per step "
        f"({card_line})")
    check(rec["launches"] == (BF16_CHURCH_ATTN, BF16_CHURCH_ATTN),
          f"[bf16-church] launches per step {rec['launches']}")
  models = []
  for cfg in (config, configs.load_config(BF16_CHURCH_CONFIG,
                                          ["model.dtype=float32"])):
    model = mutils.create_model(cfg, "cuda",
                                torch.Generator().manual_seed(cfg.seed))
    unit_gain_(torch, model, layers, seed=cfg.seed)
    models.append(model)
  gen = torch.Generator(device="cuda").manual_seed(1)
  size = config.data.image_size
  x = torch.rand(HIRES_BATCH, 3, size, size, device="cuda", generator=gen)
  labels = _labels(config, torch.rand(HIRES_BATCH, device="cuda",
                                      generator=gen))
  with torch.no_grad():
    attn.flash_attention_launches = 0
    out16 = models[0](x, labels)
    launches = attn.flash_attention_launches
    out32 = models[1](x, labels)
  dist = ((out16 - out32).norm() / out32.norm()).item()
  say(f"[bf16-church] unit-gain forward at batch {HIRES_BATCH}: bf16 vs "
      f"fp32 of the same weights, relative L2 {dist:.4g}; output dtype "
      f"{out16.dtype}; {launches} attention launches")
  check(out16.dtype == torch.float32 and bool(torch.isfinite(out16).all()),
        f"[bf16-church] output {out16.dtype}")
  check(1e-4 < dist <= 5e-2, f"[bf16-church] bf16 vs fp32 distance {dist}")
  check(launches == BF16_CHURCH_ATTN,
        f"[bf16-church] {launches} launches in one forward")
  return train[0] + sample, train[1]


def phase_bf16_1024(torch, attn, card_line: str) -> tuple:
  """[bf16-1024]: tpu/celebahq_1024_ncsnpp_tpu.py (bf16, remat) at full
  width, the train step at its batch of 8, driven directly as
  [hires-1024]'s is: ms/step and peak memory, 3 forward launches and 3
  backward calls per step. Returns the launches of the timed steps."""
  from score_sde_pytorch_tpu_torch import configs
  config = configs.load_config(BF16_1024_CONFIG)
  steps = 2
  rec = train_step_peak(torch, attn, config, config.training.batch_size,
                        steps=steps)
  say(f"[bf16-1024] {BF16_1024_CONFIG[len(ROOT) + 1:]} train step with "
      f"remat at batch {config.training.batch_size}, bf16: {rec['ms']:.1f} "
      f"ms/step, peak max_memory_allocated {rec['peak_gib']:.2f} GiB; "
      f"{rec['launches'][0]:g} forward launches and {rec['launches'][1]:g} "
      f"backward calls per step ({card_line})")
  check(rec["launches"] == (BF16_1024_ATTN, BF16_1024_ATTN),
        f"[bf16-1024] launches per step {rec['launches']}")
  return (BF16_1024_ATTN * steps, BF16_1024_ATTN * steps)


# --- the peripherals: URI workdirs, trace, demo, debug, stats, H100 leaves --


def phase_uri(torch, attn, card_line: str) -> tuple:
  """[uri]: ``myfs://`` registered onto a temporary directory
  (``utils.io.LocalMirrorHandler``), then the flagship's ``main --mode
  train`` at full width and batch URI_BATCH on ``myfs://bucket/wd``: 2
  steps with snapshot sampling and ``training.trace_steps=2``, a resume to
  4 (traced too), ``--mode eval`` (the loss) and ``--mode sample`` (one
  round). Every artifact must be under the mirror root and none under a
  local ``myfs:``; the traces must name the attention kernels; an
  unregistered ``gs://`` workdir must raise before any step. Returns the
  forward and backward launches."""
  from score_sde_pytorch_tpu_torch import main
  from score_sde_pytorch_tpu_torch.utils import io
  wd = "myfs://bucket/wd"
  common = ["--config", FLAGSHIP, "--workdir", wd,
            f"--config.model.num_scales={URI_SCALES}",
            f"--config.eval.batch_size={URI_BATCH}"]
  train = ["--mode", "train", f"--config.training.batch_size={URI_BATCH}",
           "--config.training.n_jitted_steps=1",
           "--config.training.log_freq=1", "--config.training.eval_freq=2",
           "--config.training.snapshot_freq=2",
           "--config.training.snapshot_freq_for_preemption=2",
           f"--config.training.trace_steps={SHORT_STEPS}"]
  runs = [
      ("train", train + ["--config.training.n_iters=2"], 2),
      ("resume", train + ["--config.training.n_iters=4",
                          "--config.training.snapshot_sampling=False"], 2),
      ("eval", ["--mode", "eval", "--config.eval.begin_ckpt=2",
                "--config.eval.end_ckpt=2", "--config.eval.enable_loss=True",
                "--config.eval.enable_bpd=False",
                "--config.eval.enable_sampling=False"], 0),
      ("sample", ["--mode", "sample"], 0),
  ]
  fwd = bwd = 0
  cwd = os.getcwd()
  with tempfile.TemporaryDirectory() as base:
    root, local_cwd = os.path.join(base, "mirror"), os.path.join(base, "cwd")
    os.makedirs(local_cwd)
    os.chdir(local_cwd)
    io.register_scheme("myfs", io.LocalMirrorHandler("myfs", root))
    try:
      _reset(attn)
      try:
        main.main(["--config", FLAGSHIP, "--workdir", "gs://bucket/wd",
                   "--mode", "train"])
        raised = ""
      except ValueError as e:
        raised = str(e)
      check("register_scheme" in raised
            and _counts(attn) == {"forward": 0, "backward": 0}
            and not os.listdir(local_cwd),
            f"[uri] an unregistered gs:// workdir: {raised!r}, launches "
            f"{_counts(attn)}, {os.listdir(local_cwd)} in the working "
            "directory")
      say(f"[uri] gs:// without a handler raised before any step: {raised}")
      for name, args, steps in runs:
        _reset(attn)
        start = time.perf_counter()
        with network_evals(torch) as evals:
          main.main(common + args)
        launches = _counts(attn)
        say(f"[uri] {name} on {wd}: {time.perf_counter() - start:.1f} s "
            f"wall; {evals[0]} network evaluations, launches {launches}")
        check(evals[0] > 0 and launches == {
            "forward": ATTN_PER_FORWARD * evals[0],
            "backward": ATTN_PER_FORWARD * steps},
              f"[uri] {name}: {evals[0]} evaluations, launches {launches}")
        fwd += launches["forward"]
        bwd += launches["backward"]
    finally:
      io.unregister_scheme("myfs")
      os.chdir(cwd)
    check(not os.listdir(local_cwd),
          f"[uri] {os.listdir(local_cwd)} in the working directory")
    local = os.path.join(root, "bucket", "wd")
    found = sorted(os.path.relpath(os.path.join(d, f), local)
                   for d, _, files in os.walk(local) for f in files)
    traces = [f for f in found if f.startswith("profile/")]
    want = ["checkpoints/checkpoint_1.pth", "checkpoints/checkpoint_2.pth",
            "checkpoints-meta/checkpoint.pth", "samples/iter_2/sample.np",
            "samples/iter_2/sample.png", "stdout.txt",
            "eval/ckpt_2_loss.npz", "generated/samples_0.npz",
            "generated/samples_0.png",
            "profile/steps_1-2_rank0.pt.trace.json",
            "profile/steps_3-4_rank0.pt.trace.json"]
    missing = [f for f in want if f not in found]
    check(not missing, f"[uri] missing under the mirror root: {missing}")
    for trace in traces:
      with open(os.path.join(local, trace)) as f:
        text = f.read()
      names = sorted(set(re.findall(r"flash_attention_(fwd|bwd_dkdv|bwd_dq)",
                                    text)))
      say(f"[uri] {trace}: {len(text) / 2 ** 20:.1f} MiB, attention "
          f"kernels {names}")
      check(names == ["bwd_dkdv", "bwd_dq", "fwd"],
            f"[uri] {trace} names the kernels {names}")
    say(f"[uri] under the mirror root: {found} ({card_line})")
  return fwd, bwd


def phase_demo(torch, attn, card_line: str) -> tuple:
  """[demo]: ``python -m score_sde_pytorch_tpu_torch.demo`` in process at
  the flagship's full width (the demo's shrink overridden back), random
  weights, num_scales cut to DEMO_SCALES: its six sections, five PNGs,
  finite bits/dim, 6 attention launches per counted evaluation and 6
  backward calls per drift evaluation. Returns the launches."""
  import io as stdio
  import numpy as np
  from score_sde_pytorch_tpu_torch import demo
  with tempfile.TemporaryDirectory() as out:
    _reset(attn)
    printed = stdio.StringIO()
    start = time.perf_counter()
    with network_evals(torch) as evals, contextlib.redirect_stdout(printed):
      result = demo.main(["--out", out, "--config.model.nf=128",
                          "--config.model.num_res_blocks=4",
                          f"--config.model.num_scales={DEMO_SCALES}"])
    seconds = time.perf_counter() - start
    launches = _counts(attn)
    pngs = sorted(os.listdir(out))
  lines = printed.getvalue().splitlines()
  for line in lines:
    say(f"[demo] {line}")
  check(pngs == ["colorized.png", "dpmpp_samples.png", "inpainted.png",
                 "ode_samples.png", "pc_samples.png"], f"[demo] PNGs {pngs}")
  check(np.isfinite(result["bpd"]).all(), f"[demo] bits/dim {result['bpd']}")
  check([line.split(":")[0] for line in lines[:4]] == [
      "PC sampling", "ODE sampling", "dpmpp sampling", "bits/dim"],
        f"[demo] printed {lines}")
  drift = result["bpd_nfe"]
  check(launches == {"forward": ATTN_PER_FORWARD * evals[0],
                     "backward": ATTN_PER_FORWARD * drift},
        f"[demo] {evals[0]} evaluations ({drift} drift), launches "
        f"{launches}")
  say(f"[demo] full-width flagship, random weights, num_scales "
      f"{DEMO_SCALES}: {seconds:.1f} s wall; NFE PC {result['pc_nfe']}, "
      f"ODE {result['ode_nfe']}, dpmpp {result['dpmpp_nfe']}, bits/dim "
      f"{drift}; {evals[0]} network evaluations, launches {launches} "
      f"({card_line})")
  return launches["forward"], launches["backward"]


def phase_debug(torch, attn, workdir: str, card_line: str) -> int:
  """[debug]: ``python -m score_sde_pytorch_tpu_torch.debug`` in process on
  [train]'s checkpoint_2 with PYTHONBREAKPOINT=0: the step and finite
  score statistics, one network evaluation. Returns the launches."""
  import io as stdio
  from score_sde_pytorch_tpu_torch import debug
  previous = os.environ.get("PYTHONBREAKPOINT")
  os.environ["PYTHONBREAKPOINT"] = "0"
  printed = stdio.StringIO()
  _reset(attn)
  try:
    with network_evals(torch) as evals, contextlib.redirect_stdout(printed):
      stats = debug.main(
          ["--config", FLAGSHIP, "--workdir", workdir, "--ckpt", "2"]
          + [f"--config.{k}={v}" for k, v in TRAIN_FLAGS.items()])
  finally:
    if previous is None:
      del os.environ["PYTHONBREAKPOINT"]
    else:
      os.environ["PYTHONBREAKPOINT"] = previous
  lines = printed.getvalue().splitlines()
  say(f"[debug] {lines} ({card_line})")
  check(lines[0] == "loaded state at step 20" and stats["step"] == 20
        and math.isfinite(stats["mean"]) and math.isfinite(stats["std"]),
        f"[debug] printed {lines}")
  check(evals[0] == 1 and _counts(attn) == {"forward": ATTN_PER_FORWARD,
                                            "backward": 0},
        f"[debug] {evals[0]} evaluations, launches {_counts(attn)}")
  return ATTN_PER_FORWARD


def phase_stats(torch, base: str, card_line: str) -> None:
  """[stats]: ``python -m score_sde_pytorch_tpu_torch.tools.
  compute_dataset_stats`` in process on [eval]'s ``.npz`` test split with
  its seeded random Inception weights, on the card, into ``assets/stats/``
  of [eval]'s working directory: ``mu`` and ``sigma`` within STATS_TOL of
  those of ``evaluation.run_inception`` on the same images on the card,
  and ``evaluation.load_dataset_stats`` reads the file."""
  import numpy as np
  from score_sde_pytorch_tpu_torch import configs, evaluation
  from score_sde_pytorch_tpu_torch.tools import compute_dataset_stats
  overrides = ["data.dataset=NPZ", f"data.data_dir={base}/data"]
  config = configs.load_config(FLAGSHIP, overrides)
  with np.load(os.path.join(base, "data", "test.npz")) as z:
    images = z["images"]
  cwd = os.getcwd()
  os.environ["INCEPTION_WEIGHTS_NPZ"] = os.path.join(base, "inception.npz")
  os.chdir(base)
  try:
    start = time.perf_counter()
    path = compute_dataset_stats.main(
        ["--config", FLAGSHIP, "--split", "test", "--device", "cuda"]
        + [f"--config.{o}" for o in overrides])
    seconds = time.perf_counter() - start
    stats = evaluation.load_dataset_stats(config)
    evaluation._INCEPTION_CACHE.clear()  # a fresh network for the check
    pool = evaluation.run_inception(images, config, "cuda")["pool_3"]
  finally:
    os.chdir(cwd)
    del os.environ["INCEPTION_WEIGHTS_NPZ"]
    evaluation._INCEPTION_CACHE.clear()
  mu_err = float(np.abs(stats["mu"] - pool.mean(0)).max())
  sigma_err = float(np.abs(stats["sigma"] - np.cov(pool, rowvar=False)).max())
  say(f"[stats] {path} from {images.shape[0]} images on the card: "
      f"{seconds:.1f} s; keys {sorted(stats)}; max |mu - run_inception's| "
      f"{mu_err:.3e}, max |sigma - np.cov| {sigma_err:.3e} (tolerance "
      f"{STATS_TOL:g}) ({card_line})")
  check(sorted(stats) == ["mu", "pool_3", "sigma"]
        and stats["pool_3"].shape == (images.shape[0], 2048)
        and mu_err <= STATS_TOL and sigma_err <= STATS_TOL,
        f"[stats] mu {mu_err:.3e}, sigma {sigma_err:.3e}")


def phase_h100_leaves(torch, attn, card_line: str) -> tuple:
  """[h100-leaves]: each ``configs/h100/`` leaf's train step at its batch,
  full width, through the kernels, timed by the grid tool that chose it
  (``tools/train_step_grid.measure``: one warm-up, then LEAF_STEPS timed
  steps): ms/step, images/s and peak memory against the card's total (at
  most 90%, the leaves' rule); then one profiled step: the device's busy
  time, idle share and kernel families. Returns the launches of the
  warm-up, timed and profiled steps."""
  from torch.profiler import ProfilerActivity, profile
  from score_sde_pytorch_tpu_torch import configs
  from score_sde_pytorch_tpu_torch.tools import train_step_grid
  total = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
  fwd = bwd = 0
  for path, per in H100_LEAVES:
    config = configs.load_config(path)
    batch = config.training.batch_size
    tag = f"[h100-leaves] {os.path.basename(path)}"
    profiled = {}

    def profile_one_step(run_steps):
      with profile(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        run_steps(1)
        profiled["wall_ms"] = (time.perf_counter() - start) * 1e3
      profiled["prof"] = prof

    _reset(attn)
    got = train_step_grid.measure(config, batch, LEAF_STEPS,
                                  after=profile_one_step)
    check(not got.get("oom"), f"{tag} out of memory at batch {batch}")
    launches = _counts(attn)
    ms, peak = got["ms"], got["peak_gib"]
    say(f"{tag} (dtype {config.model.dtype}, remat {config.model.remat}) at "
        f"batch {batch}: {ms:.1f} ms/step = {got['images_per_s']:.2f} "
        f"images/s over {LEAF_STEPS} steps (SM clock {got['sm_mhz']} MHz, "
        f"{got['watts']} W); peak max_memory_allocated {peak:.2f} of "
        f"{total:.2f} GiB ({peak / total:.3f}); launches {launches} in "
        f"{LEAF_STEPS + 2} steps ({card_line})")
    want = per * (LEAF_STEPS + 2)
    check(launches == {"forward": want, "backward": want},
          f"{tag} launches {launches}, want {want} each")
    check(peak <= 0.9 * total, f"{tag} peak {peak:.2f} GiB of {total:.2f}")
    by_kernel = _device_us_by_kernel(profiled.pop("prof"))
    busy_ms = sum(by_kernel.values()) / 1e3
    if busy_ms > 0:
      say(f"{tag} profiled step: device busy {busy_ms:.2f} ms, idle share "
          f"{1 - busy_ms / ms:.3f} of the unprofiled {ms:.1f} ms/step "
          f"({1 - busy_ms / profiled['wall_ms']:.3f} of the profiled step's "
          f"{profiled['wall_ms']:.1f} ms)")
      _report_families(tag, by_kernel, 1, "step")
    else:
      say(f"{tag} profiler: no device time recorded; idle share not "
          "measured")
    fwd += want
    bwd += want
  return fwd, bwd


# --- data: seeded files in the layouts of the real sets ----------------------


def write_image_folder(root: str, splits: dict, size_wh: tuple, fmt: str,
                       seed: int) -> str:
  """``splits[s]`` images of ``size_wh`` (width, height) under
  ``root/<s>/``, JPEG or PNG: smooth random fields with pixel noise (from
  a seed), compressible as photographs are. Returns ``root``."""
  import numpy as np
  from PIL import Image
  rng = np.random.default_rng(seed)
  w, h = size_wh
  ext = {"JPEG": "jpg", "PNG": "png"}[fmt]
  for split, n in splits.items():
    os.makedirs(os.path.join(root, split))
    for i in range(n):
      coarse = rng.integers(0, 256, (h // 32 + 2, w // 32 + 2, 3),
                            dtype=np.uint8)
      img = np.asarray(Image.fromarray(coarse).resize((w, h),
                                                      Image.BICUBIC))
      img = np.clip(img + rng.integers(-16, 17, img.shape), 0, 255)
      Image.fromarray(img.astype(np.uint8)).save(
          os.path.join(root, split, f"{i:06d}.{ext}"), fmt, quality=90)
  return root


def _pb_varint(n: int) -> bytes:
  out = bytearray()
  while True:
    byte, n = n & 0x7F, n >> 7
    out.append(byte | (0x80 if n else 0))
    if not n:
      return bytes(out)


def _pb_bytes(field: int, payload: bytes) -> bytes:
  """A length-delimited protobuf field."""
  return _pb_varint(field << 3 | 2) + _pb_varint(len(payload)) + payload


def tfrecord_example(image_chw) -> bytes:
  """A ``tf.train.Example`` of the FFHQ/CelebAHQ layout: 'shape' (packed
  int64 list) and 'data' (the CHW uint8 bytes)."""
  shape = _pb_bytes(3, _pb_bytes(1, b"".join(
      _pb_varint(int(d)) for d in image_chw.shape)))   # Feature.int64_list
  data = _pb_bytes(1, _pb_bytes(1, image_chw.tobytes()))  # .bytes_list
  entries = b"".join(_pb_bytes(1, _pb_bytes(1, key) + _pb_bytes(2, value))
                     for key, value in ((b"shape", shape), (b"data", data)))
  return _pb_bytes(1, entries)  # Example.features


def write_tfrecords(path: str, images) -> None:
  """CHW uint8 ``images`` as one TFRecord file, framed and checksummed as
  TensorFlow's writer frames them."""
  import struct
  from score_sde_pytorch_tpu_torch.native.crc32c import crc32c, masked
  with open(path, "wb") as f:
    for image in images:
      record = tfrecord_example(image)
      length = struct.pack("<Q", len(record))
      f.write(length + struct.pack("<I", masked(crc32c(length))))
      f.write(record + struct.pack("<I", masked(crc32c(record))))


def write_svhn(root: str, splits: dict, seed: int) -> str:
  """``{train,test}_32x32.mat`` with ``X`` as SVHN stores it (32, 32, 3, N)
  and labels ``y``, through scipy.io.savemat."""
  import numpy as np
  import scipy.io
  rng = np.random.default_rng(seed)
  os.makedirs(root)
  for split, n in splits.items():
    scipy.io.savemat(os.path.join(root, f"{split}_32x32.mat"), {
        "X": rng.integers(0, 256, (32, 32, 3, n), dtype=np.uint8),
        "y": rng.integers(1, 11, (n, 1), dtype=np.uint8)})
  return root


def _resume_skipped(workdir: str, tag: str, train: int, eval_: int) -> None:
  log = open(os.path.join(workdir, "stdout.txt")).read()
  want = [f"Skipped {train} train batches"]
  want += [f"Skipped {eval_} eval batches"] if eval_ else []
  for line in want:
    check(line in log, f"{tag} the resume did not log {line!r}")


def short_train_flags(eval_freq: int = SHORT_STEPS, **data) -> dict:
  """Flags of a short train run: one logged loss per run (two without an
  eval), the eval loss at the run's end where ``eval_freq`` is
  ``SHORT_STEPS``, and checkpoints there; ``data`` as ``key=path``."""
  return dict({"training.n_jitted_steps": 1, "training.n_iters": SHORT_STEPS,
               "training.log_freq": (SHORT_STEPS if eval_freq == SHORT_STEPS
                                     else 1),
               "training.eval_freq": eval_freq,
               "training.snapshot_freq": SHORT_STEPS,
               "training.snapshot_freq_for_preemption": SHORT_STEPS},
              **{f"data.{k}": v for k, v in data.items()})


def phase_data_church(torch, attn, data_root: str, card_line: str) -> tuple:
  """[data-church]: ve/church_ncsnpp_continuous.py (LSUN 256², remat) at
  its batch of 64 on a folder of JPEGs: ``main --mode train`` and a resume
  across an epoch boundary; then the loader alone (decode + resize
  images/s against the step's demand) and ``skip`` over 10⁵ batches.
  Returns the forward and backward launches."""
  import numpy as np
  from score_sde_pytorch_tpu_torch import configs, datasets
  start = time.perf_counter()
  data = write_image_folder(os.path.join(data_root, "church"), CHURCH_SPLITS,
                            CHURCH_JPEG_WH, "JPEG", seed=11)
  say(f"[data-church] {CHURCH_SPLITS} JPEGs of {CHURCH_JPEG_WH[0]}x"
      f"{CHURCH_JPEG_WH[1]} written in {time.perf_counter() - start:.2f} s")
  with tempfile.TemporaryDirectory() as workdir:
    launches = phase_train_run(
        torch, attn, CHURCH_CONFIG, workdir, short_train_flags(data_dir=data),
        HIRES_ATTN_PER_FORWARD, "[data-church]", resume_to=2 * SHORT_STEPS,
        card_line=card_line)
    _resume_skipped(workdir, "[data-church]", SHORT_STEPS, 1)
  config = configs.load_config(CHURCH_CONFIG, [f"data.data_dir={data}"])
  train_it, _ = datasets.get_dataset(config)
  source = train_it.source
  handles = list(source.handles())[:STEP_DEMAND[0]]
  start = time.perf_counter()
  images = [source.decode(h) for h in handles]
  decode_s = time.perf_counter() - start
  check(all(i.shape == (256, 256, 3) for i in images), "church image shape")
  start = time.perf_counter()
  batches = [next(train_it) for _ in range(3)]
  batch_s = time.perf_counter() - start
  check(all(b.shape == (64, 256, 256, 3) and np.isfinite(b).all()
            for b in batches), "church batches")
  demand = STEP_DEMAND[0] / STEP_DEMAND[1]
  say(f"[data-church] loader alone: decode + resize {len(images) / decode_s:.1f}"
      f" images/s on one thread; 3 batches of 64 through the iterator "
      f"(prefetch thread, float32, flips) {3 * 64 / batch_s:.1f} images/s; "
      f"the step's demand {demand:.1f} images/s ({STEP_DEMAND[0]} per "
      f"{STEP_DEMAND[1]} s step) (host CPU; {card_line})")
  fresh, _ = datasets.get_dataset(config)
  start = time.perf_counter()
  fresh.skip(SKIP_BATCHES)
  skip_s = time.perf_counter() - start
  decoded = fresh.decoded
  check(decoded == 0, f"skip decoded {decoded} images")
  after = next(fresh)
  check(after.shape == (64, 256, 256, 3) and np.isfinite(after).all(),
        "the batch after skip")
  say(f"[data-church] skip({SKIP_BATCHES}) on the train stream: "
      f"{skip_s:.3f} s, {decoded} images decoded ({card_line})")
  return launches


def phase_data_ffhq(torch, attn, data_root: str, card_line: str) -> tuple:
  """[data-ffhq]: ve/ffhq_ncsnpp_continuous.py (1024², batch 8, remat) on
  TFRecords of 3x1024x1024 in 2 shards: ``main --mode train`` and a
  resume; the reader's MB/s with the CRC on, the CRC's GB/s. Returns the
  forward and backward launches."""
  import numpy as np
  from score_sde_pytorch_tpu_torch import configs, datasets
  from score_sde_pytorch_tpu_torch.native.crc32c import crc32c
  root = os.path.join(data_root, "ffhq")
  os.makedirs(root)
  rng = np.random.default_rng(13)
  start = time.perf_counter()
  half = FFHQ_RECORDS // 2
  for shard in range(2):
    write_tfrecords(os.path.join(root, f"ffhq-r10-{shard:02d}.tfrecords"),
                    (rng.integers(0, 256, (3, 1024, 1024), dtype=np.uint8)
                     for _ in range(half)))
  say(f"[data-ffhq] {FFHQ_RECORDS} records of 3x1024x1024 in 2 shards "
      f"({sum(os.path.getsize(os.path.join(root, f)) for f in os.listdir(root)) / 1e6:.1f}"
      f" MB) written in {time.perf_counter() - start:.2f} s")
  with tempfile.TemporaryDirectory() as workdir:
    launches = phase_train_run(
        torch, attn, FFHQ_CONFIG, workdir,
        short_train_flags(tfrecords_path=root), HQ1024_ATTN_PER_FORWARD,
        "[data-ffhq]", resume_to=2 * SHORT_STEPS, card_line=card_line)
    _resume_skipped(workdir, "[data-ffhq]", SHORT_STEPS, 1)
  config = configs.load_config(FFHQ_CONFIG, [f"data.tfrecords_path={root}"])
  train_it, _ = datasets.get_dataset(config)
  check(train_it.batches_per_epoch == FFHQ_RECORDS // 8,
        f"[data-ffhq] {train_it.batches_per_epoch} batches per epoch")
  source = train_it.source
  handles = list(source.handles())
  start = time.perf_counter()
  nbytes = sum(source.decode(h).nbytes for h in handles)
  read_s = time.perf_counter() - start
  buf = rng.integers(0, 256, 64 << 20, dtype=np.uint8).tobytes()
  crc32c(buf)
  start = time.perf_counter()
  for _ in range(4):
    crc32c(buf)
  crc_s = (time.perf_counter() - start) / 4
  say(f"[data-ffhq] reader: {len(handles)} records, {nbytes / read_s / 1e6:.1f}"
      f" MB/s (read, both CRCs, Example parse, CHW->HWC) on one thread; "
      f"CRC-32C {len(buf) / crc_s / 1e9:.2f} GB/s (host CPU; {card_line})")
  return launches


def phase_data_celeba(torch, attn, data_root: str, card_line: str) -> tuple:
  """[data-celeba]: ve/celeba_ncsnpp.py (CELEBA 64², SMLD) on PNGs at
  aligned CelebA's 178x218: ``main --mode train`` at its batch of 128 and
  a resume (no eval loss in training: the eval split is read only by the
  eval), then ``main --mode eval`` (the loss over the streamed test split,
  bits/dim over the streamed train split: one integration at batch 128,
  where the test split would be integrated 5 times). Returns the forward
  and backward launches."""
  import numpy as np
  from score_sde_pytorch_tpu_torch import main
  data = write_image_folder(os.path.join(data_root, "celeba"), CELEBA_SPLITS,
                            CELEBA_PNG_WH, "PNG", seed=17)
  flags = short_train_flags(eval_freq=100 * SHORT_STEPS, data_dir=data)
  with tempfile.TemporaryDirectory() as workdir:
    train = phase_train_run(
        torch, attn, CELEBA_CONFIG, workdir, flags, CELEBA_ATTN_PER_FORWARD,
        "[data-celeba]", resume_to=2 * SHORT_STEPS, card_line=card_line)
    _resume_skipped(workdir, "[data-celeba]", SHORT_STEPS, 0)
    overrides = {"data.data_dir": data, "eval.begin_ckpt": 2,
                 "eval.end_ckpt": 2, "eval.batch_size": CELEBA_EVAL_BATCH,
                 "eval.enable_loss": True, "eval.enable_bpd": True,
                 "eval.bpd_dataset": "train", "eval.enable_sampling": False}
    attn.flash_attention_launches = 0
    attn.flash_attention_backward_launches = 0
    start = time.perf_counter()
    (record,) = main.main(["--config", CELEBA_CONFIG, "--workdir", workdir,
                           "--mode", "eval", "--device", "cuda"]
                          + [f"--config.{k}={v}" for k, v in overrides.items()])
    seconds = time.perf_counter() - start
    launches = (attn.flash_attention_launches,
                attn.flash_attention_backward_launches)
    with np.load(os.path.join(workdir, "eval", "train_ckpt_2_bpd.npz")) as z:
      bpd = z["bpd"]
    with np.load(os.path.join(workdir, "eval", "ckpt_2_loss.npz")) as z:
      losses = z["all_losses"]
  test_batches = CELEBA_SPLITS["test"] // CELEBA_EVAL_BATCH
  check(losses.shape == (test_batches,) and np.isfinite(losses).all(),
        f"[data-celeba] eval losses {losses}")
  check(bpd.shape == (CELEBA_SPLITS["train"],) and np.isfinite(bpd).all(),
        f"[data-celeba] bpd shape {bpd.shape}")
  drift_evals = sum(record["bpd_nfe"])
  want = (CELEBA_ATTN_PER_FORWARD * (test_batches + drift_evals),
          CELEBA_ATTN_PER_FORWARD * drift_evals)
  say(f"[data-celeba] main --mode eval on checkpoint_2: {seconds:.1f} s wall;"
      f" eval loss {record['mean_loss']:.6g} over {test_batches} streamed "
      f"batch(es) of {CELEBA_EVAL_BATCH}; bits/dim {record['bpd']:.6f} (the "
      f"train split once), RK45 NFE {record['bpd_nfe']}; launches forward "
      f"{launches[0]}, backward calls {launches[1]} ({card_line})")
  check(launches == want, f"[data-celeba] eval launches {launches}, "
        f"want {want}")
  return train[0] + launches[0], train[1] + launches[1]


def _images_per_s(it, batches: int) -> float:
  for _ in range(2):
    next(it)
  start = time.perf_counter()
  for _ in range(batches):
    batch = next(it)
  seconds = time.perf_counter() - start
  check(batch.dtype.name == "float32" and 0 <= batch.min()
        and batch.max() <= 1, "loader batch out of [0, 1]")
  return batches * batch.shape[0] / seconds


def phase_data_native(data_root: str, card_line: str) -> None:
  """[data-native]: the C++ loader (``loader_backend='native'``, two
  threads) against the python pipeline in images/s: SVHN from a
  ``.mat`` at 32² and batch 128, and the church folder ``in_memory`` at
  256² and batch 64."""
  from score_sde_pytorch_tpu_torch import configs, datasets
  svhn = write_svhn(os.path.join(data_root, "svhn"), SVHN_IMAGES, seed=19)
  cases = [
      ("SVHN 32² batch 128", FLAGSHIP,
       ["data.dataset=SVHN", f"data.data_dir={svhn}",
        "data.uniform_dequantization=True"]),
      ("church in_memory 256² batch 64", CHURCH_CONFIG,
       [f"data.data_dir={os.path.join(data_root, 'church')}"])]
  for label, path, overrides in cases:
    config = configs.load_config(path, overrides)
    config.data.in_memory = True
    rates = {}
    for backend in ("python", "native", "native", "python"):
      config.data.loader_backend = backend
      train_it, _ = datasets.get_dataset(config)
      rates.setdefault(backend, []).append(
          _images_per_s(train_it, NATIVE_BATCHES))
      if backend == "native":
        train_it.close()
    say(f"[data-native] {label}: images/s python "
        f"{[round(r, 1) for r in rates['python']]}, native "
        f"{[round(r, 1) for r in rates['native']]} (in turns; host CPU; "
        f"{card_line})")


# ---------------------------------------------------------------------------
# Data parallelism over torch.distributed: [ddp-2rank], [ddp-nccl], [ddp-cli].
# The ranks are processes of this script, ``--ddp-worker JOB OUT_DIR
# [main's arguments]`` (launch_ranks); each writes its counts and numbers to
# OUT_DIR/rank<r>.json, which the phases read and hold to their gates. The card is one, so NCCL runs at world size 1 and the two-rank
# runs use gloo with both ranks on cuda:0.


def phase_learn(torch, attn, card_line: str) -> tuple:
  """[learn]: the full-width flagship trained by the learning proof's own
  functions at batch 128 for LEARN_STEPS steps on N(0.5, 0.2²) pixels
  (PyTorch's default TF32 settings): the last 10 losses' mean under
  LEARN_LOSS_SHARE x the first step's, the EMA score's rel-L2 against the
  closed form at t = 0.5 and 0.9 under LEARN_REL_BOUND, and 6 forward
  launches and 6 backward calls per train step (as [train]) and 6
  launches per score evaluation. Returns the launch counts."""
  from score_sde_pytorch_tpu_torch.tools import learning_proof as lp
  config = lp.load_config(tiny=False, dtype="float32", seed=lp.SEED)
  proof = lp.Proof(config, "gaussian", "cuda", lp.FULL)
  _reset(attn)
  result = lp.train(proof, LEARN_STEPS // lp.N_INNER, probe_every=0)
  trained = _counts(attn)
  rel = proof.score_rel_err(lp.PROBE_TIMES, seed=42)
  counts = _counts(attn)
  share = result["loss_curve"][-1] / result["first_step_loss"]
  say(f"[learn] {LEARN_STEPS} steps at batch {proof.sizes['batch']}: "
      f"{result['train_s']} s, {result['ms_per_step']} ms/step; first-step "
      f"loss {result['first_step_loss']}, the last 10 steps' mean "
      f"{result['loss_curve'][-1]} ({share:.3f} of it, bound "
      f"{LEARN_LOSS_SHARE}); EMA score rel-L2 {rel} (bounds "
      f"{LEARN_REL_BOUND}); launches {counts} ({card_line})")
  check(share < LEARN_LOSS_SHARE, f"[learn] loss share {share:.3f}")
  for t, bound in LEARN_REL_BOUND.items():
    check(rel[t] < bound, f"[learn] rel-L2 {rel[t]} at t = {t}")
  want = ATTN_PER_FORWARD * LEARN_STEPS
  check(trained == {"forward": want, "backward": want},
        f"[learn] launches {trained} in {LEARN_STEPS} train steps")
  check(counts["forward"] - want == ATTN_PER_FORWARD * len(rel)
        and counts["backward"] == want,
        f"[learn] launches {counts} with {len(rel)} score evaluations")
  return counts["forward"], counts["backward"]


def _counts(attn) -> dict:
  return {"forward": attn.flash_attention_launches,
          "backward": attn.flash_attention_backward_launches}


def _reset(attn) -> None:
  attn.flash_attention_launches = 0
  attn.flash_attention_backward_launches = 0


def _flat_params(torch, model):
  return torch.cat([p.detach().reshape(-1) for p in model.parameters()
                    if p.requires_grad])


def _ranks_equal(torch, flat, group) -> bool:
  """Whether every rank's ``flat`` is bit-equal to rank 0's."""
  import torch.distributed as dist
  from score_sde_pytorch_tpu_torch import parallel
  theirs = flat.clone()
  dist.broadcast(theirs, src=0, group=group)
  return bool(parallel.all_reduce_min(int(torch.equal(theirs, flat)), group))


def _ddp_train_steps(torch, config, state, batches, group) -> tuple:
  """The DDP step (``state["forward"]`` wrapped, or one process with
  ``group=None``) on the rank's rows of ``batches``: the losses and the
  wall ms of the last step."""
  from score_sde_pytorch_tpu_torch import losses, parallel
  from score_sde_pytorch_tpu_torch import sde as sde_lib
  tcfg = config.training
  step_fn = losses.get_step_fn(
      sde_lib.build_sde(config), train=True,
      optimize_fn=losses.optimization_manager(config),
      reduce_mean=tcfg.reduce_mean, continuous=tcfg.continuous,
      likelihood_weighting=tcfg.likelihood_weighting, group=group)
  out, ms = [], 0.0
  for batch in batches:
    torch.cuda.synchronize()
    start = time.perf_counter()
    out.append(float(step_fn(state, parallel.local_rows(batch, group),
                             state["generator"])))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - start) * 1e3
  return out, ms


def _ddp_pair(torch, attn) -> dict:
  """[ddp-2rank] on each of two gloo ranks sharing cuda:0 (TF32 off): (a)
  flagship train steps at the global batch, (b) PC sampling, (c) one RK45
  bits/dim batch, (d) the church NCSN++ with remat; rank 0 also runs (a)-(c)
  as one process for the comparison."""
  import torch.distributed as dist
  from score_sde_pytorch_tpu_torch import (configs, likelihood, losses,
                                           parallel, sampling)
  from score_sde_pytorch_tpu_torch import sde as sde_lib
  from score_sde_pytorch_tpu_torch.models import layers
  from score_sde_pytorch_tpu_torch.models import utils as mutils
  group = parallel.default_group()
  rank = parallel.rank()
  out = {"rank": rank,
         "nvcc_s": attn.kernel_library().build_seconds}
  _tf32_off(torch)

  # (a) Adam moves every weight by ~lr from the first step (warmup off);
  # dropout off, so one process can repeat the global batch's step.
  config = configs.load_config(FLAGSHIP, ["model.dropout=0.0",
                                          "optim.warmup=0"])

  def fresh():
    model = mutils.create_model(config, "cuda",
                                torch.Generator().manual_seed(config.seed))
    return model, losses.init_train_state(config, model, "cuda")

  cuda_gen = torch.Generator(device="cuda")
  batches = [torch.rand(TRAIN_BATCH, 3, 32, 32, device="cuda",
                        generator=cuda_gen.manual_seed(10 + i))
             for i in range(DDP_STEPS)]
  model, state = fresh()
  state["forward"] = parallel.wrap(model, "cuda:0")
  _reset(attn)
  out["train_losses"], out["train_ms"] = _ddp_train_steps(
      torch, config, state, batches, group)
  out["train_launches"] = _counts(attn)
  flat = _flat_params(torch, model)
  out["train_params"] = flat.numel()
  out["train_ranks_equal"] = _ranks_equal(torch, flat, group)
  grads = torch.randn(flat.numel(), device="cuda")
  times = []
  for _ in range(DDP_ALLREDUCE_REPEATS):
    torch.cuda.synchronize()
    start = time.perf_counter()
    dist.all_reduce(grads, group=group)
    torch.cuda.synchronize()
    times.append((time.perf_counter() - start) * 1e3)
  out["allreduce_ms"] = times
  if rank == 0:
    model1, state1 = fresh()
    out["one_losses"], out["one_ms"] = _ddp_train_steps(
        torch, config, state1, batches, None)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    diffs = {n: (a.detach() - b.detach()).abs().max().item()
             for n, a, b in zip(names, (p for p in model.parameters()
                                        if p.requires_grad),
                                (p for p in model1.parameters()
                                 if p.requires_grad))}
    out["train_err"] = max(v for n, v in diffs.items()
                           if not n.endswith("NIN_1.b"))
    out["key_bias_err"] = max(v for n, v in diffs.items()
                              if n.endswith("NIN_1.b"))
    del model1, state1
  del model, state, grads
  parallel.barrier(group)

  # (b), (c): unit gain with the Fourier projection at scale 1, so the
  # integration is well conditioned and few of its steps sit at the
  # acceptance threshold.
  cfg = configs.load_config(FLAGSHIP, [f"model.num_scales={SMOKE_SCALES}"])
  model = mutils.create_model(cfg, "cuda",
                              torch.Generator().manual_seed(cfg.seed))
  unit_gain_(torch, model, layers, seed=cfg.seed)
  with torch.no_grad():
    model.all_modules[0].W.mul_(1 / 16)
  sde = sde_lib.build_sde(cfg)
  shape = (DDP_SAMPLE_BATCH, 32, 32, 3)

  def pc(grp):
    sampler = sampling.get_pc_sampler(
        sde, model, shape, sampling.get_predictor("reverse_diffusion"),
        sampling.get_corrector("langevin"), lambda x: x, snr=cfg.sampling.snr,
        n_steps=1, continuous=True, eps=1e-3, group=grp)
    return sampler(torch.Generator(device="cuda").manual_seed(5))

  data = torch.rand(DDP_SAMPLE_BATCH, 3, 32, 32, device="cuda",
                    generator=cuda_gen.manual_seed(7))

  def bpd(grp):
    fn = likelihood.get_likelihood_fn(sde, model, lambda x: x,
                                      rtol=DDP_ODE_TOL, atol=DDP_ODE_TOL,
                                      group=grp)
    return fn(model, parallel.local_rows(data, grp),
              torch.Generator(device="cuda").manual_seed(6))

  _reset(attn)
  with network_evals(torch) as evals:
    samples, out["pc_nfe"] = pc(group)
  out["pc_evals"], out["pc_launches"] = evals[0], _counts(attn)
  samples = parallel.gather_to_host(samples, group)
  _reset(attn)
  with network_evals(torch) as evals:
    rank_bpd, _, out["bpd_nfe"] = bpd(group)
  out["bpd_evals"], out["bpd_launches"] = evals[0], _counts(attn)
  rank_bpd = parallel.gather_to_host(rank_bpd, group)
  if rank == 0:
    want, out["pc_nfe_one"] = pc(None)
    want = want.cpu()
    out["pc_err"] = ((samples - want).abs().max() / want.abs().max()).item()
    out["pc_finite"] = bool(torch.isfinite(samples).all())
    want_bpd, _, out["bpd_nfe_one"] = bpd(None)
    out["bpd_err"] = (rank_bpd - want_bpd.cpu()).abs().max().item()
    out["bpd"] = rank_bpd.tolist()
  del model
  parallel.barrier(group)

  # (d) the church NCSN++ with remat under DDP.
  config = configs.load_config(CHURCH_CONFIG,
                               [f"training.batch_size={DDP_CHURCH_BATCH}"])
  model = mutils.create_model(config, "cuda",
                              torch.Generator().manual_seed(config.seed))
  state = losses.init_train_state(config, model, "cuda")
  state["forward"] = parallel.wrap(model, "cuda:0")
  size = config.data.image_size
  church = [torch.rand(DDP_CHURCH_BATCH, 3, size, size, device="cuda",
                       generator=cuda_gen.manual_seed(20 + i))
            for i in range(DDP_STEPS)]
  _reset(attn)
  out["church_losses"], out["church_ms"] = _ddp_train_steps(
      torch, config, state, church, group)
  out["church_launches"] = _counts(attn)
  flat = _flat_params(torch, model)
  out["church_finite"] = bool(torch.isfinite(flat).all())
  out["church_ranks_equal"] = _ranks_equal(torch, flat, group)
  return out


def ddp_worker(job: str, out_dir: str, *args) -> int:
  """A rank that launch_ranks started: ``pair`` (the [ddp-2rank] checks on a
  gloo group it joins on cuda:0) or ``cli`` (``main`` with ``args``, which
  joins and leaves the group itself). Writes this rank's counts and numbers
  to ``out_dir/rank<r>.json``."""
  import torch
  from score_sde_pytorch_tpu_torch import parallel
  from score_sde_pytorch_tpu_torch.ops import attention as attn
  rank = int(os.environ["RANK"])
  if job == "pair":
    parallel.init("gloo", "cuda:0")
    try:
      result = _ddp_pair(torch, attn)
    finally:
      parallel.shutdown()
  elif job == "cli":
    from score_sde_pytorch_tpu_torch import main as cli
    start = time.perf_counter()
    with network_evals(torch) as evals:
      returned = cli.main(list(args))
    result = {"evals": evals[0], "launches": _counts(attn),
              "returned": returned, "main_s": time.perf_counter() - start}
  else:
    raise SystemExit(f"unknown --ddp-worker job {job!r}")
  result["worker_s"] = time.perf_counter() - _STARTED
  with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
    json.dump(result, f, default=float)
  return 0


def _free_port() -> int:
  import socket
  with socket.socket() as sock:
    sock.bind(("localhost", 0))
    return sock.getsockname()[1]


def launch_ranks(nproc: int, job: str, out_dir: str, tag: str, args=(),
                 torchrun: bool = False) -> tuple:
  """This script's ``--ddp-worker job`` on ``nproc`` ranks: under
  ``torchrun --standalone``, or (quicker: no launcher process) as
  ``nproc`` processes given the environment torchrun would set. Returns
  each rank's record and the run's wall seconds. A rank that fails or
  outlasts DDP_TIMEOUT fails the smoke, and no rank outlives the call."""
  os.makedirs(out_dir, exist_ok=True)
  for name in os.listdir(out_dir):
    if name.startswith("rank"):
      os.remove(os.path.join(out_dir, name))
  worker = [os.path.abspath(__file__), "--ddp-worker", job, out_dir, *args]
  if torchrun:
    cmds = [([sys.executable, "-m", "torch.distributed.run", "--standalone",
              f"--nproc_per_node={nproc}", *worker], None)]
  else:
    port = str(_free_port())
    cmds = [([sys.executable, *worker],
             dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                  WORLD_SIZE=str(nproc), LOCAL_WORLD_SIZE=str(nproc),
                  MASTER_ADDR="localhost", MASTER_PORT=port))
            for r in range(nproc)]
  start = time.perf_counter()
  procs = [subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
           for cmd, env in cmds]
  try:
    outs = [p.communicate(timeout=DDP_TIMEOUT)[0] for p in procs]
  except subprocess.TimeoutExpired as e:
    raise RuntimeError(f"chip_smoke check failed: {tag} {job} outlasted "
                       f"{DDP_TIMEOUT} s") from e
  finally:
    for p in procs:
      if p.poll() is None:
        p.kill()
        p.wait()
  seconds = time.perf_counter() - start
  for p, out in zip(procs, outs):
    if p.returncode != 0:
      say(out[-6000:])
    check(p.returncode == 0, f"{tag} {job} exited {p.returncode}")
  records = []
  for r in range(nproc):
    with open(os.path.join(out_dir, f"rank{r}.json")) as f:
      records.append(json.load(f))
  return records, seconds


def phase_ddp_pair(card_line: str) -> tuple:
  """[ddp-2rank]: two gloo ranks on cuda:0, started from an empty kernel
  build directory (both build the attention kernels at once). Returns the
  forward and backward launches of both ranks."""
  from score_sde_pytorch_tpu_torch.ops import build
  removed = [p.name for p in build.BUILD_DIR.glob("*.so")]
  for name in removed:
    os.remove(build.BUILD_DIR / name)
  say(f"[ddp-2rank] build directory emptied ({len(removed)} libraries): both "
      "ranks build the attention kernels at once")
  with tempfile.TemporaryDirectory() as out_dir:
    ranks, seconds = launch_ranks(2, "pair", out_dir, "[ddp-2rank]")
  r0 = ranks[0]
  say(f"[ddp-2rank] 2 gloo ranks on cuda:0: {seconds:.1f} s "
      f"wall, the ranks' scripts {[round(r['worker_s'], 1) for r in ranks]} "
      f"s; nvcc per rank {[round(r['nvcc_s'], 2) for r in ranks]} s")
  fwd = bwd = 0
  for r in ranks:
    tag = f"[ddp-2rank] rank {r['rank']}"
    want = ATTN_PER_FORWARD * DDP_STEPS
    check(r["train_launches"] == {"forward": want, "backward": want},
          f"{tag} train launches {r['train_launches']}, want {want} each")
    check(r["pc_evals"] == r["pc_nfe"] == 2 * SMOKE_SCALES
          and r["pc_launches"] == {"forward": ATTN_PER_FORWARD
                                   * r["pc_evals"], "backward": 0},
          f"{tag} PC: {r['pc_evals']} evaluations, NFE {r['pc_nfe']}, "
          f"launches {r['pc_launches']}")
    check(r["bpd_evals"] == r["bpd_nfe"]
          and r["bpd_launches"] == {"forward": ATTN_PER_FORWARD
                                    * r["bpd_nfe"],
                                    "backward": ATTN_PER_FORWARD
                                    * r["bpd_nfe"]},
          f"{tag} bits/dim: {r['bpd_evals']} evaluations, NFE "
          f"{r['bpd_nfe']}, launches {r['bpd_launches']}")
    want = HIRES_ATTN_PER_FORWARD * DDP_STEPS
    check(r["church_launches"] == {"forward": want, "backward": want},
          f"{tag} church launches {r['church_launches']}, want {want} each")
    check(r["train_ranks_equal"] and r["church_ranks_equal"],
          f"{tag}: the ranks' weights differ")
    check(r["church_finite"] and all(math.isfinite(v)
                                     for v in r["church_losses"]),
          f"{tag}: church losses {r['church_losses']}")
    check(r["bpd_nfe"] == r0["bpd_nfe_one"]
          and r["pc_nfe"] == r0["pc_nfe_one"],
          f"{tag}: NFE {r['pc_nfe']}, {r['bpd_nfe']} against one process's "
          f"{r0['pc_nfe_one']}, {r0['bpd_nfe_one']}")
    for key in ("train", "pc", "bpd", "church"):
      fwd += r[f"{key}_launches"]["forward"]
      bwd += r[f"{key}_launches"]["backward"]
    say(f"{tag}: launches forward/backward per rank: train "
        f"{r['train_launches']}, PC {r['pc_launches']} ({r['pc_evals']} "
        f"evaluations), bits/dim {r['bpd_launches']} (NFE {r['bpd_nfe']}), "
        f"church {r['church_launches']}")
  say(f"[ddp-2rank] (a) flagship, {DDP_STEPS} steps at global batch "
      f"{TRAIN_BATCH} ({TRAIN_BATCH // 2} a rank), warmup 0, dropout 0, TF32 off: losses "
      f"{r0['train_losses']} vs one process {r0['one_losses']}; weights "
      f"max |2 ranks - 1 process| {r0['train_err']:.3e} (tolerance "
      f"{DDP_PARAM_TOL:g}; the attention key bias NIN_1.b, whose gradient is "
      f"0 up to rounding, {r0['key_bias_err']:.3e}); ranks bit-equal")
  say(f"[ddp-2rank] (a) step ms: 2 gloo ranks {r0['train_ms']:.2f} vs one "
      f"process at {TRAIN_BATCH} {r0['one_ms']:.2f}; gloo all_reduce of "
      f"{r0['train_params']} fp32 ({r0['train_params'] * 4 / 1e6:.1f} MB) "
      f"{[round(t, 2) for t in r0['allreduce_ms']]} ms ({card_line})")
  say(f"[ddp-2rank] (b) PC at global batch {DDP_SAMPLE_BATCH}, num_scales "
      f"{SMOKE_SCALES}: max |2 ranks - 1 process| / max |samples| "
      f"{r0['pc_err']:.3e} (tolerance {DDP_SAMPLE_RTOL:g}), NFE "
      f"{r0['pc_nfe']} = one process's")
  say(f"[ddp-2rank] (c) bits/dim of {DDP_SAMPLE_BATCH} by RK45 (rtol = atol "
      f"= {DDP_ODE_TOL:g}): NFE {r0['bpd_nfe']} = one process's, max |bpd "
      f"difference| {r0['bpd_err']:.3e} (tolerance {DDP_BPD_TOL:g}); bpd "
      f"{[round(b, 4) for b in r0['bpd']]}")
  say(f"[ddp-2rank] (d) church NCSN++ (remat) {DDP_STEPS} steps at global "
      f"batch {DDP_CHURCH_BATCH}: losses {r0['church_losses']}, last step "
      f"{r0['church_ms']:.1f} ms, ranks bit-equal ({card_line})")
  check(r0["train_err"] <= DDP_PARAM_TOL, f"[ddp-2rank] weights "
        f"{r0['train_err']:.3e} from one process's")
  check(r0["key_bias_err"] <= 2 * DDP_STEPS * 2e-4,
        f"[ddp-2rank] key bias moved {r0['key_bias_err']:.3e}")
  check(all(math.isclose(a, b, rel_tol=1e-5) for a, b in zip(
      r0["train_losses"], r0["one_losses"])), "[ddp-2rank] losses differ")
  check(r0["pc_finite"] and r0["pc_err"] <= DDP_SAMPLE_RTOL,
        f"[ddp-2rank] PC samples {r0['pc_err']:.3e} from one process's")
  check(r0["bpd_err"] <= DDP_BPD_TOL,
        f"[ddp-2rank] bits/dim {r0['bpd_err']:.3e} from one process's")
  return fwd, bwd


def _logged_step_ms(workdir: str) -> dict:
  """``step -> ms`` of the ``training_loss`` lines in stdout.txt."""
  with open(os.path.join(workdir, "stdout.txt")) as f:
    return {int(s): float(v) * 1e3 for s, v in re.findall(
        r"step: (\d+), training_loss: \S+ \((\S+) s/step\)", f.read())}


def phase_ddp_nccl(torch, attn, card_line: str, plain_ms: float) -> tuple:
  """[ddp-nccl]: ``main --mode train`` under torchrun at world size 1 on
  NCCL, the flagship at batch 128: 4 steps with a checkpoint at 4, then a
  resume to 6; its logged ms/step beside the same run's in this process
  without a group and [train]'s ``plain_ms``. Returns the forward and
  backward launches."""
  from score_sde_pytorch_tpu_torch import checkpoint, main
  first, resume = DDP_NCCL_STEPS

  def flags(workdir, n_iters):
    return ["--config", FLAGSHIP, "--workdir", workdir, "--mode", "train",
            f"--config.training.batch_size={TRAIN_BATCH}",
            f"--config.training.n_iters={n_iters}",
            f"--config.training.snapshot_freq={first}",
            f"--config.training.snapshot_freq_for_preemption={first}",
            "--config.training.eval_freq=1000",
            "--config.training.log_freq=1",
            "--config.training.n_jitted_steps=1",
            "--config.training.snapshot_sampling=False"]

  with tempfile.TemporaryDirectory() as workdir:
    _reset(attn)
    main.main(flags(workdir, first))
    check(_counts(attn) == {"forward": ATTN_PER_FORWARD * first,
                            "backward": ATTN_PER_FORWARD * first},
          f"[ddp-nccl] launches without a group {_counts(attn)}")
    fwd, bwd = _counts(attn).values()
    alone = _logged_step_ms(workdir)
  with tempfile.TemporaryDirectory() as workdir:
    out_dir = os.path.join(workdir, "ranks")
    runs = []
    for n_iters in (first, resume):
      args = flags(workdir, n_iters)
      (rec,), seconds = launch_ranks(1, "cli", out_dir, "[ddp-nccl]", args,
                                     torchrun=True)
      say(f"[ddp-nccl] to step {n_iters}: {seconds:.1f} s wall of torchrun, "
          f"of which the rank's script {rec['worker_s']:.1f} s and main "
          f"{rec['main_s']:.1f} s")
      steps = n_iters - rec["returned"]["initial_step"]
      check(rec["evals"] == steps and rec["launches"] == {
          "forward": ATTN_PER_FORWARD * steps,
          "backward": ATTN_PER_FORWARD * steps},
            f"[ddp-nccl] {rec['evals']} evaluations, launches "
            f"{rec['launches']} for {steps} steps")
      fwd += rec["launches"]["forward"]
      bwd += rec["launches"]["backward"]
      runs.append((rec, seconds))
    with open(os.path.join(workdir, "stdout.txt")) as f:
      log = f.read()
    check(f"Starting training loop at step {first}" in log,
          f"[ddp-nccl] the resume did not start at step {first}")
    check(checkpoint.has_numbered(workdir, 1), "[ddp-nccl] checkpoint_1.pth")
    meta = torch.load(checkpoint.meta_path(workdir), map_location="cpu",
                      weights_only=True)
    check(meta["step"] == first and len(meta["rng"]["ranks"]) == 1,
          f"[ddp-nccl] rolling checkpoint at step {meta['step']}")
    ms = _logged_step_ms(workdir)
  steady = sorted(ms[s] for s in range(2, first + 1))
  steady_alone = sorted(alone[s] for s in range(2, first + 1))
  losses = [v for rec, _ in runs for _, v in rec["returned"]["train_losses"]]
  check(len(losses) == resume and all(math.isfinite(v) for v in losses),
        f"[ddp-nccl] losses {losses}")
  say(f"[ddp-nccl] torchrun --nproc_per_node=1, nccl, main --mode train at "
      f"batch {TRAIN_BATCH}: {first} steps in {runs[0][1]:.1f} s wall, the "
      f"resume to {resume} in {runs[1][1]:.1f} s (process start, build and "
      f"checkpoints included); logged ms/step at steps 2-{first} (a loss "
      f"read each step) {[round(v, 2) for v in steady]} (median "
      f"{steady[1]:.2f}) vs the same run in this process without a group "
      f"{[round(v, 2) for v in steady_alone]} (median {steady_alone[1]:.2f})"
      f" and [train]'s step without DDP {plain_ms:.2f} ({card_line})")
  return fwd, bwd


def _write_npz_split(root: str, images: int, size: int) -> str:
  import numpy as np
  os.makedirs(root, exist_ok=True)
  rng = np.random.default_rng(0)
  for split in ("train", "test"):
    np.savez(os.path.join(root, f"{split}.npz"),
             images=rng.integers(0, 256, (images, size, size, 3),
                                 dtype=np.uint8))
  return root


def phase_ddp_cli(card_line: str) -> tuple:
  """[ddp-cli]: two gloo ranks on cuda:0 run the flagship's ``main --mode
  train`` (with rank 0's sample grid), a resume, ``--mode eval`` (loss,
  bits/dim, PC sampling) and ``--mode sample``. Returns the forward and
  backward launches of both ranks."""
  import numpy as np
  fwd = bwd = 0
  common = ["--config", FLAGSHIP, "--device", "cuda:0", "--dist_backend",
            "gloo", f"--config.model.num_scales={DDP_CLI_SCALES}"]
  nfe = 2 * DDP_CLI_SCALES
  with tempfile.TemporaryDirectory() as base:
    workdir, out_dir = os.path.join(base, "run"), os.path.join(base, "ranks")
    data_dir = _write_npz_split(os.path.join(base, "data"), DDP_EVAL_BATCH,
                                32)
    train = ["--mode", "train", "--workdir", workdir,
             f"--config.training.batch_size={TRAIN_BATCH}",
             "--config.training.n_jitted_steps=1",
             "--config.training.log_freq=1", "--config.training.eval_freq=2",
             "--config.training.snapshot_freq=2",
             "--config.training.snapshot_freq_for_preemption=2"]
    runs = [
        ("train", train + ["--config.training.n_iters=2"]),
        ("resume", train + ["--config.training.n_iters=4",
                            "--config.training.snapshot_sampling=False"]),
        ("eval", ["--mode", "eval", "--workdir", workdir,
                  "--config.eval.begin_ckpt=2", "--config.eval.end_ckpt=2",
                  f"--config.eval.batch_size={DDP_EVAL_BATCH}",
                  "--config.eval.enable_loss=True",
                  "--config.eval.enable_bpd=True",
                  "--config.eval.bpd_dataset=train",
                  "--config.eval.enable_sampling=True",
                  f"--config.eval.num_samples={DDP_EVAL_BATCH}",
                  "--config.data.dataset=NPZ",
                  f"--config.data.data_dir={data_dir}"]),
        ("sample", ["--mode", "sample", "--workdir", workdir,
                    "--num_samples", str(DDP_EVAL_BATCH * 3 // 2),
                    f"--config.eval.batch_size={DDP_EVAL_BATCH}"]),
    ]
    for name, args in runs:
      ranks, seconds = launch_ranks(2, "cli", out_dir, "[ddp-cli]",
                                    common + args)
      for r, rec in enumerate(ranks):
        returned = rec["returned"]
        if name in ("train", "resume"):
          steps = 2
          evals = steps + 1 + (nfe if name == "train" and r == 0 else 0)
          backward = steps
        elif name == "eval":
          (record,) = returned
          drift = sum(record["bpd_nfe"])
          evals = 1 + drift + sum(record["sampling_nfe"])
          backward = drift
        else:
          evals, backward = sum(x["nfe"] for x in returned), 0
        check(rec["evals"] == evals and rec["launches"] == {
            "forward": ATTN_PER_FORWARD * evals,
            "backward": ATTN_PER_FORWARD * backward},
              f"[ddp-cli] {name} rank {r}: {rec['evals']} evaluations "
              f"(want {evals}), launches {rec['launches']}")
        fwd += rec["launches"]["forward"]
        bwd += rec["launches"]["backward"]
      say(f"[ddp-cli] {name}: {seconds:.1f} s wall, of which "
          f"the ranks' scripts {[round(r['worker_s'], 1) for r in ranks]} s "
          f"and main {[round(r['main_s'], 1) for r in ranks]} s; per rank "
          f"evaluations {[rec['evals'] for rec in ranks]}, launches "
          f"{[rec['launches'] for rec in ranks]} ({card_line})")
      if name == "resume":
        losses = [r["returned"]["train_losses"] for r in ranks]
        check(losses[0] == losses[1] and len(losses[0]) == 2,
              f"[ddp-cli] the ranks logged {losses}")
    with open(os.path.join(workdir, "stdout.txt")) as f:
      log = f.read()
    check(re.findall(r"Starting training loop at step (\d+)", log)
          == ["0", "2"], "[ddp-cli] the resume did not start at step 2")
    for sub in ("checkpoints-meta/checkpoint.pth",
                "checkpoints/checkpoint_1.pth", "checkpoints/checkpoint_2.pth",
                "samples/iter_2/sample.png", "eval/ckpt_2_loss.npz",
                "eval/train_ckpt_2_bpd.npz"):
      check(os.path.isfile(os.path.join(workdir, sub)), f"[ddp-cli] {sub}")
    grid = np.load(os.path.join(workdir, "samples", "iter_2", "sample.np"))
    check(grid.shape == (TRAIN_BATCH // 2, 32, 32, 3)
          and np.isfinite(grid).all(), f"[ddp-cli] sample grid {grid.shape}")
    with np.load(os.path.join(workdir, "eval", "train_ckpt_2_bpd.npz")) as z:
      check(z["bpd"].shape == (DDP_EVAL_BATCH,)
            and np.isfinite(z["bpd"]).all(), f"[ddp-cli] bpd {z['bpd'].shape}")
    with np.load(os.path.join(workdir, "eval",
                              "ckpt_2_samples_0.npz")) as z:
      check(z["samples"].shape == (DDP_EVAL_BATCH, 32, 32, 3),
            f"[ddp-cli] eval samples {z['samples'].shape}")
    shapes = [np.load(os.path.join(workdir, "generated",
                                   f"samples_{r}.npz"))["samples"].shape
              for r in range(2)]
    check(shapes == [(DDP_EVAL_BATCH, 32, 32, 3),
                     (DDP_EVAL_BATCH // 2, 32, 32, 3)],
          f"[ddp-cli] generated {shapes}")
  return fwd, bwd


def main() -> int:
  import torch
  if not torch.cuda.is_available():
    raise SystemExit("chip_smoke.py needs a CUDA device: "
                     "torch.cuda.is_available() is False")
  from score_sde_pytorch_tpu_torch import configs
  from score_sde_pytorch_tpu_torch import sde as sde_lib
  from score_sde_pytorch_tpu_torch.models import layers
  from score_sde_pytorch_tpu_torch.models import utils as mutils
  from score_sde_pytorch_tpu_torch.ops import attention as attn
  from score_sde_pytorch_tpu_torch.ops import fused_act as act

  card_line = card()
  say(f"[card] {card_line}; torch {torch.__version__}, CUDA "
      f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
  start = time.perf_counter()

  def lap(what: str) -> None:
    say(f"[time] {what} done at {time.perf_counter() - start:.1f} s")

  phase_build(attn, act)

  defaults = _tf32_off(torch)
  record = phase_kernel(torch, attn)
  record_bwd = phase_kernel_bwd(torch, attn)
  record_512 = phase_kernel(torch, attn, ATTN_512_SHAPES, "[kernel-512]")
  record_bwd_512 = phase_kernel_bwd(torch, attn, ATTN_512_SHAPES,
                                    "[kernel-bwd-512]")
  for rec, wide in ((record, record_512), (record_bwd, record_bwd_512)):
    rec["max_abs_err"] = max(rec["max_abs_err"], wide["max_abs_err"])
  phase_kernel_bf16(torch, attn, card_line)
  record_act, record_act_bwd = phase_fused_act(torch, act)
  lap("the kernel phases")

  config = configs.load_config(
      FLAGSHIP, [f"model.num_scales={SMOKE_SCALES}",
                 f"eval.batch_size={SMOKE_BATCH}"])
  model = mutils.create_model(config, "cuda",
                              torch.Generator().manual_seed(config.seed))
  unit_gain_(torch, model, layers, seed=config.seed)
  phase_forward(torch, attn, config, model)
  phase_grad(torch, attn, config, model)
  vp_config = configs.load_config(VP_CONFIG)
  vp_model = mutils.create_model(vp_config, "cuda",
                                 torch.Generator().manual_seed(vp_config.seed))
  unit_gain_(torch, vp_model, layers, seed=vp_config.seed)
  say(f"[vp-forward] {VP_CONFIG[len(ROOT) + 1:]}: "
      f"{sum(p.numel() for p in vp_model.parameters())} parameters")
  phase_forward(torch, attn, vp_config, vp_model, tag="[vp-forward]")
  for sde in (sde_lib.VPSDE(), sde_lib.SubVPSDE()):
    phase_grad(torch, attn, vp_config, vp_model, sde=sde, tag="[vp-grad]")

  # Sampling, training and evaluation run as a user runs them: PyTorch's
  # default TF32 settings.
  _tf32_restore(torch, defaults)
  learn = phase_learn(torch, attn, card_line)
  lap("[learn]")
  launches = phase_sample(torch, attn, config, model, card_line)
  attn.flash_attention_launches = 0
  phase_sample_profile(torch, model, card_line)
  profile_launches = attn.flash_attention_launches
  check(profile_launches == ATTN_PER_FORWARD * PROFILE_SCALES * 2 * 3,
        f"{profile_launches} kernel launches in 3 sampler runs of "
        f"{PROFILE_SCALES * 2} NFE")
  act.fused_leaky_relu_launches = act.fused_leaky_relu_backward_launches = 0
  with tempfile.TemporaryDirectory() as workdir:
    train_fwd, train_bwd, train_ms = phase_train(torch, attn, card_line,
                                                 workdir)
    eval_fwd, eval_bwd = phase_eval(torch, attn, workdir, card_line)
    act_launches = (act.fused_leaky_relu_launches,
                    act.fused_leaky_relu_backward_launches)
    phase_eval_checks(torch, attn, config, model, workdir, card_line)
    debug_fwd = phase_debug(torch, attn, workdir, card_line)
  del model
  lap("[sample], [train], [eval], [stats], [debug]")
  uri = phase_uri(torch, attn, card_line)
  demo = phase_demo(torch, attn, card_line)
  lap("[uri], [demo]")
  ddp = [phase_ddp_pair(card_line),
         phase_ddp_nccl(torch, attn, card_line, train_ms),
         phase_ddp_cli(card_line)]
  lap("[ddp-2rank], [ddp-nccl], [ddp-cli]")
  with tempfile.TemporaryDirectory() as workdir:
    vp_train = phase_vp_train(torch, attn, card_line, workdir)
    vp_sample = phase_main_sample(
        torch, attn, VP_CONFIG, workdir, [f"model.num_scales={SMOKE_SCALES}"],
        ATTN_PER_FORWARD, SMOKE_SCALES, SMOKE_BATCH, "[vp-sample]",
        card_line, rounds=SMOKE_ROUNDS)
    vp_eval = phase_vp_eval(torch, attn, workdir, card_line)
  ddpm_sample = phase_ddpm(torch, attn, card_line)
  samplers = phase_samplers(torch, attn, vp_model, card_line)
  attn.flash_attention_launches = 0
  evals = phase_sample_profile(torch, vp_model, card_line, VP_CONFIG,
                               VP_PROFILE_SCALES, tag="[vp-profile]")
  check(evals == VP_PROFILE_SCALES
        and attn.flash_attention_launches == ATTN_PER_FORWARD * evals * 3,
        f"[vp-profile] {attn.flash_attention_launches} kernel launches in 3 "
        f"sampler runs of {evals} evaluations")
  del vp_model
  lap("the VP phases")
  ddpm256 = phase_ddpm256(torch, attn, card_line)
  lap("[ddpm-256*]")
  hires = phase_hires(torch, attn, card_line)
  lap("[hires-*]")
  hires_1024 = phase_hires_1024(torch, attn, card_line)
  phase_ncsn(torch, attn, card_line)
  lap("[hires-1024], [ncsn*]")
  phase_ncsnv2(torch, attn, card_line)
  lap("[ncsnv2*]")
  bf16_church = phase_bf16_church(torch, attn, card_line)
  bf16_1024 = phase_bf16_1024(torch, attn, card_line)
  leaves = phase_h100_leaves(torch, attn, card_line)
  lap("[bf16-*], [h100-leaves]")
  with tempfile.TemporaryDirectory() as data_root:
    data = [phase_data_church(torch, attn, data_root, card_line)]
    lap("[data-church]")
    data.append(phase_data_ffhq(torch, attn, data_root, card_line))
    lap("[data-ffhq]")
    data.append(phase_data_celeba(torch, attn, data_root, card_line))
    lap("[data-celeba]")
    phase_data_native(data_root, card_line)
    lap("[data-native]")
  # The card's machine has jax installed, so an import of it would not fail;
  # nor would one of the JAX package, which sits beside the port.
  leaked = sorted(m for m in sys.modules if m.split(".")[0] in (
      "jax", "jaxlib", "flax", "score_sde_pytorch_tpu", "tensorflow"))
  check(not leaked, f"the port imported JAX, the JAX package or "
        f"TensorFlow: {leaked[:5]}")

  kernels = [
      ("flash_attention_forward", KERNEL_SOURCE, TPU_KERNEL,
       launches + train_fwd + eval_fwd + vp_train[0] + vp_sample
       + vp_eval[0] + ddpm_sample + samplers + ddpm256[0] + hires[0]
       + hires_1024[0] + bf16_church[0] + bf16_1024[0]
       + sum(d[0] for d in data) + sum(d[0] for d in ddp) + uri[0] + demo[0]
       + debug_fwd + leaves[0] + learn[0], record),
      ("flash_attention_backward", KERNEL_SOURCE, TPU_BWD,
       train_bwd + eval_bwd + vp_train[1] + vp_eval[1] + ddpm256[1]
       + hires[1] + hires_1024[1] + bf16_church[1] + bf16_1024[1]
       + sum(d[1] for d in data) + sum(d[1] for d in ddp) + uri[1] + demo[1]
       + leaves[1] + learn[1], record_bwd),
      # On no model's path: the sample, train and eval runs launch it 0
      # times.
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
  if sys.argv[1:2] == ["--ddp-worker"]:
    sys.exit(ddp_worker(*sys.argv[2:]))
  sys.exit(main())
