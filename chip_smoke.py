#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (score_sde_pytorch_tpu_torch) on one
NVIDIA GPU: every CLI mode, model family, data source and parallel layout
at full width, each held to its gates. Run it from the root of a
checkout:

    python3 chip_smoke.py

It needs a CUDA device, the CUDA toolkit (nvcc) and g++, and imports
nothing of JAX, of the JAX package or of TensorFlow. The kernels alone
are held to their plain versions by the ``cuda``-marked tests
(``pytest tests/test_torch_{attention,fused_act,group_norm,graphs}.py -m
cuda``) and timed by ``python -m score_sde_pytorch_tpu_torch.ops.
bench_kernels``; the benchmark's cells (``bench_port/``) time the train
step and the sampler. This script times nothing. Its phases, each of
which fails the run if it fails (about 14 minutes on one H100):

1. [card] the card's name and power limit, and torch's versions;
2. [forward] (TF32 off) the full-width flagship NCSN++
   (score_sde_pytorch_tpu_torch/configs/ve/cifar10_ncsnpp_continuous.py)
   forward on the card through the kernel against through the plain
   attention, and against the CPU; [grad] one loss of that model (injected
   t and z) and its parameter gradients through the kernels against
   through the plain attention, and the loss against the CPU's;
   [vp-forward], [vp-grad] the same for the full-width DDPM++ of
   configs/vp/cifar10_ddpmpp_continuous.py, a VP and a subVP loss;
3. [learn] (PyTorch's default TF32 settings from here on): the gaussian
   learning proof of score_sde_pytorch_tpu_torch/tools/learning_proof.py
   cut to 500 of its 3000 steps: the flagship at full width and batch 128
   trained on N(0.5, 0.2²) pixels by the tool's own functions, the last
   10 losses' mean under half the first step's, the EMA score's rel-L2
   against the closed form at t = 0.5 and 0.9 under 1.5 x the full run's
   at step 500, and 6 forward and 6 backward attention calls per train
   step;
4. [sample] the user's entry point: a reference-schema checkpoint of the
   flagship in a temporary workdir, then ``main --mode sample`` in process
   at full width (num_scales cut to 25), the samples checked, and the
   kernel launches held to 6 attention calls x NFE x rounds; [sampler] the
   sampler at batch 64 as run_lib builds it: its samples on the card and
   finite, 6 launches per counted evaluation;
5. [train] ``main --mode train`` in process at full width and batch 128
   (10 steps with snapshot sampling, then a resume to step 20), its
   checkpoints, samples, launch counts and replayed resblock graphs;
   [eval] ``main --mode eval`` on the checkpoint that [train] wrote, with
   the eval loss, bits/dim (probability-flow ODE, Hutchinson divergence by
   vjp through both attention kernels) and sampling (the ODE sampler) ->
   InceptionV3 -> FID/IS/KID, on a small ``.npz`` test split, seeded
   random Inception weights and dataset statistics made from that split:
   its files, finite scores and the kernel launches (6 forward and 6
   backward attention calls per drift evaluation of the bits/dim stage);
   [stats] tools/compute_dataset_stats.py on that split with those
   weights, its mu and sigma within 1e-5 of run_inception's on the card;
   [eval-check] with TF32 off, the divergence through the kernels against
   through the plain attention and the card's Inception features against
   the CPU's, the bits/dim with TF32 on and off, and the peak memory of a
   chunked drift evaluation at batch 1024; [debug] debug.py on [train]'s
   checkpoint (PYTHONBREAKPOINT=0), the step and finite score statistics;
6. [uri] ``myfs://`` registered onto a temporary directory, then the
   flagship's ``main --mode train`` at full width and batch 32 on a
   ``myfs://`` workdir (2 steps with snapshot sampling and
   ``training.trace_steps=2``, a traced resume to 4), ``--mode eval`` (the
   loss) and ``--mode sample``: every artifact under the mirror root, none
   under a local ``myfs:``, both traces naming the attention forward and
   backward kernels, and an unregistered ``gs://`` workdir raising before
   any step; [demo] ``score_sde_pytorch_tpu_torch.demo`` at the flagship's
   full width with random weights (num_scales 20): PC, ODE, DPM-Solver++,
   bits/dim, inpainting and colorization, its five PNGs and finite
   bits/dim;
7. data parallelism over torch.distributed, each rank a process of this
   script (``--ddp-worker``) that reports its counts, started by torchrun
   for [ddp-nccl] and with torchrun's environment for the two-rank phases:
   [ddp-2rank] two gloo ranks sharing cuda:0, started from an empty kernel
   build directory (both ranks build at once), TF32 off: (a) 2 flagship
   train steps at global batch 128 held to one process's on the same
   batches (weights within 1e-5, losses within 1e-5 relative) with the
   ranks' weights bit-equal; (b) PC sampling at global batch 16 and (c)
   one RK45 bits/dim batch of 16, each held to one process's (samples
   within 1e-4 of their largest magnitude, bits/dim within 1e-4, the same
   NFE); (d) the church NCSN++ with remat, 2 steps at global batch 4,
   finite and bit-equal across the ranks; [ddp-nccl] ``main --mode
   train`` under torchrun on NCCL at world size 1, the flagship at batch
   128, 4 steps and a resume to 6, and the same 4 steps without a group;
   [ddp-cli] two gloo ranks on the card run the flagship's ``main --mode
   train`` (rank 0's sample grid), a resume, ``--mode eval`` (loss,
   bits/dim, PC sampling; the samples gathered to the whole global batch)
   and ``--mode sample``, each a launch of its own. Every rank's attention
   launches are held to 6 per evaluation (4 on the church) and the
   backward calls to as many per train step and drift evaluation;
   [space-2rank] two gloo ranks on cuda:0 laid out as a (1, 2) grid by
   ``parallel.init_grid``, each image's height split over them, TF32 off:
   the church 256² spatial-sharding file at full width in fp32 at global
   batch 4 (the forward within 1e-4 of one process's, 2 train steps'
   losses within 1e-5 relative, each tensor's gradients within 1e-4 of its
   largest entry or 10 times the distance of the same steps split over the
   batch where that is larger, the weights within 1e-5 where the two runs'
   gradients agree to 10% and within 2 x steps x lr where they do not, an
   eval-loss step, the ranks' weights bit-equal), the same file in bf16 as
   shipped (one step, the loss within 1e-2) and the 1024² file in fp32 at
   batch 2 (the gates of the first); per rank the attention launches at
   the slab's lengths (4 per church forward: three [4, 128 | 256, 256],
   one [4, 8 | 16, 256]; 3 per 1024² forward at C = 512: 128 | 256 and
   32 | 64), peak memory beside one process's, and the halo, gather and
   all-reduce bytes;
8. [vp-train], [vp-sample], [vp-eval]: ``main --mode train`` on the VP
   DDPM++ config at batch 128 (10 steps, Euler-Maruyama snapshot grid),
   ``--mode sample`` and ``--mode eval`` (loss, bits/dim over the one
   batch of the train split) on its checkpoint; [ddpm] the full-width DDPM
   of vp/ddpm/cifar10.py through the kernel against the plain attention
   (TF32 off), then ``main --mode sample`` with ancestral sampling from
   its seeded checkpoint; [samplers] PC reverse diffusion + Langevin, PC
   none + ALD, heun and DPM-Solver++ (deterministic and stochastic) on the
   DDPM++ at batch 64; [vp-sampler] Euler-Maruyama at batch 64 as
   [sampler];
9. [ddpm-256*]: the full-width vp/ddpm/church.py (attention at C = 512):
   forward and DDPM-loss gradient through the kernels against the plain
   attention (TF32 off), ``main --mode train`` at batch 8 for 5 steps and
   ``--mode sample`` (ancestral, num_scales 25) on its checkpoint;
10. [hires-*], [controllable]: the full-width
   ve/church_ncsnpp_continuous.py (output and input pyramids, remat):
   ``main --mode sample``; at unit gain, inpainting and colorization at
   batch 4 (known half and gray channel kept within 1e-3), and the forward
   and gradient through the kernels against the plain attention (TF32
   off); the multiattn file's forward (attention at 32² too); ``main
   --mode train`` at batch 16 (its config: 64) for 2 steps and a resume
   to 4; and the train step's peak memory and launches with remat at
   batch 64 and without it at the largest batch that fits;
11. [hires-1024]: the full-width ve/celebahq_ncsnpp_continuous.py (1024²,
   attention at C = 512): forward through the kernels against the plain
   attention, and the train step with remat at its batch of 8 with its
   peak memory and launches, driven directly; [ncsn*], [ncsnv2*]: NCSN v1
   (ve/ncsn/cifar10.py) and NCSNv2 (ve/ncsnv2/cifar10.py, bedroom.py, an
   ncsnv2_256 override) at full width: forwards against the CPU, ``main
   --mode train`` and ALD ``main --mode sample`` (NCSN v1 at 10 scales x
   10 steps, cut from 100), one sampler step's peak memory at batch 1024
   (30 Langevin steps), the 128² train step;
12. [bf16-church*], [bf16-1024]: the two bf16 files: ``main --mode
   train`` (church at batch 8, its config: 32) and a resume, ``--mode
   sample``, the train step's memory and launches in bf16 and fp32, the
   bf16 forward's distance from fp32; the 1024² remat train step;
   [h100-leaves]: the two configs/h100/ leaves' train steps at their
   batches, their launches and peak memory against the card's total;
13. [data-*]: the data sources, on files written from a seed under a
   temporary directory: [data-church] ve/church_ncsnpp_continuous.py (LSUN
   256²) on a folder of 320x256 JPEGs, ``main --mode train`` at its batch
   of 64 and a resume that skips its streams across an epoch boundary, the
   loader alone and ``skip`` over 10⁵ batches with no image decoded;
   [data-ffhq] ve/ffhq_ncsnpp_continuous.py (1024², batch 8) on TFRecords
   of 3x1024x1024 in 2 shards, train and resume; [data-celeba]
   ve/celeba_ncsnpp.py (CELEBA 64²) on 178x218 PNGs, train and resume at
   batch 32 (config 128), then ``main --mode eval`` with the loss over the
   streamed test split and bits/dim over the streamed train split (one
   batch of 32); [data-native] the C++ loader and the python pipeline on
   SVHN from a ``.mat`` at 32² and the church folder in memory at 256²,
   their batches float32 in [0, 1].

Network evaluations are counted with a forward hook (the PC sampler's NFE
is N·(n_steps + 1) whatever the corrector; the "none" predictor evaluates
nothing), and every run above holds the attention launches
(``kernel.attention.*`` counters of ``utils/tracing.py``) per evaluation
to 6 (NCSN++/DDPM++ at 32², the CelebA NCSN++ at 64²), 4 (the DDPM at
32² and 256², the church NCSN++ in fp32 and bf16), 7 (multiattn), 3
(1024², fp32 and bf16) and 0 (NCSN, NCSNv2), and the backward calls to
as many per train step (remat recomputes the resblocks, not the
attention) and per bits/dim drift evaluation. A train step on one card
without remat replays CUDA graphs of the resblocks (``models/graphs.py``),
captured after one forward without gradient that records their inputs:
the runs add one forward's attention launches per capture, read from the
``graph.capture`` counter.

The last three lines of standard output are the kernels' JSON record
(each kernel's launches in the runs above in this process, and its ms,
plain ms, library ms, bound and largest error at one shape from
``ops/bench_kernels.py``, that error held to the kernel's bound),
the card's ``nvidia-smi`` name and power limit, and ``{"ok": true, ...}``.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import tempfile
from unittest import mock

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
FORWARD_RTOL = 1e-4
GN_SOURCE = "score_sde_pytorch_tpu_torch/ops/csrc/group_norm.cu"
GN_REPLACES = "none: the JAX package's GroupNorm + swish is XLA's"
# GroupNorm calls of one NCSN++ resblock (GroupNorm_0 and GroupNorm_1), the
# blocks that a train step on one card replays as CUDA graphs.
GN_PER_RESBLOCK = 2
# The shape each kernel's row of the closing record is timed at
# (ops/bench_kernels.py): B, N_q, N_kv, C of the attention (sampling at
# 64, training at 128); fused act's and GroupNorm's tensor (cell 3's
# largest GroupNorm call).
RECORD_SHAPES = {"attention_forward": (64, 256, 256, 256),
                 "attention_backward": (128, 256, 256, 256),
                 "fused_act": (128, 256, 16, 16),
                 "group_norm": (1024, 128, 32, 32)}
SAMPLER_BATCH = 64           # [sampler] and [vp-sampler]
SAMPLER_SCALES = 10          # 20 NFE
GRAD_BATCH = 8
GRAD_RTOL = 1e-4
LOSS_RTOL = 1e-5
TRAIN_BATCH = 128
TRAIN_FLAGS = {"training.batch_size": TRAIN_BATCH, "training.log_freq": 5,
               "training.eval_freq": 5,
               "training.snapshot_freq_for_preemption": 5,
               "training.snapshot_freq": 10,
               "model.num_scales": SMOKE_SCALES}
EVAL_BATCH = 32              # eval.batch_size cut from 1024 for the time
EVAL_TRAIN_IMAGES = 64       # the .npz split sizes
DIV_BATCH = 8
DIV_RTOL = 1e-4
INCEPTION_CHECK = 4          # images through the card's and the CPU's
INCEPTION_TOL = 1e-4         # of max |pool_3|
DRIFT_BIG_BATCH = 1024       # the configs' eval.batch_size
VP_TRAIN_STEPS = 10
SAMPLERS_BATCH = 64
SAMPLERS_SCALES = 25         # discrete VP rules need num_scales > beta_max
FLOW_STEPS = 10              # heun and dpmpp steps
VP_SAMPLER_SCALES = 20       # Euler-Maruyama: 20 network evaluations
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
HIRES_TRAIN_BATCH = 16       # [hires-train]'s batch, cut from the config's 64
BF16_TRAIN_BATCH = 8         # [bf16-church-train]'s, cut from the config's 32
DDPM256_TRAIN_BATCH = 8      # a batch that fits without remat (config: 64)
DDPM256_SCALES = 25          # discrete VP rules need num_scales > beta_max
HQ1024_TRAIN_BATCH = 8       # the config's own
NO_REMAT_BATCHES = (32, 24, 16, 8, 4)
NCSN_CONFIG = os.path.join(CONFIGS, "ve", "ncsn", "cifar10.py")
NCSNV2_CONFIG = os.path.join(CONFIGS, "ve", "ncsnv2", "cifar10.py")
BEDROOM_CONFIG = os.path.join(CONFIGS, "ve", "ncsnv2", "bedroom.py")
BF16_CHURCH_CONFIG = os.path.join(CONFIGS, "tpu", "church_256_ncsnpp_tpu.py")
BF16_1024_CONFIG = os.path.join(CONFIGS, "tpu", "celebahq_1024_ncsnpp_tpu.py")
NCSN_SAMPLE_BATCH = 64
NCSN_SAMPLE_STEPS = 10       # ALD steps per scale, cut from 100 for the time
NCSN_STEP_STEPS = 30         # [ncsn-step]'s Langevin steps, cut from 100
NCSN_TRAIN_STEPS = 5         # then a resume to 10
NCSNV2_SCALES = 20           # num_scales cut from 232 for the time
BEDROOM_BATCHES = (128, 64, 32)
V2_256_BATCH = 4
BF16_CHURCH_ATTN = 4         # 3 x [B, 256, 256] and 1 x [B, 16, 256]
BF16_1024_ATTN = 3           # 2 x [B, 256, 512] and 1 x [B, 64, 512]
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
CELEBA_SPLITS = {"train": 32, "test": 32}
CELEBA_PNG_WH = (178, 218)   # aligned CelebA
CELEBA_ATTN_PER_FORWARD = 6  # 4 down blocks at 16², the 8² bottleneck, 1 up
CELEBA_TRAIN_BATCH = 32      # cut from the config's 128
CELEBA_EVAL_BATCH = 32       # each split in one batch (config 1024)
SKIP_BATCHES = 100_000
DDP_STEPS = 2                # [ddp-2rank] train steps (flagship and church)
DDP_SAMPLE_BATCH = 16        # [ddp-2rank] PC and bits/dim: 8 rows a rank
DDP_ODE_TOL = 1e-2           # the bits/dim integration's rtol and atol
DDP_CHURCH_BATCH = 4
DDP_PARAM_TOL = 1e-5         # 2 ranks vs one process after 2 Adam steps
DDP_SAMPLE_RTOL = 1e-4       # of the largest |sample|
DDP_BPD_TOL = 1e-4           # bits/dim, absolute
DDP_NCCL_STEPS = (4, 6)      # [ddp-nccl]: train to 4, resume to 6
DDP_CLI_SCALES = 10          # [ddp-cli] num_scales: 20 NFE a sampler run
DDP_EVAL_BATCH = 32          # [ddp-cli] eval.batch_size, 16 a rank
DDP_TIMEOUT = 600
URI_BATCH = 32               # [uri]: the flagship's train, eval and sample
URI_SCALES = 10              # [uri] snapshot and sample: 20 NFE
DEMO_SCALES = 20             # [demo]: PC, inpainting, colorization 40 NFE
STATS_TOL = 1e-5             # [stats]: mu and sigma against run_inception's
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
# [space-2rank]: the two spatial-sharding files at full width split over a
# (1, 2) grid of gloo ranks on cuda:0, against one process at the same
# global batch. Attention per forward as (q rows, k rows): the church's
# three 16² blocks and its 4² bottleneck, the 1024²'s two 16² blocks and
# its 8² bottleneck, each slab's queries against both ranks' keys.
SPACE_CHURCH_BATCH = 4
SPACE_1024_BATCH = 2
SPACE_STEPS = 2
SPACE_CHURCH_ATTN = [(128, 256)] * 2 + [(8, 16)] + [(128, 256)]
SPACE_1024_ATTN = [(128, 256), (32, 64), (128, 256)]
SPACE_BF16_RTOL = 1e-2       # bf16 loss, 2 ranks vs one process
# Each tensor's step gradients are held to one process's within GRAD_RTOL
# of the tensor's largest entry, or within SPACE_ROUNDING times the
# distance of a third run's from one process's where that is larger: the
# same steps split over the batch instead (DDP over both ranks), whose
# gradients differ from one process's by rounding alone (another order of
# the same fp32 sums; sums that cancel, as a bias's over 262,144 pixels,
# lose the most). Adam's first steps move a weight by about ±lr whatever
# the size of its gradient, so an element whose gradients the split run and
# one process do not agree on to SPACE_AGREE of their size is held to 2 x
# steps x lr, and every other element to DDP_PARAM_TOL.
SPACE_AGREE = 0.1
SPACE_ROUNDING = 10
SVHN_IMAGES = {"train": 4096, "test": 512}


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
    before = _counts()["forward"]
    through_kernel = model(x, labels)
    torch.cuda.synchronize()
    launches = _counts()["forward"] - before
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


def phase_sample(config, model) -> None:
  import numpy as np
  from score_sde_pytorch_tpu_torch import checkpoint, main
  overrides = [f"--config.model.num_scales={SMOKE_SCALES}",
               f"--config.eval.batch_size={SMOKE_BATCH}"]
  say(f"[sample] num_scales cut from 1000 to {SMOKE_SCALES} for the smoke's "
      f"time: NFE {SMOKE_SCALES * 2} per round instead of 2000")
  with tempfile.TemporaryDirectory() as workdir:
    checkpoint.save_checkpoint(checkpoint.numbered_path(workdir, 1), model,
                               config, step=1)
    _reset()
    rounds = main.main(["--config", FLAGSHIP, "--workdir", workdir,
                        "--mode", "sample",
                        "--num_samples", str(SMOKE_BATCH * SMOKE_ROUNDS)]
                       + overrides)
    launches = _counts()["forward"]
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
  say(f"[sample] {SMOKE_ROUNDS} rounds of {SMOKE_BATCH} samples; {launches} "
      f"kernel launches = {ATTN_PER_FORWARD} x NFE {nfe} x {SMOKE_ROUNDS} "
      "rounds")


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

  _reset()
  loss, grads = loss_and_grads()
  torch.cuda.synchronize()
  launches = _counts()["backward"]
  forward_launches = _counts()["forward"]
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


def phase_sampler(torch, model, config_path=FLAGSHIP,
                  scales: int = SAMPLER_SCALES, tag: str = "[sampler]") -> int:
  """The config's sampler at batch 64 over ``scales`` steps, as
  ``run_lib.sample`` builds it with no device given (the model's device):
  its samples on the card and finite. Evaluations are counted, not read
  off the sampler's NFE (the PC sampler reports N·(n_steps + 1) whatever
  its corrector). Returns the evaluations."""
  from score_sde_pytorch_tpu_torch import configs, datasets, sampling
  from score_sde_pytorch_tpu_torch import sde as sde_lib
  config = configs.load_config(config_path, [f"model.num_scales={scales}"])
  size = config.data.image_size
  sampler = sampling.get_sampling_fn(
      config, sde_lib.build_sde(config), model,
      (SAMPLER_BATCH, size, size, config.data.num_channels),
      datasets.get_data_inverse_scaler(config))
  with network_evals(torch) as evals:
    samples, nfe = sampler(torch.Generator(device="cuda").manual_seed(6))
  check(samples.device.type == "cuda", f"{tag} the sampler ran off the card")
  check(bool(torch.isfinite(samples).all()), f"{tag} samples not finite")
  say(f"{tag} {config.sampling.method} {config.sampling.predictor}/"
      f"{config.sampling.corrector} at batch {SAMPLER_BATCH}: {evals[0]} "
      f"network evaluations (reported NFE {nfe})")
  return evals[0]


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


def phase_train(torch, workdir: str) -> None:
  """``main --mode train`` in process at full width in ``workdir``: 10
  steps with a snapshot sample grid, then a resume to step 20: its
  checkpoints, samples, launches and replayed resblock graphs."""
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
  _reset()
  graphs_before = [_graph(n) for n in ("capture", "replay", "eager")]
  runs = []
  for n_iters, sampling_on in ((10, True), (20, False)):
    runs.append(main.main(
        ["--config", FLAGSHIP, "--workdir", workdir, "--mode", "train",
         f"--config.training.n_iters={n_iters}",
         f"--config.training.snapshot_sampling={sampling_on}"] + flags))
  launches = tuple(_counts().values())
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
  captures, replays, eager = (_graph(n) - b for n, b in zip(
      ("capture", "replay", "eager"), graphs_before))
  want = (ATTN_PER_FORWARD * (steps + n_jitted * evals + nfe + captures),
          ATTN_PER_FORWARD * steps)
  say(f"[train] kernel launches: forward {launches[0]} = {ATTN_PER_FORWARD} x "
      f"({steps} train steps + {n_jitted} x {evals} eval calls + {nfe} "
      f"sampling NFE + {captures} graph captures), backward calls "
      f"{launches[1]} = {ATTN_PER_FORWARD} x {steps} train steps; resblock "
      f"graphs: {replays} replayed and {eager} eager calls")
  check(launches == want, f"train launches {launches}, want {want}")
  # One capture per run (a fresh model each), and every resblock call of
  # every train step replayed: the flagship's 44 a forward.
  check((captures, replays, eager) == (len(runs), 44 * steps, 0),
        f"[train] graph captures {captures}, replays {replays}, eager "
        f"calls {eager}, want {len(runs)}, {44 * steps}, 0")


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


def phase_eval(workdir: str) -> None:
  """``main --mode eval`` in process on [train]'s checkpoint_2 with all
  three stages and the ODE sampler, in a working directory that holds the
  dataset statistics (``assets/stats/``), then [stats] on its split."""
  with tempfile.TemporaryDirectory() as base:
    _run_eval(workdir, base)
    phase_stats(base)


def _run_eval(workdir: str, base: str) -> None:
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
    _reset()
    (record,) = main.main(["--config", FLAGSHIP, "--workdir", workdir,
                           "--mode", "eval", "--device", "cuda"]
                          + [f"--config.{k}={v}" for k, v in overrides.items()])
    launches = tuple(_counts().values())
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
  say(f"[eval] main --mode eval: eval loss {record['mean_loss']:.6g}; "
      f"bits/dim {record['bpd']:.6f} (mean of {5 * EVAL_BATCH}), RK45 NFE "
      f"per integration {record['bpd_nfe']}; ODE sampler NFE "
      f"{record['sampling_nfe']} at batch {EVAL_BATCH}; random-weights "
      f"scores {record['scores']}")
  say(f"[eval] kernel launches: forward {launches[0]} = {ATTN_PER_FORWARD} x "
      f"(1 loss batch + {drift_evals} bpd drift evaluations + "
      f"{sum(record['sampling_nfe'])} sampling NFE), backward calls "
      f"{launches[1]} = {ATTN_PER_FORWARD} x {drift_evals} bpd drift "
      f"evaluations")
  check(launches[1] > 0, "no attention backward launch in the bpd stage")
  check(launches == want, f"eval launches {launches}, want {want}")
  check(all(math.isfinite(v) for v in record["scores"].values()),
        f"scores {record['scores']}")


def phase_eval_checks(torch, attn, config, model, workdir: str) -> None:
  """With TF32 off: the divergence of the full-width drift through the
  kernels vs through the plain attention (``model`` at unit gain), and the
  card's Inception features vs the CPU's. Then the bits/dim of one batch
  with TF32 on vs off at one fixed probe, and, at PyTorch's defaults, the
  peak memory of a chunked augmented drift evaluation at batch 1024."""
  import numpy as np
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
    _reset()
    drift_k, div_k = aug(y, 0.5)
    torch.cuda.synchronize()
    bwd = _counts()["backward"]
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
  y, eps = probe(DRIFT_BIG_BATCH)
  with likelihood.frozen(model):
    aug = likelihood.get_augmented_drift(sde, model, eps)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    drift, div = aug(y, 0.5)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
  check(bool(torch.isfinite(div).all()) and drift.shape == y[0].shape,
        "batch-1024 drift evaluation not finite")
  say(f"[eval-check] one augmented drift evaluation at batch "
      f"{DRIFT_BIG_BATCH} in chunks of {likelihood.DRIFT_CHUNK}: peak "
      f"max_memory_allocated {peak / 2 ** 30:.2f} GiB "
      f"({(peak - base) / 2 ** 30:.2f} GiB above the {base / 2 ** 30:.2f} GiB "
      f"held before it)")
  (torch.backends.cuda.matmul.allow_tf32,
   torch.backends.cudnn.allow_tf32) = defaults


def phase_vp_train(torch, workdir: str) -> None:
  """``main --mode train`` in process on the VP DDPM++ config at full width
  and batch 128: VP_TRAIN_STEPS steps with an Euler-Maruyama snapshot grid
  (num_scales 25, one network evaluation a step), its checkpoint and the
  launches checked."""
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
  _reset()
  captured = _graph("capture")
  with network_evals(torch) as evals:
    run = main.main(["--config", VP_CONFIG, "--workdir", workdir,
                     "--mode", "train"]
                    + [f"--config.{k}={v}" for k, v in flags.items()])
  launches = tuple(_counts().values())
  captures = _graph("capture") - captured
  say(f"[vp-train] main --mode train, {VP_TRAIN_STEPS} steps at batch "
      f"{TRAIN_BATCH}, snapshot sampling Euler-Maruyama at num_scales "
      f"{SMOKE_SCALES}: losses {run['train_losses']}, eval "
      f"{run['eval_losses']}")
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
  want = (ATTN_PER_FORWARD * (want_evals + captures),
          ATTN_PER_FORWARD * VP_TRAIN_STEPS)
  say(f"[vp-train] kernel launches: forward {launches[0]} = "
      f"{ATTN_PER_FORWARD} x ({evals[0]} network evaluations ("
      f"{VP_TRAIN_STEPS} train steps + {n_jitted} x {eval_calls} eval calls "
      f"+ {SMOKE_SCALES} sampling) + {captures} graph captures), backward "
      f"calls {launches[1]} = "
      f"{ATTN_PER_FORWARD} x {VP_TRAIN_STEPS} train steps")
  check(evals[0] == want_evals, f"[vp-train] {evals[0]} network "
        f"evaluations, want {want_evals}")
  check(launches == want, f"[vp-train] launches {launches}, want {want}")


def phase_vp_eval(torch, workdir: str) -> None:
  """``main --mode eval`` in process on [vp-train]'s checkpoint_1 with the
  loss and bits/dim stages on the small ``.npz`` test split of [eval]."""
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
    _reset()
    with network_evals(torch) as evals:
      (record,) = main.main(
          ["--config", VP_CONFIG, "--workdir", workdir, "--mode", "eval"]
          + [f"--config.{k}={v}" for k, v in overrides.items()])
  launches = tuple(_counts().values())
  with np.load(os.path.join(workdir, "eval", "train_ckpt_1_bpd.npz")) as z:
    bpd = z["bpd"]
  check(bpd.shape == (EVAL_BATCH,) and np.isfinite(bpd).all(),
        f"[vp-eval] bits/dim {bpd.shape}, finite {np.isfinite(bpd).all()}")
  drift_evals = sum(record["bpd_nfe"])
  check(evals[0] == 1 + drift_evals,
        f"[vp-eval] {evals[0]} network evaluations, want 1 + {drift_evals}")
  want = (ATTN_PER_FORWARD * (1 + drift_evals),
          ATTN_PER_FORWARD * drift_evals)
  say(f"[vp-eval] main --mode eval: eval loss {record['mean_loss']:.6g}; "
      f"bits/dim {record['bpd']:.6f} (mean of {bpd.size}), RK45 NFE per "
      f"integration {record['bpd_nfe']}")
  say(f"[vp-eval] kernel launches: forward {launches[0]} = {ATTN_PER_FORWARD}"
      f" x (1 loss batch + {drift_evals} drift evaluations), backward calls "
      f"{launches[1]} = {ATTN_PER_FORWARD} x {drift_evals}")
  check(launches == want, f"[vp-eval] launches {launches}, want {want}")


def phase_ddpm(torch, attn) -> None:
  """vp/ddpm/cifar10.py at full width: a checkpoint of the seeded model,
  then (TF32 off) the unit-gain forward through the kernel against the
  plain attention and the CPU, then (PyTorch's defaults) ``main --mode
  sample`` with ancestral sampling, 4 attention calls per evaluation."""
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
    phase_main_sample(torch, DDPM_CONFIG, workdir,
                      [f"model.num_scales={SMOKE_SCALES}"],
                      DDPM_ATTN_PER_FORWARD, SMOKE_SCALES, SMOKE_BATCH,
                      "[ddpm]")


def phase_samplers(torch, model) -> None:
  """Every other sampling rule on the VP DDPM++ model at batch 64: finite
  samples, the network evaluations each rule makes, and 6 attention
  launches per evaluation."""
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
  for name, settings, want in cases:
    config = configs.load_config(VP_CONFIG, [f"model.num_scales={n}"] + [
        f"sampling.{key}={value}" for key, value in settings.items()])
    size = config.data.image_size
    sampler = sampling.get_sampling_fn(
        config, sde_lib.build_sde(config), model,
        (SAMPLERS_BATCH, size, size, 3),
        datasets.get_data_inverse_scaler(config))
    _reset()
    with network_evals(torch) as evals:
      samples, nfe = sampler(torch.Generator(device="cuda").manual_seed(11))
    launches = _counts()["forward"]
    say(f"[samplers] {name} at batch {SAMPLERS_BATCH}: reported NFE {nfe}, "
        f"{evals[0]} network evaluations, {launches} kernel launches; "
        f"max|sample| {samples.abs().max().item():.4g}")
    check(bool(torch.isfinite(samples).all()), f"[samplers] {name}: "
          "samples not finite")
    check(evals[0] == want, f"[samplers] {name}: {evals[0]} evaluations, "
          f"want {want}")
    check(launches == ATTN_PER_FORWARD * evals[0],
          f"[samplers] {name}: {launches} launches, want {ATTN_PER_FORWARD}"
          f" x {evals[0]}")


def phase_train_run(torch, config_path: str, workdir: str, flags: dict,
                    per_forward: int, tag: str, resume_to: int = 0) -> None:
  """``main --mode train`` in process with ``flags`` (snapshot sampling
  off), then, with ``resume_to``, a resume to that step: logged losses,
  numbered checkpoints, the resume, the network evaluations (train steps
  and eval forwards; remat recomputes resblocks, not the network) and the
  launches, ``per_forward`` forward launches per evaluation and backward
  calls per train step."""
  from score_sde_pytorch_tpu_torch import checkpoint, configs, main
  from score_sde_pytorch_tpu_torch.models import utils as mutils
  flags = dict(flags, **{"training.snapshot_sampling": False})
  config = configs.load_config(config_path,
                               [f"{k}={v}" for k, v in flags.items()])
  tcfg = config.training
  initial = [p.detach() for p in mutils.create_model(
      config, "cpu", torch.Generator().manual_seed(config.seed)).parameters()
             if p.requires_grad]
  _reset()
  captured = _graph("capture")
  runs = []
  with network_evals(torch) as evals:
    for n_iters in (tcfg.n_iters,) + ((resume_to,) if resume_to else ()):
      runs.append(main.main(
          ["--config", config_path, "--workdir", workdir, "--mode", "train"]
          + [f"--config.{k}={v}" for k, v in flags.items()]
          + [f"--config.training.n_iters={n_iters}"]))
      say(f"{tag} main --mode train to step {n_iters} from step "
          f"{runs[-1]['initial_step']} at batch {tcfg.batch_size} (remat "
          f"{config.model.get('remat', False)}): losses "
          f"{runs[-1]['train_losses']}, eval {runs[-1]['eval_losses']}")
  launches = tuple(_counts().values())
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
  captures = _graph("capture") - captured
  want = (per_forward * (steps + eval_forwards + captures),
          per_forward * steps)
  say(f"{tag} {evals[0]} network evaluations ({steps} train steps + "
      f"{eval_forwards} eval forwards), {captures} resblock graph captures "
      f"(one recording forward each); kernel launches: forward "
      f"{launches[0]}, backward calls {launches[1]} = {per_forward} x "
      f"{steps} train steps")
  check(evals[0] == steps + eval_forwards,
        f"{tag} {evals[0]} network evaluations, want {steps} + "
        f"{eval_forwards}")
  check(launches == want, f"{tag} launches {launches}, want {want}")


def phase_main_sample(torch, config_path: str, workdir: str, overrides: list,
                      per_forward: int, want_evals: int, batch: int, tag: str,
                      rounds: int = 1) -> None:
  """``main --mode sample`` in process on ``workdir``'s latest checkpoint,
  ``rounds`` rounds of ``batch``: the samples, ``want_evals`` counted
  network evaluations per round and ``per_forward`` launches per
  evaluation."""
  import numpy as np
  from score_sde_pytorch_tpu_torch import configs, main
  size = configs.load_config(config_path, overrides).data.image_size
  _reset()
  with network_evals(torch) as evals:
    main.main(["--config", config_path, "--workdir", workdir, "--mode",
               "sample", "--num_samples", str(batch * rounds),
               f"--config.eval.batch_size={batch}"]
              + [f"--config.{o}" for o in overrides])
  launches = _counts()["forward"]
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
  say(f"{tag} main --mode sample ({' '.join(overrides)}): {rounds} "
      f"round(s) of {batch}, {launches} kernel launches = {per_forward} x "
      f"{evals[0]} network evaluations")


def train_step_peak(torch, config, batch_size: int, per_forward: int,
                    tag: str) -> float:
  """Two train steps of ``config`` at ``batch_size`` on the card (the
  first sets up Adam's state), each with ``per_forward`` forward launches
  and backward calls (and one forward's more for each resblock graph
  capture). Returns the peak max_memory_allocated over both, in GiB."""
  torch.cuda.synchronize()
  torch.cuda.empty_cache()
  torch.cuda.reset_peak_memory_stats()
  _reset()
  captured = _graph("capture")
  _train_step(torch, config, batch_size)(2)
  captures = _graph("capture") - captured
  launches = _counts()
  want = {"forward": per_forward * (2 + captures),
          "backward": per_forward * 2}
  check(launches == want, f"{tag} launches in 2 steps {launches}, want "
        f"{want}")
  return torch.cuda.max_memory_allocated() / 2 ** 30


def phase_remat_memory(torch, config) -> None:
  """[hires-memory]: the church train step at its batch of 64 with remat,
  then without remat at the largest batch of NO_REMAT_BATCHES that fits
  (a batch that runs out of device memory is reported and the next smaller
  one tried)."""
  import gc
  from score_sde_pytorch_tpu_torch import configs
  batch = config.training.batch_size
  peak = train_step_peak(torch, config, batch, HIRES_ATTN_PER_FORWARD,
                         "[hires-memory]")
  say(f"[hires-memory] remat on, batch {batch}: peak max_memory_allocated "
      f"{peak:.2f} GiB")
  plain = configs.load_config(CHURCH_CONFIG, ["model.remat=False"])
  for b in NO_REMAT_BATCHES:
    try:
      peak = train_step_peak(torch, plain, b, HIRES_ATTN_PER_FORWARD,
                             "[hires-memory]")
    except torch.cuda.OutOfMemoryError:
      peak = None
    gc.collect()
    torch.cuda.empty_cache()
    if peak is None:
      say(f"[hires-memory] remat off, batch {b}: out of device memory")
      continue
    say(f"[hires-memory] remat off, batch {b} (the largest of "
        f"{NO_REMAT_BATCHES} that fits): peak max_memory_allocated "
        f"{peak:.2f} GiB")
    return
  check(False, f"[hires-memory] no batch of {NO_REMAT_BATCHES} fits "
        "without remat")


def phase_controllable(torch, config, model) -> None:
  """[controllable]: inpainting (the top half known) and colorization of a
  batch at full width with the config's PC sampler at its cut num_scales:
  the known half and the gray channel kept within 1e-3, finite images, and
  the attention launches per counted evaluation."""
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
  for name, run in (
      ("inpaint", lambda: cg.get_pc_inpainter(*args, **kwargs)(gen, data,
                                                               mask)),
      ("colorize", lambda: cg.get_pc_colorizer(*args, **kwargs)(gen, gray))):
    _reset()
    with network_evals(torch) as evals:
      out = run()
    launches = _counts()["forward"]
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
        f"{config.model.num_scales}: {evals[0]} network evaluations, "
        f"{launches} kernel launches; max |kept - given| {err:.3g}")
    check(err <= 1e-3, f"[controllable] {name}: kept region off by {err:.3g}")
    check(evals[0] == want, f"[controllable] {name}: {evals[0]} evaluations, "
          f"want {want}")
    check(launches == HIRES_ATTN_PER_FORWARD * evals[0],
          f"[controllable] {name}: {launches} launches, want "
          f"{HIRES_ATTN_PER_FORWARD} x {evals[0]}")


def phase_hires(torch, attn) -> None:
  """ve/church_ncsnpp_continuous.py at full width (output and input
  pyramids, remat): [hires-sample] from the seeded model's checkpoint;
  then at unit gain [controllable], and with TF32 off [hires-forward] and
  [hires-grad] through the kernels against the plain attention, and the
  multiattn file's forward
  (attention at 32² too); [hires-train] ``main --mode train`` at batch 16
  and a resume; [hires-memory]."""
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
    phase_main_sample(
        torch, CHURCH_CONFIG, workdir, [f"model.num_scales={HIRES_SCALES}"],
        HIRES_ATTN_PER_FORWARD,
        (config.sampling.n_steps_each + 1) * HIRES_SCALES, HIRES_BATCH,
        "[hires-sample]")
  # At its init the network's output convs are zero (init_scale 0), so the
  # Langevin step, scaled by 1/|score|², would throw the unknown channels
  # far out; at unit gain the score has the scale of a trained one.
  unit_gain_(torch, model, layers, seed=config.seed)
  phase_controllable(torch, config, model)
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
    flags = dict(short_train_flags(),
                 **{"training.batch_size": HIRES_TRAIN_BATCH})
    phase_train_run(torch, CHURCH_CONFIG, workdir, flags,
                    HIRES_ATTN_PER_FORWARD, "[hires-train]",
                    resume_to=2 * SHORT_STEPS)
  phase_remat_memory(torch, configs.load_config(CHURCH_CONFIG))


def phase_ddpm256(torch, attn) -> None:
  """vp/ddpm/church.py at full width (attention at C = 512): [ddpm-256]
  the unit-gain forward and a DDPM-loss gradient through the kernels
  against the plain attention (TF32 off); ``main --mode train`` at batch 8
  (no remat in this model) and ``--mode sample`` (ancestral sampling at a
  cut num_scales) on its checkpoint."""
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
    phase_train_run(torch, DDPM256_CONFIG, workdir, flags,
                    DDPM256_ATTN_PER_FORWARD, "[ddpm-256-train]")
    phase_main_sample(
        torch, DDPM256_CONFIG, workdir, [f"model.num_scales={DDPM256_SCALES}"],
        DDPM256_ATTN_PER_FORWARD, DDPM256_SCALES, HIRES_BATCH,
        "[ddpm-256-sample]")


def phase_hires_1024(torch, attn) -> None:
  """ve/celebahq_ncsnpp_continuous.py at full width (1024², attention at
  C = 512): [hires-1024] the unit-gain forward through the kernels against
  the plain attention (TF32 off), then the train step with remat at its
  batch of 8, driven directly (the synthetic split at 1024² is 640 images
  of 3 MB), with its peak memory."""
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
  peak = train_step_peak(torch, config, HQ1024_TRAIN_BATCH,
                         HQ1024_ATTN_PER_FORWARD, "[hires-1024]")
  say(f"[hires-1024] train step with remat at batch {HQ1024_TRAIN_BATCH}: "
      f"peak max_memory_allocated {peak:.2f} GiB")


def _forward_card_vs_cpu(torch, config, model, labels, tag: str,
                         batch: int, cpu_batch: int) -> float:
  """The full-width forward on the card against the CPU forward of the same
  weights (TF32 off), with no attention launch; returns the card's
  output's max |value|."""
  gen = torch.Generator(device="cuda").manual_seed(1)
  size = config.data.image_size
  x = torch.rand(batch, 3, size, size, device="cuda", generator=gen)
  before = _counts()["forward"]
  with torch.no_grad():
    out = model(x, labels)
    torch.cuda.synchronize()
    on_cpu = model.to("cpu")(x[:cpu_batch].cpu(), labels[:cpu_batch].cpu())
  model.to("cuda")
  launches = _counts()["forward"] - before
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


def phase_ncsn(torch) -> None:
  """[ncsn]: ve/ncsn/cifar10.py (NCSN v1, conditional InstanceNorm++, 10
  scales, annealed Langevin dynamics with 100 steps per scale) at full
  width: the forward on the card against the CPU (TF32 off); ``main --mode
  train`` at the config's batch for 5 steps and a resume to 10; ``main
  --mode sample`` at the config's 10 scales x 10 steps (cut from 100) and
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
    phase_train_run(torch, NCSN_CONFIG, workdir, flags, 0, "[ncsn-train]",
                    resume_to=2 * NCSN_TRAIN_STEPS)
    # The "none" predictor evaluates nothing: num_scales x n_steps
    # evaluations under a reported NFE of num_scales x (n_steps + 1).
    phase_main_sample(torch, NCSN_CONFIG, workdir,
                      [f"sampling.n_steps_each={NCSN_SAMPLE_STEPS}"], 0,
                      config.model.num_scales * NCSN_SAMPLE_STEPS,
                      NCSN_SAMPLE_BATCH, "[ncsn-sample]")
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
  with network_evals(torch) as evals:
    samples, nfe = sampler(torch.Generator(device="cuda").manual_seed(9))
  torch.cuda.synchronize()
  step_gib = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
  say(f"[ncsn-step] one sampler step at eval batch {batch}: {evals[0]} "
      f"evaluations; peak max_memory_allocated above the model "
      f"{step_gib:.3f} GiB, one forward alone {forward_gib:.3f} GiB; the "
      f"stacked noise of {n_steps} steps would be {stacked_gib:.3f} GiB")
  check(bool(torch.isfinite(samples).all()) and evals[0] == n_steps,
        f"[ncsn-step] {evals[0]} evaluations, finite "
        f"{bool(torch.isfinite(samples).all())}")
  check(step_gib < forward_gib + stacked_gib / 2,
        f"[ncsn-step] peak {step_gib:.3f} GiB: a stacked noise tensor?")


def phase_ncsnv2(torch) -> None:
  """[ncsnv2]: ve/ncsnv2/cifar10.py (ncsnv2_64) at full width: the forward
  on the card against the CPU (TF32 off), ``main --mode train`` for 5
  steps and ``main --mode sample`` with annealed Langevin dynamics at 20
  scales; ve/ncsnv2/bedroom.py (ncsnv2_128, 128²): the train step at its
  batch of 128 or the largest of BEDROOM_BATCHES that fits, and its peak
  memory; an ncsnv2_256 forward at 256² and batch 4 (the bedroom file
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
    phase_train_run(torch, NCSNV2_CONFIG, workdir, flags, 0,
                    "[ncsnv2-train]")
    phase_main_sample(
        torch, NCSNV2_CONFIG, workdir, [f"model.num_scales={NCSNV2_SCALES}"],
        0, NCSNV2_SCALES * config.sampling.n_steps_each, NCSN_SAMPLE_BATCH,
        "[ncsnv2-sample]")
  bedroom = configs.load_config(BEDROOM_CONFIG)
  for b in BEDROOM_BATCHES:
    try:
      peak = train_step_peak(torch, bedroom, b, 0, "[ncsnv2-bedroom]")
    except torch.cuda.OutOfMemoryError:
      peak = None
    gc.collect()
    torch.cuda.empty_cache()
    if peak is None:
      say(f"[ncsnv2-bedroom] train step at batch {b}: out of device memory")
      continue
    say(f"[ncsnv2-bedroom] {BEDROOM_CONFIG[len(ROOT) + 1:]} (ncsnv2_128, "
        f"128²) train step at batch {b} (the config's: "
        f"{bedroom.training.batch_size}): peak max_memory_allocated "
        f"{peak:.2f} GiB")
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


def phase_bf16_church(torch) -> None:
  """[bf16-church]: tpu/church_256_ncsnpp_tpu.py (model.dtype bfloat16,
  remat, batch 32) at full width: ``main --mode train`` at batch 8 for 2
  steps and a resume to 4 (4 forward launches and 4 backward calls per
  step), then ``main --mode sample`` (PC, num_scales 10, batch 4) on its
  checkpoint; the train step's peak memory and launches at batch 32,
  beside the fp32 file's at the same batch; and at unit gain, the bf16
  forward's relative L2 distance from the fp32 forward of the same
  weights, with its 4 launches."""
  from score_sde_pytorch_tpu_torch import configs
  from score_sde_pytorch_tpu_torch.models import layers
  from score_sde_pytorch_tpu_torch.models import utils as mutils
  config = configs.load_config(BF16_CHURCH_CONFIG)
  with tempfile.TemporaryDirectory() as workdir:
    flags = dict(short_train_flags(),
                 **{"training.batch_size": BF16_TRAIN_BATCH})
    phase_train_run(torch, BF16_CHURCH_CONFIG, workdir, flags,
                    BF16_CHURCH_ATTN, "[bf16-church-train]",
                    resume_to=2 * SHORT_STEPS)
    phase_main_sample(
        torch, BF16_CHURCH_CONFIG, workdir,
        [f"model.num_scales={HIRES_SCALES}"], BF16_CHURCH_ATTN,
        (config.sampling.n_steps_each + 1) * HIRES_SCALES, HIRES_BATCH,
        "[bf16-church-sample]")
  batch = config.training.batch_size
  for cfg, what in ((config, "bf16"), (configs.load_config(
      BF16_CHURCH_CONFIG, ["model.dtype=float32"]), "fp32")):
    peak = train_step_peak(torch, cfg, batch, BF16_CHURCH_ATTN,
                           f"[bf16-church] {what}")
    say(f"[bf16-church] train step with remat at batch {batch}, {what}: "
        f"peak max_memory_allocated {peak:.2f} GiB")
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
    _reset()
    out16 = models[0](x, labels)
    launches = _counts()["forward"]
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


def phase_bf16_1024(torch) -> None:
  """[bf16-1024]: tpu/celebahq_1024_ncsnpp_tpu.py (bf16, remat) at full
  width, the train step at its batch of 8, driven directly as
  [hires-1024]'s is: peak memory, 3 forward launches and 3 backward calls
  per step."""
  from score_sde_pytorch_tpu_torch import configs
  config = configs.load_config(BF16_1024_CONFIG)
  peak = train_step_peak(torch, config, config.training.batch_size,
                         BF16_1024_ATTN, "[bf16-1024]")
  say(f"[bf16-1024] {BF16_1024_CONFIG[len(ROOT) + 1:]} train step with "
      f"remat at batch {config.training.batch_size}, bf16: peak "
      f"max_memory_allocated {peak:.2f} GiB")


# --- the peripherals: URI workdirs, trace, demo, debug, stats, H100 leaves --


def phase_uri(torch) -> None:
  """[uri]: ``myfs://`` registered onto a temporary directory
  (``utils.io.LocalMirrorHandler``), then the flagship's ``main --mode
  train`` at full width and batch URI_BATCH on ``myfs://bucket/wd``: 2
  steps with snapshot sampling and ``training.trace_steps=2``, a resume to
  4 (traced too), ``--mode eval`` (the loss) and ``--mode sample`` (one
  round). Every artifact must be under the mirror root and none under a
  local ``myfs:``; the traces must name the attention kernels; an
  unregistered ``gs://`` workdir must raise before any step."""
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
  cwd = os.getcwd()
  with tempfile.TemporaryDirectory() as base:
    root, local_cwd = os.path.join(base, "mirror"), os.path.join(base, "cwd")
    os.makedirs(local_cwd)
    os.chdir(local_cwd)
    io.register_scheme("myfs", io.LocalMirrorHandler("myfs", root))
    try:
      _reset()
      try:
        main.main(["--config", FLAGSHIP, "--workdir", "gs://bucket/wd",
                   "--mode", "train"])
        raised = ""
      except ValueError as e:
        raised = str(e)
      check("register_scheme" in raised
            and _counts() == {"forward": 0, "backward": 0}
            and not os.listdir(local_cwd),
            f"[uri] an unregistered gs:// workdir: {raised!r}, launches "
            f"{_counts()}, {os.listdir(local_cwd)} in the working "
            "directory")
      say(f"[uri] gs:// without a handler raised before any step: {raised}")
      for name, args, steps in runs:
        _reset()
        captured = _graph("capture")
        with network_evals(torch) as evals:
          main.main(common + args)
        launches = _counts()
        captures = _graph("capture") - captured
        say(f"[uri] {name} on {wd}: {evals[0]} network evaluations, "
            f"{captures} resblock graph captures, launches {launches}")
        check(evals[0] > 0 and launches == {
            "forward": ATTN_PER_FORWARD * (evals[0] + captures),
            "backward": ATTN_PER_FORWARD * steps},
              f"[uri] {name}: {evals[0]} evaluations, launches {launches}")
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
    say(f"[uri] under the mirror root: {found}")


def phase_demo(torch) -> None:
  """[demo]: ``python -m score_sde_pytorch_tpu_torch.demo`` in process at
  the flagship's full width (the demo's shrink overridden back), random
  weights, num_scales cut to DEMO_SCALES: its six sections, five PNGs,
  finite bits/dim, 6 attention launches per counted evaluation and 6
  backward calls per drift evaluation."""
  import io as stdio
  import numpy as np
  from score_sde_pytorch_tpu_torch import demo
  with tempfile.TemporaryDirectory() as out:
    _reset()
    printed = stdio.StringIO()
    with network_evals(torch) as evals, contextlib.redirect_stdout(printed):
      result = demo.main(["--out", out, "--config.model.nf=128",
                          "--config.model.num_res_blocks=4",
                          f"--config.model.num_scales={DEMO_SCALES}"])
    launches = _counts()
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
      f"{DEMO_SCALES}: NFE PC {result['pc_nfe']}, ODE {result['ode_nfe']}, "
      f"dpmpp {result['dpmpp_nfe']}, bits/dim {drift}; {evals[0]} network "
      f"evaluations, launches {launches}")


def phase_debug(torch, workdir: str) -> None:
  """[debug]: ``python -m score_sde_pytorch_tpu_torch.debug`` in process on
  [train]'s checkpoint_2 with PYTHONBREAKPOINT=0: the step and finite
  score statistics, one network evaluation."""
  import io as stdio
  from score_sde_pytorch_tpu_torch import debug
  previous = os.environ.get("PYTHONBREAKPOINT")
  os.environ["PYTHONBREAKPOINT"] = "0"
  printed = stdio.StringIO()
  _reset()
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
  say(f"[debug] {lines}")
  check(lines[0] == "loaded state at step 20" and stats["step"] == 20
        and math.isfinite(stats["mean"]) and math.isfinite(stats["std"]),
        f"[debug] printed {lines}")
  check(evals[0] == 1 and _counts() == {"forward": ATTN_PER_FORWARD,
                                            "backward": 0},
        f"[debug] {evals[0]} evaluations, launches {_counts()}")


def phase_stats(base: str) -> None:
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
    path = compute_dataset_stats.main(
        ["--config", FLAGSHIP, "--split", "test", "--device", "cuda"]
        + [f"--config.{o}" for o in overrides])
    stats = evaluation.load_dataset_stats(config)
    evaluation._INCEPTION_CACHE.clear()  # a fresh network for the check
    pool = evaluation.run_inception(images, config, "cuda")["pool_3"]
  finally:
    os.chdir(cwd)
    del os.environ["INCEPTION_WEIGHTS_NPZ"]
    evaluation._INCEPTION_CACHE.clear()
  mu_err = float(np.abs(stats["mu"] - pool.mean(0)).max())
  sigma_err = float(np.abs(stats["sigma"] - np.cov(pool, rowvar=False)).max())
  say(f"[stats] {path} from {images.shape[0]} images on the card: keys "
      f"{sorted(stats)}; max |mu - run_inception's| {mu_err:.3e}, max "
      f"|sigma - np.cov| {sigma_err:.3e} (tolerance {STATS_TOL:g})")
  check(sorted(stats) == ["mu", "pool_3", "sigma"]
        and stats["pool_3"].shape == (images.shape[0], 2048)
        and mu_err <= STATS_TOL and sigma_err <= STATS_TOL,
        f"[stats] mu {mu_err:.3e}, sigma {sigma_err:.3e}")


def phase_h100_leaves(torch) -> None:
  """[h100-leaves]: each ``configs/h100/`` leaf's train step at its batch,
  full width, through the kernels: two steps, their launches, and the
  peak memory against the card's total (at most 90%, the leaves' rule)."""
  from score_sde_pytorch_tpu_torch import configs
  total = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
  for path, per in H100_LEAVES:
    config = configs.load_config(path)
    batch = config.training.batch_size
    tag = f"[h100-leaves] {os.path.basename(path)}"
    before = {k: _graph(k) for k in ("capture_refused", "capture_failed")}
    peak = train_step_peak(torch, config, batch, per, tag)
    refused, failed = (_graph(k) - n for k, n in before.items())
    say(f"{tag} (dtype {config.model.dtype}, remat {config.model.remat}) at "
        f"batch {batch}: peak max_memory_allocated {peak:.2f} of "
        f"{total:.2f} GiB ({peak / total:.3f}); resblock graph captures "
        f"refused {refused}, failed {failed}")
    check(peak <= 0.9 * total, f"{tag} peak {peak:.2f} GiB of {total:.2f}")


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


def phase_data_church(torch, data_root: str) -> None:
  """[data-church]: ve/church_ncsnpp_continuous.py (LSUN 256², remat) at
  its batch of 64 on a folder of JPEGs: ``main --mode train`` and a resume
  across an epoch boundary; then the loader alone (decode + resize, and
  batches through the iterator) and ``skip`` over 10⁵ batches."""
  import numpy as np
  from score_sde_pytorch_tpu_torch import configs, datasets
  data = write_image_folder(os.path.join(data_root, "church"), CHURCH_SPLITS,
                            CHURCH_JPEG_WH, "JPEG", seed=11)
  with tempfile.TemporaryDirectory() as workdir:
    phase_train_run(
        torch, CHURCH_CONFIG, workdir, short_train_flags(data_dir=data),
        HIRES_ATTN_PER_FORWARD, "[data-church]", resume_to=2 * SHORT_STEPS)
    _resume_skipped(workdir, "[data-church]", SHORT_STEPS, 1)
  config = configs.load_config(CHURCH_CONFIG, [f"data.data_dir={data}"])
  train_it, _ = datasets.get_dataset(config)
  source = train_it.source
  images = [source.decode(h) for h in list(source.handles())[:64]]
  check(all(i.shape == (256, 256, 3) for i in images), "church image shape")
  batches = [next(train_it) for _ in range(3)]
  check(all(b.shape == (64, 256, 256, 3) and np.isfinite(b).all()
            for b in batches), "church batches")
  fresh, _ = datasets.get_dataset(config)
  fresh.skip(SKIP_BATCHES)
  decoded = fresh.decoded
  check(decoded == 0, f"skip decoded {decoded} images")
  after = next(fresh)
  check(after.shape == (64, 256, 256, 3) and np.isfinite(after).all(),
        "the batch after skip")
  say(f"[data-church] {CHURCH_SPLITS} JPEGs of {CHURCH_JPEG_WH[0]}x"
      f"{CHURCH_JPEG_WH[1]}: {len(images)} decoded alone and 3 batches of 64 "
      f"through the iterator; skip({SKIP_BATCHES}) on the train stream "
      f"decoded {decoded} images")


def phase_data_ffhq(torch, data_root: str) -> None:
  """[data-ffhq]: ve/ffhq_ncsnpp_continuous.py (1024², batch 8, remat) on
  TFRecords of 3x1024x1024 in 2 shards: ``main --mode train`` and a
  resume, and the batches of an epoch."""
  import numpy as np
  from score_sde_pytorch_tpu_torch import configs, datasets
  root = os.path.join(data_root, "ffhq")
  os.makedirs(root)
  rng = np.random.default_rng(13)
  half = FFHQ_RECORDS // 2
  for shard in range(2):
    write_tfrecords(os.path.join(root, f"ffhq-r10-{shard:02d}.tfrecords"),
                    (rng.integers(0, 256, (3, 1024, 1024), dtype=np.uint8)
                     for _ in range(half)))
  say(f"[data-ffhq] {FFHQ_RECORDS} records of 3x1024x1024 in 2 shards")
  with tempfile.TemporaryDirectory() as workdir:
    phase_train_run(
        torch, FFHQ_CONFIG, workdir, short_train_flags(tfrecords_path=root),
        HQ1024_ATTN_PER_FORWARD, "[data-ffhq]", resume_to=2 * SHORT_STEPS)
    _resume_skipped(workdir, "[data-ffhq]", SHORT_STEPS, 1)
  config = configs.load_config(FFHQ_CONFIG, [f"data.tfrecords_path={root}"])
  train_it, _ = datasets.get_dataset(config)
  check(train_it.batches_per_epoch == FFHQ_RECORDS // 8,
        f"[data-ffhq] {train_it.batches_per_epoch} batches per epoch")


def phase_data_celeba(torch, data_root: str) -> None:
  """[data-celeba]: ve/celeba_ncsnpp.py (CELEBA 64², SMLD) on PNGs at
  aligned CelebA's 178x218: ``main --mode train`` at batch 32 (its
  config: 128) and
  a resume (no eval loss in training: the eval split is read only by the
  eval), then ``main --mode eval`` (the loss over the streamed test split,
  bits/dim over the streamed train split: one integration at batch 32,
  where the test split would be integrated 5 times)."""
  import numpy as np
  from score_sde_pytorch_tpu_torch import main
  data = write_image_folder(os.path.join(data_root, "celeba"), CELEBA_SPLITS,
                            CELEBA_PNG_WH, "PNG", seed=17)
  flags = dict(short_train_flags(eval_freq=100 * SHORT_STEPS, data_dir=data),
               **{"training.batch_size": CELEBA_TRAIN_BATCH})
  with tempfile.TemporaryDirectory() as workdir:
    phase_train_run(torch, CELEBA_CONFIG, workdir, flags,
                    CELEBA_ATTN_PER_FORWARD, "[data-celeba]",
                    resume_to=2 * SHORT_STEPS)
    _resume_skipped(workdir, "[data-celeba]", SHORT_STEPS, 0)
    overrides = {"data.data_dir": data, "eval.begin_ckpt": 2,
                 "eval.end_ckpt": 2, "eval.batch_size": CELEBA_EVAL_BATCH,
                 "eval.enable_loss": True, "eval.enable_bpd": True,
                 "eval.bpd_dataset": "train", "eval.enable_sampling": False}
    _reset()
    (record,) = main.main(["--config", CELEBA_CONFIG, "--workdir", workdir,
                           "--mode", "eval", "--device", "cuda"]
                          + [f"--config.{k}={v}" for k, v in overrides.items()])
    launches = tuple(_counts().values())
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
  say(f"[data-celeba] main --mode eval on checkpoint_2: eval loss "
      f"{record['mean_loss']:.6g} over {test_batches} streamed batch(es) of "
      f"{CELEBA_EVAL_BATCH}; bits/dim {record['bpd']:.6f} (the train split "
      f"once), RK45 NFE {record['bpd_nfe']}; launches forward "
      f"{launches[0]}, backward calls {launches[1]}")
  check(launches == want, f"[data-celeba] eval launches {launches}, "
        f"want {want}")


def phase_data_native(data_root: str) -> None:
  """[data-native]: the C++ loader (``loader_backend='native'``, two
  threads) and the python pipeline: SVHN from a ``.mat`` at 32² and batch
  128, and the church folder ``in_memory`` at 256² and batch 64, each
  batch float32 in [0, 1]."""
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
    for backend in ("python", "native"):
      config.data.loader_backend = backend
      train_it, _ = datasets.get_dataset(config)
      for _ in range(3):
        batch = next(train_it)
        check(batch.dtype.name == "float32" and 0 <= batch.min()
              and batch.max() <= 1, f"[data-native] {label} {backend}: "
              "loader batch out of [0, 1]")
      if backend == "native":
        train_it.close()
    say(f"[data-native] {label}: python and native batches float32 in "
        "[0, 1]")


# ---------------------------------------------------------------------------
# Data parallelism over torch.distributed: [ddp-2rank], [ddp-nccl], [ddp-cli].
# The ranks are processes of this script, ``--ddp-worker JOB OUT_DIR
# [main's arguments]`` (launch_ranks); each writes its counts and numbers to
# OUT_DIR/rank<r>.json, which the phases read and hold to their gates. The card is one, so NCCL runs at world size 1 and the two-rank
# runs use gloo with both ranks on cuda:0.


def phase_learn() -> None:
  """[learn]: the full-width flagship trained by the learning proof's own
  functions at batch 128 for LEARN_STEPS steps on N(0.5, 0.2²) pixels
  (PyTorch's default TF32 settings): the last 10 losses' mean under
  LEARN_LOSS_SHARE x the first step's, the EMA score's rel-L2 against the
  closed form at t = 0.5 and 0.9 under LEARN_REL_BOUND, and 6 forward
  launches and 6 backward calls per train step (as [train]) and 6
  launches per score evaluation."""
  from score_sde_pytorch_tpu_torch.tools import learning_proof as lp
  config = lp.load_config(tiny=False, dtype="float32", seed=lp.SEED)
  proof = lp.Proof(config, "gaussian", "cuda", lp.FULL)
  _reset()
  captured = _graph("capture")
  result = lp.train(proof, LEARN_STEPS // lp.N_INNER, probe_every=0)
  trained = _counts()
  recorded = ATTN_PER_FORWARD * (_graph("capture") - captured)
  rel = proof.score_rel_err(lp.PROBE_TIMES, seed=42)
  counts = _counts()
  share = result["loss_curve"][-1] / result["first_step_loss"]
  say(f"[learn] {LEARN_STEPS} steps at batch {proof.sizes['batch']}: "
      f"first-step loss {result['first_step_loss']}, the last 10 steps' "
      f"mean {result['loss_curve'][-1]} ({share:.3f} of it, bound "
      f"{LEARN_LOSS_SHARE}); EMA score rel-L2 {rel} (bounds "
      f"{LEARN_REL_BOUND}); launches {counts}")
  check(share < LEARN_LOSS_SHARE, f"[learn] loss share {share:.3f}")
  for t, bound in LEARN_REL_BOUND.items():
    check(rel[t] < bound, f"[learn] rel-L2 {rel[t]} at t = {t}")
  want = ATTN_PER_FORWARD * LEARN_STEPS
  check(trained == {"forward": want + recorded, "backward": want},
        f"[learn] launches {trained} in {LEARN_STEPS} train steps and "
        f"{recorded} in graph captures")
  check(counts["forward"] - want - recorded == ATTN_PER_FORWARD * len(rel)
        and counts["backward"] == want,
        f"[learn] launches {counts} with {len(rel)} score evaluations")


# The kernels' counters of ``utils/tracing.py``, one per kernel and path.
KERNEL_COUNTERS = ("kernel.attention.fwd", "kernel.attention.bwd",
                   "kernel.fused_act.fwd", "kernel.fused_act.bwd",
                   "kernel.group_norm.onchip_fwd",
                   "kernel.group_norm.onchip_bwd",
                   "kernel.group_norm.split_fwd",
                   "kernel.group_norm.split_bwd")
# The attention counters at the last _reset(): forward launches and
# backward calls.
_ATTENTION = {"forward": "kernel.attention.fwd",
              "backward": "kernel.attention.bwd"}
_ZERO = dict.fromkeys(_ATTENTION, 0)


def _counts() -> dict:
  """The attention launches since the last :func:`_reset`."""
  from score_sde_pytorch_tpu_torch.utils import tracing
  return {k: tracing.count_of(name) - _ZERO[k]
          for k, name in _ATTENTION.items()}


def _reset() -> None:
  from score_sde_pytorch_tpu_torch.utils import tracing
  _ZERO.update({k: tracing.count_of(name) for k, name in _ATTENTION.items()})


def _graph(name: str) -> int:
  """The count of ``graph.<name>`` (``models/graphs.py``). Each capture of
  a model's resblock graphs (``graph.capture``) begins with one forward
  without gradient that records the blocks' inputs: one forward's
  attention launches more than the train steps ask for."""
  from score_sde_pytorch_tpu_torch.utils import tracing
  return tracing.count_of(f"graph.{name}")


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


def _ddp_train_steps(config, state, batches, group) -> list:
  """The DDP step (``state["forward"]`` wrapped, or one process with
  ``group=None``) on the rank's rows of ``batches``: the losses."""
  from score_sde_pytorch_tpu_torch import losses, parallel
  from score_sde_pytorch_tpu_torch import sde as sde_lib
  tcfg = config.training
  step_fn = losses.get_step_fn(
      sde_lib.build_sde(config), train=True,
      optimize_fn=losses.optimization_manager(config),
      reduce_mean=tcfg.reduce_mean, continuous=tcfg.continuous,
      likelihood_weighting=tcfg.likelihood_weighting, group=group)
  return [float(step_fn(state, parallel.local_rows(batch, group),
                        state["generator"])) for batch in batches]


def _ddp_pair(torch) -> dict:
  """[ddp-2rank] on each of two gloo ranks sharing cuda:0 (TF32 off): (a)
  flagship train steps at the global batch, (b) PC sampling, (c) one RK45
  bits/dim batch, (d) the church NCSN++ with remat; rank 0 also runs (a)-(c)
  as one process for the comparison."""
  from score_sde_pytorch_tpu_torch import (configs, likelihood, losses,
                                           parallel, sampling)
  from score_sde_pytorch_tpu_torch import sde as sde_lib
  from score_sde_pytorch_tpu_torch.models import layers
  from score_sde_pytorch_tpu_torch.models import utils as mutils
  group = parallel.default_group()
  rank = parallel.rank()
  out = {"rank": rank}
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
  _reset()
  out["train_losses"] = _ddp_train_steps(config, state, batches, group)
  out["train_launches"] = _counts()
  flat = _flat_params(torch, model)
  out["train_ranks_equal"] = _ranks_equal(torch, flat, group)
  if rank == 0:
    model1, state1 = fresh()
    out["one_losses"] = _ddp_train_steps(config, state1, batches, None)
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
  del model, state
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

  _reset()
  with network_evals(torch) as evals:
    samples, out["pc_nfe"] = pc(group)
  out["pc_evals"], out["pc_launches"] = evals[0], _counts()
  samples = parallel.gather_to_host(samples, group)
  _reset()
  with network_evals(torch) as evals:
    rank_bpd, _, out["bpd_nfe"] = bpd(group)
  out["bpd_evals"], out["bpd_launches"] = evals[0], _counts()
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
  _reset()
  out["church_losses"] = _ddp_train_steps(config, state, church, group)
  out["church_launches"] = _counts()
  flat = _flat_params(torch, model)
  out["church_finite"] = bool(torch.isfinite(flat).all())
  out["church_ranks_equal"] = _ranks_equal(torch, flat, group)
  return out


def _space_compare(torch, got: dict, want: dict, other: list,
                   lr: float) -> dict:
  """The split run's (``got``) step gradients and weights against one
  process's (``want``), per tensor and step, beside ``other``, the batch
  split's gradients (see SPACE_ROUNDING). The attention's key bias NIN_1.b,
  whose gradient is 0 up to rounding (a shift of every key leaves the
  softmax as it is), is held to the weights' gap bound alone, as in
  [ddp-2rank]."""
  out = {"param_err": 0.0, "exempt_gap": 0.0, "exempt": 0,
         "exempt_other": 0, "elements": 0,
         "gap_bound": 2 * len(want["grads"]) * lr}
  worst = []
  for i, name in enumerate(got["names"]):
    gap = (got["params"][i] - want["params"][i]).abs()
    out["elements"] += gap.numel()
    if name.endswith("NIN_1.b"):
      out["exempt"] += gap.numel()
      out["exempt_gap"] = max(out["exempt_gap"], gap.max().item())
      continue
    agree = torch.ones_like(gap, dtype=torch.bool)
    agree_other = torch.ones_like(agree)
    for a, b, c in zip((g[i] for g in got["grads"]),
                       (g[i] for g in want["grads"]),
                       (g[i] for g in other)):
      scale = b.abs().max().item() or 1.0
      err = (a - b).abs().max().item() / scale
      floor = (c - b).abs().max().item() / scale
      worst.append((err / max(GRAD_RTOL, SPACE_ROUNDING * floor), name, err,
                    floor))
      agree &= (a - b).abs() <= SPACE_AGREE * b.abs()
      agree_other &= (c - b).abs() <= SPACE_AGREE * b.abs()
    if agree.any():
      out["param_err"] = max(out["param_err"], gap[agree].max().item())
    if not agree.all():
      out["exempt"] += int((~agree).sum())
      out["exempt_gap"] = max(out["exempt_gap"], gap[~agree].max().item())
    out["exempt_other"] += int((~agree_other).sum())
  worst.sort(key=lambda w: -w[0])
  out["grad_ratio"] = worst[0][0]
  out["worst_grads"] = [w[1:] for w in worst[:3]]
  out["largest_grads"] = [w[1:] for w in sorted(worst,
                                                key=lambda w: -w[2])[:3]]
  return out


def _space_run(torch, attn, config_path: str, overrides: list, batch: int,
               steps: int, data, space, regroup: bool = True) -> dict:
  """One spatial-sharding file on this rank's slab of a (1, 2) grid: the
  forward (the slabs gathered) and ``steps`` train steps and an eval-loss
  step (DDP over the world, the rank's slab of each global batch, t and z
  drawn globally), with their attention launches (and the kernels'
  shapes), the space collectives' bytes and the peak memory;
  with ``regroup``, both ranks then take the same steps split over the
  batch instead; rank 0 then repeats it all as one process on the whole
  batch (each run's model freed first, so its peak is its own)."""
  import torch.distributed as dist
  from score_sde_pytorch_tpu_torch import configs, losses, parallel
  from score_sde_pytorch_tpu_torch import sde as sde_lib
  from score_sde_pytorch_tpu_torch.models import utils as mutils
  from score_sde_pytorch_tpu_torch.parallel import spatial
  config = configs.load_config(config_path, overrides)
  size = config.data.image_size
  gen = torch.Generator(device="cuda")
  trainable = lambda model: [p for p in model.parameters() if p.requires_grad]
  x = torch.rand(batch, 3, size, size, device="cuda",
                 generator=gen.manual_seed(30))
  t = torch.exp(torch.linspace(math.log(0.05), math.log(
      config.model.sigma_max), batch, device="cuda"))
  batches = [torch.rand(batch, 3, size, size, device="cuda",
                        generator=gen.manual_seed(40 + i))
             for i in range(steps)]
  tcfg = config.training
  sde = sde_lib.build_sde(config)
  shapes = []
  launch = attn._launch_flash_attention

  def recording(q, k, v, with_lse=False):
    shapes.append([q.shape[1], k.shape[1], q.shape[0], q.shape[2]])
    return launch(q, k, v, with_lse)

  def train(split: bool) -> dict:
    """The forward and the steps, split over the grid or as one process."""
    model = mutils.create_model(config, "cuda",
                                torch.Generator().manual_seed(config.seed))
    state = losses.init_train_state(config, model, "cuda")
    grid = dict(group=data, space_group=space) if split else {}
    cut = ((lambda b: spatial.split_rows(parallel.local_rows(b, data),
                                         space)) if split else (lambda b: b))
    kwargs = dict(reduce_mean=tcfg.reduce_mean, continuous=tcfg.continuous,
                  likelihood_weighting=tcfg.likelihood_weighting, **grid)
    step_fn = losses.get_step_fn(
        sde, train=True, optimize_fn=losses.optimization_manager(config),
        **kwargs)
    eval_fn = losses.get_step_fn(sde, train=False, **kwargs)
    rec = {}
    _reset()
    shapes.clear()
    with torch.no_grad(), spatial.sharded(space if split else None):
      out = model.eval()(cut(x), t)
      rec["forward"] = (spatial.gather_rows(out, space) if split
                        else out).cpu()
    torch.cuda.synchronize()
    rec["forward_launches"], rec["forward_shapes"] = _counts(), list(
        shapes)
    model.train()
    if split:
      state["forward"] = parallel.wrap(model, "cuda:0")
    del out
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset()
    shapes.clear()
    spatial.reset_counts()
    rec["losses"], rec["grads"] = [], []
    for b in batches:
      rec["losses"].append(float(step_fn(state, cut(b), state["generator"])))
      # The step's gradient (DDP's mean over the ranks under the split).
      rec["grads"].append([p.grad.detach().cpu() for p in trainable(model)])
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    rec["step_launches"], rec["step_shapes"] = _counts(), list(shapes)
    rec["comm"] = spatial.counts()
    rec["eval_loss"] = float(eval_fn(state, cut(batches[0]),
                                     state["generator"]))
    rec["names"] = [n for n, p in model.named_parameters() if p.requires_grad]
    flat = _flat_params(torch, model)
    rec["finite"] = bool(torch.isfinite(flat).all())
    if split:
      rec["ranks_equal"] = _ranks_equal(torch, flat, dist.group.WORLD)
    rec["params"] = [p.detach().cpu() for p in trainable(model)]
    del model, state, flat
    torch.cuda.empty_cache()
    return rec

  def regrouped() -> list:
    """The steps' gradients with DDP over both ranks, each taking half of
    every global batch at full height."""
    world = dist.group.WORLD
    model = mutils.create_model(config, "cuda",
                                torch.Generator().manual_seed(config.seed))
    state = losses.init_train_state(config, model, "cuda")
    state["forward"] = parallel.wrap(model, "cuda:0")
    step_fn = losses.get_step_fn(
        sde, train=True, optimize_fn=losses.optimization_manager(config),
        reduce_mean=tcfg.reduce_mean, continuous=tcfg.continuous,
        likelihood_weighting=tcfg.likelihood_weighting, group=world)
    grads = []
    for b in batches:
      step_fn(state, parallel.local_rows(b, world), state["generator"])
      grads.append([p.grad.detach().cpu() for p in trainable(model)])
    del model, state
    torch.cuda.empty_cache()
    return grads

  attn._launch_flash_attention = recording
  try:
    got = train(True)
    other = regrouped() if regroup else None
    parallel.barrier(dist.group.WORLD)
    if parallel.rank() == 0:
      want = train(False)
      got["forward_err"] = ((got["forward"] - want["forward"]).abs().max()
                            / want["forward"].abs().max()).item()
      got.update(_space_compare(torch, got, want, other or want["grads"],
                                config.optim.lr))
      got["one"] = {k: want[k] for k in ("losses", "peak_gib",
                                         "eval_loss", "forward_launches",
                                         "step_launches")}
    parallel.barrier(dist.group.WORLD)
  finally:
    attn._launch_flash_attention = launch
  for key in ("forward", "params", "names", "grads"):
    del got[key]
  return got


def _space_pair(torch, attn) -> dict:
  """[space-2rank] on each of two gloo ranks sharing cuda:0, laid out as a
  (1, 2) grid (TF32 off): (a) the church file at full width in fp32, (b)
  the same in bf16, as shipped, (c) the 1024² file in fp32."""
  from score_sde_pytorch_tpu_torch import parallel
  data, space = parallel.init_grid(2)
  _tf32_off(torch)
  fp32 = ["model.dtype=float32", "model.dropout=0.0", "optim.warmup=0"]
  return {
      "rank": parallel.rank(),
      "church": _space_run(torch, attn, BF16_CHURCH_CONFIG, fp32,
                           SPACE_CHURCH_BATCH, SPACE_STEPS, data, space),
      "bf16": _space_run(torch, attn, BF16_CHURCH_CONFIG, [],
                         SPACE_CHURCH_BATCH, 1, data, space, regroup=False),
      "hq1024": _space_run(torch, attn, BF16_1024_CONFIG, fp32,
                           SPACE_1024_BATCH, 1, data, space)}


def ddp_worker(job: str, out_dir: str, *args) -> int:
  """A rank that launch_ranks started: ``pair`` (the [ddp-2rank] checks on a
  gloo group it joins on cuda:0), ``space`` (the [space-2rank] checks, the
  same way) or ``cli`` (``main`` with ``args``, which joins and leaves the
  group itself). Writes this rank's counts and numbers to
  ``out_dir/rank<r>.json``."""
  import torch
  from score_sde_pytorch_tpu_torch import parallel
  from score_sde_pytorch_tpu_torch.ops import attention as attn
  rank = int(os.environ["RANK"])
  if job in ("pair", "space"):
    parallel.init("gloo", "cuda:0")
    try:
      result = (_ddp_pair(torch) if job == "pair"
                else _space_pair(torch, attn))
    finally:
      parallel.shutdown()
  elif job == "cli":
    from score_sde_pytorch_tpu_torch import main as cli
    with network_evals(torch) as evals:
      returned = cli.main(list(args))
    result = {"evals": evals[0], "launches": _counts(),
              "returned": returned}
  else:
    raise SystemExit(f"unknown --ddp-worker job {job!r}")
  with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
    json.dump(result, f, default=float)
  return 0


def _free_port() -> int:
  import socket
  with socket.socket() as sock:
    sock.bind(("localhost", 0))
    return sock.getsockname()[1]


def launch_ranks(nproc: int, job: str, out_dir: str, tag: str, args=(),
                 torchrun: bool = False) -> list:
  """This script's ``--ddp-worker job`` on ``nproc`` ranks: under
  ``torchrun --standalone``, or (quicker: no launcher process) as
  ``nproc`` processes given the environment torchrun would set. Returns
  each rank's record. A rank that fails or outlasts DDP_TIMEOUT fails the smoke, and no rank
  outlives the call."""
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
  for p, out in zip(procs, outs):
    if p.returncode != 0:
      say(out[-6000:])
    check(p.returncode == 0, f"{tag} {job} exited {p.returncode}")
  records = []
  for r in range(nproc):
    with open(os.path.join(out_dir, f"rank{r}.json")) as f:
      records.append(json.load(f))
  return records


def phase_ddp_pair() -> None:
  """[ddp-2rank]: two gloo ranks on cuda:0, started from an empty kernel
  build directory (both build the attention kernels at once)."""
  from score_sde_pytorch_tpu_torch.ops import build
  removed = [p.name for p in build.BUILD_DIR.glob("*.so")]
  for name in removed:
    os.remove(build.BUILD_DIR / name)
  say(f"[ddp-2rank] build directory emptied ({len(removed)} libraries): both "
      "ranks build the attention kernels at once")
  with tempfile.TemporaryDirectory() as out_dir:
    ranks = launch_ranks(2, "pair", out_dir, "[ddp-2rank]")
  r0 = ranks[0]
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
  say(f"[ddp-2rank] (b) PC at global batch {DDP_SAMPLE_BATCH}, num_scales "
      f"{SMOKE_SCALES}: max |2 ranks - 1 process| / max |samples| "
      f"{r0['pc_err']:.3e} (tolerance {DDP_SAMPLE_RTOL:g}), NFE "
      f"{r0['pc_nfe']} = one process's")
  say(f"[ddp-2rank] (c) bits/dim of {DDP_SAMPLE_BATCH} by RK45 (rtol = atol "
      f"= {DDP_ODE_TOL:g}): NFE {r0['bpd_nfe']} = one process's, max |bpd "
      f"difference| {r0['bpd_err']:.3e} (tolerance {DDP_BPD_TOL:g}); bpd "
      f"{[round(b, 4) for b in r0['bpd']]}")
  say(f"[ddp-2rank] (d) church NCSN++ (remat) {DDP_STEPS} steps at global "
      f"batch {DDP_CHURCH_BATCH}: losses {r0['church_losses']}, ranks "
      "bit-equal")
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


def phase_space_pair() -> None:
  """[space-2rank]: two gloo ranks on cuda:0 split each image's height
  (``parallel.init_grid(2)``: a (1, 2) grid), TF32 off. Each file against
  one process at the same global batch on the same seeds: (a) the church
  256² spatial-sharding file at full width in fp32 (remat as shipped),
  the forward within 1e-4 of one process's (relative to its largest
  magnitude), 2 train steps' losses within 1e-5 relative, gradients and
  weights per tensor as SPACE_ROUNDING says, the ranks' weights bit-equal, the
  eval-loss step within 1e-5; (b) the same file in bf16 as shipped, one step, finite, the loss
  within 1e-2 relative; (c) the 1024² file in fp32 with remat at global
  batch 2, the forward and one step to (a)'s gates. Every rank's attention
  launches are held to the files' counts at the slab's lengths (N_q = N /
  2 queries against N keys), the backward calls to as many per step."""
  with tempfile.TemporaryDirectory() as out_dir:
    ranks = launch_ranks(2, "space", out_dir, "[space-2rank]")
  runs = (("church", "(a) church 256² fp32", SPACE_CHURCH_BATCH,
           SPACE_CHURCH_ATTN, 256, SPACE_STEPS),
          ("bf16", "(b) church 256² bf16", SPACE_CHURCH_BATCH,
           SPACE_CHURCH_ATTN, 256, 1),
          ("hq1024", "(c) 1024² fp32", SPACE_1024_BATCH, SPACE_1024_ATTN, 512,
           1))
  for key, what, batch, attn_rows, c, steps in runs:
    want_rows = [[q, k, batch, c] for q, k in attn_rows]
    for r in ranks:
      run = r[key]
      tag = f"[space-2rank] {what} rank {r['rank']}"
      check(run["forward_shapes"] == want_rows,
            f"{tag}: forward attention at (N_q, N_kv, B, C) "
            f"{run['forward_shapes']}, want {want_rows}")
      check(run["step_shapes"] == want_rows * steps,
            f"{tag}: train attention at {run['step_shapes']}")
      n = len(attn_rows)
      check(run["forward_launches"] == {"forward": n, "backward": 0}
            and run["step_launches"] == {"forward": n * steps,
                                         "backward": n * steps},
            f"{tag}: launches {run['forward_launches']}, "
            f"{run['step_launches']}")
      check(run["finite"] and all(math.isfinite(v) for v in run["losses"]),
            f"{tag}: losses {run['losses']}")
      check(run["ranks_equal"], f"{tag}: the ranks' weights differ")
    r0 = ranks[0][key]
    one = r0["one"]
    comm = r0["comm"]
    say(f"[space-2rank] {what} at global batch {batch} (every row on both "
        f"ranks, half its height each): forward max |2 ranks - 1 process| / "
        f"max |out| {r0['forward_err']:.3e}; losses {r0['losses']} vs one "
        f"process {one['losses']}; eval loss {r0['eval_loss']} vs "
        f"{one['eval_loss']}; ranks bit-equal")
    if key != "bf16":
      say(f"[space-2rank] {what}: step gradients per tensor and step, max "
          f"|diff| / max |g| against one process's (split over the height; "
          f"split over the batch), the largest "
          f"{[(n, f'{e:.3e}', f'{f:.3e}') for n, e, f in r0['largest_grads']]}"
          f", furthest from the gate "
          f"{[(n, f'{e:.3e}', f'{f:.3e}') for n, e, f in r0['worst_grads']]}"
          f": {r0['grad_ratio']:.3f} of the allowance max({GRAD_RTOL:g}, "
          f"{SPACE_ROUNDING} x the batch split's); weights max |diff| "
          f"{r0['param_err']:.3e} where every step's gradients agree to "
          f"{SPACE_AGREE:g}; {r0['exempt']} of {r0['elements']} elements "
          f"(the key bias NIN_1.b and those whose gradients do not agree; "
          f"{r0['exempt_other']} under the batch split) up to "
          f"{r0['exempt_gap']:.3e} apart (bound {r0['gap_bound']:.1e})")
    say(f"[space-2rank] {what}: peak max_memory_allocated per rank "
        f"{[round(r[key]['peak_gib'], 3) for r in ranks]} GiB vs one process "
        f"{one['peak_gib']:.3f} GiB; per step on rank 0: halo "
        f"{comm['halo_bytes'] / steps / 1e6:.2f} MB, gather "
        f"{comm['gather_bytes'] / steps / 1e6:.2f} MB, all-reduce "
        f"{comm['reduce_bytes'] / steps / 1e6:.3f} MB, replicated ops "
        f"{comm['replicated_ops']}")
    say(f"[space-2rank] {what}: attention per forward per rank at "
        f"(N_q, N_kv, B, C) {r0['forward_shapes']}; launches forward "
        f"{r0['forward_launches']}, train {r0['step_launches']} (one process "
        f"{one['step_launches']})")
    if key == "bf16":
      check(all(math.isclose(a, b, rel_tol=SPACE_BF16_RTOL)
                for a, b in zip(r0["losses"], one["losses"])),
            f"[space-2rank] {what}: losses {r0['losses']} vs {one['losses']}")
      continue
    check(r0["forward_err"] <= FORWARD_RTOL,
          f"[space-2rank] {what}: forward {r0['forward_err']:.3e} from one "
          "process's")
    check(all(math.isclose(a, b, rel_tol=LOSS_RTOL) for a, b in zip(
        r0["losses"] + [r0["eval_loss"]], one["losses"] + [one["eval_loss"]])),
          f"[space-2rank] {what}: losses differ")
    check(r0["grad_ratio"] <= 1,
          f"[space-2rank] {what}: step gradients {r0['worst_grads'][0]} "
          f"from one process's: {r0['grad_ratio']:.3f} of the allowance")
    check(r0["param_err"] <= DDP_PARAM_TOL,
          f"[space-2rank] {what}: weights {r0['param_err']:.3e} from one "
          "process's where the gradients agree")
    check(r0["exempt_gap"] <= r0["gap_bound"],
          f"[space-2rank] {what}: where the gradients do not agree, weights "
          f"{r0['exempt_gap']:.3e} apart (bound {r0['gap_bound']:.1e})")


def phase_ddp_nccl(torch) -> None:
  """[ddp-nccl]: ``main --mode train`` under torchrun at world size 1 on
  NCCL, the flagship at batch 128: 4 steps with a checkpoint at 4, then a
  resume to 6; and the same 4 steps in this process without a group."""
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
    _reset()
    captured = _graph("capture")
    main.main(flags(workdir, first))
    captures = _graph("capture") - captured
    check(_counts() == {"forward": ATTN_PER_FORWARD * (first + captures),
                        "backward": ATTN_PER_FORWARD * first},
          f"[ddp-nccl] launches without a group {_counts()}")
  with tempfile.TemporaryDirectory() as workdir:
    out_dir = os.path.join(workdir, "ranks")
    losses = []
    for n_iters in (first, resume):
      (rec,) = launch_ranks(1, "cli", out_dir, "[ddp-nccl]",
                            flags(workdir, n_iters), torchrun=True)
      steps = n_iters - rec["returned"]["initial_step"]
      check(rec["evals"] == steps and rec["launches"] == {
          "forward": ATTN_PER_FORWARD * steps,
          "backward": ATTN_PER_FORWARD * steps},
            f"[ddp-nccl] {rec['evals']} evaluations, launches "
            f"{rec['launches']} for {steps} steps")
      losses += [v for _, v in rec["returned"]["train_losses"]]
    with open(os.path.join(workdir, "stdout.txt")) as f:
      log = f.read()
    check(f"Starting training loop at step {first}" in log,
          f"[ddp-nccl] the resume did not start at step {first}")
    check(checkpoint.has_numbered(workdir, 1), "[ddp-nccl] checkpoint_1.pth")
    meta = torch.load(checkpoint.meta_path(workdir), map_location="cpu",
                      weights_only=True)
    check(meta["step"] == first and len(meta["rng"]["ranks"]) == 1,
          f"[ddp-nccl] rolling checkpoint at step {meta['step']}")
  check(len(losses) == resume and all(math.isfinite(v) for v in losses),
        f"[ddp-nccl] losses {losses}")
  say(f"[ddp-nccl] torchrun --nproc_per_node=1, nccl, main --mode train at "
      f"batch {TRAIN_BATCH}: {first} steps, then the resume to {resume}; "
      f"losses {losses}")


def _write_npz_split(root: str, images: int, size: int) -> str:
  import numpy as np
  os.makedirs(root, exist_ok=True)
  rng = np.random.default_rng(0)
  for split in ("train", "test"):
    np.savez(os.path.join(root, f"{split}.npz"),
             images=rng.integers(0, 256, (images, size, size, 3),
                                 dtype=np.uint8))
  return root


def phase_ddp_cli() -> None:
  """[ddp-cli]: two gloo ranks on cuda:0 run the flagship's ``main --mode
  train`` (with rank 0's sample grid), a resume, ``--mode eval`` (loss,
  bits/dim, PC sampling) and ``--mode sample``."""
  import numpy as np
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
      ranks = launch_ranks(2, "cli", out_dir, "[ddp-cli]", common + args)
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
      say(f"[ddp-cli] {name}: per rank evaluations "
          f"{[rec['evals'] for rec in ranks]}, launches "
          f"{[rec['launches'] for rec in ranks]}")
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
  from score_sde_pytorch_tpu_torch.ops import bench_kernels
  from score_sde_pytorch_tpu_torch.utils import tracing

  card_line = card()
  say(f"[card] {card_line}; torch {torch.__version__}, CUDA "
      f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")

  defaults = _tf32_off(torch)
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
  phase_learn()
  phase_sample(config, model)
  _reset()
  evals = phase_sampler(torch, model)
  check(_counts()["forward"] == ATTN_PER_FORWARD * evals
        == ATTN_PER_FORWARD * SAMPLER_SCALES * 2,
        f"[sampler] {_counts()['forward']} kernel launches in {evals} "
        f"evaluations, want {ATTN_PER_FORWARD} x {SAMPLER_SCALES * 2}")
  with tempfile.TemporaryDirectory() as workdir:
    phase_train(torch, workdir)
    phase_eval(workdir)
    phase_eval_checks(torch, attn, config, model, workdir)
    phase_debug(torch, workdir)
  del model
  phase_uri(torch)
  phase_demo(torch)
  phase_ddp_pair()
  phase_ddp_nccl(torch)
  phase_ddp_cli()
  phase_space_pair()
  with tempfile.TemporaryDirectory() as workdir:
    phase_vp_train(torch, workdir)
    phase_main_sample(torch, VP_CONFIG, workdir,
                      [f"model.num_scales={SMOKE_SCALES}"], ATTN_PER_FORWARD,
                      SMOKE_SCALES, SMOKE_BATCH, "[vp-sample]",
                      rounds=SMOKE_ROUNDS)
    phase_vp_eval(torch, workdir)
  phase_ddpm(torch, attn)
  phase_samplers(torch, vp_model)
  _reset()
  evals = phase_sampler(torch, vp_model, VP_CONFIG, VP_SAMPLER_SCALES,
                        tag="[vp-sampler]")
  check(evals == VP_SAMPLER_SCALES
        and _counts()["forward"] == ATTN_PER_FORWARD * evals,
        f"[vp-sampler] {_counts()['forward']} kernel launches in {evals} "
        "evaluations")
  del vp_model
  phase_ddpm256(torch, attn)
  phase_hires(torch, attn)
  phase_hires_1024(torch, attn)
  phase_ncsn(torch)
  phase_ncsnv2(torch)
  phase_bf16_church(torch)
  phase_bf16_1024(torch)
  phase_h100_leaves(torch)
  with tempfile.TemporaryDirectory() as data_root:
    phase_data_church(torch, data_root)
    phase_data_ffhq(torch, data_root)
    phase_data_celeba(torch, data_root)
    phase_data_native(data_root)
  # The card's machine has jax installed, so an import of it would not fail;
  # nor would one of the JAX package, which sits beside the port.
  leaked = sorted(m for m in sys.modules if m.split(".")[0] in (
      "jax", "jaxlib", "flax", "score_sde_pytorch_tpu", "tensorflow"))
  check(not leaked, f"the port imported JAX, the JAX package or "
        f"TensorFlow: {leaked[:5]}")

  # Every kernel call of the runs above in this process (the ddp and space
  # ranks run in processes of their own and are left out); a replayed
  # resblock's GroupNorm calls, forward and backward, which the counters
  # saw only at capture, at each replay.
  launched = {name: tracing.count_of(name) for name in KERNEL_COUNTERS}
  replayed = GN_PER_RESBLOCK * _graph("replay")
  gn_calls = [launched[f"kernel.group_norm.onchip_{d}"]
              + launched[f"kernel.group_norm.split_{d}"] + replayed
              for d in ("fwd", "bwd")]
  # Each kernel's ms, plain ms, library ms, bound and errors at one shape,
  # TF32 off, from the kernel bench, which takes the kernel's side through
  # the port's wrapper (with autograd for the backward). Each row's error
  # is held to the kernel's own bound (the cuda tests hold the other shapes
  # and dtypes): attention forward 2e-5; its backward 5e-4 absolute +
  # relative; fused act 1e-6; GroupNorm 1e-5 of each tensor's largest
  # entry.
  defaults = _tf32_off(torch)
  shapes = RECORD_SHAPES
  kernels = [
      ("flash_attention_forward", KERNEL_SOURCE, TPU_KERNEL,
       launched["kernel.attention.fwd"],
       bench_kernels.attention_forward(*shapes["attention_forward"]),
       "max_abs_err", 2e-5),
      ("flash_attention_backward", KERNEL_SOURCE, TPU_BWD,
       launched["kernel.attention.bwd"],
       bench_kernels.attention_backward(*shapes["attention_backward"]),
       "abs_rel_err", 5e-4),
      # On no model's path: the runs above launch it 0 times.
      ("fused_leaky_relu_forward", ACT_SOURCE, TPU_ACT,
       launched["kernel.fused_act.fwd"],
       bench_kernels.fused_act_forward(shapes["fused_act"]),
       "max_abs_err", 1e-6),
      ("fused_leaky_relu_backward", ACT_SOURCE, TPU_ACT,
       launched["kernel.fused_act.bwd"],
       bench_kernels.fused_act_backward(shapes["fused_act"]),
       "max_abs_err", 1e-6),
      ("group_norm_forward", GN_SOURCE, GN_REPLACES, gn_calls[0],
       bench_kernels.group_norm_forward(shapes["group_norm"]),
       "scaled_err", 1e-5),
      ("group_norm_backward", GN_SOURCE, GN_REPLACES, gn_calls[1],
       bench_kernels.group_norm_backward(shapes["group_norm"]),
       "scaled_err", 1e-5),
  ]
  _tf32_restore(torch, defaults)
  for name, _, _, _, rec, key, limit in kernels:
    check(rec[key] <= limit, f"[kernels] {name} at {rec['shape']} "
          f"{rec['dtype']}: {key} {rec[key]:.3g} > {limit:.0e}")
  say(json.dumps({"kernels": [{
      "name": name, "route": "cuda", "source": source, "replaces": replaces,
      "launches": n, "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
      "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
      "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]}
      for name, source, replaces, n, rec, _, _ in kernels]}))
  say(card_line)
  say(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  if sys.argv[1:2] == ["--ddp-worker"]:
    sys.exit(ddp_worker(*sys.argv[2:]))
  sys.exit(main())
