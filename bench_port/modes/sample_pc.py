"""Sampling traffic: whole chains of the program's predictor–corrector
sampler (``sampling.get_sampling_fn`` with the configuration's method,
predictor, corrector, snr and ``num_scales`` levels) at the batch
``eval.batch_size``, back to back. Chain k draws its noise from a
generator seeded by (seed, k). Each chain's samples stay on the card (up
to ``chains_kept``).

Set-up builds the program's sampler and a one-level sampler of the same
shapes, and runs the latter once, which runs every shape of the window
(the corrector's and the predictor's evaluations at the batch). The
traced segment is ``trace_chains`` more chains. Network evaluations are
counted by the benchmark's forward hook on the score network and held
equal to the sampler's own count.

Compared with the reference (``reference/sampling.py``, same weights and
seeds): every image of one chain drawn from the seed among those the
window completed, by the worst image's distance to the reference's over
the reference image's norm or the median image's, whichever is larger.
"""
from __future__ import annotations

import numpy as np
import torch

from bench_port import faults, program, reference, seeds, weights
from bench_port.counters import ncsnpp as counters
from bench_port.reference import sampling as ref_sampling


def chain_seed(seed: int, k: int) -> int:
  return seeds.derive(seed, 7, k)


def image_gap(program_out: torch.Tensor, ref_out: torch.Tensor) -> float:
  """Worst image's L2 distance over max(its reference norm, the median
  reference image's norm)."""
  b = ref_out.shape[0]
  diff = torch.linalg.vector_norm((program_out.float() - ref_out.float())
                                  .reshape(b, -1), dim=-1)
  norm = torch.linalg.vector_norm(ref_out.float().reshape(b, -1), dim=-1)
  scale = torch.maximum(norm, norm.median())
  gap = float((diff / scale).max())
  return gap if np.isfinite(gap) else float("inf")


class Session:

  def __init__(self, ctx):
    from score_sde_pytorch_tpu_torch import datasets, sampling
    from score_sde_pytorch_tpu_torch import sde as sde_lib
    self.ctx = ctx
    cfg, dev = ctx.cfg, ctx.device
    faults.plant(ctx)
    self.model = program.build_model(cfg, ctx.plain, ctx.seed, dev,
                                     ctx.mark)
    ctx.mark("model")
    self.calls = 0

    def count(module, args, output):
      self.calls += 1

    self.hook = self.model.register_forward_hook(count)
    d = cfg.data
    self.shape = (cfg.eval.batch_size, d.image_size, d.image_size,
                  d.num_channels)
    scaler = datasets.get_data_inverse_scaler(cfg)
    self.sampler = sampling.get_sampling_fn(
        cfg, sde_lib.build_sde(cfg), self.model, self.shape, scaler,
        device=dev)
    one = program.port_config(
        ctx.config_file, program.merged(ctx.plain,
                                        {"model": {"num_scales": 1}}),
        ctx.seed)
    warm = sampling.get_sampling_fn(one, sde_lib.build_sde(one), self.model,
                                    self.shape, scaler, device=dev)
    warm(torch.Generator(device=dev).manual_seed(
        seeds.derive(ctx.seed, 7, 2 ** 32)))
    self.calls = 0
    self.flops = {"nfe": counters.forward_flops(ctx.plain, self.shape[0])}
    self.kept = ctx.cell.get("chains_kept", 64)
    self.readings = {"chains": []}
    self.attempted = self.failed = 0

  def _chain(self) -> dict:
    k = self.attempted
    gen = torch.Generator(device=self.ctx.device).manual_seed(
        chain_seed(self.ctx.seed, k))
    before = self.calls
    samples, nfe = self.sampler(gen)
    if self.calls - before != nfe:  # the sampler skipped or added work
      self.failed += 1
    self.attempted += 1
    if k < self.kept:
      self.readings["chains"].append(samples)
    return {"nfe": nfe, "chains": 1}

  def block(self) -> dict:
    return self._chain()

  def traced_blocks(self) -> dict:
    work = {"nfe": 0, "chains": 0}
    for _ in range(self.ctx.cell.get("trace_chains", 1)):
      for key, value in self._chain().items():
        work[key] += value
    return work

  def release(self) -> None:
    faults.remove()
    self.hook.remove()
    chains = self.readings["chains"]
    self.failed += sum(1 for s in chains if not bool(torch.isfinite(s).all()))
    self.model = self.sampler = self.hook = None


def check(ctx, readings: dict) -> dict:
  """The reference re-runs one chain of the window, drawn from the seed."""
  chains = readings["chains"]
  k = int(seeds.rng(ctx.seed, 8).integers(len(chains)))
  dev = ctx.device
  net = weights.reference_with_weights(ctx.plain, ctx.seed, dev).eval()
  b, h, w, c = chains[k].shape
  gen = torch.Generator(device=dev).manual_seed(chain_seed(ctx.seed, k))
  eps = ctx.plain["sampling"]["eps"]
  eps = eps if eps > 0 else 1e-5
  with reference.plain_precision():
    ref = ref_sampling.pc_sample(net, ctx.plain, (b, c, h, w), gen, eps, dev)
  return {"sample_gap": image_gap(chains[k], ref.permute(0, 2, 3, 1))}
