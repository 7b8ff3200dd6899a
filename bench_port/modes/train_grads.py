"""Training traffic whose check holds the first step's gradient element by
element.

The traffic, the set-up, the traced segment and the readings are those of
``modes/train.py``, loaded through the registry and run unchanged (its
faults planted as for ``train``). This mode adds one reading: the first
step's gradient of every leaf whole, read as ``train.py`` reads its norm
(Adam's first moment after step 0, over 1 − β₁) and moved to the host.

Its check is ``train.py``'s ``loss_gap``, ``grad_gap``, ``change_gap`` and
``ema_gap`` plus ``grad_diff``: the worst leaf's ‖g_program − g_reference‖
over the larger of ‖g_reference‖ and the median leaf's norm. A difference
of norms averages a lower precision's rounding away over a 256² image; the
norm of the difference does not. ``grad_diff`` is infinite where the
program's gradients are not one of the reference's shape for each leaf
(say, none were read because the parameters were stepped outside
``Optimizer.step``).

The reference's three float32 steps (TF32 off) do not fit at batch 24 of
256² images on one card: each step calls the reference network in
micro-batches of ``_PART`` images, each recomputed in the backward pass
(``torch.utils.checkpoint``), so autograd sums the per-image losses'
gradients over the parts. Each image's draws and
arithmetic are those of the whole batch; the configuration has no dropout.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch.optim.optimizer import register_optimizer_step_post_hook
from torch.utils import checkpoint

from bench_port import registry
from bench_port.reference import train as ref_train

_train = registry.mode("train")
_PART = 8  # images of the reference's micro-batch: 8 of 256² fit on an H100


class Session(_train.Session):

  def __init__(self, ctx):
    beta1 = ctx.cfg.optim.beta1
    first = []

    def keep(optimizer, args, kwargs):
      state = getattr(self, "state", {})
      if not first and optimizer is state.get("optimizer"):  # step 0
        for p in self.leaves:
          m = optimizer.state.get(p, {}).get("exp_avg")
          first.append(torch.zeros(p.shape) if m is None
                       else (m / (1 - beta1)).cpu())

    hook = register_optimizer_step_post_hook(keep)
    try:
      super().__init__(dataclasses.replace(
          ctx, cell={**ctx.cell, "mode": "train"}))
    finally:
      hook.remove()
    self.readings["grads"] = first


class _InParts(torch.nn.Module):
  """``net`` called on ``part`` images at a time, each part recomputed in
  the backward pass."""

  def __init__(self, net: torch.nn.Module, part: int):
    super().__init__()
    self.net, self.part = net, part

  def forward(self, x, sigmas):
    return torch.cat([
        checkpoint.checkpoint(self.net, xs, ss, use_reentrant=False)
        for xs, ss in zip(x.split(self.part), sigmas.split(self.part))])


class _Reference:
  """``reference/train.py`` as ``train.check`` calls it, with the network
  in parts; keeps what its steps returned."""

  leaf_gap = staticmethod(ref_train.leaf_gap)
  out = None

  def steps(self, net, cfg, batches, gen):
    self.out = ref_train.steps(_InParts(net, _PART), cfg, batches, gen)
    return self.out


def grad_diff(program: list, reference: list) -> float:
  """The worst leaf's ‖program − reference‖ over the larger of its
  ‖reference‖ and the median leaf's; infinite unless the two lists hold
  leaves of the same shapes."""
  if not reference or [p.shape for p in program] != [
      r.shape for r in reference]:
    return math.inf
  norms = [float(torch.linalg.vector_norm(r)) for r in reference]
  median = sorted(norms)[len(norms) // 2]
  worst = 0.0
  for p, r, norm in zip(program, reference, norms):
    gap = float(torch.linalg.vector_norm(p.to(r.device, r.dtype) - r)) \
        / max(norm, median)
    worst = max(worst, gap if math.isfinite(gap) else math.inf)
  return worst


def check(ctx, readings: dict) -> dict:
  """``train.check``'s gaps, its reference in parts, and ``grad_diff``."""
  reference = _Reference()
  _train.ref_train = reference
  try:
    gaps = _train.check(ctx, readings)
  finally:
    _train.ref_train = ref_train
  gaps["grad_diff"] = grad_diff(readings["grads"],
                                reference.out["first_grads"])
  return gaps
