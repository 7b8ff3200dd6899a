"""The plain reference of the first training steps.

The continuous VE denoising score matching loss (Song et al. 2021, eq. 7
with λ(t) = σ(t)²), its gradient by autograd through the reference
network, global-norm clipping (scaled by clip/‖g‖ where ‖g‖ ≥ clip), Adam
with a linear warm-up of the learning rate (lr·min(k/warmup, 1) at the
k-th step counted from 0; β₂ = 0.999) and the EMA of the weights with
decay min(rate, (1 + n)/(10 + n)) at its n-th update. The draws of each
step come from the generator the benchmark seeds: t ~ U(ε, T) then
z ~ N(0, 1), ε = 1e-5, T = 1; dropout draws from the device's default
generator, seeded by the caller.
"""
from __future__ import annotations

import math

import torch

_BETA2 = 0.999
_T_EPS = 1e-5


def sigma(model_cfg: dict, t: torch.Tensor) -> torch.Tensor:
  lo, hi = model_cfg["sigma_min"], model_cfg["sigma_max"]
  return lo * (hi / lo) ** t


def loss(net, cfg: dict, batch: torch.Tensor, gen: torch.Generator):
  """The loss of one batch (NCHW in [0, 1]) and its draws from ``gen``."""
  tr = cfg["training"]
  if tr["reduce_mean"] or tr["likelihood_weighting"] or not tr["continuous"]:
    raise NotImplementedError("reference loss: continuous, summed, "
                              "unweighted only")
  b = batch.shape[0]
  t = torch.rand(b, generator=gen, device=batch.device) * (1.0 - _T_EPS) \
      + _T_EPS
  z = torch.randn(batch.shape, generator=gen, device=batch.device)
  s = sigma(cfg["model"], t)[:, None, None, None]
  score = net(batch + s * z, s.flatten())
  per_image = 0.5 * torch.sum(torch.square(score * s + z).reshape(b, -1),
                              dim=-1)
  return per_image.mean()


def steps(net, cfg: dict, batches, gen: torch.Generator) -> dict:
  """Trains ``net`` in place over ``batches``; returns each step's loss,
  the first step's clipped gradient of each leaf, and each leaf's weights
  and EMA after the last step."""
  opt = cfg["optim"]
  params = [p for p in net.parameters() if p.requires_grad]
  m = [torch.zeros_like(p) for p in params]
  v = [torch.zeros_like(p) for p in params]
  ema = [p.detach().clone() for p in params]
  out = {"losses": [], "first_grads": None}
  for k, batch in enumerate(batches):
    value = loss(net, cfg, batch, gen)
    grads = torch.autograd.grad(value, params)
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    if norm >= opt["grad_clip"]:
      grads = [g * (opt["grad_clip"] / norm) for g in grads]
    if k == 0:
      out["first_grads"] = [g.detach().clone() for g in grads]
    rate = opt["lr"] * min(k / opt["warmup"], 1.0) if opt["warmup"] > 0 \
        else opt["lr"]
    b1 = opt["beta1"]
    with torch.no_grad():
      for p, g, mi, vi in zip(params, grads, m, v):
        mi.mul_(b1).add_(g, alpha=1 - b1)
        vi.mul_(_BETA2).add_(g * g, alpha=1 - _BETA2)
        m_hat = mi / (1 - b1 ** (k + 1))
        v_hat = vi / (1 - _BETA2 ** (k + 1))
        p.sub_(rate * m_hat / (torch.sqrt(v_hat) + opt["eps"]))
      decay = min(cfg["model"]["ema_rate"], (2.0 + k) / (11.0 + k))
      for e, p in zip(ema, params):
        e.sub_((1.0 - decay) * (e - p))
    out["losses"].append(float(value.detach()))
  out["weights"] = [p.detach() for p in params]
  out["ema"] = ema
  return out


def leaf_gap(program: list, reference: list, keep=None) -> float:
  """The worst leaf's gap between two lists of per-leaf norms, each gap
  over the reference's norm of the leaf or of the median leaf, whichever
  is larger; only the leaves ``keep`` marks."""
  idx = [i for i in range(len(reference)) if keep is None or keep[i]]
  ref = sorted(reference[i] for i in idx)
  median = ref[len(ref) // 2]
  worst = 0.0
  for i in idx:
    gap = abs(program[i] - reference[i]) / max(reference[i], median)
    worst = max(worst, gap if math.isfinite(gap) else math.inf)
  return worst
