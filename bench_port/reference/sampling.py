"""The plain reference of the VE predictor–corrector sampler (Song et al.
2021, Algorithm 2 with one Langevin step; the published
yang-song/score_sde sampling.py): ``N`` times from ``linspace(T, ε, N)``
(the published fp32 formula ``start·(1 − s) + stop·s``), at each a Langevin
corrector step of size 2·(snr·mean‖z‖/mean‖score‖)², then a reverse
diffusion step with ``g = sqrt(σᵢ² − σᵢ₋₁²)`` on the geometric ladder of
``N`` levels (σᵢ at index ⌊t·(N − 1)⌋); the last step's mean is the
sample. The draws come from the generator the benchmark seeds, in the
published order: the prior, then per step the corrector's noise and the
predictor's.
"""
from __future__ import annotations

import math

import torch


def _linspace(start: float, stop: float, num: int, device) -> torch.Tensor:
  s = torch.arange(num - 1, dtype=torch.float32, device=device) / (num - 1)
  a = torch.tensor(start, dtype=torch.float32, device=device)
  b = torch.tensor(stop, dtype=torch.float32, device=device)
  return torch.cat([a * (1 - s) + b * s, b.reshape(1)])


def _norm_mean(v: torch.Tensor) -> torch.Tensor:
  return torch.linalg.vector_norm(v.reshape(v.shape[0], -1), dim=-1).mean()


@torch.no_grad()
def pc_sample(net, cfg: dict, shape, gen: torch.Generator, eps: float,
              device) -> torch.Tensor:
  """Samples of NCHW ``shape`` from the reference network ``net``."""
  m, sc = cfg["model"], cfg["sampling"]
  if (sc["predictor"], sc["corrector"], sc["n_steps_each"]) != (
      "reverse_diffusion", "langevin", 1) or sc["probability_flow"] \
      or not sc["noise_removal"] or cfg["data"]["centered"]:
    raise NotImplementedError("reference PC: reverse diffusion + one "
                              "Langevin step, denoised, uncentered")
  lo, hi, n = m["sigma_min"], m["sigma_max"], m["num_scales"]
  sigmas = torch.exp(_linspace(math.log(lo), math.log(hi), n, device))
  times = _linspace(1.0, eps, n, device)
  b = shape[0]
  x = torch.randn(shape, generator=gen, device=device) * hi
  x_mean = x
  for i in range(n):
    t = times[i].expand(b)
    sigma_t = lo * (hi / lo) ** t
    z = torch.randn(shape, generator=gen, device=device)
    grad = net(x, sigma_t)
    step = (sc["snr"] * _norm_mean(z) / _norm_mean(grad)) ** 2 * 2
    x_mean = x + step * grad
    x = x_mean + torch.sqrt(step * 2) * z
    z = torch.randn(shape, generator=gen, device=device)
    idx = (t * (n - 1)).to(torch.int32).long()
    sigma = sigmas[idx]
    adjacent = torch.where(idx == 0, torch.zeros_like(sigma),
                           sigmas[(idx - 1).clamp_min(0)])
    g2 = sigma ** 2 - adjacent ** 2
    x_mean = x + g2[:, None, None, None] * net(x, sigma_t)
    x = x_mean + torch.sqrt(g2)[:, None, None, None] * z
  return x_mean
