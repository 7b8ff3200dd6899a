"""Seeded weights for the program and the reference alike.

The benchmark draws every parameter itself, on the device, from the run's
seed: one ``torch.randn`` of all the parameters' elements from a
``torch.Generator`` on the card, cut into leaves and scaled by kind
(variance scaling by the fan average for weights, 0.1 for biases,
1 + 0.1·n for norm scales, the Fourier scale for the fixed projection).
Every leaf is nonzero, so every layer of the network shapes the output
(the published initialization zeroes the last convolution of each branch,
which would hide a fault in it). The reference's parameter list names the
leaves; the program's model must hold exactly the same names and shapes.
"""
from __future__ import annotations

import math

import torch

from bench_port.reference import ncsnpp as ref_ncsnpp

_BIAS_SCALE = 0.1
# Shares of the variance-scaling width by a weight's role: "branch_out",
# the layers the published initialization zeroes (the last convolution of
# each resblock, attention's output projection, the output convolutions);
# "time", each resblock's projection of the time embedding.
ROLE_SCALE = {"main": 1.0, "branch_out": 0.1, "time": 0.01}


def reference_model(config: dict, device) -> ref_ncsnpp.NCSNpp:
  """The reference network with uninitialized parameters on ``device``."""
  with torch.device("meta"):
    model = ref_ncsnpp.NCSNpp(config)
  return model.to_empty(device=device)


def draw(model: torch.nn.Module, seed: int, device) -> dict:
  """``{name: tensor}`` for every parameter of the reference ``model``,
  drawn on ``device`` from ``seed``."""
  kinds = ref_ncsnpp.param_kinds(model)
  named = list(model.named_parameters())
  total = sum(p.numel() for _, p in named)
  gen = torch.Generator(device=device).manual_seed(seed)
  flat = torch.randn(total, generator=gen, device=device)
  out, offset = {}, 0
  for name, p in named:
    leaf = flat[offset:offset + p.numel()].view(p.shape)
    offset += p.numel()
    kind, detail = kinds[name]
    if kind == "fan":
      fan_in, fan_out, role = detail
      leaf.mul_(math.sqrt(2.0 / (fan_in + fan_out)) * ROLE_SCALE[role])
    elif kind == "bias":
      leaf.mul_(_BIAS_SCALE)
    elif kind == "norm_weight":
      leaf.mul_(_BIAS_SCALE).add_(1.0)
    elif kind == "normal":
      leaf.mul_(detail)
    else:
      raise ValueError(f"unknown init kind {kind!r} of {name}")
    out[name] = leaf
  return out


@torch.no_grad()
def load_into(module: torch.nn.Module, weights: dict) -> None:
  """Copy ``weights`` into ``module``'s parameters; the names and shapes
  must be the same sets."""
  params = dict(module.named_parameters())
  if set(params) != set(weights):
    raise RuntimeError(
        "the program's parameters are not the reference's: only in the "
        f"program {sorted(set(params) - set(weights))[:5]}, only in the "
        f"reference {sorted(set(weights) - set(params))[:5]}")
  for name, p in params.items():
    if p.shape != weights[name].shape:
      raise RuntimeError(f"{name}: program {tuple(p.shape)}, reference "
                         f"{tuple(weights[name].shape)}")
    p.copy_(weights[name])


def reference_with_weights(config: dict, seed: int, device):
  """The reference network holding the seed's weights."""
  model = reference_model(config, device)
  load_into(model, draw(model, seed, device))
  return model
