"""Exponential moving average of a model's trainable parameters.

Counterpart of score_sde_pytorch_tpu/models/ema.py:23-35 and of the torch
reference's ``ExponentialMovingAverage`` (yang-song/score_sde_pytorch
models/ema.py). The shadow list holds the trainable parameters in
``model.parameters()`` order, which is the ``shadow_params`` entry of the
reference's ``.pth`` files (checkpoint.py). Updates are in place.
"""
from __future__ import annotations

from typing import Iterable, List

import torch


def _trainable(parameters: Iterable[torch.nn.Parameter]) -> List[torch.Tensor]:
  return [p for p in parameters if p.requires_grad]


class ExponentialMovingAverage:
  """``shadow ← shadow − (1 − d)(shadow − p)`` with
  ``d = min(decay, (1 + n) / (10 + n))`` at the n-th update."""

  def __init__(self, parameters: Iterable[torch.nn.Parameter], decay: float):
    if not 0.0 <= decay <= 1.0:
      raise ValueError(f"EMA decay must be in [0, 1], got {decay}")
    self.decay = float(decay)
    self.num_updates = 0
    self.shadow_params = [p.detach().clone() for p in _trainable(parameters)]
    self._stored: List[torch.Tensor] = []

  @torch.no_grad()
  def update(self, parameters: Iterable[torch.nn.Parameter]) -> None:
    params = _trainable(parameters)
    self.num_updates += 1
    n = self.num_updates
    one_minus_decay = 1.0 - min(self.decay, (1.0 + n) / (10.0 + n))
    diff = torch._foreach_sub(self.shadow_params, params)
    torch._foreach_mul_(diff, one_minus_decay)
    torch._foreach_sub_(self.shadow_params, diff)

  @torch.no_grad()
  def copy_to(self, parameters: Iterable[torch.nn.Parameter]) -> None:
    """Copy the shadow into the trainable ``parameters``."""
    for param, shadow in zip(_trainable(parameters), self.shadow_params,
                             strict=True):
      param.copy_(shadow)

  def store(self, parameters: Iterable[torch.nn.Parameter]) -> None:
    """Keep a copy of ``parameters`` for :meth:`restore`."""
    self._stored = [p.detach().clone() for p in _trainable(parameters)]

  @torch.no_grad()
  def restore(self, parameters: Iterable[torch.nn.Parameter]) -> None:
    """Put back what :meth:`store` kept."""
    for param, kept in zip(_trainable(parameters), self._stored, strict=True):
      param.copy_(kept)
    self._stored = []

  def state_dict(self) -> dict:
    return {"decay": self.decay, "num_updates": self.num_updates,
            "shadow_params": [p.detach().cpu().clone()
                              for p in self.shadow_params]}

  @torch.no_grad()
  def load_state_dict(self, state: dict) -> None:
    shadow = state["shadow_params"]
    if len(shadow) != len(self.shadow_params):
      raise ValueError(f"{len(shadow)} EMA shadow params for "
                       f"{len(self.shadow_params)} trainable params")
    for mine, value in zip(self.shadow_params, shadow):
      if mine.shape != value.shape:
        raise ValueError(f"EMA shadow param of shape {tuple(value.shape)} "
                         f"for a parameter of shape {tuple(mine.shape)}")
      mine.copy_(value)
    self.decay = float(state["decay"])
    self.num_updates = int(state["num_updates"])
