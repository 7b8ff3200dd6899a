"""Model registry, factory and score-function adapter.

Counterpart of score_sde_pytorch_tpu/models/utils.py. ``create_model``
returns an ``nn.Module`` on an explicit device; the adapters return plain
functions of NCHW tensors.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from score_sde_pytorch_tpu_torch import sde as sde_lib

_MODELS = {}


def register_model(cls=None, *, name: Optional[str] = None):
  """Decorator registry (reference models/utils.py:27-44)."""

  def _register(cls):
    local_name = cls.__name__ if name is None else name
    if local_name in _MODELS:
      raise ValueError(f"Already registered model with name: {local_name}")
    _MODELS[local_name] = cls
    return cls

  return _register if cls is None else _register(cls)


def get_model(name: str):
  if name not in _MODELS:
    raise NotImplementedError(
        f"model {name!r} is not ported yet (ported: {sorted(_MODELS)}); see "
        "ROADMAP.md queue 1 item 11")
  return _MODELS[name]


def get_sigmas(config) -> np.ndarray:
  """Descending geometric noise ladder (reference models/utils.py:49-59)."""
  return np.exp(np.linspace(np.log(config.model.sigma_max),
                            np.log(config.model.sigma_min),
                            config.model.num_scales))


def create_model(config, device, generator: torch.Generator) -> torch.nn.Module:
  """Build the registered model, initialize it from ``generator`` and move it
  to ``device``, in eval mode.

  ``generator`` is a CPU generator: parameters are drawn on the CPU, so one
  seed gives the same weights on every device."""
  model = get_model(config.model.name)(config, generator=generator)
  return model.to(device).eval()


def get_model_fn(model: torch.nn.Module, train: bool = False) -> Callable:
  """Raw-output model function ``model_fn(x, labels)`` (JAX
  models/utils.py:88-107). ``train=True`` puts the model in train mode, so
  dropout is on and draws from PyTorch's default generator of the model's
  device; ``train=False`` puts it in eval mode."""
  model.train(train)

  def model_fn(x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return model(x, labels)

  return model_fn


def get_score_fn(sde: sde_lib.SDE, model: torch.nn.Module,
                 train: bool = False, continuous: bool = False) -> Callable:
  """Network output to score (JAX models/utils.py:110-144). Ported: the
  continuous VE SDE, whose model takes the noise level sigma(t) as label."""
  model_fn = get_model_fn(model, train=train)
  if not isinstance(sde, sde_lib.VESDE):
    raise NotImplementedError(
        f"score functions for {type(sde).__name__} are not ported yet; see "
        "ROADMAP.md queue 1 item 2")
  if not continuous:
    raise NotImplementedError("discrete-time VE score functions are not "
                              "ported yet; see ROADMAP.md queue 1 item 11")

  def score_fn(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    labels = sde.marginal_prob(torch.zeros_like(x), t)[1]
    return model_fn(x, labels)

  return score_fn
