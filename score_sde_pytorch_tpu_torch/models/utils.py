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


def get_ddpm_params(config) -> dict:
  """The original DDPM schedule constants, float64 numpy (JAX
  models/utils.py:48-66)."""
  num_diffusion_timesteps = 1000
  beta_start = config.model.beta_min / config.model.num_scales
  beta_end = config.model.beta_max / config.model.num_scales
  betas = np.linspace(beta_start, beta_end, num_diffusion_timesteps,
                      dtype=np.float64)
  alphas = 1.0 - betas
  alphas_cumprod = np.cumprod(alphas, axis=0)
  return {
      "betas": betas,
      "alphas": alphas,
      "alphas_cumprod": alphas_cumprod,
      "sqrt_alphas_cumprod": np.sqrt(alphas_cumprod),
      "sqrt_1m_alphas_cumprod": np.sqrt(1.0 - alphas_cumprod),
      "beta_min": beta_start * (num_diffusion_timesteps - 1),
      "beta_max": beta_end * (num_diffusion_timesteps - 1),
      "num_diffusion_timesteps": num_diffusion_timesteps,
  }


def gather_clamped(table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
  """``table[int32(index)]`` for a nonnegative ``index``, clamped to the
  table as JAX's gather clamps it. The models read their sigma ladder this
  way: VP labels ``t·999`` run past a ladder of fewer than 1000 scales,
  where JAX clamps silently and torch would raise (or trip a device-side
  assert)."""
  return table[index.to(torch.int32).long().clamp(0, table.shape[0] - 1)]


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
  """Network output to score (JAX models/utils.py:110-144), by the SDE's
  label and scaling conventions:

  - VP/subVP, continuous (subVP always): labels ``t·999``, the output
    divided by ``-std(t)`` of ``marginal_prob``;
  - VP, discrete: labels ``t·(N-1)``, divided by
    ``-sqrt_1m_alphas_cumprod[int32(labels)]``;
  - VE, continuous: the label is sigma(t), the output is the score;
  - VE, discrete: integer labels ``round((T - t)(N - 1))`` (t = 0 is the
    highest noise level of the descending SMLD ladder)."""
  model_fn = get_model_fn(model, train=train)

  if isinstance(sde, (sde_lib.VPSDE, sde_lib.SubVPSDE)):

    def score_fn(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
      if continuous or isinstance(sde, sde_lib.SubVPSDE):
        labels = t * 999
        score = model_fn(x, labels)
        std = sde.marginal_prob(torch.zeros_like(x), t)[1]
      else:
        labels = t * (sde.N - 1)
        score = model_fn(x, labels)
        std = sde.sqrt_1m_alphas_cumprod(t.device)[
            labels.to(torch.int32).long()]
      return sde_lib.batch_mul(-1.0 / std, score)

  elif isinstance(sde, sde_lib.VESDE):

    def score_fn(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
      if continuous:
        labels = sde.marginal_prob(torch.zeros_like(x), t)[1]
      else:
        labels = torch.round((sde.T - t) * (sde.N - 1)).to(torch.int32)
      return model_fn(x, labels)

  else:
    raise NotImplementedError(
        f"SDE class {type(sde).__name__} not yet supported.")

  return score_fn
