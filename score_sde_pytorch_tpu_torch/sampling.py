"""Predictor–corrector sampling (PyTorch).

Counterpart of score_sde_pytorch_tpu/sampling.py:91-103, 164-191, 237-285
and 480-525. Update functions take their Gaussian noise as an argument
(``update_fn(x, t, z)``); the PC loop draws it from an explicit
``torch.Generator`` through :func:`normal`, so tests can inject the noise the
JAX package sees. The loop is a Python loop of eager steps (the JAX package
scans it inside one jit). States are NCHW; the sampler returns NHWC, as the
JAX package does.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from score_sde_pytorch_tpu_torch import sde as sde_lib
from score_sde_pytorch_tpu_torch.models import utils as mutils
from score_sde_pytorch_tpu_torch.sde import batch_mul

_PREDICTORS = {}
_CORRECTORS = {}


def _registrar(registry, kind):
  def register(fn=None, *, name: Optional[str] = None):
    def _register(fn):
      local_name = fn.__name__ if name is None else name
      if local_name in registry:
        raise ValueError(f"Already registered {kind} with name: {local_name}")
      registry[local_name] = fn
      return fn
    return _register if fn is None else _register(fn)
  return register


register_predictor = _registrar(_PREDICTORS, "predictor")
register_corrector = _registrar(_CORRECTORS, "corrector")


def _lookup(registry, kind, name):
  if name not in registry:
    raise NotImplementedError(
        f"{kind} {name!r} is not ported yet (ported: {sorted(registry)}); "
        "see ROADMAP.md queue 1 item 8")
  return registry[name]


def get_predictor(name: str):
  return _lookup(_PREDICTORS, "predictor", name)


def get_corrector(name: str):
  return _lookup(_CORRECTORS, "corrector", name)


def normal(shape: Sequence[int], generator: torch.Generator,
           device) -> torch.Tensor:
  """Standard normal noise for the samplers; the one place they draw it."""
  return torch.randn(tuple(shape), generator=generator, device=device)


@register_predictor(name="reverse_diffusion")
def reverse_diffusion_predictor(sde, score_fn, probability_flow=False):
  """``update_fn(x, t, z) -> (x, x_mean)`` (reference sampling.py:190-200)."""
  rsde = sde.reverse(score_fn, probability_flow)

  def update_fn(x, t, z):
    f, g = rsde.discretize(x, t)
    x_mean = x - f
    x = x_mean + batch_mul(g, z)
    return x, x_mean

  return update_fn


@register_predictor(name="none")
def none_predictor(sde, score_fn, probability_flow=False):

  def update_fn(x, t, z):
    return x, x

  return update_fn


@register_corrector(name="langevin")
def langevin_corrector(sde, score_fn, snr, n_steps):
  """Langevin steps of size 2·alpha·(snr·‖z‖/‖score‖)² (reference
  sampling.py:253-282). The norms are per sample, then averaged over the
  batch, as in the reference. ``update_fn(x, t, zs)`` takes ``n_steps``
  noise tensors stacked on a leading axis."""
  if not isinstance(sde, sde_lib.VESDE):
    raise NotImplementedError(
        f"the Langevin corrector for {type(sde).__name__} is not ported yet; "
        "see ROADMAP.md queue 1 item 2")

  def update_fn(x, t, zs):
    alpha = torch.ones_like(t)  # VE; VP/subVP read sde.alphas here
    x_mean = x
    for step in range(n_steps):
      z = zs[step]
      grad = score_fn(x, t)
      grad_norm = torch.linalg.norm(grad.reshape(grad.shape[0], -1),
                                    dim=-1).mean()
      noise_norm = torch.linalg.norm(z.reshape(z.shape[0], -1), dim=-1).mean()
      step_size = (snr * noise_norm / grad_norm) ** 2 * 2 * alpha
      x_mean = x + batch_mul(step_size, grad)
      x = x_mean + batch_mul(torch.sqrt(step_size * 2), z)
    return x, x_mean

  return update_fn


@register_corrector(name="none")
def none_corrector(sde, score_fn, snr, n_steps):

  def update_fn(x, t, zs):
    return x, x

  return update_fn


def get_pc_sampler(sde, model, shape, predictor, corrector,
                   inverse_scaler: Callable, snr: float, n_steps: int = 1,
                   probability_flow: bool = False, continuous: bool = False,
                   denoise: bool = True, eps: float = 1e-3, device=None):
  """Predictor–corrector sampler.

  ``shape`` is NHWC, as in the JAX package. Returns
  ``sampler(generator) -> (samples, nfe)`` with NHWC samples on ``device``
  and ``nfe = N * (n_steps + 1)``. Each step runs the corrector, then the
  predictor, at one time of ``linspace(T, eps, N)``. ``device=None`` takes
  the device of the model's parameters."""
  predictor = predictor or _PREDICTORS["none"]
  corrector = corrector or _CORRECTORS["none"]
  b, h, w, c = shape
  state_shape = (b, c, h, w)
  device = torch.device(device) if device is not None else next(
      model.parameters()).device

  def pc_sampler(generator: torch.Generator):
    score_fn = mutils.get_score_fn(sde, model, train=False,
                                   continuous=continuous)
    predictor_update = predictor(sde, score_fn, probability_flow)
    corrector_update = corrector(sde, score_fn, snr, n_steps)
    with torch.no_grad():
      x = sde.prior_sampling(state_shape, generator, device)
      x_mean = x
      timesteps = sde_lib.linspace(sde.T, eps, sde.N, device)
      for i in range(sde.N):
        t = timesteps[i].expand(b)
        zs = normal((n_steps,) + state_shape, generator, device)
        x, x_mean = corrector_update(x, t, zs)
        z = normal(state_shape, generator, device)
        x, x_mean = predictor_update(x, t, z)
      out = inverse_scaler(x_mean if denoise else x)
    return out.permute(0, 2, 3, 1), sde.N * (n_steps + 1)

  return pc_sampler


def get_sampling_fn(config, sde, model, shape, inverse_scaler,
                    eps: Optional[float] = None, device=None):
  """Sampler named by ``config.sampling.method``; only ``pc`` is ported."""
  if eps is None:
    eps = sde_lib.sampling_eps(config)
  method = config.sampling.method.lower()
  if method != "pc":
    raise NotImplementedError(
        f"sampler {method!r} is not ported yet (only 'pc'); see ROADMAP.md "
        "queue 1 item 8")
  return get_pc_sampler(
      sde, model, shape, get_predictor(config.sampling.predictor.lower()),
      get_corrector(config.sampling.corrector.lower()), inverse_scaler,
      snr=config.sampling.snr, n_steps=config.sampling.n_steps_each,
      probability_flow=config.sampling.probability_flow,
      continuous=config.training.continuous,
      denoise=config.sampling.noise_removal, eps=eps, device=device)
