"""Samplers (PyTorch): predictor–corrector, probability-flow ODE, Heun and
DPM-Solver++(2M).

Counterpart of score_sde_pytorch_tpu/sampling.py. Update functions take
their Gaussian noise as an argument: a predictor's ``update_fn(x, t, z)``
takes a tensor, a corrector's ``update_fn(x, t, noise)`` a callable
``noise(step)`` that it calls once per Langevin step, when that step runs,
so no more than one step's noise is ever held (the JAX package draws it
inside its scan). The samplers draw from an explicit ``torch.Generator``
through :func:`normal`, so tests can inject the noise the JAX package
sees. Loops are Python loops of eager steps (the JAX package scans them
inside one jit). States are NCHW; the samplers take and return NHWC, as
the JAX package does.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch

from score_sde_pytorch_tpu_torch import ode as ode_lib
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
    raise KeyError(f"{kind} {name!r} unknown (registered: "
                   f"{sorted(registry)})")
  return registry[name]


def get_predictor(name: str):
  return _lookup(_PREDICTORS, "predictor", name)


def get_corrector(name: str):
  return _lookup(_CORRECTORS, "corrector", name)


def normal(shape: Sequence[int], generator: torch.Generator,
           device) -> torch.Tensor:
  """Standard normal noise for the samplers; the one place they draw it."""
  return torch.randn(tuple(shape), generator=generator, device=device)


def _prior(sde, state_shape, generator, device, z):
  """The state at T, NCHW: ``z`` (NHWC) when given, else a prior draw."""
  if z is None:
    return sde.prior_sampling(state_shape, generator, device)
  return z.to(device).permute(0, 3, 1, 2).contiguous()


def _model_device(model, device):
  return torch.device(device) if device is not None else next(
      model.parameters()).device


@register_predictor(name="euler_maruyama")
def euler_maruyama_predictor(sde, score_fn, probability_flow=False):
  """``update_fn(x, t, z) -> (x, x_mean)``: one Euler–Maruyama step of the
  reverse SDE, ``dt = -1/N`` (JAX sampling.py:75-88)."""
  rsde = sde.reverse(score_fn, probability_flow)

  def update_fn(x, t, z):
    dt = -1.0 / rsde.N
    drift, diffusion = rsde.sde(x, t)
    x_mean = x + drift * dt
    x = x_mean + batch_mul(diffusion, math.sqrt(-dt) * z)
    return x, x_mean

  return update_fn


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


@register_predictor(name="ancestral_sampling")
def ancestral_sampling_predictor(sde, score_fn, probability_flow=False):
  """The exact SMLD (VE) and DDPM (VP) ancestral rules (JAX
  sampling.py:106-139); any other SDE raises NotImplementedError."""
  if probability_flow:
    raise ValueError("Probability flow not supported by ancestral sampling")
  if isinstance(sde, sde_lib.VESDE):

    def update_fn(x, t, z):
      timestep = sde.timestep_index(t)
      sigmas = sde.discrete_sigmas(t.device)
      sigma = sigmas[timestep]
      adjacent_sigma = torch.where(timestep == 0, torch.zeros_like(sigma),
                                   sigmas[(timestep - 1).clamp_min(0)])
      score = score_fn(x, t)
      x_mean = x + batch_mul(sigma ** 2 - adjacent_sigma ** 2, score)
      std = torch.sqrt(adjacent_sigma ** 2 * (sigma ** 2 - adjacent_sigma ** 2)
                       / sigma ** 2)
      return x_mean + batch_mul(std, z), x_mean

    return update_fn
  if isinstance(sde, sde_lib.VPSDE):

    def update_fn(x, t, z):
      beta = sde.discrete_betas(t.device)[sde.timestep_index(t)]
      score = score_fn(x, t)
      x_mean = batch_mul(1.0 / torch.sqrt(1.0 - beta),
                         x + batch_mul(beta, score))
      return x_mean + batch_mul(torch.sqrt(beta), z), x_mean

    return update_fn
  raise NotImplementedError(
      f"SDE class {type(sde).__name__} not yet supported.")


@register_predictor(name="none")
def none_predictor(sde, score_fn, probability_flow=False):

  def update_fn(x, t, z):
    return x, x

  return update_fn


def _corrector_alpha(sde, t):
  """The correctors' step scale: ``alphas[i]`` of the discrete grid for
  VP/subVP, 1 for VE (JAX sampling.py:157-161)."""
  if isinstance(sde, (sde_lib.VPSDE, sde_lib.SubVPSDE)):
    return sde.alphas(t.device)[sde.timestep_index(t)]
  return torch.ones_like(t)


def _check_corrector_sde(sde):
  if not isinstance(sde, (sde_lib.VPSDE, sde_lib.VESDE, sde_lib.SubVPSDE)):
    raise NotImplementedError(
        f"SDE class {type(sde).__name__} not yet supported.")


@register_corrector(name="langevin")
def langevin_corrector(sde, score_fn, snr, n_steps):
  """Langevin steps of size 2·alpha·(snr·‖z‖/‖score‖)² (JAX
  sampling.py:164-191). The norms are per sample, then averaged over the
  batch, as in the reference. ``update_fn(x, t, noise)`` calls
  ``noise(step)`` for each step's noise, of ``x``'s shape."""
  _check_corrector_sde(sde)

  def update_fn(x, t, noise):
    alpha = _corrector_alpha(sde, t)
    x_mean = x
    for step in range(n_steps):
      z = noise(step)
      grad = score_fn(x, t)
      grad_norm = torch.linalg.norm(grad.reshape(grad.shape[0], -1),
                                    dim=-1).mean()
      noise_norm = torch.linalg.norm(z.reshape(z.shape[0], -1), dim=-1).mean()
      step_size = (snr * noise_norm / grad_norm) ** 2 * 2 * alpha
      x_mean = x + batch_mul(step_size, grad)
      x = x_mean + batch_mul(torch.sqrt(step_size * 2), z)
    return x, x_mean

  return update_fn


@register_corrector(name="ald")
def annealed_langevin_dynamics(sde, score_fn, snr, n_steps):
  """The original NCSN annealed Langevin dynamics: steps of size
  2·alpha·(snr·std(t))² (JAX sampling.py:194-219). ``update_fn(x, t,
  noise)`` as :func:`langevin_corrector`'s."""
  _check_corrector_sde(sde)

  def update_fn(x, t, noise):
    alpha = _corrector_alpha(sde, t)
    std = sde.marginal_prob(x, t)[1]
    step_size = (snr * std) ** 2 * 2 * alpha
    x_mean = x
    for step in range(n_steps):
      grad = score_fn(x, t)
      x_mean = x + batch_mul(step_size, grad)
      x = x_mean + batch_mul(torch.sqrt(step_size * 2), noise(step))
    return x, x_mean

  return update_fn


@register_corrector(name="none")
def none_corrector(sde, score_fn, snr, n_steps):

  def update_fn(x, t, noise):
    return x, x

  return update_fn


def step_noise(state_shape, generator: torch.Generator, device) -> Callable:
  """A corrector's ``noise(step)``: each call draws one step's noise of
  ``state_shape`` through :func:`normal`."""
  return lambda step: normal(state_shape, generator, device)


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
  device = _model_device(model, device)

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
        x, x_mean = corrector_update(
            x, t, step_noise(state_shape, generator, device))
        z = normal(state_shape, generator, device)
        x, x_mean = predictor_update(x, t, z)
      out = inverse_scaler(x_mean if denoise else x)
    return out.permute(0, 2, 3, 1), sde.N * (n_steps + 1)

  return pc_sampler


def get_ode_sampler(sde, model, shape, inverse_scaler, denoise: bool = False,
                    rtol: float = 1e-5, atol: float = 1e-5, eps: float = 1e-3,
                    max_steps: int = 10000, device=None):
  """Probability-flow ODE sampler (JAX sampling.py:288-327) through the
  adaptive RK45 of :mod:`score_sde_pytorch_tpu_torch.ode`, from ``T`` to
  ``eps``.

  Returns ``sampler(generator, z=None) -> (samples, nfe)``: ``z`` is the
  NHWC state at ``T`` (None draws it from the prior), the samples are NHWC.
  They are all NaN unless the solver reached ``eps``. ``denoise`` adds one
  reverse-diffusion step at ``eps`` (its mean; one more NFE).
  ``device=None`` takes the device of the model's parameters."""
  b, h, w, c = shape
  state_shape = (b, c, h, w)
  device = _model_device(model, device)

  def ode_sampler(generator: torch.Generator,
                  z: Optional[torch.Tensor] = None):
    score_fn = mutils.get_score_fn(sde, model, train=False, continuous=True)
    rsde = sde.reverse(score_fn, probability_flow=True)
    with torch.no_grad():
      x0 = _prior(sde, state_shape, generator, device, z)

      def drift_fn(x, t_scalar: float):
        return rsde.sde(x, torch.full((b,), t_scalar, device=device))[0]

      x, nfe, status = ode_lib.odeint_rk45(drift_fn, x0, sde.T, eps,
                                           rtol=rtol, atol=atol,
                                           max_steps=max_steps)
      if status != ode_lib.STATUS_OK:
        x = torch.full_like(x, float("nan"))
      if denoise:
        rd = reverse_diffusion_predictor(sde, score_fn, probability_flow=False)
        _, x = rd(x, torch.full((b,), eps, device=device), torch.zeros_like(x))
        nfe += 1
      out = inverse_scaler(x)
    return out.permute(0, 2, 3, 1), nfe

  return ode_sampler


def get_heun_sampler(sde, model, shape, inverse_scaler, n_steps: int = 50,
                     denoise: bool = True, continuous: bool = True,
                     eps: float = 1e-3, device=None):
  """Heun's method on the probability-flow ODE over ``linspace(T, eps,
  n_steps + 1)``, 2 NFE a step, then (``denoise``) the Tweedie step
  ``x + std(eps)² score`` (JAX sampling.py:338-388).

  Returns ``sampler(generator, z=None) -> (samples, nfe)``, ``z`` the NHWC
  state at T (None draws it from the prior)."""
  b, h, w, c = shape
  state_shape = (b, c, h, w)
  device = _model_device(model, device)

  def heun_sampler(generator: torch.Generator,
                   z: Optional[torch.Tensor] = None):
    score_fn = mutils.get_score_fn(sde, model, train=False,
                                   continuous=continuous)
    rsde = sde.reverse(score_fn, probability_flow=True)
    with torch.no_grad():
      x = _prior(sde, state_shape, generator, device, z)
      ts = sde_lib.linspace(sde.T, eps, n_steps + 1, device)
      for i in range(n_steps):
        dt = ts[i + 1] - ts[i]
        d0 = rsde.sde(x, ts[i].expand(b))[0]
        d1 = rsde.sde(x + dt * d0, ts[i + 1].expand(b))[0]
        x = x + dt * 0.5 * (d0 + d1)
      nfe = 2 * n_steps
      if denoise:
        t = torch.full((b,), eps, device=device)
        std = sde.marginal_prob(torch.zeros_like(x), t)[1]
        x = x + batch_mul(std ** 2, score_fn(x, t))
        nfe += 1
      out = inverse_scaler(x)
    return out.permute(0, 2, 3, 1), nfe

  return heun_sampler


def get_dpmpp_sampler(sde, model, shape, inverse_scaler, n_steps: int = 20,
                      denoise: bool = False, continuous: bool = True,
                      eps: float = 1e-3, stochastic: bool = False,
                      device=None):
  """DPM-Solver++(2M), 1 NFE a step, in half-log-SNR time
  ``lambda = log(alpha/sigma)`` with the data prediction
  ``x0 = (x + sigma² score)/alpha``; ``stochastic=True`` is
  SDE-DPM-Solver++(2M), which draws fresh noise each step through
  :func:`normal` (JAX sampling.py:391-477). ``denoise`` ends with the data
  prediction at ``eps`` (one more NFE).

  Returns ``sampler(generator, z=None) -> (samples, nfe)``, as
  :func:`get_heun_sampler`'s."""
  b, h, w, c = shape
  state_shape = (b, c, h, w)
  device = _model_device(model, device)

  def dpmpp_sampler(generator: torch.Generator,
                    z: Optional[torch.Tensor] = None):
    score_fn = mutils.get_score_fn(sde, model, train=False,
                                   continuous=continuous)
    with torch.no_grad():
      ts = sde_lib.linspace(sde.T, eps, n_steps + 1, device)
      mean, sigmas = sde.marginal_prob(
          torch.ones((n_steps + 1, 1, 1, 1), device=device), ts)
      alphas = mean.reshape(-1)
      lams = torch.log(alphas) - torch.log(sigmas)

      def x0_pred(x, i):
        t = ts[i].expand(b)
        return (x + sigmas[i] ** 2 * score_fn(x, t)) / alphas[i]

      x = _prior(sde, state_shape, generator, device, z)
      prev_x0 = x
      for i in range(n_steps):
        h_step = lams[i + 1] - lams[i]
        x0 = x0_pred(x, i)
        if i == 0:  # no history: first order
          d = x0
        else:
          r = (lams[i] - lams[i - 1]) / h_step
          d = (1.0 + 1.0 / (2.0 * r)) * x0 - prev_x0 / (2.0 * r)
        if stochastic:
          noise = normal(state_shape, generator, device)
          x = (sigmas[i + 1] / sigmas[i]) * torch.exp(-h_step) * x \
              - alphas[i + 1] * torch.expm1(-2.0 * h_step) * d \
              + sigmas[i + 1] * torch.sqrt(-torch.expm1(-2.0 * h_step)) * noise
        else:
          x = (sigmas[i + 1] / sigmas[i]) * x \
              - alphas[i + 1] * torch.expm1(-h_step) * d
        prev_x0 = x0
      nfe = n_steps
      if denoise:
        x = x0_pred(x, n_steps)
        nfe += 1
      out = inverse_scaler(x)
    return out.permute(0, 2, 3, 1), nfe

  return dpmpp_sampler


def get_sampling_fn(config, sde, model, shape, inverse_scaler,
                    eps: Optional[float] = None, device=None):
  """Sampler named by ``config.sampling.method``: ``pc``, ``ode``, ``heun``
  or ``dpmpp`` (JAX sampling.py:480-525). The ODE's tolerances and step
  limit come from ``config.sampling.{rtol,atol,ode_max_steps}``; heun's and
  dpmpp's step counts from ``sampling.heun_steps`` and
  ``sampling.dpmpp_steps``, and ``sampling.dpmpp_stochastic`` picks the SDE
  form of DPM-Solver++."""
  if eps is None:
    eps = sde_lib.sampling_eps(config)
  scfg = config.sampling
  method = scfg.method.lower()
  if method == "ode":
    return get_ode_sampler(
        sde, model, shape, inverse_scaler, denoise=scfg.noise_removal,
        rtol=scfg.get("rtol", 1e-5), atol=scfg.get("atol", 1e-5), eps=eps,
        max_steps=scfg.get("ode_max_steps", 10000), device=device)
  if method == "heun":
    return get_heun_sampler(
        sde, model, shape, inverse_scaler, n_steps=scfg.get("heun_steps", 50),
        denoise=scfg.noise_removal, continuous=config.training.continuous,
        eps=eps, device=device)
  if method == "dpmpp":
    return get_dpmpp_sampler(
        sde, model, shape, inverse_scaler,
        n_steps=scfg.get("dpmpp_steps", 20), denoise=scfg.noise_removal,
        continuous=config.training.continuous, eps=eps,
        stochastic=scfg.get("dpmpp_stochastic", False), device=device)
  if method == "pc":
    return get_pc_sampler(
        sde, model, shape, get_predictor(scfg.predictor.lower()),
        get_corrector(scfg.corrector.lower()), inverse_scaler, snr=scfg.snr,
        n_steps=scfg.n_steps_each, probability_flow=scfg.probability_flow,
        continuous=config.training.continuous, denoise=scfg.noise_removal,
        eps=eps, device=device)
  raise ValueError(f"Sampler name {scfg.method} unknown.")
