"""SDE core: the SDE base, its reverse, and the VP, subVP and VE SDEs
(PyTorch).

Counterpart of score_sde_pytorch_tpu/sde.py. Tensors are NCHW, time ``t`` is
a rank-1 batch vector, and randomness comes from an explicit
``torch.Generator``.
"""
from __future__ import annotations

import abc
import dataclasses
import math
from typing import Callable, Sequence, Tuple

import torch


def batch_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Multiply a batch vector ``a`` (shape ``[B]``) onto ``b`` (``[B, ...]``)."""
  return a.reshape(a.shape + (1,) * (b.dim() - a.dim())) * b


def linspace(start: float, stop: float, num: int,
             device=None) -> torch.Tensor:
  """fp32 ``linspace`` by ``jnp.linspace``'s formula.

  ``jnp.linspace`` computes ``start * (1 - s) + stop * s`` with
  ``s = arange(num - 1) / (num - 1)`` in fp32 and appends ``stop``.
  ``VESDE.discretize`` truncates ``t (N - 1)`` to a sigma index, so a time
  rounded to the other side of an integer shifts the index by one; with
  this formula the port's index sequence is the JAX package's (tested at
  N = 1000, 100 and 2000). XLA may fuse and reassociate the arithmetic, so
  single times can still differ from JAX's in the last bit."""
  # torch.full fills on the device: no host-to-device copy per call.
  start_t = torch.full((), start, dtype=torch.float32, device=device)
  stop_t = torch.full((), stop, dtype=torch.float32, device=device)
  if num == 1:
    return start_t.reshape(1)
  div = num - 1
  s = torch.arange(div, dtype=torch.float32, device=device) / div
  out = start_t * (1 - s) + stop_t * s
  return torch.cat([out, stop_t.reshape(1)])


class SDE(abc.ABC):
  """Abstract forward SDE ``dx = f(x,t) dt + g(t) dW`` on t in [0, T]."""

  N: int

  @property
  @abc.abstractmethod
  def T(self) -> float:
    """End time of the SDE."""

  @abc.abstractmethod
  def sde(self, x: torch.Tensor, t: torch.Tensor) -> Tuple[torch.Tensor,
                                                            torch.Tensor]:
    """Drift ``f(x,t)`` and diffusion ``g(t)`` (diffusion shape ``[B]``)."""

  @abc.abstractmethod
  def marginal_prob(self, x: torch.Tensor,
                    t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and std of the perturbation kernel ``p_t(x(t) | x(0))``."""

  @abc.abstractmethod
  def prior_sampling(self, shape: Sequence[int], generator: torch.Generator,
                     device) -> torch.Tensor:
    """Sample from the prior ``p_T``."""

  @abc.abstractmethod
  def prior_logp(self, z: torch.Tensor) -> torch.Tensor:
    """Log-density of the prior at ``z``; shape ``[B]``."""

  def discretize(self, x: torch.Tensor,
                 t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Euler–Maruyama step: ``f = drift * dt``, ``G = diffusion * sqrt(dt)``."""
    dt = self.T / self.N
    drift, diffusion = self.sde(x, t)
    return drift * dt, diffusion * math.sqrt(dt)

  def reverse(self, score_fn: Callable, probability_flow: bool = False):
    """Reverse-time SDE / probability-flow ODE."""
    return ReverseSDE(self, score_fn, probability_flow)


@dataclasses.dataclass(frozen=True)
class ReverseSDE:
  """``dx = [f - g² score (½ for the ODE)] dt + g dW``; ``g = 0`` for the ODE."""
  fwd: SDE
  score_fn: Callable
  probability_flow: bool = False

  @property
  def T(self) -> float:
    return self.fwd.T

  @property
  def N(self) -> int:
    return self.fwd.N

  def sde(self, x, t):
    drift, diffusion = self.fwd.sde(x, t)
    score = self.score_fn(x, t)
    factor = 0.5 if self.probability_flow else 1.0
    drift = drift - batch_mul(diffusion ** 2, score) * factor
    if self.probability_flow:
      diffusion = torch.zeros_like(diffusion)
    return drift, diffusion

  def discretize(self, x, t):
    """Reverse discretization for discrete-step predictors."""
    f, g = self.fwd.discretize(x, t)
    factor = 0.5 if self.probability_flow else 1.0
    rev_f = f - batch_mul(g ** 2, self.score_fn(x, t)) * factor
    rev_g = torch.zeros_like(g) if self.probability_flow else g
    return rev_f, rev_g


def _check_discrete_betas_valid(sde) -> None:
  """Raise where a discrete DDPM buffer is built with ``N <= beta_max``.

  The grid is ``linspace(beta_min/N, beta_max/N, N)``: with ``N <= beta_max``
  the last betas reach 1, the alphas go negative, and every discrete rule
  (reverse-diffusion discretization, ancestral sampling, the Langevin and
  ALD step sizes, the DDPM loss) returns NaN. Continuous use at small N
  stays legal (JAX sde.py:120-136)."""
  if sde.beta_max / sde.N >= 1.0:
    raise ValueError(
        f"{type(sde).__name__}(N={sde.N}, beta_max={sde.beta_max}): discrete "
        f"betas reach {sde.beta_max / sde.N:.3g} >= 1, so alphas go negative "
        "and every discrete sampling rule produces NaN. Use "
        f"num_scales > beta_max (= {sde.beta_max:g}) for VP/subVP.")


def _timestep_index(sde, t: torch.Tensor) -> torch.Tensor:
  """Index of time ``t`` on a discrete grid: ``int32(t (N - 1) / T)``,
  truncated, as the JAX package computes it."""
  return (t * (sde.N - 1) / sde.T).to(torch.int32).long()


class _LinearBeta:
  """The linear beta schedule and its discrete DDPM grid, shared by VP and
  subVP (which the samplers and losses tell apart by class: subVP is not a
  VP subclass). Buffers are fp32, built on the device asked for."""

  beta_min: float
  beta_max: float
  N: int

  @property
  def T(self) -> float:
    return 1.0

  def discrete_betas(self, device=None) -> torch.Tensor:
    _check_discrete_betas_valid(self)
    return linspace(self.beta_min / self.N, self.beta_max / self.N, self.N,
                    device)

  def alphas(self, device=None) -> torch.Tensor:
    return 1.0 - self.discrete_betas(device)

  def beta_t(self, t: torch.Tensor) -> torch.Tensor:
    return self.beta_min + t * (self.beta_max - self.beta_min)

  def _log_mean_coeff(self, t: torch.Tensor) -> torch.Tensor:
    return (-0.25 * t ** 2 * (self.beta_max - self.beta_min)
            - 0.5 * t * self.beta_min)

  def prior_sampling(self, shape, generator, device):
    return torch.randn(tuple(shape), generator=generator, device=device)

  def prior_logp(self, z):
    n = math.prod(z.shape[1:])
    return (-n / 2.0 * math.log(2 * math.pi)
            - torch.sum(z.reshape(z.shape[0], -1) ** 2, dim=-1) / 2.0)

  def timestep_index(self, t: torch.Tensor) -> torch.Tensor:
    return _timestep_index(self, t)


@dataclasses.dataclass(frozen=True)
class VPSDE(_LinearBeta, SDE):
  """Variance-preserving SDE (DDPM):
  ``dx = -0.5 beta(t) x dt + sqrt(beta(t)) dW``, beta linear in t."""
  beta_min: float = 0.1
  beta_max: float = 20.0
  N: int = 1000

  def alphas_cumprod(self, device=None) -> torch.Tensor:
    return torch.cumprod(self.alphas(device), dim=0)

  def sqrt_alphas_cumprod(self, device=None) -> torch.Tensor:
    return torch.sqrt(self.alphas_cumprod(device))

  def sqrt_1m_alphas_cumprod(self, device=None) -> torch.Tensor:
    return torch.sqrt(1.0 - self.alphas_cumprod(device))

  def sde(self, x, t):
    beta_t = self.beta_t(t)
    return -0.5 * batch_mul(beta_t, x), torch.sqrt(beta_t)

  def marginal_prob(self, x, t):
    log_mean_coeff = self._log_mean_coeff(t)
    mean = batch_mul(torch.exp(log_mean_coeff), x)
    std = torch.sqrt(1.0 - torch.exp(2.0 * log_mean_coeff))
    return mean, std

  def discretize(self, x, t):
    """DDPM discretization: ``f = (sqrt(alpha_i) - 1) x``, ``G = sqrt(beta_i)``."""
    timestep = self.timestep_index(t)
    beta = self.discrete_betas(t.device)[timestep]
    alpha = self.alphas(t.device)[timestep]
    return batch_mul(torch.sqrt(alpha), x) - x, torch.sqrt(beta)


@dataclasses.dataclass(frozen=True)
class SubVPSDE(_LinearBeta, SDE):
  """Sub-variance-preserving SDE. Its discrete betas and alphas (the linear
  schedule's) are what the Langevin and ALD correctors read, as in the JAX
  package; it has no DDPM discretization of its own."""
  beta_min: float = 0.1
  beta_max: float = 20.0
  N: int = 1000

  def sde(self, x, t):
    beta_t = self.beta_t(t)
    discount = 1.0 - torch.exp(-2.0 * self.beta_min * t
                               - (self.beta_max - self.beta_min) * t ** 2)
    return -0.5 * batch_mul(beta_t, x), torch.sqrt(beta_t * discount)

  def marginal_prob(self, x, t):
    log_mean_coeff = self._log_mean_coeff(t)
    mean = batch_mul(torch.exp(log_mean_coeff), x)
    # No square root: the JAX package and the reference both return the
    # variance 1 - exp(2 lmc) as "std" here, and the port is held to them.
    std = 1.0 - torch.exp(2.0 * log_mean_coeff)
    return mean, std


@dataclasses.dataclass(frozen=True)
class VESDE(SDE):
  """Variance-exploding SDE; ``sigma(t) = sigma_min (sigma_max/sigma_min)^t``."""
  sigma_min: float = 0.01
  sigma_max: float = 50.0
  N: int = 1000

  @property
  def T(self) -> float:
    return 1.0

  def discrete_sigmas(self, device=None) -> torch.Tensor:
    """Geometric noise ladder (ascending), fp32 as in the JAX package."""
    return torch.exp(linspace(math.log(self.sigma_min),
                              math.log(self.sigma_max), self.N, device))

  def sigma_t(self, t: torch.Tensor) -> torch.Tensor:
    return self.sigma_min * (self.sigma_max / self.sigma_min) ** t

  def sde(self, x, t):
    sigma = self.sigma_t(t)
    drift = torch.zeros_like(x)
    diffusion = sigma * math.sqrt(
        2.0 * (math.log(self.sigma_max) - math.log(self.sigma_min)))
    return drift, diffusion

  def marginal_prob(self, x, t):
    return x, self.sigma_t(t)

  def prior_sampling(self, shape, generator, device):
    return torch.randn(tuple(shape), generator=generator,
                       device=device) * self.sigma_max

  def prior_logp(self, z):
    n = math.prod(z.shape[1:])
    return (-n / 2.0 * math.log(2 * math.pi * self.sigma_max ** 2)
            - torch.sum(z.reshape(z.shape[0], -1) ** 2, dim=-1)
            / (2.0 * self.sigma_max ** 2))

  def timestep_index(self, t: torch.Tensor) -> torch.Tensor:
    """Sigma index of time ``t``: ``int32(t (N - 1) / T)``, truncated."""
    return _timestep_index(self, t)

  def discretize(self, x, t):
    """SMLD ancestral discretization: ``G = sqrt(sigma_i² - sigma_{i-1}²)``."""
    timestep = self.timestep_index(t)
    sigmas = self.discrete_sigmas(t.device)
    sigma = sigmas[timestep]
    adjacent_sigma = torch.where(timestep == 0, torch.zeros_like(sigma),
                                 sigmas[(timestep - 1).clamp_min(0)])
    f = torch.zeros_like(x)
    g = torch.sqrt(sigma ** 2 - adjacent_sigma ** 2)
    return f, g


def sampling_eps(config) -> float:
  """Smallest integration time (1e-3 VP/subVP, 1e-5 VE);
  ``config.sampling.eps > 0`` overrides."""
  if "sampling" in config:
    eps = config.sampling.get("eps", -1.0)
    if eps is not None and eps > 0:
      return float(eps)
  return 1e-5 if config.training.sde.lower() == "vesde" else 1e-3


def build_sde(config) -> SDE:
  """The SDE named in ``config.training.sde``."""
  name = config.training.sde.lower()
  m = config.model
  if name == "vpsde":
    return VPSDE(beta_min=m.beta_min, beta_max=m.beta_max, N=m.num_scales)
  if name == "subvpsde":
    return SubVPSDE(beta_min=m.beta_min, beta_max=m.beta_max, N=m.num_scales)
  if name == "vesde":
    return VESDE(sigma_min=m.sigma_min, sigma_max=m.sigma_max, N=m.num_scales)
  raise NotImplementedError(f"SDE {name} unknown.")
