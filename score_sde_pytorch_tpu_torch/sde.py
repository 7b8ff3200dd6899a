"""SDE core: the SDE base, its reverse, and the VE SDE (PyTorch).

Counterpart of score_sde_pytorch_tpu/sde.py:34-118 and 268-345. Tensors are
NCHW, time ``t`` is a rank-1 batch vector, and randomness comes from an
explicit ``torch.Generator``. VP and subVP are not ported yet.
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
    return (t * (self.N - 1) / self.T).to(torch.int32).long()

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
  if name == "vesde":
    return VESDE(sigma_min=config.model.sigma_min,
                 sigma_max=config.model.sigma_max, N=config.model.num_scales)
  if name in ("vpsde", "subvpsde"):
    raise NotImplementedError(
        f"SDE {name} is not ported yet; see ROADMAP.md queue 1 item 2")
  raise NotImplementedError(f"SDE {name} unknown.")
