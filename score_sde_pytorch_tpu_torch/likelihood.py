"""Exact likelihood (bits/dim) through the probability-flow ODE (PyTorch).

Counterpart of score_sde_pytorch_tpu/likelihood.py:37-114: the augmented
``[x; Δlogp]`` system integrated from ``eps`` to ``T`` by
:func:`score_sde_pytorch_tpu_torch.ode.odeint_rk45`, a Rademacher or
Gaussian Hutchinson–Skilling estimate of the drift's divergence, bits/dim
with the ``7 − inverse_scaler(−1)`` offset, and NaN ``bpd`` and ``z`` when
the solver does not reach ``T``.

The divergence is reverse mode, ``εᵀ(∂f/∂x)ε = ((∂f/∂x)ᵀε)·ε``, one forward
and one vector–Jacobian product per drift evaluation, as the torch
reference computes it (yang-song/score_sde_pytorch likelihood.py:26-37).
The JAX package uses the forward-mode ``jax.jvp`` for the same quantity;
here forward mode would have to go through the attention kernels'
``autograd.Function``, which has a backward and no jvp, so the vjp runs
the hand-written forward and backward kernels on the card. Only the input
gets a gradient: the model's trainable parameters are frozen
(``requires_grad_(False)``) while the likelihood runs.

A vjp keeps one forward's activations, so the drift and its divergence are
evaluated in micro-batches of at most :data:`DRIFT_CHUNK` samples and
concatenated; the solver still sees the whole batch and takes one step size
for it. NCSN++ with GroupNorm treats each sample on its own, so the chunks
give what the whole batch would.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional

import torch

from score_sde_pytorch_tpu_torch import ode as ode_lib
from score_sde_pytorch_tpu_torch import sde as sde_lib
from score_sde_pytorch_tpu_torch.models import utils as mutils

#: samples per forward + vjp of the augmented drift; batch 128 at full
#: width is the train step's working set (PERF.md)
DRIFT_CHUNK = 128


def drift_and_div(fn, x: torch.Tensor, t: torch.Tensor, eps: torch.Tensor):
  """``(fn(x, t), εᵀ(∂fn/∂x)ε)`` from one forward and one vjp: the
  Hutchinson–Skilling estimate ``grad((fn(x)·ε).sum(), x)·ε`` per sample
  (the JAX package's ``get_div_fn``)."""
  with torch.enable_grad():
    x = x.detach().requires_grad_(True)
    fx = fn(x, t)
    (vjp,) = torch.autograd.grad(torch.sum(fx * eps), x)
  return fx.detach(), torch.sum(vjp * eps, dim=tuple(range(1, x.dim())))


def draw_epsilon(shape, generator: torch.Generator, hutchinson_type: str,
                 device) -> torch.Tensor:
  """The Hutchinson probe: Rademacher (±1) or standard Gaussian."""
  if hutchinson_type == "Gaussian":
    return torch.randn(tuple(shape), generator=generator, device=device)
  if hutchinson_type == "Rademacher":
    bits = torch.randint(0, 2, tuple(shape), generator=generator,
                         device=device)
    return bits.to(torch.float32) * 2 - 1
  raise NotImplementedError(f"Hutchinson type {hutchinson_type} unknown.")


@contextlib.contextmanager
def frozen(model: torch.nn.Module):
  """The model's trainable parameters with ``requires_grad`` off, so a
  vjp differentiates the input alone; restored on exit."""
  params = [p for p in model.parameters() if p.requires_grad]
  for p in params:
    p.requires_grad_(False)
  try:
    yield model
  finally:
    for p in params:
      p.requires_grad_(True)


def get_augmented_drift(sde: sde_lib.SDE, model: torch.nn.Module,
                        epsilon: torch.Tensor,
                        chunk: int = DRIFT_CHUNK) -> Callable:
  """``aug_drift((x, Δlogp), t) -> (drift, divergence)`` of the
  probability-flow ODE (JAX likelihood.py:75-80), ``t`` a Python float:
  one forward and one vjp per micro-batch of at most ``chunk`` samples.
  Call it with the model's parameters :func:`frozen`."""

  def drift_fn(x, t):
    score_fn = mutils.get_score_fn(sde, model, train=False, continuous=True)
    return sde.reverse(score_fn, probability_flow=True).sde(x, t)[0]

  def aug_drift(y, t_scalar: float):
    x, _ = y
    b = x.shape[0]
    t = torch.full((b,), t_scalar, device=x.device)
    parts = [drift_and_div(drift_fn, x[i:i + chunk], t[i:i + chunk],
                           epsilon[i:i + chunk])
             for i in range(0, b, chunk)]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))

  return aug_drift


def get_likelihood_fn(sde: sde_lib.SDE, model: torch.nn.Module,
                      inverse_scaler: Callable,
                      hutchinson_type: str = "Rademacher",
                      rtol: float = 1e-5, atol: float = 1e-5,
                      eps: float = 1e-5, max_steps: int = 10000,
                      chunk: int = DRIFT_CHUNK) -> Callable:
  """Bits/dim of a batch (JAX likelihood.py:37-102).

  Returns ``likelihood_fn(model, data, generator, epsilon=None) -> (bpd, z,
  nfe)``: ``data`` is a scaled NCHW batch on the model's device, ``bpd``
  has shape [B], ``z`` is the latent at ``T`` (NCHW) and ``nfe`` the
  solver's count of augmented drift evaluations. ``epsilon`` (data's shape)
  is the Hutchinson probe; None draws it from ``generator``.

  ``model`` here stands where the JAX package passes its ``model_def``; the
  weights are those of the ``model`` handed to each call, which is the
  module evaluated."""
  del model

  def likelihood_fn(mdl: torch.nn.Module, data: torch.Tensor,
                    generator: Optional[torch.Generator],
                    epsilon: Optional[torch.Tensor] = None):
    b = data.shape[0]
    if epsilon is None:
      epsilon = draw_epsilon(data.shape, generator, hutchinson_type,
                             data.device)
    aug_drift = get_augmented_drift(sde, mdl, epsilon, chunk)
    with frozen(mdl):
      init = (data, torch.zeros((b,), dtype=data.dtype, device=data.device))
      (z, delta_logp), nfe, status = ode_lib.odeint_rk45(
          aug_drift, init, eps, sde.T, rtol=rtol, atol=atol,
          max_steps=max_steps)

    prior_logp = sde.prior_logp(z)
    n_dims = math.prod(data.shape[1:])
    bpd = -(prior_logp + delta_logp) / math.log(2.0) / n_dims
    # Data scaling offset (reference likelihood.py:106-110): with
    # inverse_scaler mapping model space back to [0,1],
    # offset = 7 - inverse_scaler(-1).
    bpd = bpd + (7.0 - inverse_scaler(-1.0))
    # A solver that did not reach T leaves an unfinished trajectory: NaN
    # the bpd and the latent rather than return plausible wrong numbers.
    if status != ode_lib.STATUS_OK:
      bpd = torch.full_like(bpd, float("nan"))
      z = torch.full_like(z, float("nan"))
    return bpd, z, nfe

  return likelihood_fn
