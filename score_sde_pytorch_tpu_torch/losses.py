"""Losses, optimizer, and train/eval step functions (PyTorch).

Counterpart of score_sde_pytorch_tpu/losses.py. The JAX package threads a
``TrainState`` pytree through pure, jitted steps; here the state is the
torch reference's dict of live objects, updated in place:

    state = {"model", "optimizer", "ema", "step", "generator"}

``generator`` is the ``torch.Generator`` the train step draws t and z from.
Dropout draws from PyTorch's default generator of the model's device (the
train loop seeds it and checkpoints its state). ``training.n_jitted_steps``
becomes a host loop of n eager steps per call (:func:`get_n_step_fn`).
"""
from __future__ import annotations

from typing import Callable, Iterable, Sequence

import torch

from score_sde_pytorch_tpu_torch import sde as sde_lib
from score_sde_pytorch_tpu_torch.models import utils as mutils
from score_sde_pytorch_tpu_torch.models.ema import ExponentialMovingAverage
from score_sde_pytorch_tpu_torch.sde import batch_mul

_B2 = 0.999  # the JAX package and the reference fix Adam's beta2


class AMSGrad(torch.optim.Optimizer):
  """Adam with the AMSGrad maximum taken as optax takes it.

  ``optax.amsgrad`` keeps the running maximum of the bias-corrected second
  moment, ``nu_max = max(nu_max, nu / (1 - b2^t))``. ``torch.optim.Adam(
  amsgrad=True)`` keeps the maximum of the raw moment and bias-corrects it
  afterwards, which is a different optimizer: after a step whose gradient
  is 0 its second moment is up to a factor 1 + b2 smaller. The update is
  ``-lr · m̂ / (sqrt(nu_max) + eps)``, with ``m̂ = m / (1 - b1^t)``."""

  def __init__(self, params, lr: float, betas=(0.9, _B2), eps: float = 1e-8):
    super().__init__(params, {"lr": lr, "betas": tuple(betas), "eps": eps})

  @torch.no_grad()
  def step(self, closure=None):
    for group in self.param_groups:
      b1, b2 = group["betas"]
      for p in group["params"]:
        if p.grad is None:
          continue
        state = self.state[p]
        if not state:
          state["step"] = 0
          state["exp_avg"] = torch.zeros_like(p)
          state["exp_avg_sq"] = torch.zeros_like(p)
          state["max_exp_avg_sq"] = torch.zeros_like(p)
        state["step"] += 1
        t = state["step"]
        m, v, v_max = (state["exp_avg"], state["exp_avg_sq"],
                       state["max_exp_avg_sq"])
        m.mul_(b1).add_(p.grad, alpha=1 - b1)
        v.mul_(b2).addcmul_(p.grad, p.grad, value=1 - b2)
        torch.maximum(v_max, v / (1 - b2 ** t), out=v_max)
        denom = v_max.sqrt().add_(group["eps"])
        p.addcdiv_(m, denom, value=-group["lr"] / (1 - b1 ** t))
    return None


def get_optimizer(config, params: Iterable[torch.nn.Parameter]
                  ) -> torch.optim.Optimizer:
  """The optimizer of ``config.optim`` (JAX losses.py:37-68): Adam with
  b2 = 0.999; decoupled weight decay (AdamW, as optax.adamw) when
  ``optim.weight_decay`` is set; :class:`AMSGrad` when ``optim.amsgrad``
  is. The learning rate is set per step by :func:`optimization_manager`."""
  optim = config.optim
  if optim.optimizer != "Adam":
    raise NotImplementedError(f"Optimizer {optim.optimizer} not supported yet!")
  params = list(params)
  betas = (optim.beta1, _B2)
  if optim.get("amsgrad", False):
    if optim.get("weight_decay", 0):
      raise NotImplementedError("amsgrad with weight_decay not supported")
    return AMSGrad(params, lr=optim.lr, betas=betas, eps=optim.eps)
  if optim.get("weight_decay", 0):
    return torch.optim.AdamW(params, lr=optim.lr, betas=betas, eps=optim.eps,
                             weight_decay=optim.weight_decay)
  return torch.optim.Adam(params, lr=optim.lr, betas=betas, eps=optim.eps)


def clip_by_global_norm_(grads: Sequence[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
  """optax's ``clip_by_global_norm``, in place: when the global norm is not
  below ``max_norm``, every gradient is scaled by ``max_norm / norm``
  (``clip_grad_norm_`` scales by ``max_norm / (norm + 1e-6)`` instead).
  Stays on the device: no host sync. Returns the norm."""
  norm = torch.linalg.vector_norm(
      torch.stack(torch._foreach_norm(grads)))
  factor = torch.where(norm < max_norm, torch.ones_like(norm),
                       max_norm / norm)
  torch._foreach_mul_(grads, factor)
  return norm


def optimization_manager(config) -> Callable:
  """``optimize_fn(optimizer, params, step)``: linear warmup of the learning
  rate, ``lr · min(step / warmup, 1)`` with ``step`` the number of steps
  taken before this one (so the first step's rate is 0, as optax's count
  starts at 0), then global-norm clipping when ``optim.grad_clip >= 0``,
  then the optimizer's step."""
  lr, warmup, grad_clip = (config.optim.lr, config.optim.warmup,
                           config.optim.grad_clip)

  def optimize_fn(optimizer: torch.optim.Optimizer,
                  params: Iterable[torch.nn.Parameter], step: int) -> None:
    rate = lr * min(step / warmup, 1.0) if warmup > 0 else lr
    for group in optimizer.param_groups:
      group["lr"] = rate
    if grad_clip >= 0:
      grads = [p.grad for p in params if p.grad is not None]
      clip_by_global_norm_(grads, grad_clip)
    optimizer.step()

  return optimize_fn


def init_train_state(config, model: torch.nn.Module, device) -> dict:
  """Optimizer, EMA, step 0 and the step's generator, seeded from
  ``config.seed``, around ``model`` (JAX losses.py:71-82)."""
  return {
      "model": model,
      "optimizer": get_optimizer(config, model.parameters()),
      "ema": ExponentialMovingAverage(model.parameters(),
                                      decay=config.model.ema_rate),
      "step": 0,
      "generator": torch.Generator(device=device).manual_seed(config.seed),
  }


def get_sde_loss_core(sde: sde_lib.SDE, train: bool, reduce_mean: bool = True,
                      continuous: bool = True,
                      likelihood_weighting: bool = True) -> Callable:
  """``core(model, batch, t, z) -> scalar``: the continuous score-matching
  loss at given times ``t`` ([B]) and noise ``z`` (batch's shape) (JAX
  losses.py:96-114 after the draws)."""

  def reduce_op(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=-1) if reduce_mean else 0.5 * x.sum(dim=-1)

  def core(model: torch.nn.Module, batch: torch.Tensor, t: torch.Tensor,
           z: torch.Tensor) -> torch.Tensor:
    score_fn = mutils.get_score_fn(sde, model, train=train,
                                   continuous=continuous)
    mean, std = sde.marginal_prob(batch, t)
    perturbed_data = mean + batch_mul(std, z)
    score = score_fn(perturbed_data, t)
    if not likelihood_weighting:
      losses = torch.square(batch_mul(std, score) + z)
      losses = reduce_op(losses.reshape(losses.shape[0], -1))
    else:
      g2 = sde.sde(torch.zeros_like(batch), t)[1] ** 2
      losses = torch.square(score + batch_mul(1.0 / std, z))
      losses = reduce_op(losses.reshape(losses.shape[0], -1)) * g2
    return torch.mean(losses)

  return core


def draw_t_z(batch: torch.Tensor, generator: torch.Generator, eps: float,
             T: float):
  """The loss's draws, t ~ U(eps, T) per example and z ~ N(0, 1) of the
  batch's shape; the one place the train and eval steps draw them."""
  t = torch.rand(batch.shape[0], generator=generator,
                 device=batch.device) * (T - eps) + eps
  z = torch.randn(batch.shape, generator=generator, device=batch.device)
  return t, z


def get_sde_loss_fn(sde: sde_lib.SDE, train: bool, reduce_mean: bool = True,
                    continuous: bool = True, likelihood_weighting: bool = True,
                    eps: float = 1e-5) -> Callable:
  """``loss_fn(model, batch, generator) -> scalar`` (JAX losses.py:85-116):
  draws t and z from ``generator``, then :func:`get_sde_loss_core`."""
  core = get_sde_loss_core(sde, train, reduce_mean, continuous,
                           likelihood_weighting)

  def loss_fn(model, batch, generator):
    t, z = draw_t_z(batch, generator, eps, sde.T)
    return core(model, batch, t, z)

  return loss_fn


def get_smld_loss_fn(*args, **kwargs):
  """SMLD loss (JAX losses.py:119-142): needs the discrete VE score
  function, which is not ported."""
  raise NotImplementedError("the SMLD loss (training.continuous=False on a "
                            "VE SDE) is not ported yet; see ROADMAP.md queue "
                            "1 item 11")


def get_ddpm_loss_fn(*args, **kwargs):
  """DDPM loss (JAX losses.py:145-166): needs the VP SDE, not ported."""
  raise NotImplementedError("the DDPM loss needs the VP SDE, which is not "
                            "ported yet; see ROADMAP.md queue 1 item 2")


def _select_loss_fn(sde, train, reduce_mean, continuous,
                    likelihood_weighting):
  """Loss dispatch (JAX losses.py:169-183)."""
  if continuous:
    return get_sde_loss_fn(sde, train, reduce_mean=reduce_mean,
                           continuous=True,
                           likelihood_weighting=likelihood_weighting)
  if likelihood_weighting:
    raise ValueError("Likelihood weighting is not supported for original "
                     "SMLD/DDPM training.")
  if isinstance(sde, sde_lib.VESDE):
    return get_smld_loss_fn(sde, train, reduce_mean=reduce_mean)
  return get_ddpm_loss_fn(sde, train, reduce_mean=reduce_mean)


def get_step_fn(sde: sde_lib.SDE, train: bool, optimize_fn=None,
                reduce_mean: bool = False, continuous: bool = True,
                likelihood_weighting: bool = False) -> Callable:
  """One step, ``step_fn(state, batch, generator) -> loss`` (JAX
  losses.py:208-257), the loss a 0-d device tensor (no host sync).

  - train: loss and gradients at the model's weights, clipping and the
    optimizer's step (``optimize_fn``), then the EMA update; ``state``'s
    ``step`` advances by one.
  - eval: the loss at the EMA weights, without gradients and with dropout
    off; the model's own weights are put back and ``state`` is unchanged."""
  loss_fn = _select_loss_fn(sde, train, reduce_mean, continuous,
                            likelihood_weighting)

  if train:
    if optimize_fn is None:
      raise ValueError("a train step needs optimize_fn")

    def step_fn(state, batch, generator):
      model, optimizer = state["model"], state["optimizer"]
      optimizer.zero_grad(set_to_none=True)
      loss = loss_fn(model, batch, generator)
      loss.backward()
      optimize_fn(optimizer, model.parameters(), step=state["step"])
      state["step"] += 1
      state["ema"].update(model.parameters())
      return loss.detach()

  else:

    def step_fn(state, batch, generator):
      model, ema = state["model"], state["ema"]
      with torch.no_grad():
        ema.store(model.parameters())
        ema.copy_to(model.parameters())
        try:
          loss = loss_fn(model, batch, generator)
        finally:
          ema.restore(model.parameters())
      return loss

  return step_fn


def get_n_step_fn(step_fn: Callable, n_steps: int) -> Callable:
  """``n_step_fn(state, batches, generator) -> losses [n]``: ``n_steps``
  eager steps in a host loop, one per batch of ``batches`` (the JAX
  package's ``lax.scan`` over ``training.n_jitted_steps``)."""

  def n_step_fn(state, batches, generator):
    if len(batches) != n_steps:
      raise ValueError(f"{len(batches)} batches for {n_steps} steps")
    return torch.stack([step_fn(state, b, generator) for b in batches])

  return n_step_fn
