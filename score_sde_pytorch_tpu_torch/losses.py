"""Losses, optimizer, and train/eval step functions (PyTorch).

Counterpart of score_sde_pytorch_tpu/losses.py. The JAX package threads a
``TrainState`` pytree through pure, jitted steps; here the state is the
torch reference's dict of live objects, updated in place:

    state = {"model", "forward", "optimizer", "ema", "step", "generator"}

``generator`` is the ``torch.Generator`` the train step draws t and z from.
Dropout draws from PyTorch's default generator of the model's device (the
train loop seeds it and checkpoints its state). ``forward`` is the module
the train step's loss runs through: the model itself, or its
DistributedDataParallel wrapper in a run over several ranks (the EMA, the
checkpoints and the samplers see the bare ``model``). With a process group
the steps draw the global batch's t and z and keep the rank's rows, and the
loss they return is the mean over the ranks. ``training.n_jitted_steps``
becomes a host loop of n eager steps per call (:func:`get_n_step_fn`).

With a space group as well (``parallel.init_grid``: ``group`` the data
group, ``space_group`` the ranks that split each image's height), the
steps take the rank's rows of the global batch cut to its slab of rows,
run the model split over the space group (``parallel/spatial.py``), draw
the global t and z and keep the rank's rows and slab (t is equal across a
space group), and all-reduce each example's pixel sums over the space
group before the division and the weighting, so every rank of a space
group holds the whole loss. Its gradient then sums to S times the loss's
over the space group, and DistributedDataParallel's mean over the D·S
ranks of the world is the data ranks' mean, the gradient of the global
batch's loss; the loss returned is the true one. Dropout draws each
slab's mask on its own rank, so with dropout on a split run differs from
one process (the parity checks run with ``model.dropout=0``).
"""
from __future__ import annotations

from typing import Callable, Iterable, Sequence

import torch

from score_sde_pytorch_tpu_torch import parallel
from score_sde_pytorch_tpu_torch import sde as sde_lib
from score_sde_pytorch_tpu_torch.models import utils as mutils
from score_sde_pytorch_tpu_torch.models.ema import ExponentialMovingAverage
from score_sde_pytorch_tpu_torch.parallel import spatial
from score_sde_pytorch_tpu_torch.sde import batch_mul
from score_sde_pytorch_tpu_torch.utils import tracing

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
  ``config.seed``, around ``model`` (JAX losses.py:71-82); the train step's
  ``forward`` is ``model`` until a run over several ranks wraps it."""
  return {
      "model": model,
      "forward": model,
      "optimizer": get_optimizer(config, model.parameters()),
      "ema": ExponentialMovingAverage(model.parameters(),
                                      decay=config.model.ema_rate),
      "step": 0,
      "generator": torch.Generator(device=device).manual_seed(config.seed),
  }


def _reduce_op(reduce_mean: bool, space_group=None) -> Callable:
  """Per-example reduction of a [B, D] tensor: the mean, or half the sum;
  with a space group, over the D pixels of every rank's slab (the sums
  all-reduced over the group)."""

  def reduce_op(x: torch.Tensor) -> torch.Tensor:
    if space_group is None:
      return x.mean(dim=-1) if reduce_mean else 0.5 * x.sum(dim=-1)
    total = spatial.all_reduce_sum(x.sum(dim=-1), space_group)
    if reduce_mean:
      return total / (x.shape[-1] * parallel.group_size(space_group))
    return 0.5 * total

  return reduce_op


def get_sde_loss_core(sde: sde_lib.SDE, train: bool, reduce_mean: bool = True,
                      continuous: bool = True,
                      likelihood_weighting: bool = True,
                      space_group=None) -> Callable:
  """``core(model, batch, t, z) -> scalar``: the continuous score-matching
  loss at given times ``t`` ([B]) and noise ``z`` (batch's shape) (JAX
  losses.py:96-114 after the draws); with a ``space_group``, ``batch`` and
  ``z`` are the rank's slabs and the loss is the whole images'."""
  reduce_op = _reduce_op(reduce_mean, space_group)

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


def _global_shape(batch: torch.Tensor, group, space_group) -> tuple:
  """The global batch's shape of the rank's rows (and slab) ``batch``."""
  shape = list(batch.shape)
  shape[0] *= parallel.group_size(group)
  if space_group is not None:
    shape[2] *= parallel.group_size(space_group)
  return tuple(shape)


def _local_slab(z: torch.Tensor, group, space_group) -> torch.Tensor:
  """The rank's rows of a global draw of the batch's shape, cut to its
  slab of image rows."""
  return spatial.split_rows(parallel.local_rows(z, group), space_group)


def draw_t_z(batch: torch.Tensor, generator: torch.Generator, eps: float,
             T: float, group=None, space_group=None):
  """The loss's draws, t ~ U(eps, T) per example and z ~ N(0, 1) of the
  batch's shape; the one place the train and eval steps draw them. With a
  process group, ``batch`` is the rank's rows: the global batch's t and z
  are drawn and the rank keeps its rows, so the generator advances on
  every rank as in one process (JAX's one global key). With a space group
  as well, ``batch`` is the rows' slab and z is cut to it too."""
  shape = _global_shape(batch, group, space_group)
  t = torch.rand(shape[0], generator=generator,
                 device=batch.device) * (T - eps) + eps
  z = torch.randn(shape, generator=generator, device=batch.device)
  return parallel.local_rows(t, group), _local_slab(z, group, space_group)


def get_sde_loss_fn(sde: sde_lib.SDE, train: bool, reduce_mean: bool = True,
                    continuous: bool = True, likelihood_weighting: bool = True,
                    eps: float = 1e-5, group=None,
                    space_group=None) -> Callable:
  """``loss_fn(model, batch, generator) -> scalar`` (JAX losses.py:85-116):
  draws t and z from ``generator`` (the rank's rows and slab of the global
  draws with a ``group`` and ``space_group``), then
  :func:`get_sde_loss_core`."""
  core = get_sde_loss_core(sde, train, reduce_mean, continuous,
                           likelihood_weighting, space_group)

  def loss_fn(model, batch, generator):
    t, z = draw_t_z(batch, generator, eps, sde.T, group, space_group)
    return core(model, batch, t, z)

  return loss_fn


def draw_labels_z(batch: torch.Tensor, generator: torch.Generator, n: int,
                  group=None, space_group=None):
  """The discrete losses' draws: an integer noise level in [0, n) per
  example and z ~ N(0, 1) of the batch's shape; with a process group the
  rank's rows (and slab) of the global draws, as :func:`draw_t_z`."""
  shape = _global_shape(batch, group, space_group)
  labels = torch.randint(0, n, (shape[0],), generator=generator,
                         device=batch.device)
  z = torch.randn(shape, generator=generator, device=batch.device)
  return (parallel.local_rows(labels, group),
          _local_slab(z, group, space_group))


def get_smld_loss_core(vesde: sde_lib.VESDE, train: bool,
                       reduce_mean: bool = False,
                       space_group=None) -> Callable:
  """``core(model, batch, labels, z) -> scalar``: the SMLD (NCSN) loss at
  integer ``labels`` into the descending sigma ladder and noise ``z`` (JAX
  losses.py:119-142 after the draws)."""
  if not isinstance(vesde, sde_lib.VESDE):
    raise ValueError("SMLD training only works for VESDEs.")
  reduce_op = _reduce_op(reduce_mean, space_group)

  def core(model, batch, labels, z):
    model_fn = mutils.get_model_fn(model, train=train)
    # Previous SMLD models assume descending sigmas.
    sigmas = torch.flip(vesde.discrete_sigmas(batch.device), (0,))[labels]
    noise = batch_mul(sigmas, z)
    score = model_fn(noise + batch, labels)
    target = batch_mul(-1.0 / sigmas ** 2, noise)
    losses = torch.square(score - target)
    losses = reduce_op(losses.reshape(losses.shape[0], -1)) * sigmas ** 2
    return torch.mean(losses)

  return core


def get_ddpm_loss_core(vpsde: sde_lib.VPSDE, train: bool,
                       reduce_mean: bool = True,
                       space_group=None) -> Callable:
  """``core(model, batch, labels, z) -> scalar``: the DDPM epsilon-prediction
  loss at integer timesteps ``labels`` and noise ``z`` (JAX
  losses.py:145-166 after the draws)."""
  if not isinstance(vpsde, sde_lib.VPSDE):
    raise ValueError("DDPM training only works for VPSDEs.")
  reduce_op = _reduce_op(reduce_mean, space_group)

  def core(model, batch, labels, z):
    model_fn = mutils.get_model_fn(model, train=train)
    perturbed_data = (
        batch_mul(vpsde.sqrt_alphas_cumprod(batch.device)[labels], batch)
        + batch_mul(vpsde.sqrt_1m_alphas_cumprod(batch.device)[labels], z))
    score = model_fn(perturbed_data, labels)
    losses = torch.square(score - z)
    return torch.mean(reduce_op(losses.reshape(losses.shape[0], -1)))

  return core


def get_smld_loss_fn(vesde: sde_lib.VESDE, train: bool,
                     reduce_mean: bool = False, group=None,
                     space_group=None) -> Callable:
  """``loss_fn(model, batch, generator) -> scalar``: draws the labels and z
  from ``generator``, then :func:`get_smld_loss_core`."""
  core = get_smld_loss_core(vesde, train, reduce_mean, space_group)

  def loss_fn(model, batch, generator):
    return core(model, batch, *draw_labels_z(batch, generator, vesde.N,
                                             group, space_group))

  return loss_fn


def get_ddpm_loss_fn(vpsde: sde_lib.VPSDE, train: bool,
                     reduce_mean: bool = True, group=None,
                     space_group=None) -> Callable:
  """``loss_fn(model, batch, generator) -> scalar``: draws the labels and z
  from ``generator``, then :func:`get_ddpm_loss_core`."""
  core = get_ddpm_loss_core(vpsde, train, reduce_mean, space_group)

  def loss_fn(model, batch, generator):
    return core(model, batch, *draw_labels_z(batch, generator, vpsde.N,
                                             group, space_group))

  return loss_fn


def _select_loss_fn(sde, train, reduce_mean, continuous,
                    likelihood_weighting, group=None, space_group=None):
  """Loss dispatch (JAX losses.py:169-183)."""
  if continuous:
    return get_sde_loss_fn(sde, train, reduce_mean=reduce_mean,
                           continuous=True,
                           likelihood_weighting=likelihood_weighting,
                           group=group, space_group=space_group)
  if likelihood_weighting:
    raise ValueError("Likelihood weighting is not supported for original "
                     "SMLD/DDPM training.")
  if isinstance(sde, sde_lib.VESDE):
    return get_smld_loss_fn(sde, train, reduce_mean=reduce_mean,
                            group=group, space_group=space_group)
  if isinstance(sde, sde_lib.VPSDE):
    return get_ddpm_loss_fn(sde, train, reduce_mean=reduce_mean,
                            group=group, space_group=space_group)
  raise ValueError(
      f"Discrete training for {type(sde).__name__} is not recommended.")


def get_step_fn(sde: sde_lib.SDE, train: bool, optimize_fn=None,
                reduce_mean: bool = False, continuous: bool = True,
                likelihood_weighting: bool = False, group=None,
                space_group=None) -> Callable:
  """One step, ``step_fn(state, batch, generator) -> loss`` (JAX
  losses.py:208-257), the loss a 0-d device tensor (no host sync).

  - train: loss and gradients at the model's weights, the forward through
    ``state["forward"]`` (DistributedDataParallel averages the gradients
    over the ranks), clipping and the optimizer's step (``optimize_fn``),
    then the EMA update; ``state``'s ``step`` advances by one.
  - eval: the loss at the EMA weights, without gradients and with dropout
    off; the model's own weights are put back and ``state`` is unchanged.

  The train step is counted and spanned as ``train.step`` (its step count
  the span's args) with ``train.loss``, ``train.backward``,
  ``train.optimize`` and ``train.ema`` inside, the eval step as
  ``eval.step`` (``utils/tracing.py``).

  With a process ``group``, ``batch`` is the rank's rows of the global
  batch and the loss returned is the mean over the ranks (JAX's replicated
  scalar). With a ``space_group`` (of more than one rank) as well,
  ``group`` is the data group, ``batch`` the rows' slab of image rows, and
  the model, which must be built with ``model.spatial_sharding``, runs
  split over the space group inside ``spatial.sharded(space_group)`` (the
  module docstring); ``state["forward"]`` is then DDP over the world
  group."""
  space_group = None if parallel.group_size(space_group) == 1 else space_group
  loss_fn = _select_loss_fn(sde, train, reduce_mean, continuous,
                            likelihood_weighting, group, space_group)

  def check_split(model) -> None:
    if space_group is not None and not getattr(model, "spatial_sharding",
                                               False):
      raise ValueError("a step over a space group needs a model built with "
                       "model.spatial_sharding")

  if train:
    if optimize_fn is None:
      raise ValueError("a train step needs optimize_fn")

    def step_fn(state, batch, generator):
      with tracing.counted("train.step", args=state["step"]):
        model, optimizer = state["model"], state["optimizer"]
        check_split(model)
        optimizer.zero_grad(set_to_none=True)
        with tracing.counted("train.loss"), spatial.sharded(space_group):
          loss = loss_fn(state["forward"], batch, generator)
        with tracing.counted("train.backward"):
          loss.backward()
        with tracing.counted("train.optimize"):
          optimize_fn(optimizer, model.parameters(), step=state["step"])
        state["step"] += 1
        with tracing.counted("train.ema"):
          state["ema"].update(model.parameters())
        return parallel.all_reduce_mean(loss.detach(), group)

  else:

    def step_fn(state, batch, generator):
      with tracing.counted("eval.step"):
        model, ema = state["model"], state["ema"]
        check_split(model)
        with torch.no_grad(), spatial.sharded(space_group):
          ema.store(model.parameters())
          ema.copy_to(model.parameters())
          try:
            loss = loss_fn(model, batch, generator)
          finally:
            ema.restore(model.parameters())
        return parallel.all_reduce_mean(loss, group)

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
