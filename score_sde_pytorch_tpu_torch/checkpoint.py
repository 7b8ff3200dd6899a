"""Checkpoints in the torch reference's ``.pth`` schema.

A checkpoint is ``{"model", "ema", "optimizer", "step"}`` as the reference
(yang-song/score_sde_pytorch utils.py) saves it and as
``score_sde_pytorch_tpu.interop.export_torch_checkpoint`` writes it:

- ``model``: the state_dict with the ``module.`` prefix of the reference's
  DataParallel wrapper;
- ``ema``: ``{"decay", "num_updates", "shadow_params"}``, the shadow list in
  ``model.parameters()`` order restricted to trainable parameters (the
  Fourier projection ``W`` is not one);
- ``optimizer``: an Adam state_dict over ``model.parameters()``;
- ``step``.

The train loop (:func:`save_train_state`) also writes ``rng``: the states
of the generators a train step draws from, which reference loaders ignore.

Numbered snapshots live at ``workdir/checkpoints/checkpoint_<N>.pth``; the
rolling one at ``workdir/checkpoints-meta/checkpoint.pth``.
"""
from __future__ import annotations

import os
import re
from typing import Optional, Sequence

import torch

_PREFIX = "module."
_NUMBERED = re.compile(r"^checkpoint_(\d+)\.pth$")


def numbered_path(workdir: str, step: int) -> str:
  return os.path.join(workdir, "checkpoints", f"checkpoint_{step}.pth")


def meta_path(workdir: str) -> str:
  return os.path.join(workdir, "checkpoints-meta", "checkpoint.pth")


def has_numbered(workdir: str, step: int) -> bool:
  return os.path.isfile(numbered_path(workdir, step))


def latest_numbered(workdir: str) -> Optional[int]:
  """Largest N of ``checkpoints/checkpoint_N.pth``, or None."""
  ckpt_dir = os.path.join(workdir, "checkpoints")
  if not os.path.isdir(ckpt_dir):
    return None
  found = [int(m.group(1)) for m in map(_NUMBERED.match, os.listdir(ckpt_dir))
           if m]
  return max(found) if found else None


def _trainable(model: torch.nn.Module):
  return [p for p in model.parameters() if p.requires_grad]


def save_checkpoint(path: str, model: torch.nn.Module, config, *,
                    step: int = 0,
                    ema_params: Optional[Sequence[torch.Tensor]] = None
                    ) -> None:
  """Write ``model`` (and EMA shadow params, by default the model's own
  trainable params) as a reference-schema ``.pth``. The EMA decay is
  ``config.model.ema_rate``; the optimizer entry is a fresh Adam state over
  ``model.parameters()`` with ``config.optim``'s hyperparameters, as
  ``score_sde_pytorch_tpu.interop.export_torch_checkpoint`` writes it."""
  shadow = list(ema_params) if ema_params is not None else _trainable(model)
  if len(shadow) != len(_trainable(model)):
    raise ValueError(f"{len(shadow)} EMA params for "
                     f"{len(_trainable(model))} trainable params")
  params = [torch.nn.Parameter(p.detach().cpu().clone())
            for p in model.parameters()]
  optim = config.optim
  optimizer = torch.optim.Adam(params, lr=optim.lr, betas=(optim.beta1, 0.999),
                               eps=optim.eps, weight_decay=optim.weight_decay)
  ckpt = {
      "model": {_PREFIX + k: v.detach().cpu()
                for k, v in model.state_dict().items()},
      "ema": {"decay": float(config.model.ema_rate), "num_updates": int(step),
              "shadow_params": [p.detach().cpu().clone() for p in shadow]},
      "optimizer": optimizer.state_dict(),
      "step": int(step),
  }
  _write(ckpt, path)


def _write(ckpt: dict, path: str) -> None:
  """``torch.save`` to a temporary name, then rename into place, so a run
  stopped while writing leaves the previous file whole."""
  os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
  tmp = path + ".tmp"
  torch.save(ckpt, tmp)
  os.replace(tmp, path)


def _load_model_state(ckpt: dict, model: torch.nn.Module, path: str) -> None:
  """Load the checkpoint's ``model`` entry. The ``sigmas`` buffer is derived
  from ``config.model`` and keeps the model's own value (sampling may use
  fewer scales than training did); every other entry must match exactly."""
  state = {k[len(_PREFIX):] if k.startswith(_PREFIX) else k: v
           for k, v in ckpt["model"].items()}
  state.pop("sigmas", None)
  missing, unexpected = model.load_state_dict(state, strict=False)
  if unexpected or set(missing) - {"sigmas"}:
    raise KeyError(f"{path} does not fit the model: missing "
                   f"{sorted(set(missing) - {'sigmas'})[:8]}, unexpected "
                   f"{sorted(unexpected)[:8]}")


def _rng_states(generator: torch.Generator, device: torch.device) -> dict:
  states = {"generator": generator.get_state(),
            "torch_cpu": torch.get_rng_state()}
  if device.type == "cuda":
    states["torch_cuda"] = torch.cuda.get_rng_state(device)
  return states


def save_train_state(path: str, state: dict) -> None:
  """Write a train state (``losses.init_train_state``) in the reference
  schema: the model, its EMA and optimizer states and the step, plus under
  ``rng`` the step's generator and PyTorch's default generators (dropout's)
  of the CPU and, when the model is on one, the CUDA device."""
  model = state["model"]
  device = next(model.parameters()).device
  _write({
      "model": {_PREFIX + k: v.detach().cpu()
                for k, v in model.state_dict().items()},
      "ema": state["ema"].state_dict(),
      "optimizer": state["optimizer"].state_dict(),
      "step": int(state["step"]),
      "rng": _rng_states(state["generator"], device),
  }, path)


def restore_train_state(path: str, state: dict) -> int:
  """Load a checkpoint that :func:`save_train_state` wrote into ``state``
  (in place) and set the generators to its ``rng`` states, so a resumed
  run draws what an uninterrupted one would. Returns the step."""
  ckpt = torch.load(path, map_location="cpu", weights_only=True)
  if "rng" not in ckpt:
    raise KeyError(f"{path} has no generator states (key 'rng'): it was "
                   "not written by the train loop, so the run cannot resume "
                   "from it exactly")
  model = state["model"]
  device = next(model.parameters()).device
  _load_model_state(ckpt, model, path)
  state["optimizer"].load_state_dict(ckpt["optimizer"])
  state["ema"].load_state_dict(ckpt["ema"])
  state["step"] = int(ckpt["step"])
  rng = ckpt["rng"]
  state["generator"].set_state(rng["generator"])
  torch.set_rng_state(rng["torch_cpu"])
  if device.type == "cuda":
    torch.cuda.set_rng_state(rng["torch_cuda"], device)
  return state["step"]


def restore_model_and_ema(path: str, model: torch.nn.Module, ema) -> int:
  """Load ``path``'s model weights into ``model`` and its EMA state into
  ``ema`` (a ``models.ema.ExponentialMovingAverage``), as evaluation needs
  them: the optimizer and generator states are not read, so any
  reference-schema checkpoint serves. Returns the step."""
  ckpt = torch.load(path, map_location="cpu", weights_only=True)
  _load_model_state(ckpt, model, path)
  ema.load_state_dict(ckpt["ema"])
  return int(ckpt["step"])


def restore_ema(path: str, model: torch.nn.Module) -> int:
  """Load ``path`` into ``model``, then copy the EMA shadow params into its
  trainable params in order (what sampling uses). Returns the step.

  The ``sigmas`` buffer keeps the model's own value (see
  :func:`_load_model_state`)."""
  ckpt = torch.load(path, map_location="cpu", weights_only=True)
  _load_model_state(ckpt, model, path)
  trainable = _trainable(model)
  shadow = ckpt["ema"]["shadow_params"]
  if len(shadow) != len(trainable):
    raise ValueError(f"{path}: {len(shadow)} EMA shadow params for "
                     f"{len(trainable)} trainable params")
  with torch.no_grad():
    for param, value in zip(trainable, shadow):
      if param.shape != value.shape:
        raise ValueError(f"{path}: EMA shadow param of shape "
                         f"{tuple(value.shape)} for a parameter of shape "
                         f"{tuple(param.shape)}")
      param.copy_(value)
  return int(ckpt["step"])
