"""Faults planted under the timed path, for the benchmark's own tests and
its calibration on the card: each breaks the program as a later change
might, and the comparison with the reference has to come out not correct.
A benchmark run plants none (``Context.fault`` is None).

- ``unchanged``: a step that returns its state as it found it (training:
  Adam and the EMA leave the weights; sampling: the predictor and the
  corrector return x);
- ``half_batch``: half of the batch left out (training: the loss is the
  mean over the first half; sampling: the second half's score is the first
  half's);
- ``altered``: one answer altered where it is produced (training: the
  network's output for one image, +1; sampling: one image of the samples,
  +1).

The program's modules are patched by swapping attributes, and put back by
:func:`remove`.
"""
from __future__ import annotations

import torch

FAULTS = ("unchanged", "half_batch", "altered")
_undo = []


def _swap(obj, name: str, value) -> None:
  _undo.append((obj, name, getattr(obj, name)))
  setattr(obj, name, value)


def remove() -> None:
  while _undo:
    obj, name, value = _undo.pop()
    if isinstance(obj, dict):
      obj[name] = value
    else:
      setattr(obj, name, value)


class _HalfMeanTorch:
  """``torch`` with ``mean`` of a 1-D tensor taken over its first half."""

  def __getattr__(self, name):
    return getattr(torch, name)

  @staticmethod
  def mean(x, *args, **kwargs):
    if x.dim() == 1 and not args and not kwargs:
      return torch.mean(x[:x.shape[0] // 2])
    return torch.mean(x, *args, **kwargs)


def _wrap_score(edit) -> None:
  from score_sde_pytorch_tpu_torch.models import utils as mutils
  original = mutils.get_score_fn

  def get_score_fn(*args, **kwargs):
    score_fn = original(*args, **kwargs)
    return lambda x, t: edit(score_fn(x, t))

  _swap(mutils, "get_score_fn", get_score_fn)


def _first_altered(x: torch.Tensor, value: float) -> torch.Tensor:
  """``x`` with ``value`` added to its first row (an image)."""
  delta = torch.zeros_like(x)
  delta[0] = value
  return x + delta


def _halves(x: torch.Tensor) -> torch.Tensor:
  h = x.shape[0] // 2
  return torch.cat([x[:h], x[:h], x[2 * h:]])


def plant(ctx) -> None:
  """Plants ``ctx.fault`` for ``ctx.cell['mode']``."""
  fault, mode = ctx.fault, ctx.cell["mode"]
  if fault is None:
    return
  if fault not in FAULTS:
    raise ValueError(f"unknown fault {fault!r}")
  from score_sde_pytorch_tpu_torch import datasets, losses
  from score_sde_pytorch_tpu_torch import sampling
  from score_sde_pytorch_tpu_torch.models import ema
  if mode == "train":
    if fault == "unchanged":
      _swap(torch.optim.Adam, "step", lambda self, closure=None: None)
      _swap(ema.ExponentialMovingAverage, "update",
            lambda self, parameters: None)
    elif fault == "half_batch":
      _swap(losses, "torch", _HalfMeanTorch())
    else:
      _wrap_score(lambda s: _first_altered(s, 1.0))
  elif mode == "sample_pc":
    if fault == "unchanged":
      same = lambda *a, **k: (lambda x, t, z: (x, x))  # noqa: E731
      for registry in (sampling._PREDICTORS, sampling._CORRECTORS):
        for name in list(registry):
          _undo.append((registry, name, registry[name]))
          registry[name] = same
    elif fault == "half_batch":
      _wrap_score(_halves)
    else:
      original = datasets.get_data_inverse_scaler
      _swap(datasets, "get_data_inverse_scaler",
            lambda cfg: (lambda x: _first_altered(original(cfg)(x), 1.0)))
  else:
    raise ValueError(f"no faults for mode {mode!r}")
