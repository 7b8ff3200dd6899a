"""Adaptive Dormand–Prince RK45 ODE solver (PyTorch).

Counterpart of score_sde_pytorch_tpu/ode.py:83-172: the same Butcher
tableau, scipy's error model (rms norm of error / (atol + rtol·max(|y|,
|y_new|))), the step factor 0.9·err^(−1/5) clamped to [0.2, 10], scipy's
initial-step rule with the probe clamped to the interval, FSAL (the last
stage of an accepted step is the next step's first), batch-uniform
acceptance (one step size for the whole system, as scipy treats the
flattened state), the 1e-6 step floor and the ``(y, nfe, status)`` contract.

The JAX package runs the loop on the device inside one ``lax.while_loop``.
Here it is a Python loop: the stages run on the state's device, and each
step reads ``err_norm`` to the host once (the initial step reads three
norms), which decides acceptance and the next step size. The step-size
arithmetic is fp32 on the host (numpy float32 scalars), as the JAX package
computes it on the device, so both take the same decisions on the same
errors. A step costs 6 evaluations of ``func`` (NFE), accepted or not; the
initial step selection costs 2.
"""
from __future__ import annotations

from typing import Callable, Tuple, Union

import numpy as np
import torch

State = Union[torch.Tensor, Tuple[torch.Tensor, ...]]

# Dormand–Prince 5(4) Butcher tableau.
_C = [0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0]
_A = [
    [],
    [1 / 5],
    [3 / 40, 9 / 40],
    [44 / 45, -56 / 15, 32 / 9],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
    [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
]
# 5th-order solution weights == last row of A (FSAL).
_B = [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0]
# Error weights: b5 − b4.
_E = [71 / 57600, 0.0, -71 / 16695, 71 / 1920, -17253 / 339200,
      22 / 525, -1 / 40]

_SAFETY = 0.9
_MIN_FACTOR = 0.2
_MAX_FACTOR = 10.0
_ORDER_EXP = -1.0 / 5.0
_MIN_STEP = 1e-6  # float32 time resolution floor near t ~ 1

#: status codes returned by :func:`odeint_rk45`
STATUS_OK = 0          # reached t1 within tolerance
STATUS_MAX_STEPS = 1   # max_steps exhausted (incl. err stuck at inf on the
                       # step floor): the returned y is NOT y(t1)

_f32 = np.float32


def _leaves(y: State) -> Tuple[torch.Tensor, ...]:
  return y if isinstance(y, tuple) else (y,)


def _like(y: State, leaves) -> State:
  return tuple(leaves) if isinstance(y, tuple) else leaves[0]


def _map(fn, *trees: State) -> State:
  return _like(trees[0], [fn(*ls) for ls in zip(*map(_leaves, trees))])


def _axpy(a, xs: State, ys: State) -> State:
  """``a·x + y`` leaf by leaf; ``a`` is an fp32 host scalar."""
  return _map(lambda x, y: float(a) * x + y, xs, ys)


def _rms_norm(tree: State) -> torch.Tensor:
  """sqrt(mean of squares over every element of every leaf), on the device."""
  leaves = _leaves(tree)
  sq = sum(torch.sum(torch.square(leaf)) for leaf in leaves)
  n = sum(leaf.numel() for leaf in leaves)
  return torch.sqrt(sq / n)


def _host(x: torch.Tensor) -> np.float32:
  """One read of a 0-d device value to an fp32 host scalar."""
  return _f32(x.item())


def odeint_rk45(func: Callable[[State, float], State], y0: State, t0: float,
                t1: float, rtol: float = 1e-5, atol: float = 1e-5,
                max_steps: int = 10000) -> Tuple[State, int, int]:
  """Integrate ``dy/dt = func(y, t)`` from ``t0`` to ``t1`` (either way).

  ``y0`` is a tensor or a tuple of tensors (the likelihood integrates the
  augmented ``(x, Δlogp)`` system); ``func`` returns the same structure and
  gets ``t`` as a Python float (an exact fp32 value). Returns ``(y, nfe,
  status)`` with ``nfe`` and ``status`` Python ints. ``status`` is
  ``STATUS_OK`` when ``t1`` was reached and ``STATUS_MAX_STEPS`` when the
  loop ran out of steps; then ``y`` is the state at the last accepted time,
  not ``y(t1)``, and callers must not use it as a solution."""
  direction = _f32(1.0 if t1 >= t0 else -1.0)
  t0, t1 = _f32(t0), _f32(t1)
  rtol, atol = _f32(rtol), _f32(atol)

  f0 = func(y0, float(t0))

  # Initial step size (scipy _select_initial_step).
  interval = _f32(abs(t1 - t0))
  scale = _map(lambda y: float(atol) + float(rtol) * torch.abs(y), y0)
  d0 = _host(_rms_norm(_map(torch.div, y0, scale)))
  d1 = _host(_rms_norm(_map(torch.div, f0, scale)))
  with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
    h0 = _f32(1e-6) if (d0 < 1e-5 or d1 < 1e-5) else _f32(
        _f32(0.01) * d0 / d1)
  # Never probe outside the integration interval (stiff RHS such as the VE
  # SDE's geometric sigma overflow immediately past t1).
  h0 = min(h0, interval)
  y1_guess = _axpy(_f32(h0 * direction), f0, y0)
  f1 = func(y1_guess, float(_f32(t0 + _f32(h0 * direction))))
  with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
    d2 = _f32(_host(_rms_norm(_map(lambda a, b, s: (a - b) / s, f1, f0,
                                   scale))) / h0)
    if not np.isfinite(d2):
      d2 = _f32(_f32(1.0) / h0)  # overflow → force a small step
    dmax = max(d1, d2)
    if dmax <= 1e-15:
      h1 = max(_f32(1e-6), _f32(h0 * _f32(1e-3)))
    else:
      h1 = _f32(np.power(_f32(_f32(0.01) / dmax), _f32(1.0 / 5.0)))
  h = _f32(min(max(min(_f32(100 * h0), h1), _f32(_MIN_STEP)), interval))

  t, y, f = t0, y0, f0
  nfe, steps, done = 2, 0, False
  while not done and steps < max_steps:
    remaining = _f32(abs(t1 - t))
    h_eff = min(h, remaining)
    is_last = h >= remaining
    hd = _f32(h_eff * direction)

    # 7 stages, FSAL: ks[0] = f carried from the previous accepted step.
    ks = [f]
    for i in range(1, 7):
      yi = y
      for j, a in enumerate(_A[i]):
        yi = _axpy(_f32(hd * _f32(a)), ks[j], yi)
      ks.append(func(yi, float(_f32(t + _f32(_f32(_C[i]) * h_eff)
                                    * direction))))

    y_new = y
    for i in range(7):
      if _B[i] != 0.0:
        y_new = _axpy(_f32(hd * _f32(_B[i])), ks[i], y_new)
    weights = [float(_f32(h_eff * _f32(e))) for e in _E]
    err = _map(lambda *k: sum((w * ki for w, ki in zip(weights[1:], k[1:])),
                              weights[0] * k[0]), *ks)
    err_norm = _host(_rms_norm(_map(
        lambda e, a, b: e / (float(atol) + float(rtol)
                             * torch.maximum(torch.abs(a), torch.abs(b))),
        err, y, y_new)))
    # An overflowed or NaN step is infinitely wrong: reject it and shrink.
    if not np.isfinite(err_norm):
      err_norm = _f32(np.inf)

    accept = err_norm <= 1.0
    with np.errstate(divide="ignore"):
      if err_norm <= 0.0:
        factor = _f32(_MAX_FACTOR)
      else:
        factor = _f32(min(max(_f32(_f32(_SAFETY)
                                   * np.power(err_norm, _f32(_ORDER_EXP))),
                              _f32(_MIN_FACTOR)), _f32(_MAX_FACTOR)))
    if not accept:
      factor = min(_f32(1.0), factor)
    # Floor the step at the float32 time-resolution limit so t always
    # advances (a smaller step cannot change t near t≈1 in fp32).
    h = max(_f32(h_eff * factor), _f32(_MIN_STEP))
    if accept:
      t = _f32(t + hd)
      y, f = y_new, ks[6]
    done = accept and is_last
    nfe += 6
    steps += 1
  return y, nfe, STATUS_OK if done else STATUS_MAX_STEPS
