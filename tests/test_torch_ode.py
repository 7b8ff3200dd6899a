"""The port's RK45 solver and ODE sampler against the JAX package (CPU, fp32).

Both solvers get the same right-hand sides and initial states, made with
numpy: the same ``nfe`` and ``status`` (the step-size arithmetic is fp32 on
both sides, so they accept and reject the same steps), and ``y`` within
1e-5 relative. The ODE sampler runs the tiny flagship-shaped NCSN++ with
the same weights and the same state at T on both sides: within 1e-4.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from score_sde_pytorch_tpu import ode as jax_ode
from score_sde_pytorch_tpu import sde as jax_sde
from score_sde_pytorch_tpu.models import utils as jax_mutils
from score_sde_pytorch_tpu_torch import interop, ode, sampling
from score_sde_pytorch_tpu_torch import sde as sde_lib
from score_sde_pytorch_tpu_torch.models import utils as mutils
from tests.test_torch_ncsnpp import init_params, tiny_flagship_config
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

jax_sampling = importlib.import_module("score_sde_pytorch_tpu.sampling")

# name: (jax rhs, torch rhs, y0 as numpy (a tuple for a tuple state), t0,
#        t1, solver keywords)
CASES = {
    "decay": (lambda y, t: -y, lambda y, t: -y,
              np.ones((4, 3), np.float32), 0.0, 2.0,
              dict(rtol=1e-6, atol=1e-8)),
    "backward": (lambda y, t: y, lambda y, t: y,
                 np.full((2, 2), 2.7182818, np.float32), 1.0, 0.0,
                 dict(rtol=1e-6, atol=1e-8)),
    "time_dependent": (lambda y, t: jnp.sin(t) * y,
                       lambda y, t: float(np.sin(np.float32(t))) * y,
                       np.array([[1.0, 2.0]], np.float32), 0.0, 3.0,
                       dict(rtol=1e-5, atol=1e-5)),
    "tuple_state": (lambda y, t: (-y[0], jnp.sum(y[0], keepdims=True)),
                    lambda y, t: (-y[0], torch.sum(y[0], dim=0,
                                                   keepdim=True)),
                    (np.ones((3,), np.float32), np.zeros((1,), np.float32)),
                    0.0, 1.0, dict(rtol=1e-6, atol=1e-8)),
    "max_steps": (lambda y, t: -2000.0 * (y - jnp.cos(t)),
                  lambda y, t: -2000.0 * (y - float(np.cos(np.float32(t)))),
                  np.zeros((1,), np.float32), 0.0, 5.0,
                  dict(rtol=1e-10, atol=1e-12, max_steps=5)),
    "non_finite": (lambda y, t: jnp.full_like(y, jnp.inf),
                   lambda y, t: torch.full_like(y, float("inf")),
                   np.ones((2,), np.float32), 0.0, 1.0,
                   dict(max_steps=25)),
}


def _as(kind, y0):
  if isinstance(y0, tuple):
    return tuple(map(kind, y0))
  return kind(y0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_odeint_rk45_matches_jax(name):
  jax_f, port_f, y0, t0, t1, kw = CASES[name]
  want_y, want_nfe, want_status = jax_ode.odeint_rk45(
      jax_f, _as(jnp.asarray, y0), t0, t1, **kw)
  got_y, got_nfe, got_status = ode.odeint_rk45(
      port_f, _as(torch.from_numpy, y0), t0, t1, **kw)
  assert (got_nfe, got_status) == (int(want_nfe), int(want_status))
  got_leaves = got_y if isinstance(got_y, tuple) else (got_y,)
  want_leaves = want_y if isinstance(want_y, tuple) else (want_y,)
  for got, want in zip(got_leaves, want_leaves, strict=True):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_stiff_rhs_takes_the_jax_packages_steps_within_a_rounding_edge():
  """About 430 steps on a stiff right-hand side: the fp32 sin/cos of XLA
  and numpy differ in the last bit at some times, which can flip a step
  that sits on the acceptance edge, so the NFE is held within 1% of the
  JAX package's, and y within 1e-5."""
  lam = 500.0
  want_y, want_nfe, want_status = jax_ode.odeint_rk45(
      lambda y, t: -lam * (y - jnp.sin(t)) + jnp.cos(t), jnp.zeros((1,)),
      0.0, 2.0, rtol=1e-6, atol=1e-8)
  got_y, nfe, status = ode.odeint_rk45(
      lambda y, t: (-lam * (y - float(np.sin(np.float32(t))))
                    + float(np.cos(np.float32(t)))),
      torch.zeros(1), 0.0, 2.0, rtol=1e-6, atol=1e-8)
  assert status == int(want_status) == ode.STATUS_OK
  assert abs(nfe - int(want_nfe)) <= 0.01 * int(want_nfe)
  np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=1e-5)


def test_status_codes_and_counts():
  """OK on convergence, MAX_STEPS when the steps run out; 2 NFE for the
  initial step and 6 for each step taken."""
  _, nfe, status = ode.odeint_rk45(lambda y, t: -y, torch.ones(3), 0.0, 1.0)
  assert status == ode.STATUS_OK and (nfe - 2) % 6 == 0 and nfe > 8
  _, nfe, status = ode.odeint_rk45(
      lambda y, t: -2000.0 * y, torch.ones(1), 0.0, 5.0, rtol=1e-10,
      atol=1e-12, max_steps=3)
  assert status == ode.STATUS_MAX_STEPS and nfe == 2 + 6 * 3


def test_rhs_gets_python_float_times_on_the_states_device():
  seen = []

  def f(y, t):
    seen.append(t)
    return -y

  ode.odeint_rk45(f, torch.ones(2), 0.0, 1.0)
  assert seen and all(type(t) is float for t in seen)
  assert all(float(np.float32(t)) == t for t in seen)  # exact fp32 times


def _tiny_models(seed=0):
  cfg = tiny_flagship_config()
  model_def = jax_mutils.get_model(cfg.model.name)(cfg)
  params = init_params(model_def, jnp.zeros((1, 16, 16, 3)), jnp.ones((1,)))
  model = mutils.create_model(cfg, "cpu", torch.Generator().manual_seed(seed))
  interop.load_jax_params(model, params, cfg)
  return cfg, model_def, params, model


def test_ode_sampler_with_the_same_z_matches_jax():
  """The probability-flow ODE sampler on the tiny NCSN++ at unit gain, with
  its denoising step, from the same z at T (rtol = atol = 1e-3 keeps the
  NFE small): the same NFE, and samples within 1e-4."""
  cfg, model_def, params, model = _tiny_models()
  shape = (2, 16, 16, 3)
  z = (np.random.default_rng(3).normal(size=shape) * 50).astype(np.float32)
  kw = dict(denoise=True, rtol=1e-3, atol=1e-3, eps=1e-5)
  sde_j = jax_sde.VESDE(sigma_min=cfg.model.sigma_min,
                        sigma_max=cfg.model.sigma_max, N=cfg.model.num_scales)
  want, want_nfe = jax_sampling.get_ode_sampler(
      sde_j, model_def, shape, lambda x: x, **kw)(
          jax.random.PRNGKey(0), params, jnp.asarray(z))
  sampler = sampling.get_ode_sampler(sde_lib.build_sde(cfg), model, shape,
                                     lambda x: x, device="cpu", **kw)
  got, nfe = sampler(torch.Generator(), torch.from_numpy(z))
  assert nfe == int(want_nfe) and got.shape == shape
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                             rtol=1e-4)


def test_ode_sampler_nans_the_samples_when_the_solver_stops_short():
  cfg, _, _, model = _tiny_models()
  sampler = sampling.get_ode_sampler(sde_lib.build_sde(cfg), model,
                                     (1, 16, 16, 3), lambda x: x, rtol=1e-8,
                                     atol=1e-8, eps=1e-5, max_steps=2)
  samples, nfe = sampler(torch.Generator().manual_seed(0))
  assert nfe == 2 + 6 * 2 and torch.isnan(samples).all()


def test_sampling_fn_dispatches_ode_with_the_configs_tolerances():
  cfg, _, _, model = _tiny_models()
  cfg.sampling.method = "ode"
  cfg.sampling.noise_removal = False
  cfg.sampling.rtol = cfg.sampling.atol = 1e-2
  sampler = sampling.get_sampling_fn(cfg, sde_lib.build_sde(cfg), model,
                                     (2, 16, 16, 3), lambda x: x)
  samples, nfe = sampler(torch.Generator().manual_seed(0))
  assert samples.shape == (2, 16, 16, 3) and torch.isfinite(samples).all()
  assert nfe > 2 and (nfe - 2) % 6 == 0
  # The same generator state gives the same prior, hence the same samples.
  again, _ = sampler(torch.Generator().manual_seed(0))
  assert torch.equal(samples, again)
