"""The port's bits/dim against the JAX package (CPU, fp32).

The port estimates the divergence by a vjp, the JAX package by a jvp: the
same Hutchinson quantity ``εᵀ(∂f/∂x)ε``. Both get the same weights (the
tiny flagship-shaped NCSN++ at unit gain, mapped by ``interop``) and the
same probe ε, made with numpy. Tolerances: the divergence within 1e-4
relative; bits/dim within 1e-3 (both integrate with the same RK45 rule and
step control). Chunked evaluation equals unchunked to fp32 rounding.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from score_sde_pytorch_tpu import likelihood as jax_likelihood
from score_sde_pytorch_tpu import ode as jax_ode
from score_sde_pytorch_tpu import sde as jax_sde
from score_sde_pytorch_tpu.models import utils as jax_mutils
from score_sde_pytorch_tpu_torch import interop, likelihood, ode
from score_sde_pytorch_tpu_torch import sde as sde_lib
from score_sde_pytorch_tpu_torch.models import utils as mutils
from score_sde_pytorch_tpu_torch.sde import batch_mul
from tests.test_torch_ncsnpp import (init_params, nchw, nhwc,
                                     tiny_flagship_config, unit_gain)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

SHAPE = (2, 16, 16, 3)


@pytest.fixture(scope="module")
def tiny():
  cfg = tiny_flagship_config()
  model_def = jax_mutils.get_model(cfg.model.name)(cfg)
  params = init_params(model_def, jnp.zeros((1, 16, 16, 3)), jnp.ones((1,)))
  model = mutils.create_model(cfg, "cpu", torch.Generator().manual_seed(0))
  interop.load_jax_params(model, params, cfg)
  sde_j = jax_sde.VESDE(sigma_min=cfg.model.sigma_min,
                        sigma_max=cfg.model.sigma_max, N=cfg.model.num_scales)
  return cfg, model_def, params, model, sde_j, sde_lib.build_sde(cfg)


def _jax_drift(sde_j, model_def, params):
  score_fn = jax_mutils.get_score_fn(sde_j, model_def, params, train=False,
                                     continuous=True)
  rsde = sde_j.reverse(score_fn, probability_flow=True)
  return lambda x, t: rsde.sde(x, t)[0]


def _inputs(seed=0):
  rng = np.random.default_rng(seed)
  data = rng.random(SHAPE).astype(np.float32)
  eps = np.where(rng.random(SHAPE) < 0.5, -1.0, 1.0).astype(np.float32)
  return data, eps


@pytest.mark.parametrize("t", [1e-3, 0.5])
def test_divergence_by_vjp_matches_jax_jvp(tiny, t):
  _, model_def, params, model, sde_j, sde_p = tiny
  data, eps = _inputs(1)
  x = data * 10.0
  drift_j = _jax_drift(sde_j, model_def, params)
  both_j = jax.jit(lambda x, t, e: (drift_j(x, t), jax_likelihood.get_div_fn(
      drift_j)(x, t, e)))
  want_drift, want = map(np.asarray, both_j(jnp.asarray(x), jnp.full((2,), t),
                                            jnp.asarray(eps)))
  aug = likelihood.get_augmented_drift(sde_p, model, nchw(eps))
  with likelihood.frozen(model):
    drift, got = aug((nchw(x), torch.zeros(2)), t)
  np.testing.assert_allclose(got.numpy(), want,
                             rtol=1e-4, atol=1e-4 * np.abs(want).max())
  np.testing.assert_allclose(nhwc(drift), want_drift, rtol=1e-4,
                             atol=1e-4 * np.abs(want_drift).max())


def _python_while_loop(cond, body, init):
  val = init
  while bool(cond(val)):
    val = body(val)
  return val


def test_bits_per_dim_with_the_same_probe_matches_jax(monkeypatch):
  """The JAX side is built from its own get_div_fn and odeint_rk45, as its
  likelihood_fn integrates, with the port's probe. Its ``lax.while_loop``
  runs as a Python loop around a jitted augmented drift (the same steps,
  one small compile instead of the whole loop's).

  The Fourier projection is drawn at scale 1 (the flagship's init draws
  it at 16, as the other tests do). At 16 the drift oscillates in t so
  fast that the error estimate, a difference of nearly equal stage values,
  differs between the jvp and the vjp by enough to move the step sizes;
  the two integrations then differ by the solver's error on Δlogp, which
  the rms norm over all of [x; Δlogp] controls only weakly (more than
  1e-3 bits/dim at rtol 1e-3), not by rounding."""
  cfg = tiny_flagship_config()
  model_def = jax_mutils.get_model(cfg.model.name)(cfg)
  key = jax.random.PRNGKey(0)
  params = unit_gain(jax.eval_shape(lambda: model_def.init(
      {"params": key, "dropout": key}, jnp.zeros((1, 16, 16, 3)),
      jnp.ones((1,))))["params"], fourier_scale=1.0)
  model = mutils.create_model(cfg, "cpu", torch.Generator().manual_seed(0))
  interop.load_jax_params(model, params, cfg)
  sde_j = jax_sde.VESDE(sigma_min=cfg.model.sigma_min,
                        sigma_max=cfg.model.sigma_max, N=cfg.model.num_scales)
  data, eps = _inputs(2)
  tol = dict(rtol=1e-3, atol=1e-3)
  drift_j = _jax_drift(sde_j, model_def, params)
  div_j = jax_likelihood.get_div_fn(drift_j)
  e = jnp.asarray(eps)

  @jax.jit
  def aug(y, t_scalar):
    t = jnp.full((SHAPE[0],), t_scalar)
    return drift_j(y[0], t), div_j(y[0], t, e)

  monkeypatch.setattr(jax.lax, "while_loop", _python_while_loop)
  (z_j, dlogp), want_nfe, want_status = jax_ode.odeint_rk45(
      aug, (jnp.asarray(data), jnp.zeros((SHAPE[0],))), 1e-5, sde_j.T, **tol)
  assert int(want_status) == jax_ode.STATUS_OK
  want = (-(sde_j.prior_logp(z_j) + dlogp) / jnp.log(2.0)
          / math.prod(SHAPE[1:]) + 8.0)
  fn = likelihood.get_likelihood_fn(sde_lib.build_sde(cfg), model,
                                    lambda v: v, eps=1e-5, **tol)
  bpd, z, nfe = fn(model, nchw(data), None, epsilon=nchw(eps))
  assert nfe == int(want_nfe)
  np.testing.assert_allclose(bpd.numpy(), np.asarray(want), atol=1e-3,
                             rtol=0)
  np.testing.assert_allclose(nhwc(z), np.asarray(z_j), rtol=1e-4,
                             atol=1e-4 * np.abs(np.asarray(z_j)).max())
  # The parameters are unfrozen again and took no gradient.
  assert all(p.grad is None for p in model.parameters())
  assert [p.requires_grad for p in model.parameters()] == [
      p is not model.all_modules[0].W for p in model.parameters()]


def test_chunked_drift_equals_unchunked(tiny):
  """Per-sample chunks give the whole batch's drift and divergence. Not bit
  for bit on the CPU: its convolutions block a batch of 1 and a batch of 2
  differently, so within 1e-6 relative."""
  *_, model, _, sde_p = tiny
  data, eps = _inputs(3)
  y = (nchw(data) * 10.0, torch.zeros(2))
  with likelihood.frozen(model):
    for t in (1e-4, 0.7):
      whole = likelihood.get_augmented_drift(sde_p, model, nchw(eps))(y, t)
      parts = likelihood.get_augmented_drift(sde_p, model, nchw(eps),
                                             chunk=1)(y, t)
      for a, b in zip(whole, parts, strict=True):
        torch.testing.assert_close(b, a, rtol=1e-6,
                                   atol=1e-6 * a.abs().max().item())


def test_chunked_likelihood_equals_unchunked():
  """A whole bits/dim integration (weights near their init, so few steps)
  at chunk 1 and at the default chunk: the same steps, bits/dim within
  1e-6."""
  cfg = tiny_flagship_config()
  model = mutils.create_model(cfg, "cpu", torch.Generator().manual_seed(0))
  sde_p = sde_lib.build_sde(cfg)
  data, eps = _inputs(4)
  runs = [likelihood.get_likelihood_fn(sde_p, model, lambda v: v,
                                       chunk=chunk)(
              model, nchw(data), None, epsilon=nchw(eps))
          for chunk in (1, likelihood.DRIFT_CHUNK)]
  (bpd1, z1, nfe1), (bpd2, z2, nfe2) = runs
  assert nfe1 == nfe2 and torch.isfinite(bpd1).all()
  torch.testing.assert_close(bpd1, bpd2, rtol=0, atol=1e-6)
  torch.testing.assert_close(z1, z2, rtol=1e-6, atol=1e-6)


def test_non_convergence_gives_nan_bpd_and_latent(tiny):
  *_, model, _, sde_p = tiny
  data, _ = _inputs(5)
  fn = likelihood.get_likelihood_fn(sde_p, model, lambda v: v, rtol=1e-8,
                                    atol=1e-8, max_steps=3)
  bpd, z, nfe = fn(model, nchw(data), torch.Generator().manual_seed(0))
  assert nfe == 2 + 6 * 3
  assert torch.isnan(bpd).all() and torch.isnan(z).all()


def test_gaussian_logp_recovered_with_the_exact_score():
  """x0 ~ N(0, I) under the VE SDE has the score -x / (1 + sigma(t)^2):
  the augmented ODE, the divergence and the prior give N(0, I)'s density
  (the drift's Jacobian is diagonal, so a Rademacher probe is exact)."""
  sde = sde_lib.VESDE(sigma_min=0.01, sigma_max=20.0, N=100)
  shape = (8, 1, 4, 4)
  gen = torch.Generator().manual_seed(0)
  data = torch.randn(shape, generator=gen)
  eps = likelihood.draw_epsilon(shape, gen, "Rademacher", "cpu")

  def drift(x, t):
    score = lambda xx, tt: batch_mul(-1.0 / (1.0 + sde.sigma_t(tt) ** 2), xx)
    return sde.reverse(score, probability_flow=True).sde(x, t)[0]

  def aug(y, t_scalar):
    t = torch.full((shape[0],), t_scalar)
    return likelihood.drift_and_div(drift, y[0], t, eps)

  (z, dlogp), _, status = ode.odeint_rk45(aug, (data, torch.zeros(8)), 1e-5,
                                          sde.T, rtol=1e-6, atol=1e-6)
  assert status == ode.STATUS_OK
  logp = sde.prior_logp(z) + dlogp
  true = -8 * math.log(2 * math.pi) - (data.reshape(8, -1) ** 2).sum(-1) / 2
  np.testing.assert_allclose(logp.numpy(), true.numpy(), rtol=0.05,
                             atol=0.15)


def test_divergence_is_exact_for_a_diagonal_jacobian():
  a = torch.tensor([2.0, 3.0])
  eps = likelihood.draw_epsilon((4, 2), torch.Generator().manual_seed(1),
                                "Rademacher", "cpu")
  fx, got = likelihood.drift_and_div(lambda x, t: x * a, torch.ones(4, 2),
                                     torch.zeros(4), eps)
  np.testing.assert_allclose(got.numpy(), 5.0, rtol=1e-6)
  torch.testing.assert_close(fx, a.expand(4, 2))


@pytest.mark.parametrize("kind", ["Rademacher", "Gaussian"])
def test_probes(kind):
  eps = likelihood.draw_epsilon((64, 3, 4, 4),
                                torch.Generator().manual_seed(0), kind, "cpu")
  assert eps.shape == (64, 3, 4, 4) and eps.dtype == torch.float32
  if kind == "Rademacher":
    assert set(eps.unique().tolist()) == {-1.0, 1.0}
  else:
    assert abs(eps.mean().item()) < 0.05 and abs(eps.std().item() - 1) < 0.05
  with pytest.raises(NotImplementedError):
    likelihood.draw_epsilon((1,), torch.Generator(), "Cauchy", "cpu")


def test_bpd_offset_follows_the_inverse_scaler(tiny):
  """offset = 7 - inverse_scaler(-1): 8 for data in [0, 1] (identity), 7
  for centered data; the rest of bits/dim is the same."""
  *_, model, _, sde_p = tiny
  data, eps = _inputs(6)
  kw = dict(rtol=1e-1, atol=1e-1)
  got = [likelihood.get_likelihood_fn(sde_p, model, inv, **kw)(
      model, nchw(data), None, epsilon=nchw(eps))[0]
         for inv in (lambda v: v, lambda v: (v + 1.0) / 2.0)]
  np.testing.assert_allclose((got[0] - got[1]).numpy(), 1.0, rtol=1e-6)
