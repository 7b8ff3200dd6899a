"""The port's VP and subVP SDEs, score functions, discrete losses, train
steps and bits/dim against the JAX package (CPU, fp32).

Networks are the tiny DDPM++ (positional embedding, fir off, no input
pyramid), the tiny VE NCSN++ with positional embedding (the SMLD configs)
and the tiny DDPM, at unit gain with the JAX params mapped by ``interop``;
labels, t and z are re-derived from the JAX keys exactly as the JAX losses
split them, and handed to the port. Dropout is 0.

Tolerances, fp32:
- SDE methods and the discrete buffers: 1e-6 relative, plus 2e-7 absolute
  where a value is a difference of O(1) terms (``1 - exp(2 lmc)`` near
  t = 0, drifts of x near 0): one ulp of the terms;
- network outputs and score functions: 1e-4 absolute / 1e-3 relative (the
  forwards' bound, tests/test_torch_ddpm.py);
- losses: 1e-5 relative; gradients 2e-4 of the largest gradient entry;
  weights and EMA after Adam steps 1e-6 absolute (tests/test_torch_training.py);
- bits/dim: 1e-3 with equal NFE (tests/test_torch_likelihood.py), the
  latent within the solver's atol.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from score_sde_pytorch_tpu import likelihood as jax_likelihood
from score_sde_pytorch_tpu import losses as jax_losses
from score_sde_pytorch_tpu import ode as jax_ode
from score_sde_pytorch_tpu import sde as jax_sde
from score_sde_pytorch_tpu.models import ema as jax_ema
from score_sde_pytorch_tpu.models import utils as jax_mutils
from score_sde_pytorch_tpu_torch import configs, interop, likelihood, losses
from score_sde_pytorch_tpu_torch import sde as sde_lib
from score_sde_pytorch_tpu_torch.models import utils as mutils
from tests.test_torch_ddpm import (DDPM, DDPMPP, VE_NCSNPP, CONFIGS,
                                   tiny_pair)
from tests.test_torch_ncsnpp import TINY, nchw, nhwc
from tests.test_torch_training import grads_by_name
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

B = 2
SDE_RTOL, SDE_ATOL = 1e-6, 2e-7
CLASSES = {"vp": (sde_lib.VPSDE, jax_sde.VPSDE),
           "subvp": (sde_lib.SubVPSDE, jax_sde.SubVPSDE)}


def pair(kind, n=1000):
  port_cls, jax_cls = CLASSES[kind]
  return port_cls(beta_min=0.1, beta_max=20.0, N=n), jax_cls(
      beta_min=0.1, beta_max=20.0, N=n)


def cell_data():
  """tests/test_golden_sde.py's inputs: x ~ N(0, 1) of [4, 8, 8, 3] and t
  uniform in [1e-3, 1), here with t = 1e-3 and 1 added."""
  rng = np.random.default_rng(0)
  x = rng.normal(size=(6, 8, 8, 3)).astype(np.float32)
  t = np.concatenate([rng.uniform(1e-3, 1.0, size=4),
                      [1e-3, 1.0]]).astype(np.float32)
  return x, t


def close(got, want, rtol=SDE_RTOL, atol=SDE_ATOL):
  got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
  np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("kind", ["vp", "subvp"])
def test_sde_methods_match_jax(kind):
  """sde(), marginal_prob() (subVP's std is the variance, unrooted, in
  both), prior_logp(), discretize() (VP: DDPM; subVP: Euler–Maruyama) and
  the reverse SDE's sde() and discretize() with an analytic score."""
  ours, ref = pair(kind)
  x, t = cell_data()
  xj, tj, xt, tt = jnp.asarray(x), jnp.asarray(t), nchw(x), torch.from_numpy(t)
  for got, want in ((ours.sde(xt, tt), ref.sde(xj, tj)),
                    (ours.marginal_prob(xt, tt), ref.marginal_prob(xj, tj)),
                    (ours.discretize(xt, tt), ref.discretize(xj, tj))):
    close(nhwc(got[0]), want[0])
    close(got[1], want[1])
  close(ours.prior_logp(xt), ref.prior_logp(xj), rtol=1e-6, atol=0)
  for flow in (False, True):
    got = ours.reverse(lambda v, s: -0.5 * v, flow)
    want = ref.reverse(lambda v, s: -0.5 * v, flow)
    for g, w in ((got.sde(xt, tt), want.sde(xj, tj)),
                 (got.discretize(xt, tt), want.discretize(xj, tj))):
      close(nhwc(g[0]), w[0], atol=1e-6)
      close(g[1], w[1])


@pytest.mark.parametrize("kind", ["vp", "subvp"])
@pytest.mark.parametrize("n", [1000, 100])
def test_discrete_buffers_match_jax(kind, n):
  """fp32 buffers from the jnp linspace formula; the cumulative product is
  sequential in torch and may be a scan in XLA: 1e-6 relative holds."""
  ours, ref = pair(kind, n)
  close(ours.discrete_betas(), ref.discrete_betas, atol=0)
  close(ours.alphas(), ref.alphas, atol=0)
  if kind == "vp":
    for name in ("alphas_cumprod", "sqrt_alphas_cumprod"):
      got = getattr(ours, name)()
      assert got.dtype == torch.float32
      close(got, getattr(ref, name), atol=0)
    # sqrt(1 - ac) carries the cumprod's 1e-6 relative, amplified by
    # ac / (2 (1 - ac)) where 1 - ac is small (the first timesteps).
    ac = np.asarray(ref.alphas_cumprod, np.float64)
    want = np.asarray(ref.sqrt_1m_alphas_cumprod, np.float64)
    got = ours.sqrt_1m_alphas_cumprod().numpy()
    assert (np.abs(got - want) <= SDE_RTOL * (want + ac / (2 * want))).all()
  else:
    assert not isinstance(ours, sde_lib.VPSDE)  # the samplers' dispatch


@pytest.mark.parametrize("n", [1000, 100])
def test_timestep_index_sequence_matches_jax(n):
  """``int32(t (N - 1))`` over the sampler's grid linspace(1, 1e-3, N)
  (VP's eps): the port's grid and truncation give JAX's indices."""
  t_jax = jnp.linspace(1.0, 1e-3, n)
  want = np.asarray((t_jax * (n - 1) / 1.0).astype(jnp.int32))
  got = pair("vp", n)[0].timestep_index(sde_lib.linspace(1.0, 1e-3, n))
  np.testing.assert_array_equal(got.numpy(), want)
  assert want[0] == n - 1 and want[-1] == 0


@pytest.mark.parametrize("kind", ["vp", "subvp"])
def test_discrete_betas_guard_raises_as_jax(kind):
  """N <= beta_max makes alphas negative: every discrete buffer raises in
  both packages; continuous use at N = 2 stays legal."""
  ours, ref = pair(kind, 20)
  with pytest.raises(ValueError, match="num_scales > beta_max"):
    ref.discrete_betas  # noqa: B018 (a property that raises)
  for name in ("discrete_betas", "alphas"):
    with pytest.raises(ValueError, match="num_scales > beta_max"):
      getattr(ours, name)()
  x, t = cell_data()
  tiny = pair(kind, 2)[0]
  assert torch.isfinite(tiny.marginal_prob(nchw(x), torch.from_numpy(t))[1]
                        ).all()


def test_build_sde_builds_vp_and_subvp():
  for rel, cls in (("vp/cifar10_ddpmpp_continuous.py", sde_lib.VPSDE),
                   ("subvp/cifar10_ddpmpp_continuous.py", sde_lib.SubVPSDE)):
    cfg = configs.load_config(CONFIGS + rel, ["model.num_scales=100"])
    sde = sde_lib.build_sde(cfg)
    assert type(sde) is cls and (sde.beta_min, sde.beta_max, sde.N) == (
        0.1, 20.0, 100)
    assert sde_lib.sampling_eps(cfg) == 1e-3


def test_ddpm_params_equal_jax():
  """The float64 DDPM schedule constants, key for key."""
  cfg = configs.load_config(DDPM)
  got = mutils.get_ddpm_params(cfg)
  want = jax_mutils.get_ddpm_params(cfg)
  assert list(got) == list(want)
  for key, value in want.items():
    np.testing.assert_array_equal(got[key], value, err_msg=key)


@pytest.fixture(scope="module")
def ddpmpp():
  return tiny_pair(DDPMPP, "model.dropout=0.0")


@pytest.fixture(scope="module")
def ve_ncsnpp():
  return tiny_pair(VE_NCSNPP, "model.dropout=0.0", "model.num_scales=10")


def _x_t(seed=1):
  rng = np.random.default_rng(seed)
  return (rng.normal(size=(3, 16, 16, 3)).astype(np.float32),
          np.array([1e-3, 0.37, 1.0], np.float32))


@pytest.mark.parametrize("kind,continuous", [("vp", True), ("vp", False),
                                             ("subvp", True),
                                             ("subvp", False)])
def test_vp_score_fns_match_jax(ddpmpp, kind, continuous):
  """Continuous: labels t·999 and std of marginal_prob (subVP always);
  discrete VP: labels t·(N-1) and sqrt_1m_alphas_cumprod[int32(labels)]."""
  _, model_def, params, model = ddpmpp
  ours, ref = pair(kind)
  x, t = _x_t()
  want = jax_mutils.get_score_fn(ref, model_def, params,
                                 continuous=continuous)(jnp.asarray(x),
                                                        jnp.asarray(t))
  with torch.no_grad():
    got = mutils.get_score_fn(ours, model, continuous=continuous)(
        nchw(x), torch.from_numpy(t))
  close(nhwc(got), want, rtol=1e-3, atol=1e-4 * np.abs(want).max())


def test_discrete_ve_score_fn_matches_jax(ve_ncsnpp):
  """Integer labels round((T - t)(N - 1)) into the descending ladder."""
  cfg, model_def, params, model = ve_ncsnpp
  ref = jax_sde.VESDE(sigma_min=cfg.model.sigma_min,
                      sigma_max=cfg.model.sigma_max, N=cfg.model.num_scales)
  x, t = _x_t(2)
  want = jax_mutils.get_score_fn(ref, model_def, params, continuous=False)(
      jnp.asarray(x), jnp.asarray(t))
  with torch.no_grad():
    got = mutils.get_score_fn(sde_lib.build_sde(cfg), model,
                              continuous=False)(nchw(x), torch.from_numpy(t))
  close(nhwc(got), want, rtol=1e-3, atol=1e-4 * np.abs(want).max())


def jax_labels_z(rng, shape, n):
  """Labels and z as JAX get_smld/ddpm_loss_fn draw them from a key."""
  label_rng, z_rng, _ = jax.random.split(rng, 3)
  labels = jax.random.randint(label_rng, (shape[0],), 0, n)
  return np.asarray(labels), np.asarray(jax.random.normal(z_rng, shape))


def _check_loss_and_grads(cfg, model, loss_j, core, params, batch, rng, n):
  want, want_grads = jax.jit(jax.value_and_grad(loss_j))(
      params, jnp.asarray(batch), rng)
  labels, z = jax_labels_z(rng, batch.shape, n)
  model.zero_grad(set_to_none=True)
  got = core(model, nchw(batch), torch.from_numpy(labels).long(), nchw(z))
  np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
  got.backward()
  want_grads = grads_by_name(want_grads, cfg)
  scale = max(np.abs(g).max() for g in want_grads.values())
  for name, p in model.named_parameters():
    np.testing.assert_allclose(p.grad.numpy(), want_grads[name],
                               atol=2e-4 * scale, rtol=0, err_msg=name)


@pytest.mark.parametrize("path", [DDPMPP, DDPM])
@pytest.mark.parametrize("reduce_mean", [True, False])
def test_ddpm_loss_and_gradients_match_jax(path, reduce_mean):
  """The DDPM epsilon loss on the discrete VP SDE (N = 1000) with the JAX
  key's labels and noise injected."""
  cfg, model_def, params, model = tiny_pair(path, "model.dropout=0.0")
  ours, ref = pair("vp")
  loss_j = jax_losses.get_ddpm_loss_fn(ref, model_def, train=True,
                                       reduce_mean=reduce_mean)
  core = losses.get_ddpm_loss_core(ours, train=True, reduce_mean=reduce_mean)
  batch = np.random.default_rng(3).uniform(-1, 1, size=(B, 16, 16, 3)).astype(
      np.float32)
  _check_loss_and_grads(cfg, model, loss_j, core, params, batch,
                        jax.random.PRNGKey(5), ours.N)


@pytest.mark.parametrize("reduce_mean", [True, False])
def test_smld_loss_and_gradients_match_jax(ve_ncsnpp, reduce_mean):
  """The SMLD loss (descending ladder, integer labels) on the VE NCSN++."""
  cfg, model_def, params, model = ve_ncsnpp
  ref = jax_sde.VESDE(sigma_min=cfg.model.sigma_min,
                      sigma_max=cfg.model.sigma_max, N=cfg.model.num_scales)
  loss_j = jax_losses.get_smld_loss_fn(ref, model_def, train=True,
                                       reduce_mean=reduce_mean)
  core = losses.get_smld_loss_core(sde_lib.build_sde(cfg), train=True,
                                   reduce_mean=reduce_mean)
  batch = np.random.default_rng(4).uniform(size=(B, 16, 16, 3)).astype(
      np.float32)
  _check_loss_and_grads(cfg, model, loss_j, core, params, batch,
                        jax.random.PRNGKey(6), ref.N)


def test_discrete_loss_dispatch_follows_jax():
  """continuous=False: SMLD on VE, DDPM on VP; subVP and likelihood
  weighting raise, as in the JAX package."""
  assert losses._select_loss_fn(pair("vp")[0], True, True, False, False
                                ).__qualname__.startswith("get_ddpm_loss_fn")
  with pytest.raises(ValueError, match="not recommended"):
    losses.get_step_fn(pair("subvp")[0], train=False, continuous=False)
  with pytest.raises(ValueError, match="Likelihood weighting"):
    losses.get_step_fn(pair("vp")[0], train=False, continuous=False,
                       likelihood_weighting=True)
  with pytest.raises(ValueError, match="VPSDE"):
    losses.get_ddpm_loss_core(pair("subvp")[0], train=True)


def test_three_vp_train_steps_match_jax(ddpmpp, monkeypatch):
  """Adam with warmup 2 and clipping, and the EMA, three steps of the
  continuous VP loss (reduce_mean, as vp/cifar10_ddpmpp_continuous.py)
  against JAX get_step_fn, t and z re-derived from its keys."""
  _, model_def, params, _ = ddpmpp
  cfg = configs.load_config(DDPMPP, TINY + ("model.dropout=0.0",
                                            "optim.warmup=2",
                                            "optim.grad_clip=1.0"))
  ours, ref = pair("vp")
  optimizer = jax_losses.get_optimizer(cfg)
  state = jax_losses.TrainState(
      step=jnp.zeros((), jnp.int32), params=params,
      opt_state=optimizer.init(params),
      ema=jax_ema.init(params, decay=cfg.model.ema_rate),
      rng=jax.random.PRNGKey(11))
  step_j = jax.jit(jax_losses.get_step_fn(
      ref, model_def, train=True, optimizer=optimizer, reduce_mean=True,
      likelihood_weighting=False, prng_impl="threefry2x32"))
  batches = [np.random.default_rng(s).uniform(-1, 1, size=(B, 16, 16, 3))
             .astype(np.float32) for s in (4, 5, 6)]
  queue = []
  for b in batches:
    t_rng, z_rng, _ = jax.random.split(jax.random.split(state.rng)[1], 3)
    t = jax.random.uniform(t_rng, (B,), minval=1e-5, maxval=1.0)
    queue.append((torch.from_numpy(np.asarray(t)),
                  nchw(np.asarray(jax.random.normal(z_rng, b.shape)))))
    state, _ = step_j(state, jnp.asarray(b))

  model = mutils.create_model(cfg, "cpu", torch.Generator().manual_seed(0))
  interop.load_jax_params(model, params, cfg)
  train_state = losses.init_train_state(cfg, model, "cpu")
  monkeypatch.setattr(losses, "draw_t_z", lambda *a: queue.pop(0))
  step_fn = losses.get_step_fn(ours, train=True,
                               optimize_fn=losses.optimization_manager(cfg),
                               reduce_mean=True, likelihood_weighting=False)
  initial = [p.detach().clone() for p in model.parameters()]
  for b in batches:
    step_fn(train_state, nchw(b), train_state["generator"])
  assert not queue and train_state["step"] == 3

  want_params = grads_by_name(state.params, cfg)
  want_ema = grads_by_name(state.ema.params, cfg)
  moved = 0.0
  for (name, p), shadow, p0 in zip(model.named_parameters(),
                                   train_state["ema"].shadow_params, initial):
    if name.endswith("NIN_1.b"):
      # The softmax cancels the key bias: its gradient is rounding noise
      # (tests/test_torch_training.py); it must stay put.
      assert (p.detach() - p0).abs().max() < 2e-5, name
      continue
    np.testing.assert_allclose(p.detach().numpy(), want_params[name],
                               atol=1e-6, rtol=0, err_msg=name)
    np.testing.assert_allclose(shadow.numpy(), want_ema[name], atol=1e-6,
                               rtol=0, err_msg=name)
    moved = max(moved, (p.detach() - p0).abs().max().item())
  assert moved > 1e-4


@pytest.mark.parametrize("kind", ["vp", "subvp"])
@pytest.mark.parametrize("t", [1e-3, 0.5])
def test_vp_divergence_by_vjp_matches_jax_jvp(ddpmpp, kind, t):
  """The probability-flow drift and its Hutchinson divergence (the port's
  vjp, JAX's jvp) within 1e-4 relative, as tests/test_torch_likelihood.py
  holds the VE ones."""
  _, model_def, params, model = ddpmpp
  ours, ref = pair(kind)
  rng = np.random.default_rng(10)
  x = rng.normal(size=(B, 16, 16, 3)).astype(np.float32)
  eps = np.where(rng.random(x.shape) < 0.5, -1.0, 1.0).astype(np.float32)
  rsde = ref.reverse(jax_mutils.get_score_fn(ref, model_def, params,
                                             continuous=True), True)
  drift_j = lambda v, s: rsde.sde(v, s)[0]  # noqa: E731
  tt = jnp.full((B,), t)
  want_drift = np.asarray(drift_j(jnp.asarray(x), tt))
  want = np.asarray(jax_likelihood.get_div_fn(drift_j)(
      jnp.asarray(x), tt, jnp.asarray(eps)))
  with likelihood.frozen(model):
    drift, got = likelihood.get_augmented_drift(ours, model, nchw(eps))(
        (nchw(x), torch.zeros(B)), t)
  close(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
  close(nhwc(drift), want_drift, rtol=1e-4,
        atol=1e-4 * np.abs(want_drift).max())


def _python_while_loop(cond, body, init):
  val = init
  while bool(cond(val)):
    val = body(val)
  return val


def test_vp_bits_per_dim_matches_jax(ddpmpp, monkeypatch):
  """Bits/dim of the tiny VP DDPM++ through the probability-flow ODE from
  eps = 1e-5 with the same Rademacher probe: JAX's get_div_fn (a jvp) and
  odeint_rk45 against the port's vjp and RK45, as
  tests/test_torch_likelihood.py runs them; centered data, so the offset
  is 7 - inverse_scaler(-1) = 8 with the identity.

  The output conv is drawn at 1/100 of unit gain. Near eps the VP drift is
  ``-0.5 beta (x - out/std)`` with std ~ 1e-3: a random unit-gain network,
  which does not predict the noise as a trained one does, makes the ODE
  so sensitive there that fp32 rounding between the jvp and the vjp moves
  z by more than the solver's tolerance (0.07 bits/dim apart at 1/10), as
  the Fourier scale did for VE. At 1/100 the two agree within 1e-3 bits/dim
  with equal NFE, and z within the solver's atol (1e-3)."""
  cfg, model_def, params, model = ddpmpp
  params = dict(params, conv_out=jax.tree_util.tree_map(
      lambda a: a * 0.01, params["conv_out"]))
  model = mutils.create_model(cfg, "cpu", torch.Generator().manual_seed(0))
  interop.load_jax_params(model, params, cfg)
  ours, ref = pair("vp")
  rng = np.random.default_rng(9)
  shape = (B, 16, 16, 3)
  data = rng.uniform(-1, 1, size=shape).astype(np.float32)
  eps = np.where(rng.random(shape) < 0.5, -1.0, 1.0).astype(np.float32)
  tol = dict(rtol=1e-3, atol=1e-3)
  score_j = jax_mutils.get_score_fn(ref, model_def, params, continuous=True)
  rsde = ref.reverse(score_j, probability_flow=True)
  drift_j = lambda x, t: rsde.sde(x, t)[0]  # noqa: E731
  div_j = jax_likelihood.get_div_fn(drift_j)
  e = jnp.asarray(eps)

  @jax.jit
  def aug(y, t_scalar):
    t = jnp.full((B,), t_scalar)
    return drift_j(y[0], t), div_j(y[0], t, e)

  monkeypatch.setattr(jax.lax, "while_loop", _python_while_loop)
  (z_j, dlogp), want_nfe, status = jax_ode.odeint_rk45(
      aug, (jnp.asarray(data), jnp.zeros((B,))), 1e-5, ref.T, **tol)
  assert int(status) == jax_ode.STATUS_OK
  want = (-(ref.prior_logp(z_j) + dlogp) / jnp.log(2.0)
          / math.prod(shape[1:]) + 8.0)
  fn = likelihood.get_likelihood_fn(ours, model, lambda v: v, eps=1e-5, **tol)
  bpd, z, nfe = fn(model, nchw(data), None, epsilon=nchw(eps))
  assert nfe == int(want_nfe)
  np.testing.assert_allclose(bpd.numpy(), np.asarray(want), atol=1e-3, rtol=0)
  np.testing.assert_allclose(nhwc(z), np.asarray(z_j), atol=1e-3, rtol=0)
