"""Every sampler of the port against the JAX package (CPU, fp32), with the
noise injected.

- The predictor x corrector x SDE matrix of tests/test_sampling.py
  (VP/subVP at N = 32, VE with sigma_max 10): one corrector and one
  predictor update from the same state and noise in both packages, on the
  analytic score model of that test (``-x·scale/(1 + label)``, whose label
  carries each SDE's convention), and the port's whole PC chain finite with
  NFE N·2. Ancestral sampling on subVP raises in both.
- Heun and DPM-Solver++(2M), deterministic and stochastic, from the same
  prior and per-step noise (JAX's draws, re-derived from its keys).
- PC chains on the tiny DDPM++ (Euler–Maruyama, continuous VP) and the
  tiny DDPM (ancestral, discrete VP, N = 25) against the JAX package's own
  update functions in a Python loop.

Tolerances: 1e-5 relative (and 1e-5 of the state's scale) for the
analytic model, where both sides round the same few fp32 operations; the
tiny networks' chains 1e-4 relative and 1e-4 of the state's scale, for
fp32 model differences (<= 1e-4 relative) carried through the steps.
"""
import importlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from score_sde_pytorch_tpu import sde as jax_sde
from score_sde_pytorch_tpu.models import utils as jax_mutils
from score_sde_pytorch_tpu_torch import sampling
from score_sde_pytorch_tpu_torch import sde as sde_lib
from score_sde_pytorch_tpu_torch.models import utils as mutils
from tests.test_torch_ddpm import DDPM, DDPMPP, tiny_pair
from tests.test_torch_ncsnpp import nchw, nhwc
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

jax_sampling = importlib.import_module("score_sde_pytorch_tpu.sampling")

SHAPE = (2, 8, 8, 1)
SDES = {
    "vpsde": (sde_lib.VPSDE(N=32), jax_sde.VPSDE(N=32)),
    "subvpsde": (sde_lib.SubVPSDE(N=32), jax_sde.SubVPSDE(N=32)),
    "vesde": (sde_lib.VESDE(sigma_min=0.01, sigma_max=10.0, N=32),
              jax_sde.VESDE(sigma_min=0.01, sigma_max=10.0, N=32)),
}
PREDICTORS = ["euler_maruyama", "reverse_diffusion", "ancestral_sampling",
              "none"]
CORRECTORS = ["langevin", "ald", "none"]
SCALE = 0.9


class _JaxModel(fnn.Module):
  """tests/test_sampling.py's tiny score module."""

  @fnn.compact
  def __call__(self, x, labels, train=False):
    scale = self.param("scale", fnn.initializers.ones, (1,))
    return -x * scale / (1.0 + labels.reshape((-1,) + (1,) * (x.ndim - 1)))


class _PortModel(torch.nn.Module):

  def __init__(self):
    super().__init__()
    self.scale = torch.nn.Parameter(torch.full((1,), SCALE))

  def forward(self, x, labels):
    return -x * self.scale / (1.0 + labels.reshape((-1,) + (1,) * (x.dim() - 1)))


def score_fns(name, continuous=True):
  ours, ref = SDES[name]
  params = {"scale": jnp.full((1,), SCALE)}
  return (mutils.get_score_fn(ours, _PortModel(), continuous=continuous),
          jax_mutils.get_score_fn(ref, _JaxModel(), params,
                                  continuous=continuous))


def _scale(name):
  return 10.0 if name == "vesde" else 1.0


def _feed(monkeypatch, noise):
  """jax.random.normal hands out ``noise`` (NHWC numpy)."""
  monkeypatch.setattr(jax.random, "normal",
                      lambda key, shape, dtype=jnp.float32: jnp.asarray(noise))


@pytest.mark.parametrize("sde_name", list(SDES))
@pytest.mark.parametrize("predictor", PREDICTORS)
@pytest.mark.parametrize("corrector", CORRECTORS)
def test_pc_cell_matches_jax(sde_name, predictor, corrector, monkeypatch):
  ours, ref = SDES[sde_name]
  port_score, jax_score = score_fns(sde_name)
  if predictor == "ancestral_sampling" and sde_name == "subvpsde":
    with pytest.raises(NotImplementedError):
      jax_sampling.get_predictor(predictor)(ref, jax_score)
    with pytest.raises(NotImplementedError):
      sampling.get_predictor(predictor)(ours, port_score)
    return
  rng = np.random.default_rng(len(predictor) + 7 * len(corrector))
  x = (rng.normal(size=SHAPE) * _scale(sde_name)).astype(np.float32)
  z_c, z_p = rng.normal(size=(2,) + SHAPE).astype(np.float32)
  t = np.array([0.5, 17.0 / 31], np.float32)
  corr_j = jax_sampling.get_corrector(corrector)(ref, jax_score, 0.16, 1)
  pred_j = jax_sampling.get_predictor(predictor)(ref, jax_score)
  key = jax.random.PRNGKey(0)
  _feed(monkeypatch, z_c)
  xj, _ = corr_j(key, jnp.asarray(x), jnp.asarray(t))
  _feed(monkeypatch, z_p)
  want_x, want_mean = pred_j(key, xj, jnp.asarray(t))

  corr = sampling.get_corrector(corrector)(ours, port_score, 0.16, 1)
  pred = sampling.get_predictor(predictor)(ours, port_score)
  tt = torch.from_numpy(t)
  xp, _ = corr(nchw(x), tt, lambda step: nchw(z_c))
  got_x, got_mean = pred(xp, tt, nchw(z_p))
  for got, want in ((got_x, want_x), (got_mean, want_mean)):
    want = np.asarray(want)
    np.testing.assert_allclose(nhwc(got), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())

  # The port's whole chain: finite, NFE N·(n_steps + 1) as JAX counts it.
  sampler = sampling.get_pc_sampler(
      ours, _PortModel(), SHAPE, sampling.get_predictor(predictor),
      sampling.get_corrector(corrector), lambda v: v, snr=0.16, n_steps=1,
      continuous=True, denoise=True, device="cpu")
  samples, nfe = sampler(torch.Generator().manual_seed(1))
  assert samples.shape == SHAPE and torch.isfinite(samples).all()
  assert nfe == ours.N * 2


@pytest.mark.parametrize("sde_name", list(SDES))
@pytest.mark.parametrize("method", ["heun", "dpmpp", "sde-dpmpp"])
def test_flow_samplers_match_jax(sde_name, method, monkeypatch):
  """Three steps and the denoising step of heun / DPM-Solver++(2M) /
  SDE-DPM-Solver++(2M) from JAX's prior and per-step noise."""
  ours, ref = SDES[sde_name]
  params = {"scale": jnp.full((1,), SCALE)}
  n_steps, eps = 3, 1e-3
  kwargs = dict(n_steps=n_steps, denoise=True, continuous=True, eps=eps)
  if method == "heun":
    want, want_nfe = jax_sampling.get_heun_sampler(
        ref, _JaxModel(), SHAPE, lambda v: v, **kwargs)(
            jax.random.PRNGKey(3), params)
    port = sampling.get_heun_sampler(ours, _PortModel(), SHAPE, lambda v: v,
                                     device="cpu", **kwargs)
  else:
    stochastic = method == "sde-dpmpp"
    want, want_nfe = jax_sampling.get_dpmpp_sampler(
        ref, _JaxModel(), SHAPE, lambda v: v, stochastic=stochastic,
        **kwargs)(jax.random.PRNGKey(3), params)
    port = sampling.get_dpmpp_sampler(ours, _PortModel(), SHAPE, lambda v: v,
                                      stochastic=stochastic, device="cpu",
                                      **kwargs)
  # The JAX samplers' draws: the prior from split(key)[1], the steps' noise
  # from split(split(key)[0], n_steps).
  rng, prior_rng = jax.random.split(jax.random.PRNGKey(3))
  prior = np.asarray(ref.prior_sampling(prior_rng, SHAPE))
  queue = [nchw(np.asarray(jax.random.normal(k, SHAPE)))
           for k in jax.random.split(rng, n_steps)]
  monkeypatch.setattr(sampling, "normal", lambda s, g, d: queue.pop(0))
  got, nfe = port(torch.Generator(), z=torch.from_numpy(prior))
  assert nfe == int(want_nfe) == (2 * n_steps + 1 if method == "heun"
                                  else n_steps + 1)
  assert len(queue) == (0 if method == "sde-dpmpp" else n_steps)
  want = np.asarray(want)
  np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                             atol=1e-5 * np.abs(want).max())


def _jax_chain(update_pairs, x, timesteps, noises, monkeypatch):
  """The JAX package's update functions in a Python loop, fed ``noises``
  [step, corrector/predictor] in the PC sampler's order."""
  x_mean = x
  for i, t_i in enumerate(timesteps):
    t = jnp.full((x.shape[0],), t_i)
    for kind, update in enumerate(update_pairs):
      _feed(monkeypatch, noises[i, kind])
      x, x_mean = update(jax.random.PRNGKey(0), x, t)
  return np.asarray(x_mean)


@pytest.mark.parametrize("path,predictor,n,continuous", [
    (DDPMPP, "euler_maruyama", 4, True),
    (DDPM, "ancestral_sampling", 25, False)])
def test_pc_chain_on_tiny_network_matches_jax(path, predictor, n, continuous,
                                              monkeypatch):
  """vp/cifar10_ddpmpp_continuous.py's sampler (Euler–Maruyama, no
  corrector) and vp/ddpm/cifar10.py's (ancestral, discrete VP) on their
  tiny networks, N steps from the same prior and noise."""
  cfg, model_def, params, model = tiny_pair(path)
  b, shape = 2, (2, 16, 16, 3)
  rng = np.random.default_rng(12)
  prior = rng.normal(size=shape).astype(np.float32)
  noises = rng.normal(size=(n, 2) + shape).astype(np.float32)
  eps = sde_lib.sampling_eps(cfg)
  sde_j = jax_sde.VPSDE(beta_min=cfg.model.beta_min,
                        beta_max=cfg.model.beta_max, N=n)
  score_j = jax.jit(jax_mutils.get_score_fn(sde_j, model_def, params,
                                            continuous=continuous))
  want = _jax_chain(
      (jax_sampling.get_corrector("none")(sde_j, score_j, 0.16, 1),
       jax_sampling.get_predictor(predictor)(sde_j, score_j)),
      jnp.asarray(prior), jnp.linspace(sde_j.T, eps, n), noises, monkeypatch)

  queue = [nchw(noises[i, 1]) for i in range(n)]  # no corrector draws
  monkeypatch.setattr(sampling, "normal",
                      lambda shape, generator, device: queue.pop(0))
  monkeypatch.setattr(sde_lib.VPSDE, "prior_sampling",
                      lambda self, s, g, d: nchw(prior))
  sde_p = sde_lib.VPSDE(beta_min=cfg.model.beta_min,
                        beta_max=cfg.model.beta_max, N=n)
  sampler = sampling.get_pc_sampler(
      sde_p, model, shape, sampling.get_predictor(predictor),
      sampling.get_corrector("none"), lambda v: v, snr=0.16, n_steps=1,
      continuous=continuous, denoise=True, eps=eps, device="cpu")
  got, nfe = sampler(torch.Generator())
  assert not queue and nfe == n * 2 and got.shape == (b, 16, 16, 3)
  np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                             atol=1e-4 * np.abs(want).max())
