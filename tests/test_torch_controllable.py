"""The port's inpainter and colorizer against the JAX package (CPU, fp32).

The JAX samplers run as the package builds them (jitted, scanned), with
``jax.random.normal`` replaced by a table lookup on the key: every key the
JAX package draws from is derived here by its own split order (the prior,
then per step five ways: corrector, its projection, predictor, its
projection), and each is given one numpy noise array. The port draws the
same arrays in the same order through ``sampling.normal`` and the SDE's
``prior_sampling``. Models: the tiny output/input-skip NCSN++ of
ve/church_ncsnpp_continuous.py (reverse diffusion + Langevin, VE) and the
tiny DDPM++ of vp/cifar10_ddpmpp_continuous.py (Euler-Maruyama, VP), with
the same unit-gain weights on both sides.

Tolerance: 1e-4 relative and 2e-6 x sigma_max absolute (VE; 1e-4 for VP),
for fp32 network differences (<= 1e-4 relative) carried through the
chain's three steps, as tests/test_torch_sampling.py's PC chain.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from score_sde_pytorch_tpu import sde as jax_sde
from score_sde_pytorch_tpu_torch import controllable_generation as cg
from score_sde_pytorch_tpu_torch import sampling
from score_sde_pytorch_tpu_torch import sde as sde_lib
from tests import test_torch_ddpm, test_torch_hires
from tests.test_torch_ncsnpp import nchw
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

jax_cg = importlib.import_module("score_sde_pytorch_tpu.controllable_generation")
jax_sampling = importlib.import_module("score_sde_pytorch_tpu.sampling")

N = 3          # PC steps
BATCH = 2
EPS = 1e-5     # the JAX package's default for both samplers


def test_basis_equals_the_jax_packages():
  assert cg._M.dtype == jax_cg._M.dtype == np.float32
  assert np.array_equal(cg._M, jax_cg._M)
  assert np.array_equal(cg._INV_M, jax_cg._INV_M)


def test_couple_decouple_inverse():
  x = torch.randn(2, 3, 4, 4, generator=torch.Generator().manual_seed(0))
  torch.testing.assert_close(cg.couple(cg.decouple(x)), x, rtol=1e-4,
                             atol=1e-5)


def test_decouple_matches_jax_on_nchw():
  x = np.random.default_rng(1).normal(size=(2, 4, 4, 3)).astype(np.float32)
  want = np.asarray(jax_cg.decouple(jnp.asarray(x)))
  got = cg.decouple(nchw(x)).permute(0, 2, 3, 1).numpy()
  np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_decouple_gray_channel_isolated():
  """A gray image (R = G = B) maps entirely onto channel 0 of the basis."""
  g = torch.randn(2, 1, 4, 4, generator=torch.Generator().manual_seed(0))
  d = cg.decouple(g.expand(-1, 3, -1, -1))
  assert d[:, 1:].abs().max() <= 1e-5
  assert d[:, 0].abs().mean() > 0


def test_mask_shape():
  m = cg.get_mask(torch.zeros(2, 3, 4, 4))
  assert m.shape == (2, 3, 4, 4)
  assert (m[:, 0] == 1).all() and (m[:, 1:] == 0).all()


def _models(kind):
  """(config, flax module, params, port model) of a tiny network."""
  if kind == "ncsnpp_skip":
    return test_torch_hires.tiny_pair(f"model.num_scales={N}")
  return test_torch_ddpm.tiny_pair(test_torch_ddpm.DDPMPP,
                                   f"model.num_scales={N}")


def _sdes(cfg):
  m = cfg.model
  if cfg.training.sde == "vesde":
    return (jax_sde.VESDE(sigma_min=m.sigma_min, sigma_max=m.sigma_max, N=N),
            sde_lib.build_sde(cfg), m.sigma_max)
  return (jax_sde.VPSDE(beta_min=m.beta_min, beta_max=m.beta_max, N=N),
          sde_lib.build_sde(cfg), 1.0)


def _draw_keys(key, corrector, predictor):
  """The keys the JAX samplers draw noise from, in their order: the prior,
  then per step the corrector's (Langevin splits its key n_steps = 1 ways),
  the projection's, the predictor's and the projection's. None marks a
  draw the JAX package does not make: the port makes none for a missing
  corrector either, and draws a missing predictor's noise all the same."""
  key, prior = jax.random.split(key)
  keys = [prior]
  for _ in range(N):
    key, c, cp, p, pp = jax.random.split(key, 5)
    keys += [jax.random.split(c, 1)[0] if corrector != "none" else None,
             cp, p if predictor != "none" else None, pp]
  return keys


@pytest.mark.parametrize("task", ["inpaint", "colorize"])
@pytest.mark.parametrize("kind", ["ncsnpp_skip", "ddpmpp"])
def test_sampler_matches_jax_with_injected_noise(kind, task, monkeypatch):
  cfg, model_def, params, model = _models(kind)
  sde_j, sde_p, sigma_max = _sdes(cfg)
  predictor, corrector = cfg.sampling.predictor, cfg.sampling.corrector
  size = cfg.data.image_size
  shape = (BATCH, size, size, 3)
  rng = np.random.default_rng(11)
  data = rng.uniform(size=shape).astype(np.float32)
  if task == "colorize":
    data = np.repeat(data[..., :1], 3, axis=-1)  # R = G = B
  mask = np.zeros(shape, np.float32)
  mask[:, :size // 2] = 1.0  # the top half is known

  keys = _draw_keys(jax.random.PRNGKey(2), corrector, predictor)
  table = rng.normal(size=(len(keys),) + shape).astype(np.float32)
  key_table = jnp.asarray(np.stack([np.asarray(k) if k is not None
                                    else np.full(2, 2 ** 32 - 1, np.uint32)
                                    for k in keys]))

  def table_normal(key, shape_, dtype=jnp.float32):
    hit = jnp.all(key_table == key[None], axis=-1)
    return jnp.asarray(table)[jnp.argmax(hit)].reshape(shape_)

  common = dict(snr=cfg.sampling.snr, n_steps=1, continuous=True,
                denoise=True, eps=EPS)
  build_j = (jax_cg.get_pc_inpainter if task == "inpaint"
             else jax_cg.get_pc_colorizer)
  sampler_j = build_j(sde_j, model_def,
                      jax_sampling.get_predictor(predictor),
                      jax_sampling.get_corrector(corrector), lambda x: x,
                      **common)
  monkeypatch.setattr(jax.random, "normal", table_normal)
  args = ((jnp.asarray(data), jnp.asarray(mask)) if task == "inpaint"
          else (jnp.asarray(data),))
  want = np.asarray(sampler_j(jax.random.PRNGKey(2), params, *args))
  monkeypatch.undo()

  # The port: the same arrays in its draw order (one draw per corrector
  # step, as it runs).
  queue = []
  for i, key in enumerate(keys[1:]):
    if key is None and i % 4 == 0:
      continue  # no corrector, no corrector draw
    queue.append(nchw(table[i + 1]) if key is not None else torch.zeros(
        BATCH, 3, size, size))
  monkeypatch.setattr(sampling, "normal",
                      lambda shape_, generator, device: queue.pop(0))
  monkeypatch.setattr(type(sde_p), "prior_sampling",
                      lambda self, s, g, d: nchw(table[0]) * sigma_max)
  build_p = (cg.get_pc_inpainter if task == "inpaint"
             else cg.get_pc_colorizer)
  sampler_p = build_p(sde_p, model, sampling.get_predictor(predictor),
                      sampling.get_corrector(corrector), lambda x: x,
                      device="cpu", **common)
  args = ((torch.from_numpy(data), torch.from_numpy(mask))
          if task == "inpaint" else (torch.from_numpy(data),))
  got = sampler_p(torch.Generator(), *args)
  assert not queue and got.shape == shape
  np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                             atol=2e-6 * sigma_max if sigma_max > 1 else 1e-4)
  # What the samplers promise: the known region / the gray channel kept.
  if task == "inpaint":
    np.testing.assert_allclose(got.numpy()[:, :size // 2],
                               data[:, :size // 2], atol=1e-3)
  else:
    gray_out = cg.decouple(got.permute(0, 3, 1, 2))[:, 0]
    gray_in = cg.decouple(nchw(data))[:, 0]
    torch.testing.assert_close(gray_out, gray_in, atol=1e-3, rtol=0)


def _tiny_church():
  return test_torch_hires.tiny_pair("model.num_scales=4")


def test_inpainter_preserves_known_region():
  """The JAX package's cell (tests/test_controllable.py) on the port: the
  known half equals the data at the final mean projection, the unknown
  half is filled with something else, all finite."""
  cfg, _, _, model = _tiny_church()
  inpainter = cg.get_pc_inpainter(
      sde_lib.build_sde(cfg), model, sampling.get_predictor(
          "reverse_diffusion"), sampling.get_corrector("langevin"),
      lambda x: x, snr=0.16, continuous=True, device="cpu")
  data = torch.rand(2, 16, 16, 3, generator=torch.Generator().manual_seed(1))
  mask = torch.zeros_like(data)
  mask[:, :8] = 1.0
  out = inpainter(torch.Generator().manual_seed(2), data, mask)
  assert torch.isfinite(out).all()
  torch.testing.assert_close(out[:, :8], data[:, :8], atol=1e-3, rtol=0)
  assert (out[:, 8:] - data[:, 8:]).abs().max() > 1e-2


def test_colorizer_preserves_gray_projection():
  cfg, _, _, model = _tiny_church()
  colorizer = cg.get_pc_colorizer(
      sde_lib.build_sde(cfg), model, sampling.get_predictor(
          "reverse_diffusion"), sampling.get_corrector("none"), lambda x: x,
      snr=0.16, continuous=True, device="cpu")
  g = torch.rand(2, 16, 16, 1, generator=torch.Generator().manual_seed(1))
  gray = g.expand(-1, -1, -1, 3)
  out = colorizer(torch.Generator().manual_seed(2), gray)
  assert torch.isfinite(out).all()
  torch.testing.assert_close(cg.decouple(out.permute(0, 3, 1, 2))[:, 0],
                             cg.decouple(gray.permute(0, 3, 1, 2))[:, 0],
                             atol=1e-3, rtol=0)
