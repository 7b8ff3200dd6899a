"""The port's VE SDE and PC sampler against the JAX package (CPU, fp32).

Noise is made with numpy and injected on both sides: ``jax.random.normal``
is monkeypatched as in tests/test_golden_sampling.py, and the port's
``sampling.normal`` (its one noise source) and ``VESDE.prior_sampling``
are patched to hand out the same arrays, transposed to NCHW.
"""
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from score_sde_pytorch_tpu import interop as jax_interop
from score_sde_pytorch_tpu import sde as jax_sde
from score_sde_pytorch_tpu.models import utils as jax_mutils
from score_sde_pytorch_tpu_torch import checkpoint, main, sampling
from score_sde_pytorch_tpu_torch import sde as sde_lib
from score_sde_pytorch_tpu_torch import interop
from score_sde_pytorch_tpu_torch.models import utils as mutils
from tests.test_torch_ncsnpp import (FLAGSHIP, TINY, init_params, nchw, nhwc,
                                     tiny_flagship_config)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

jax_sampling = importlib.import_module("score_sde_pytorch_tpu.sampling")

SIGMA_MAX = 50.0


@pytest.mark.parametrize("n", [1000, 100, 2000])
def test_sigma_index_sequence_matches_jax(n):
  """The hazard of VESDE.discretize: int32(t (N-1)) on fp32 timesteps, where
  a time one ulp off can truncate to the next index. XLA reassociates the
  linspace arithmetic, so times may differ from JAX's in the last bit; the
  index sequences must be equal (N=1000 is the flagship's)."""
  eps = 1e-5
  t_jax = np.asarray(jnp.linspace(1.0, eps, n))
  idx_jax = np.asarray((jnp.asarray(t_jax) * (n - 1) / 1.0).astype(jnp.int32))
  t_port = sde_lib.linspace(1.0, eps, n)
  np.testing.assert_allclose(t_port.numpy(), t_jax, rtol=0,
                             atol=np.spacing(np.float32(1.0)))
  idx_port = sde_lib.VESDE(N=n).timestep_index(t_port).numpy()
  np.testing.assert_array_equal(idx_port, idx_jax)
  assert idx_port[0] == n - 1 and idx_port[-1] == 0


def test_discrete_sigmas_match_jax():
  got = sde_lib.VESDE(N=1000).discrete_sigmas().numpy()
  want = np.asarray(jax_sde.VESDE(N=1000).discrete_sigmas)
  np.testing.assert_allclose(got, want, rtol=1e-6)


def test_vp_and_subvp_raise_naming_roadmap():
  """VP and subVP were not ported before; build_sde now builds them from
  the config's beta range and num_scales, and subVP is no VP subclass
  (the samplers' and losses' dispatch relies on it)."""
  cfg = tiny_flagship_config()
  for name, cls in (("vpsde", sde_lib.VPSDE), ("subvpsde", sde_lib.SubVPSDE)):
    cfg.training.sde = name
    sde = sde_lib.build_sde(cfg)
    assert type(sde) is cls
    assert (sde.beta_min, sde.beta_max, sde.N) == (
        cfg.model.beta_min, cfg.model.beta_max, cfg.model.num_scales)
  assert not issubclass(sde_lib.SubVPSDE, sde_lib.VPSDE)
  cfg.training.sde = "rfsde"
  with pytest.raises(NotImplementedError, match="unknown"):
    sde_lib.build_sde(cfg)


def test_vesde_functions_match_jax():
  """sde(), marginal_prob(), prior_logp() and the reverse SDE's sde()."""
  rng = np.random.default_rng(8)
  x = (rng.normal(size=(3, 4, 4, 3)) * 20).astype(np.float32)
  t = np.array([1e-5, 0.3, 1.0], np.float32)
  ours, ref = sde_lib.VESDE(N=50), jax_sde.VESDE(N=50)
  jax_score, port_score = _analytic_scores()
  xt, tt = nchw(x), torch.from_numpy(t)
  pairs = [
      (ours.sde(xt, tt)[1], ref.sde(jnp.asarray(x), jnp.asarray(t))[1]),
      (ours.marginal_prob(xt, tt)[1],
       ref.marginal_prob(jnp.asarray(x), jnp.asarray(t))[1]),
      (ours.prior_logp(xt), ref.prior_logp(jnp.asarray(x))),
  ]
  for got, want in pairs:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
  for flow in (False, True):
    got_drift, got_diff = ours.reverse(port_score, flow).sde(xt, tt)
    want_drift, want_diff = ref.reverse(jax_score, flow).sde(
        jnp.asarray(x), jnp.asarray(t))
    np.testing.assert_allclose(nhwc(got_drift), want_drift, rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(got_diff.numpy(), want_diff, rtol=1e-5)


def _analytic_scores():
  return (lambda x, t: jax_sde.batch_mul(-1.0 / (1.0 + t), x),
          lambda x, t: sde_lib.batch_mul(-1.0 / (1.0 + t), x))


def _step_data(b=4):
  rng = np.random.default_rng(7)
  x = (rng.normal(size=(b, 8, 8, 3)) * 10).astype(np.float32)
  t = np.array([1e-5, 17.0 / 99, 0.5, 1.0], np.float32)
  noise = rng.normal(size=(b, 8, 8, 3)).astype(np.float32)
  return x, t, noise


def test_predictor_step_matches_jax(monkeypatch):
  """Tolerance 1e-4 absolute: fp32 rounding at the VE scale (|x| ~ 50)."""
  x, t, noise = _step_data()
  jax_score, port_score = _analytic_scores()
  monkeypatch.setattr(jax.random, "normal",
                      lambda key, shape, dtype=jnp.float32: jnp.asarray(noise))
  want_x, want_mean = jax_sampling.reverse_diffusion_predictor(
      jax_sde.VESDE(N=100), jax_score)(jax.random.PRNGKey(0),
                                       jnp.asarray(x), jnp.asarray(t))
  got_x, got_mean = sampling.reverse_diffusion_predictor(
      sde_lib.VESDE(N=100), port_score)(nchw(x), torch.from_numpy(t),
                                        nchw(noise))
  np.testing.assert_allclose(nhwc(got_mean), want_mean, atol=1e-4, rtol=1e-5)
  np.testing.assert_allclose(nhwc(got_x), want_x, atol=1e-4, rtol=1e-5)


def test_corrector_step_matches_jax(monkeypatch):
  x, t, noise = _step_data()
  jax_score, port_score = _analytic_scores()
  monkeypatch.setattr(jax.random, "normal",
                      lambda key, shape, dtype=jnp.float32: jnp.asarray(noise))
  want_x, want_mean = jax_sampling.langevin_corrector(
      jax_sde.VESDE(N=100), jax_score, snr=0.16, n_steps=1)(
          jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t))
  got_x, got_mean = sampling.langevin_corrector(
      sde_lib.VESDE(N=100), port_score, snr=0.16, n_steps=1)(
          nchw(x), torch.from_numpy(t), lambda step: nchw(noise))
  np.testing.assert_allclose(nhwc(got_mean), want_mean, atol=1e-4, rtol=1e-5)
  np.testing.assert_allclose(nhwc(got_x), want_x, atol=1e-4, rtol=1e-5)


def test_four_step_pc_chain_on_tiny_model_matches_jax(monkeypatch):
  """Four PC steps (Langevin corrector, then reverse-diffusion predictor)
  on the tiny flagship-shaped NCSN++ with the same weights and noise.

  Tolerance: 2e-6 · sigma_max = 1e-4 absolute on states that start at
  sigma_max scale, for fp32 model differences (<= 1e-4 relative) carried
  through four steps."""
  cfg = tiny_flagship_config()
  n_steps, b = 4, 2
  model_def = jax_mutils.get_model(cfg.model.name)(cfg)
  params = init_params(model_def, jnp.zeros((1, 16, 16, 3)), jnp.ones((1,)))
  model = mutils.create_model(cfg, "cpu", torch.Generator().manual_seed(0))
  interop.load_jax_params(model, params, cfg)

  rng = np.random.default_rng(11)
  shape = (b, 16, 16, 3)
  prior = rng.normal(size=shape).astype(np.float32)
  noises = rng.normal(size=(n_steps, 2) + shape).astype(np.float32)
  eps = sde_lib.sampling_eps(cfg)

  # JAX: the package's own update and score functions in a Python loop.
  sde_j = jax_sde.VESDE(sigma_min=cfg.model.sigma_min,
                        sigma_max=cfg.model.sigma_max, N=n_steps)
  score_j = jax.jit(jax_mutils.get_score_fn(sde_j, model_def, params,
                                            continuous=True))
  corrector_j = jax_sampling.langevin_corrector(sde_j, score_j, snr=0.16,
                                                n_steps=1)
  predictor_j = jax_sampling.reverse_diffusion_predictor(sde_j, score_j)
  x = jnp.asarray(prior) * sde_j.sigma_max
  key = jax.random.PRNGKey(0)
  for i, t_i in enumerate(jnp.linspace(sde_j.T, eps, n_steps)):
    t = jnp.full((b,), t_i)
    for kind, update in ((0, corrector_j), (1, predictor_j)):
      z = jnp.asarray(noises[i, kind])
      monkeypatch.setattr(jax.random, "normal",
                          lambda k, s, dtype=jnp.float32, z=z: z)
      x, x_mean = update(key, x, t)
  want = np.asarray(x_mean)

  # Port: its sampler, fed the same noise in its draw order.
  queue = [nchw(noises[i, kind]) for i in range(n_steps) for kind in (0, 1)]
  monkeypatch.setattr(sampling, "normal",
                      lambda shape, generator, device: queue.pop(0))
  monkeypatch.setattr(sde_lib.VESDE, "prior_sampling",
                      lambda self, s, g, d: nchw(prior) * self.sigma_max)
  sde_p = sde_lib.VESDE(sigma_min=cfg.model.sigma_min,
                        sigma_max=cfg.model.sigma_max, N=n_steps)
  sampler = sampling.get_pc_sampler(
      sde_p, model, shape, sampling.reverse_diffusion_predictor,
      sampling.langevin_corrector, lambda v: v, snr=0.16, n_steps=1,
      continuous=True, denoise=True, eps=eps, device="cpu")
  got, nfe = sampler(torch.Generator())
  assert not queue and nfe == n_steps * 2
  assert got.shape == shape
  np.testing.assert_allclose(got.numpy(), want, atol=2e-6 * SIGMA_MAX,
                             rtol=1e-4)


def test_sample_mode_end_to_end_on_cpu(tmp_path):
  """main --mode sample --device cpu from a .pth that the JAX package's
  interop.export_torch_checkpoint wrote: two rounds, the last one trimmed."""
  cfg = tiny_flagship_config()
  model_def = jax_mutils.get_model(cfg.model.name)(cfg)
  params = init_params(model_def, jnp.zeros((1, 16, 16, 3)), jnp.ones((1,)))
  os.makedirs(tmp_path / "checkpoints")
  jax_interop.export_torch_checkpoint(
      params, cfg, str(tmp_path / "checkpoints" / "checkpoint_3.pth"), step=3)
  rounds = main.main(
      ["--config", FLAGSHIP, "--workdir", str(tmp_path), "--mode", "sample",
       "--device", "cpu", "--num_samples", "5",
       "--config.eval.batch_size=4", "--config.model.num_scales=3"]
      + ["--config." + o for o in TINY])
  assert [r["samples"] for r in rounds] == [4, 1]
  assert [r["nfe"] for r in rounds] == [6, 6]
  for r, n in enumerate((4, 1)):
    samples = np.load(tmp_path / "generated" / f"samples_{r}.npz")["samples"]
    assert samples.dtype == np.uint8 and samples.shape == (n, 16, 16, 3)
    assert (tmp_path / "generated" / f"samples_{r}.png").is_file()
  assert "Sampling from checkpoint_3" in (tmp_path / "stdout.txt").read_text()


def test_restore_copies_ema_shadow_params(tmp_path):
  """Sampling uses the EMA weights: restore copies shadow_params, in order,
  into the trainable parameters; the frozen Fourier W keeps the model's."""
  cfg = tiny_flagship_config()
  source = mutils.create_model(cfg, "cpu", torch.Generator().manual_seed(1))
  trainable = [p for p in source.parameters() if p.requires_grad]
  ema = [p.detach() + 1.0 for p in trainable]
  path = str(tmp_path / "ckpt.pth")
  checkpoint.save_checkpoint(path, source, cfg, step=7, ema_params=ema)
  target = mutils.create_model(cfg, "cpu", torch.Generator().manual_seed(2))
  assert checkpoint.restore_ema(path, target) == 7
  restored = [p for p in target.parameters() if p.requires_grad]
  for got, want in zip(restored, ema):
    torch.testing.assert_close(got, want, atol=0, rtol=0)
  torch.testing.assert_close(target.all_modules[0].W, source.all_modules[0].W,
                             atol=0, rtol=0)


def test_predictor_only_sampling_with_corrector_none():
  """corrector='none' runs the predictor alone; the chain stays finite, and
  nfe is the JAX package's count, N·(n_steps+1), whatever the corrector."""
  cfg = tiny_flagship_config()
  cfg.sampling.corrector = "none"
  cfg.model.num_scales = 3
  model = mutils.create_model(cfg, "cpu", torch.Generator().manual_seed(0))
  sampler = sampling.get_sampling_fn(cfg, sde_lib.build_sde(cfg), model,
                                     (2, 16, 16, 3), lambda v: v,
                                     device="cpu")
  samples, nfe = sampler(torch.Generator().manual_seed(0))
  assert nfe == 6 and samples.shape == (2, 16, 16, 3)
  assert torch.isfinite(samples).all()


@pytest.mark.parametrize("corrector", ["langevin", "ald"])
@pytest.mark.parametrize("entry", ["pc_sampler", "inpainter"])
def test_correctors_draw_each_steps_noise_when_it_runs(corrector, entry,
                                                       monkeypatch):
  """With n_steps_each = 5, no noise tensor of shape (n_steps,) + state is
  made: every draw through ``sampling.normal`` is one state's shape, and a
  corrector's draws come one per Langevin step, between its network
  evaluations."""
  from score_sde_pytorch_tpu_torch import controllable_generation as cg
  cfg = tiny_flagship_config()
  cfg.model.num_scales = 2
  cfg.sampling.corrector = corrector
  cfg.sampling.n_steps_each = 5
  model = mutils.create_model(cfg, "cpu", torch.Generator().manual_seed(0))
  events, draw = [], sampling.normal

  def recording_normal(shape, generator, device):
    events.append(tuple(shape))
    return draw(shape, generator, device)

  monkeypatch.setattr(sampling, "normal", recording_normal)
  model.register_forward_pre_hook(lambda m, a: events.append("eval"))
  sde = sde_lib.build_sde(cfg)
  g = torch.Generator().manual_seed(0)
  if entry == "pc_sampler":
    out, nfe = sampling.get_sampling_fn(cfg, sde, model, (2, 16, 16, 3),
                                        lambda v: v, device="cpu")(g)
    assert nfe == 2 * 6
  else:
    data = torch.rand(2, 16, 16, 3, generator=g)
    out = cg.get_pc_inpainter(
        sde, model, sampling.get_predictor(cfg.sampling.predictor),
        sampling.get_corrector(corrector), lambda v: v, cfg.sampling.snr,
        n_steps=5, continuous=True)(g, data, torch.ones_like(data))
  assert torch.isfinite(out).all()
  draws = [e for e in events if e != "eval"]
  assert set(draws) == {(2, 3, 16, 16)}
  # The corrector's 5 draws each come with its own evaluation; the
  # inpainter also draws its 2 projections' noise per step.
  assert len(draws) == 2 * (6 if entry == "pc_sampler" else 8)
  assert events.count("eval") == 2 * 6
  first = events.index("eval")
  assert events[first:first + 10].count("eval") == 5


def test_unported_samplers_raise_naming_roadmap():
  """Every sampling method is ported: get_sampling_fn builds each of pc
  (every predictor and corrector), ode, heun and dpmpp, and each samples a
  finite batch with its NFE; an unknown name raises as in the JAX
  package."""
  model = mutils.create_model(tiny_flagship_config(), "cpu",
                              torch.Generator().manual_seed(0))
  settings = [dict(method="pc", predictor=p, corrector=c)
              for p in ("euler_maruyama", "reverse_diffusion",
                        "ancestral_sampling", "none")
              for c in ("langevin", "ald", "none")]
  settings += [dict(method="ode"), dict(method="heun", heun_steps=1),
               dict(method="dpmpp", dpmpp_steps=2),
               dict(method="dpmpp", dpmpp_steps=2, dpmpp_stochastic=True)]
  for setting in settings:
    cfg = tiny_flagship_config()
    cfg.model.num_scales = 2
    for key, value in setting.items():
      cfg.sampling[key] = value
    sampler = sampling.get_sampling_fn(cfg, sde_lib.build_sde(cfg), model,
                                       (1, 16, 16, 3), lambda v: v,
                                       device="cpu")
    samples, nfe = sampler(torch.Generator().manual_seed(0))
    assert samples.shape == (1, 16, 16, 3), setting
    assert torch.isfinite(samples).all(), setting
    want = {"pc": 4, "heun": 3, "dpmpp": 3}.get(setting["method"])
    assert want is None or nfe == want, (setting, nfe)
  for key, value, error in (("method", "rk4", ValueError),
                            ("predictor", "leapfrog", KeyError),
                            ("corrector", "hmc", KeyError)):
    bad = tiny_flagship_config()
    bad.sampling[key] = value
    with pytest.raises(error, match=value):
      sampling.get_sampling_fn(bad, sde_lib.build_sde(bad), model,
                               (1, 16, 16, 3), lambda v: v, device="cpu")


def test_sample_resolves_meta_checkpoint_and_reports_missing(tmp_path):
  from score_sde_pytorch_tpu_torch import run_lib
  with pytest.raises(FileNotFoundError, match="no checkpoint"):
    run_lib._resolve_checkpoint(str(tmp_path), -1)
  os.makedirs(tmp_path / "checkpoints-meta")
  (tmp_path / "checkpoints-meta" / "checkpoint.pth").write_bytes(b"")
  assert run_lib._resolve_checkpoint(str(tmp_path), -1)[1] == (
      "checkpoints-meta")
  with pytest.raises(FileNotFoundError, match="checkpoint_4"):
    run_lib._resolve_checkpoint(str(tmp_path), 4)


def test_latest_checkpoint_is_the_highest_number(tmp_path):
  for n in (2, 10, 9):
    os.makedirs(tmp_path / "checkpoints", exist_ok=True)
    (tmp_path / "checkpoints" / f"checkpoint_{n}.pth").write_bytes(b"")
  (tmp_path / "checkpoints" / "checkpoint_x.pth").write_bytes(b"")
  assert checkpoint.latest_numbered(str(tmp_path)) == 10
  assert checkpoint.latest_numbered(str(tmp_path / "missing")) is None
