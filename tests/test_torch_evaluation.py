"""The port's FID, IS and KID against the JAX package's (CPU).

The same activations and logits, made with numpy, go through both
packages. Tolerances: FID 1e-3 relative (both fp32, an ``eigh`` of a D×D
covariance in different libraries), IS 1e-5 relative, KID 1e-6 relative
(both float64 numpy).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from score_sde_pytorch_tpu import evaluation as jax_evaluation
from score_sde_pytorch_tpu_torch import configs, evaluation, inception
from tests.test_torch_ncsnpp import FLAGSHIP
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _acts(n, d, seed, shift=0.0):
  rng = np.random.default_rng(seed)
  # Correlated features with a spread of scales, like pool_3's.
  mix = rng.normal(size=(d, d)) / np.sqrt(d)
  return (rng.normal(size=(n, d)) @ mix * rng.uniform(0.1, 2.0, d)
          + shift).astype(np.float32)


@pytest.mark.parametrize("n,d", [(300, 64), (64, 512)])
def test_fid_from_activations_matches_jax(n, d):
  """d = 512 with 64 samples: rank-deficient covariances, as 2048-d pool_3
  features of fewer than 2048 images give, where the trace-relative
  regularisation carries the result."""
  a, b = _acts(n, d, 0), _acts(n + 7, d, 1, shift=0.3)
  want = jax_evaluation.fid_from_activations(a, b)
  got = evaluation.fid_from_activations(a, b)
  assert np.isfinite(got) and got > 0
  np.testing.assert_allclose(got, want, rtol=1e-3)


def test_fid_from_stats_matches_jax():
  a, ref = _acts(200, 32, 2), _acts(500, 32, 3, shift=0.1)
  mu, sigma = ref.mean(0), np.cov(ref, rowvar=False).astype(np.float32)
  want = jax_evaluation.fid_from_stats(a, mu, sigma)
  got = evaluation.fid_from_stats(a, mu, sigma)
  np.testing.assert_allclose(got, want, rtol=1e-3)


def test_fid_of_a_set_with_itself_is_near_zero():
  a = _acts(400, 16, 4)
  assert abs(evaluation.fid_from_activations(a, a)) < 1e-3


def test_inception_score_matches_jax():
  logits = np.random.default_rng(5).normal(size=(50, 1008)).astype(
      np.float32) * 3
  want = jax_evaluation.inception_score_from_logits(logits)
  got = evaluation.inception_score_from_logits(logits)
  np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("block_size", [1000, 40])
def test_kid_matches_jax(block_size):
  a, b = _acts(120, 48, 6), _acts(100, 48, 7, shift=0.2)
  want = jax_evaluation.kid_from_activations(a, b, block_size)
  got = evaluation.kid_from_activations(a, b, block_size)
  np.testing.assert_allclose(got, want, rtol=1e-6)


def test_sqrtm_newton_schulz_matches_jax():
  a = _acts(200, 24, 8)
  cov = np.cov(a, rowvar=False).astype(np.float32) + 0.1 * np.eye(
      24, dtype=np.float32)
  got = evaluation.sqrtm_newton_schulz(torch.from_numpy(cov)).numpy()
  want = np.asarray(jax_evaluation.sqrtm_newton_schulz(jnp.asarray(cov)))
  np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
  np.testing.assert_allclose(got @ got, cov, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("size", [32, 256])
def test_weights_path_follows_the_protocol(size, tmp_path, monkeypatch):
  """Below 256 px INCEPTION_WEIGHTS_NPZ / eval.inception_weights, from
  256 px INCEPTION_V3_FEATURE_WEIGHTS_NPZ / eval.inception_feature_weights;
  a path that does not exist counts as none."""
  config = configs.load_config(FLAGSHIP, [f"data.image_size={size}"])
  for var in ("INCEPTION_WEIGHTS_NPZ", "INCEPTION_V3_FEATURE_WEIGHTS_NPZ"):
    monkeypatch.delenv(var, raising=False)
  assert evaluation.is_inceptionv3(config) == (size >= 256)
  assert evaluation.get_inception_weights_path(config) is None
  assert evaluation.run_inception(np.zeros((1, 8, 8, 3), np.uint8),
                                  config) is None
  path = tmp_path / "w.npz"
  path.write_bytes(b"")
  var, key = (("INCEPTION_V3_FEATURE_WEIGHTS_NPZ", "inception_feature_weights")
              if size >= 256 else ("INCEPTION_WEIGHTS_NPZ",
                                   "inception_weights"))
  monkeypatch.setenv(var, str(path))
  for pkg in (evaluation, jax_evaluation):
    assert pkg.get_inception_weights_path(config) == str(path)
  monkeypatch.delenv(var)
  config.eval[key] = str(path)
  for pkg in (evaluation, jax_evaluation):
    assert pkg.get_inception_weights_path(config) == str(path)
  config.eval[key] = str(tmp_path / "missing.npz")
  assert evaluation.get_inception_weights_path(config) is None


@pytest.mark.parametrize("stats_keys", ["pool_3", "mu_sigma", "none"])
def test_compute_scores_matches_jax(stats_keys, tmp_path, monkeypatch):
  """The report's keys and values against the JAX package's, with the
  statistics file in ``assets/stats/`` of the working directory."""
  config = configs.load_config(FLAGSHIP, [])
  pools, ref = _acts(80, 64, 9), _acts(90, 64, 10, shift=0.05)
  logits = np.random.default_rng(11).normal(size=(80, 1008)).astype(
      np.float32)
  monkeypatch.chdir(tmp_path)
  if stats_keys != "none":
    os.makedirs("assets/stats")
    arrays = ({"pool_3": ref} if stats_keys == "pool_3" else
              {"mu": ref.mean(0), "sigma": np.cov(ref, rowvar=False)})
    np.savez("assets/stats/cifar10_stats.npz", **arrays)
  got = evaluation.compute_scores(pools, config, logits=logits)
  want = jax_evaluation.compute_scores(pools, config, logits=logits)
  assert set(got) == set(want) == {
      "pool_3": {"inception_score", "fid", "kid"},
      "mu_sigma": {"inception_score", "fid"},
      "none": {"inception_score"}}[stats_keys]
  for key, rtol in (("inception_score", 1e-5), ("fid", 1e-3), ("kid", 1e-6)):
    if key in want:
      np.testing.assert_allclose(got[key], want[key], rtol=rtol, err_msg=key)


def test_scores_at_256px_have_no_inception_score(tmp_path, monkeypatch):
  config = configs.load_config(FLAGSHIP, ["data.image_size=256"])
  monkeypatch.chdir(tmp_path)
  got = evaluation.compute_scores(_acts(10, 64, 12), config,
                                  logits=np.zeros((10, 1008), np.float32))
  assert got == {}


def test_dataset_stats_prefer_the_sized_file(tmp_path, monkeypatch):
  config = configs.load_config(FLAGSHIP, [])
  monkeypatch.chdir(tmp_path)
  with pytest.raises(FileNotFoundError, match="cifar10@32"):
    evaluation.load_dataset_stats(config)
  os.makedirs("assets/stats")
  np.savez("assets/stats/cifar10_stats.npz", mu=np.zeros(2))
  np.savez("assets/stats/cifar10_32_stats.npz", mu=np.ones(2))
  assert evaluation.load_dataset_stats(config)["mu"].tolist() == [1.0, 1.0]


def test_run_inception_uses_the_weights_and_caches_the_model(tmp_path,
                                                             monkeypatch):
  path = inception.write_random_npz(str(tmp_path / "w.npz"), seed=1)
  monkeypatch.setenv("INCEPTION_WEIGHTS_NPZ", path)
  config = configs.load_config(FLAGSHIP, [])
  images = np.random.default_rng(0).integers(0, 256, (2, 32, 32, 3),
                                             dtype=np.uint8)
  stats = evaluation.run_inception(images, config)
  assert stats["pool_3"].shape == (2, 2048)
  assert stats["logits"].shape == (2, 1008)
  model = evaluation.get_inception_model(config)
  assert model is evaluation.get_inception_model(config)
