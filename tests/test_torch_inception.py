"""The port's InceptionV3 against the JAX package's (CPU, fp32).

One random npz in the raw pytorch-fid layout, written by the port, is
loaded by both packages; the same uint8 images go through both extractors.
``pool_3`` and ``logits`` agree within 1e-4 of their max |value|, at 32×32
(upsampled to 299) and at 256×256 (a pool-only npz, as the ≥256 px
protocol loads). The resize alone is held to ``jax.image.resize`` in both
directions, up from 32 and down (anti-aliased) from 1024.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from score_sde_pytorch_tpu import inception as jax_inception
from score_sde_pytorch_tpu_torch import inception
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-4


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
  root = tmp_path_factory.mktemp("inception")
  return {logits: inception.write_random_npz(
      str(root / f"w_{logits}.npz"), seed=3, logits=logits)
          for logits in (True, False)}


def _images(n, size, seed):
  return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3),
                                              dtype=np.uint8)


def _close(got, want):
  np.testing.assert_allclose(got, want, rtol=0,
                             atol=TOL * np.abs(want).max())


def test_features_at_32px_match_jax(npz):
  images = _images(3, 32, 0)
  want = jax_inception.InceptionV3Features(npz[True], batch=4,
                                           shard=False)(images)
  got = inception.InceptionV3Features(npz[True], batch=2)(images)
  assert set(got) == {"pool_3", "logits"}
  assert got["pool_3"].shape == (3, 2048) and got["logits"].shape == (3, 1008)
  for key in want:
    _close(got[key], want[key])


def test_pool_only_features_at_256px_match_jax(npz):
  images = _images(1, 256, 1)
  want = jax_inception.InceptionV3Features(npz[False], batch=1,
                                           shard=False)(images)
  got = inception.InceptionV3Features(npz[False], batch=1)(images)
  assert set(got) == set(want) == {"pool_3"}
  _close(got["pool_3"], want["pool_3"])


@pytest.mark.parametrize("size", [32, 1024])
def test_resize_matches_jax_image_resize(size):
  """Up from 32 (half-pixel bilinear) and down from 1024 (anti-aliased),
  as the extractors resize before the network."""
  images = _images(1, size, 2)
  got = inception.preprocess(torch.from_numpy(images)).numpy()
  x = jnp.asarray(images, jnp.float32) / 255.0
  want = jax.image.resize(x, (1, 299, 299, 3), method="bilinear") * 2.0 - 1.0
  np.testing.assert_allclose(got.transpose(0, 2, 3, 1), np.asarray(want),
                             rtol=0, atol=1e-5)


def test_grey_images_are_tiled_to_three_channels():
  grey = _images(1, 32, 3)[..., :1]
  x = inception.preprocess(torch.from_numpy(grey))
  assert x.shape == (1, 3, 299, 299)
  assert torch.equal(x[:, 0], x[:, 1]) and torch.equal(x[:, 0], x[:, 2])


def test_weight_spec_equals_the_jax_packages():
  assert inception.weight_spec() == jax_inception.weight_spec()
  assert len(inception.weight_spec()) == 94


def test_random_params_are_the_jax_packages_draws():
  """random_params(seed) holds the JAX package's random_params(seed) draws,
  OIHW instead of HWIO; the model takes them as its state_dict."""
  got = inception.random_params(5)
  want = jax_inception.random_params(5)
  assert set(got) == set(want)
  for key, value in want.items():
    value = np.asarray(value)
    if key.endswith(".conv.weight"):
      value = value.transpose(3, 2, 0, 1)
    elif key == "fc.weight":
      value = value.T
    np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)
  inception.InceptionV3.from_params(got)


def test_load_params_folds_batch_norm_as_the_jax_package(npz, tmp_path):
  raw = inception.random_raw_params(seed=4)
  rng = np.random.default_rng(4)
  for name, *_ in inception.weight_spec():
    for bn in ("weight", "bias", "running_mean", "running_var"):
      key = f"{name}.bn.{bn}"
      raw[key] = (rng.uniform(0.5, 1.5, raw[key].shape) if "var" in bn
                  or bn == "weight" else rng.normal(0, 0.1, raw[key].shape)
                  ).astype(np.float32)
  path = str(tmp_path / "bn.npz")
  np.savez(path, **raw)
  got = inception.load_params(path)
  want = jax_inception.load_params(path)
  for name, *_ in inception.weight_spec():
    for part in ("scale", "shift"):
      np.testing.assert_allclose(got[f"{name}.{part}"].numpy(),
                                 np.asarray(want[f"{name}.{part}"]),
                                 rtol=1e-6, atol=1e-7)
  np.testing.assert_array_equal(got["fc.weight"].numpy(),
                                np.asarray(want["fc.weight"]).T)


@pytest.mark.parametrize("damage", ["missing", "hwio"])
def test_load_params_rejects_a_damaged_npz(damage, tmp_path):
  raw = inception.random_raw_params(seed=0)
  if damage == "missing":
    del raw["Mixed_7b.branch_pool.conv.weight"]
    match = "missing Mixed_7b"
  else:
    raw["Conv2d_1a_3x3.conv.weight"] = raw[
        "Conv2d_1a_3x3.conv.weight"].transpose(2, 3, 1, 0)
    match = "Conv2d_1a_3x3.conv.weight"
  path = str(tmp_path / "bad.npz")
  np.savez(path, **raw)
  with pytest.raises(ValueError, match=match):
    inception.load_params(path)
  with pytest.raises(ValueError, match=match):
    jax_inception.load_params(path)


def test_in_block_average_pool_leaves_padding_out():
  x = torch.ones(1, 1, 4, 4)
  torch.testing.assert_close(inception._avg_pool_3x3(x), x)
