"""The port's own copies of JAX-package modules equal their originals.

The port imports nothing of the JAX package, so it carries copies of what
it reads: the config tree, the data pipeline, the NCSN++ parameter map,
the image grid and the C++ data loader's source. Each is held to its original here, on the
CPU: config dicts key for key, batches bit for bit (including the skip a
resumed run makes), parameter maps row for row.
"""
import importlib
import os
import pickle
from pathlib import Path

import numpy as np
import pytest

from score_sde_pytorch_tpu import datasets as jax_datasets
from score_sde_pytorch_tpu import interop as jax_interop
from score_sde_pytorch_tpu.utils import image as jax_image
from score_sde_pytorch_tpu_torch import configs, datasets, interop
from score_sde_pytorch_tpu_torch.utils import image

ROOT = Path(__file__).resolve().parents[1]
JAX_CONFIGS = ROOT / "score_sde_pytorch_tpu" / "configs"
NOT_LEAVES = {"__init__.py", "builder.py", "default_cifar10_configs.py",
              "default_celeba_configs.py", "default_lsun_configs.py"}
LEAVES = sorted(str(p.relative_to(JAX_CONFIGS))
                for p in JAX_CONFIGS.rglob("*.py") if p.name not in NOT_LEAVES)
FLAGSHIP = "score_sde_pytorch_tpu_torch/configs/ve/cifar10_ncsnpp_continuous.py"
DDPM_CONFIG = "score_sde_pytorch_tpu_torch/configs/vp/ddpm/cifar10.py"
DDPM_UNCONDITIONAL = (
    "score_sde_pytorch_tpu_torch/configs/vp/ddpm/cifar10_unconditional.py")
TINY = ("model.nf=16", "model.ch_mult=(1,2)", "model.num_res_blocks=1",
        "model.attn_resolutions=(8,)", "data.image_size=16")


def as_dict(config):
  """A config (ml_collections or the port's stand-in) as nested dicts."""
  if hasattr(config, "to_dict"):
    return config.to_dict()
  fields = object.__getattribute__(config, "_fields")
  return {k: as_dict(v) if isinstance(v, configs.ConfigDict) else v
          for k, v in fields.items()}


def jax_config(rel: str):
  name = "score_sde_pytorch_tpu.configs." + rel[:-3].replace(os.sep, ".")
  return importlib.import_module(name).get_config()


def test_the_port_copies_every_config_file():
  port = sorted(str(p.relative_to(configs.CONFIG_DIR))
                for p in configs.CONFIG_DIR.rglob("*.py")
                if p.name not in NOT_LEAVES)
  assert port == LEAVES
  assert len(LEAVES) > 40


@pytest.mark.parametrize("rel", LEAVES)
def test_config_copy_equals_the_jax_packages(rel):
  got = as_dict(configs.read_config(str(configs.CONFIG_DIR / rel)))
  assert got == as_dict(jax_config(rel))
  # The JAX package's path for the same file loads the port's copy.
  jax_path = str(JAX_CONFIGS / rel)
  assert configs.resolve(jax_path) == configs.CONFIG_DIR / rel


def write_cifar10(root: Path, rng) -> str:
  base = root / "cifar-10-batches-py"
  base.mkdir(parents=True)
  for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
    data = rng.integers(0, 256, size=(12, 3 * 32 * 32), dtype=np.uint8)
    with open(base / name, "wb") as f:
      pickle.dump({b"data": data, b"labels": [0] * 12}, f)
  return str(root)


def write_npz(root: Path, rng) -> str:
  root.mkdir(parents=True)
  for split, n in (("train", 40), ("test", 24)):
    np.savez(root / f"{split}.npz",
             images=rng.integers(0, 256, size=(n, 16, 16, 3), dtype=np.uint8))
  return str(root)


@pytest.mark.parametrize("source", ["synthetic", "cifar10", "npz"])
@pytest.mark.parametrize("dequantize", [False, True])
def test_batches_equal_the_jax_python_backend(source, dequantize, tmp_path):
  """The same batches, bit for bit, from fresh iterators and after the
  skip of k batches that a resumed run makes (JAX's iterator is run
  through them)."""
  rng = np.random.default_rng(0)
  overrides = ["training.batch_size=8", "eval.batch_size=8",
               f"data.uniform_dequantization={dequantize}"]
  if source == "cifar10":
    overrides += ["data.image_size=32",
                  f"data.data_dir={write_cifar10(tmp_path, rng)}"]
  elif source == "npz":
    overrides += ["data.image_size=16", "data.dataset=NPZ",
                  f"data.data_dir={write_npz(tmp_path / 'npz', rng)}"]
  else:
    overrides += ["data.image_size=8"]
  config = configs.load_config(FLAGSHIP, overrides)
  config.data.loader_backend = "python"
  want_train, want_eval = jax_datasets.get_dataset(config, process_index=0,
                                                   process_count=1)
  got_train, got_eval = datasets.get_dataset(config)
  for got, want, count in ((got_train, want_train, 9),
                           (got_eval, want_eval, 4)):
    for _ in range(count):  # past an epoch boundary in every source
      a, b = next(got), next(want)
      assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
  skip = 5
  skipped, _ = datasets.get_dataset(config)
  fresh, _ = jax_datasets.get_dataset(config, process_index=0,
                                      process_count=1)
  skipped.skip(skip)
  for _ in range(skip):
    next(fresh)
  assert np.array_equal(next(skipped), next(fresh))


@pytest.mark.parametrize("source", ["synthetic", "npz"])
@pytest.mark.parametrize("dequantize", [False, True])
def test_eval_batches_equal_the_jax_python_backend(source, dequantize,
                                                   tmp_path):
  """``get_dataset(evaluation=True, uniform_dequantization=...)``, as the
  eval loss and bits/dim stages build it: eval.batch_size batches, the
  dequantization flag OR'ed with the config's, the same epoch sizes, and
  the same batches bit for bit over more than one epoch."""
  rng = np.random.default_rng(3)
  overrides = ["training.batch_size=8", "eval.batch_size=6"]
  if source == "npz":
    overrides += ["data.image_size=16", "data.dataset=NPZ",
                  f"data.data_dir={write_npz(tmp_path / 'npz', rng)}"]
  else:
    overrides += ["data.image_size=8"]
  config = configs.load_config(FLAGSHIP, overrides)
  config.data.loader_backend = "python"
  want = jax_datasets.get_dataset(config, evaluation=True,
                                  uniform_dequantization=dequantize,
                                  process_index=0, process_count=1)
  got = datasets.get_dataset(config, evaluation=True,
                             uniform_dequantization=dequantize)
  for got_it, want_it in zip(got, want, strict=True):
    assert got_it.batches_per_epoch == want_it.batches_per_epoch
    assert got_it.batch_size == 6
    for _ in range(want_it.batches_per_epoch + 2):
      a, b = next(got_it), next(want_it)
      assert a.shape[0] == 6 and np.array_equal(a, b)
  jax_run_lib = importlib.import_module("score_sde_pytorch_tpu.run_lib")
  from score_sde_pytorch_tpu_torch import run_lib
  for it in got:
    assert run_lib._epoch_batches(it) == jax_run_lib._epoch_batches(it)
  with pytest.raises(ValueError, match="epoch size"):
    run_lib._epoch_batches(object())


def test_train_batches_keep_the_training_batch_size():
  config = configs.load_config(FLAGSHIP, ["training.batch_size=8",
                                          "eval.batch_size=6",
                                          "data.image_size=8"])
  train_it, eval_it = datasets.get_dataset(config)
  assert train_it.batch_size == eval_it.batch_size == 8
  assert (train_it.batches_per_epoch, eval_it.batches_per_epoch) == (64, 16)
  assert not train_it.uniform_dequantization


@pytest.mark.parametrize("centered", [False, True])
def test_scalers_equal_the_jax_packages(centered):
  config = configs.load_config(FLAGSHIP, [f"data.centered={centered}"])
  x = np.random.default_rng(1).random((2, 4, 4, 3)).astype(np.float32)
  for port_fn, jax_fn in ((datasets.get_data_scaler,
                           jax_datasets.get_data_scaler),
                          (datasets.get_data_inverse_scaler,
                           jax_datasets.get_data_inverse_scaler)):
    assert np.array_equal(port_fn(config)(x), jax_fn(config)(x))


@pytest.mark.parametrize("override", ["data.dataset=IMAGENET",
                                      "data.loader_backend=turbo"])
def test_unported_data_paths_raise_naming_roadmap(override, tmp_path):
  """Every data source of the JAX package is ported (SVHN and the native
  loader raised here until they were: tests/test_torch_datasets.py). A
  dataset that neither package reads raises as JAX's does, and so does a
  loader_backend outside {auto, native, python}, which the JAX package
  would take for 'python'."""
  config = configs.load_config(FLAGSHIP, [f"data.data_dir={tmp_path}"])
  key, value = override.split("=")
  setattr(config.data, key.split(".")[1], value)
  if key == "data.dataset":
    message = "Dataset IMAGENET not supported."
    with pytest.raises(NotImplementedError, match=message):
      jax_datasets.get_dataset(config, process_index=0, process_count=1)
    with pytest.raises(NotImplementedError, match=message):
      datasets.get_dataset(config)
  else:
    with pytest.raises(ValueError, match="loader_backend='turbo'"):
      datasets.get_dataset(config)


NCSNPP_LEAVES = [rel for rel in LEAVES
                 if jax_config(rel).model.get("name") == "ncsnpp"]
DDPM_LEAVES = [rel for rel in LEAVES
               if jax_config(rel).model.get("name") == "ddpm"]


@pytest.mark.parametrize("rel", NCSNPP_LEAVES)
def test_ncsnpp_param_map_equals_the_jax_packages(rel):
  config = configs.read_config(str(configs.CONFIG_DIR / rel))
  assert interop.ncsnpp_param_map(config) == jax_interop.ncsnpp_param_map(
      config)


@pytest.mark.parametrize("rel", DDPM_LEAVES)
def test_ddpm_param_map_equals_the_jax_packages(rel):
  """Row for row, the unconditional model's shape-carrying Dense_0 rows
  included."""
  config = configs.read_config(str(configs.CONFIG_DIR / rel))
  assert interop.ddpm_param_map(config) == jax_interop.ddpm_param_map(config)


def fake_params(config, seed=0):
  """A flax params tree with one array per row of the JAX map, shaped by
  the row's transform."""
  rng = np.random.default_rng(seed)
  shapes = {"conv": (3, 3, 2, 5), "dense": (4, 6), "copy": (7,)}
  tree = {}
  for _, path, kind in jax_interop._param_rows(config):
    if path is None:
      continue
    node = tree
    *parents, leaf = path.split("/")
    for p in parents:
      node = node.setdefault(p, {})
    node[leaf] = rng.normal(size=shapes[kind]).astype(np.float32)
  return tree


def _assert_state_dicts_equal(config):
  params = fake_params(config)
  got = interop.flax_params_to_torch_state_dict(params, config)
  want = jax_interop.flax_params_to_torch_state_dict(params, config)
  assert list(got) == list(want)
  for key in want:
    assert got[key].dtype == want[key].dtype, key
    assert np.array_equal(got[key], want[key]), key


@pytest.mark.parametrize("tiny", [True, False])
def test_state_dict_equals_the_jax_packages(tiny):
  _assert_state_dicts_equal(configs.load_config(FLAGSHIP,
                                                TINY if tiny else ()))


@pytest.mark.parametrize("path", [DDPM_CONFIG, DDPM_UNCONDITIONAL])
@pytest.mark.parametrize("tiny", [True, False])
def test_ddpm_state_dict_equals_the_jax_packages(path, tiny):
  """The unconditional model's unused Dense_0 rows come out as zeros of the
  torch shape in both."""
  _assert_state_dicts_equal(configs.load_config(path, TINY if tiny else ()))


NCSNV2_CASES = [(rel, ()) for rel in LEAVES if rel.startswith("ve/ncsnv2/")
                ] + [("ve/ncsnv2/bedroom.py", ("model.name=ncsnv2_256",)),
                     ("ve/ncsnv2/cifar10.py", ("data.image_size=28",))]


@pytest.mark.parametrize("rel,overrides", NCSNV2_CASES)
def test_ncsnv2_param_map_equals_the_jax_packages(rel, overrides):
  """The three shipped NCSNv2 files, ncsnv2_256 (no shipped file uses it)
  and 28² (the adjust_padding size), row for row, and the state_dicts the
  two make of one params tree."""
  config = configs.load_config(str(configs.CONFIG_DIR / rel), overrides)
  assert interop.ncsnv2_param_map(config) == jax_interop.ncsnv2_param_map(
      config)
  _assert_state_dicts_equal(config)


def test_ncsn_map_has_no_jax_counterpart():
  """NCSN v1: the JAX package has no map (tests/test_torch_ncsnv2.py holds
  the port's by forward parity); the port's has every conditional norm and
  no sigmas buffer."""
  config = configs.read_config(str(configs.CONFIG_DIR / "ve/ncsn/cifar10.py"))
  with pytest.raises(NotImplementedError):
    jax_interop.flax_params_to_torch_state_dict({}, config)
  rows = interop.ncsn_param_map(config)
  # normalizer 1, residual blocks 8 x 2, refine1 8, refine2 and 3 14 each,
  # refine4 18
  assert sum(k.endswith("embed.weight") for k, _, _ in rows) == 71
  assert all(k != "sigmas" for k, _, _ in rows)


def test_native_loader_source_equals_the_jax_packages():
  """The C++ batch producer is the JAX package's file, byte for byte but
  for one comment, where the JAX file names the reference by a local path
  (the port builds it with its own g++ step, beside its own CRC-32C)."""
  port = ROOT / "score_sde_pytorch_tpu_torch" / "native" / "dataloader.cpp"
  jax = ROOT / "score_sde_pytorch_tpu" / "native" / "dataloader.cpp"
  local = "/" + "root/reference/datasets.py"
  want = jax.read_bytes().replace(local.encode(), b"yang-song's datasets.py")
  assert want != jax.read_bytes()
  assert port.read_bytes() == want


def test_image_grid_and_png_equal_the_jax_packages(tmp_path):
  images = np.random.default_rng(2).random((5, 6, 6, 3)).astype(np.float32)
  grid = image.make_grid(images, 3, padding=2)
  assert np.array_equal(grid, jax_image.make_grid(images, 3, padding=2))
  image.save_image(grid, str(tmp_path / "port.png"))
  jax_image.save_image(grid, str(tmp_path / "jax.png"))
  assert (tmp_path / "port.png").read_bytes() == (
      tmp_path / "jax.png").read_bytes()
