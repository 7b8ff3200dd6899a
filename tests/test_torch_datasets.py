"""The port's data sources and iterators against the JAX package's (CPU).

Images, ``.mat`` files and folders are written from a seed; the same
config goes through ``score_sde_pytorch_tpu.datasets`` and
``score_sde_pytorch_tpu_torch.datasets`` and the batches are compared bit
for bit: the resize ops, the CELEBA/LSUN/FOLDER chains, SVHN,
``data.in_memory``, the streaming iterator's reservoir (with a small
``buffer_bytes``, so that images are replaced in it), per-process shards
and seeds, and the native loader. ``skip(k)`` is held to ``k`` calls of
``next``; a folder-sourced train with a resume to the losses of a run
without one. TFRecords: tests/test_torch_tfrecord.py.
"""
import os

import numpy as np
import pytest
from PIL import Image

from score_sde_pytorch_tpu import datasets as jax_datasets
from score_sde_pytorch_tpu.native import build as jax_native_build
from score_sde_pytorch_tpu.native import loader as jax_native_loader
from score_sde_pytorch_tpu_torch import configs, datasets, main, native
from score_sde_pytorch_tpu_torch.native import build as native_build
from tests.torch_threads import one_torch_thread  # noqa: F401

FLAGSHIP = "score_sde_pytorch_tpu_torch/configs/ve/cifar10_ncsnpp_continuous.py"
TINY = ("model.nf=16", "model.ch_mult=(1,2)", "model.num_res_blocks=1",
        "model.attn_resolutions=(8,)", "model.num_scales=2")


def write_folder(root, splits: dict, sizes: list, fmt="PNG", seed=0):
  """``splits[s]`` images under ``root/<s>/``, cycling through ``sizes``
  ((height, width) each)."""
  rng = np.random.default_rng(seed)
  for split, n in splits.items():
    os.makedirs(os.path.join(root, split))
    for i in range(n):
      h, w = sizes[i % len(sizes)]
      img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
      Image.fromarray(img).save(
          os.path.join(root, split, f"{i:04d}.{fmt.lower()}"), fmt)
  return str(root)


def config_for(dataset, size, data_dir, batch=4, flip=True, dequant=True,
               eval_batch=None):
  config = configs.load_config(FLAGSHIP, [
      f"data.dataset={dataset}", f"data.image_size={size}",
      f"data.data_dir={data_dir}", f"training.batch_size={batch}",
      f"eval.batch_size={eval_batch or batch}", f"data.random_flip={flip}",
      f"data.uniform_dequantization={dequant}"])
  config.data.loader_backend = "python"
  return config


def assert_same_batches(got, want, count):
  for _ in range(count):
    a, b = next(got), next(want)
    assert a.dtype == b.dtype == np.float32
    assert np.array_equal(a, b)


# --- resize ops ---------------------------------------------------------------

SHAPES = [(37, 53), (64, 48), (33, 33), (50, 19)]


@pytest.mark.parametrize("h,w", SHAPES)
@pytest.mark.parametrize("op,arg", [("crop_resize", 24), ("crop_resize", 41),
                                    ("resize_small", 16), ("resize_small", 45),
                                    ("central_crop", 15)])
def test_resize_ops_equal_the_jax_packages(h, w, op, arg):
  image = np.random.default_rng(h * w).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)
  got = getattr(datasets, op)(image, arg)
  want = getattr(jax_datasets, op)(image, arg)
  assert got.dtype == want.dtype == np.uint8
  assert np.array_equal(got, want)


# --- folder sources -----------------------------------------------------------

FOLDER_CASES = {
    # aligned CelebA's 178x218: central_crop(140), then resize_small
    "CELEBA": ("CELEBA", 32, [(218, 178)]),
    # resize_small, then central_crop
    "LSUN@128": ("LSUN", 128, [(40, 56), (61, 45)]),
    # crop_resize
    "LSUN@256": ("LSUN", 256, [(48, 64), (37, 29)]),
    "FOLDER": ("FOLDER", 24, [(32, 40), (27, 27), (50, 31)]),
}


@pytest.mark.parametrize("case", sorted(FOLDER_CASES))
def test_folder_batches_equal_the_jax_packages(case, tmp_path):
  """get_dataset's streamed train and eval batches, flips and
  dequantization on, past an epoch boundary (7 train images make one batch
  of 4 per epoch, 5 test images one); the eval split's epoch size."""
  dataset, size, sizes = FOLDER_CASES[case]
  data = write_folder(tmp_path / "data", {"train": 7, "test": 5}, sizes,
                      seed=len(case))
  config = config_for(dataset, size, data)
  got = datasets.get_dataset(config)
  want = jax_datasets.get_dataset(config, process_index=0, process_count=1)
  for g, w in zip(got, want):
    assert isinstance(g, datasets.StreamingDatasetIterator)
    assert g.batches_per_epoch == w.batches_per_epoch == 1
    assert_same_batches(g, w, 3)


@pytest.mark.parametrize("shuffle", [True, False])
def test_reservoir_replacements_equal_the_jax_packages(shuffle, tmp_path):
  """A buffer of 8 images' bytes over 21 images: the reservoir replaces
  images (its integer draws interleave with the batches' flips and
  dequantization) and the epoch's remainder is dropped."""
  data = write_folder(tmp_path / "data", {"train": 21}, [(20, 26), (26, 20)])
  source = datasets.load_raw_dataset(config_for("FOLDER", 16, data), "train")
  jax_source = jax_datasets.load_raw_dataset(config_for("FOLDER", 16, data),
                                             "train")
  kwargs = dict(random_flip=True, uniform_dequantization=True,
                shuffle=shuffle, seed=5, buffer_bytes=8 * 16 * 16 * 3)
  got = datasets.StreamingDatasetIterator(source, 3, **kwargs)
  want = jax_datasets.StreamingDatasetIterator(jax_source, 3, prefetch=False,
                                               **kwargs)
  assert_same_batches(got, want, 15)  # 7 batches an epoch


def test_folder_sources_read_the_split_subfolder_or_the_directory(tmp_path):
  flat = write_folder(tmp_path / "flat", {"images": 3}, [(16, 16)])
  config = config_for("FOLDER", 16, flat)
  for split in ("train", "test"):
    got = datasets.load_raw_dataset(config, split)
    assert got.count == 3 and got.shape(next(got.handles())) == (16, 16, 3)
  with pytest.raises(FileNotFoundError, match="No images"):
    datasets.load_raw_dataset(config_for("FOLDER", 16, tmp_path / "none"),
                              "train")


def test_in_memory_materializes_the_jax_packages_arrays(tmp_path):
  data = write_folder(tmp_path / "data", {"train": 9, "test": 4},
                      [(218, 178)], fmt="JPEG")
  config = config_for("CELEBA", 16, data)
  config.data.in_memory = True
  for split in ("train", "test"):
    got = datasets.load_raw_dataset(config, split)
    want = jax_datasets.load_raw_dataset(config, split)
    assert isinstance(got, np.ndarray) and got.shape == (
        {"train": 9, "test": 4}[split], 16, 16, 3)
    assert np.array_equal(got, want)
    assert datasets.materialize(got) is got
  config.data.in_memory = False
  source = datasets.load_raw_dataset(config, "train")
  assert np.array_equal(datasets.materialize(source), jax_datasets.materialize(
      jax_datasets.load_raw_dataset(config, "train")))
  config.data.in_memory = True
  got = datasets.get_dataset(config)
  want = jax_datasets.get_dataset(config, process_index=0, process_count=1)
  for g, w in zip(got, want):
    assert isinstance(g, datasets.DatasetIterator)
    assert_same_batches(g, w, 5)


def write_svhn(root, seed=0):
  import scipy.io
  rng = np.random.default_rng(seed)
  os.makedirs(root)
  for split, n in (("train", 11), ("test", 6)):
    scipy.io.savemat(os.path.join(root, f"{split}_32x32.mat"), {
        "X": rng.integers(0, 256, (32, 32, 3, n), dtype=np.uint8),
        "y": rng.integers(1, 11, (n, 1), dtype=np.uint8)})
  return str(root)


def test_svhn_equals_the_jax_packages(tmp_path):
  config = config_for("SVHN", 32, write_svhn(tmp_path / "svhn"))
  for split in ("train", "test"):
    got = datasets.load_raw_dataset(config, split)
    assert got.shape == ({"train": 11, "test": 6}[split], 32, 32, 3)
    assert np.array_equal(got,
                          jax_datasets.load_raw_dataset(config, split))
  got = datasets.get_dataset(config)
  want = jax_datasets.get_dataset(config, process_index=0, process_count=1)
  for g, w in zip(got, want):
    assert_same_batches(g, w, 4)


# --- processes ----------------------------------------------------------------


def test_shard_for_process_equals_the_jax_packages():
  images = np.random.default_rng(0).integers(0, 256, (37, 4, 4, 3),
                                             dtype=np.uint8)
  items = [np.full((2, 2, 3), i, np.uint8) for i in range(11)]
  for index in range(4):
    assert np.array_equal(datasets.shard_for_process(images, index, 4),
                          jax_datasets.shard_for_process(images, index, 4))
  for count, n_shards in ((11, 3), (None, 3), (11, 1)):
    source = datasets.StreamingSource(lambda: iter(items), count=count,
                                      count_fn=lambda: 11)
    jax_source = jax_datasets.StreamingSource(lambda: iter(items),
                                              count=count, count_fn=lambda: 11)
    for index in range(n_shards):
      got = datasets.shard_for_process(source, index, n_shards)
      want = jax_datasets.shard_for_process(jax_source, index, n_shards)
      assert got.count == want.count
      assert [int(x[0, 0, 0]) for x in got.images()] == [
          int(x[0, 0, 0]) for x in want.gen_factory()]


@pytest.mark.parametrize("source", ["synthetic", "folder"])
def test_process_shards_and_seeds_equal_the_jax_packages(source, tmp_path):
  """Process 1 of 2: its shard, its local batch of 4 and its seed
  (config.seed + 7919), dequantization and flips on; a batch of 9 raises
  in both."""
  if source == "folder":
    data = write_folder(tmp_path / "data", {"train": 18, "test": 9},
                        [(20, 24)])
    config = config_for("FOLDER", 16, data, batch=8)
  else:
    config = config_for("CIFAR10", 8, "", batch=8)
  got = datasets.get_dataset(config, process_index=1, process_count=2)
  want = jax_datasets.get_dataset(config, process_index=1, process_count=2)
  for g, w in zip(got, want):
    assert g.batch_size == 4 and g.seed == w.seed
    assert g.batches_per_epoch == w.batches_per_epoch
    assert_same_batches(g, w, 3)
  assert got[0].seed == config.seed + 7919
  config.training.batch_size = 9
  for package in (datasets, jax_datasets):
    with pytest.raises(ValueError, match="divisible"):
      package.get_dataset(config, process_index=0, process_count=2)


def test_process_defaults_to_zero_of_one():
  config = config_for("CIFAR10", 8, "", batch=8)
  train_it, _ = datasets.get_dataset(config)
  assert train_it.seed == config.seed and train_it.batch_size == 8


def test_process_comes_from_torch_distributed(monkeypatch):
  """Where torch.distributed is initialized, its rank and world size are
  the process index and count."""
  import torch.distributed as dist
  monkeypatch.setattr(dist, "is_initialized", lambda: True)
  monkeypatch.setattr(dist, "get_rank", lambda: 1)
  monkeypatch.setattr(dist, "get_world_size", lambda: 2)
  config = config_for("CIFAR10", 8, "", batch=8)
  got, _ = datasets.get_dataset(config)
  want, _ = jax_datasets.get_dataset(config, process_index=1,
                                     process_count=2)
  assert got.batch_size == 4 and got.seed == config.seed + 7919
  assert_same_batches(got, want, 2)


# --- skip ---------------------------------------------------------------------


@pytest.mark.parametrize("source", ["in_memory", "folder"])
@pytest.mark.parametrize("k", [1, 5, 12])
def test_skip_lands_on_the_kth_batch_without_decoding(source, k, tmp_path):
  """skip(k), with the prefetcher on, then batches equal to those after k
  calls of next, flips and dequantization on, across epochs (the folder's
  reservoir replaces images: buffer of 6 images, 11 images, batch 3); skip
  decodes nothing; a skip after the first batch raises."""
  if source == "folder":
    data = write_folder(tmp_path / "data", {"train": 11}, [(12, 14)])
    src = datasets.load_raw_dataset(config_for("FOLDER", 12, data), "train")

    def make():
      return datasets.StreamingDatasetIterator(
          src, 3, random_flip=True, uniform_dequantization=True, seed=4,
          buffer_bytes=6 * 12 * 12 * 3)
  else:
    images = np.random.default_rng(1).integers(0, 256, (11, 6, 6, 3),
                                               dtype=np.uint8)

    def make():
      return datasets.DatasetIterator(
          images, 3, random_flip=True, uniform_dequantization=True,
          shuffle=True, seed=4)
  replayed, skipped = make(), make()
  for _ in range(k):
    next(replayed)
  skipped.skip(k)
  assert skipped.decoded == 0
  assert_same_batches(skipped, replayed, 4)
  with pytest.raises(RuntimeError, match="before the first batch"):
    skipped.skip(1)


def test_skip_keeps_the_generators_cached_half():
  """A bounded integer draw leaves half of a 64-bit draw cached; skipping
  dequantization draws by advancing the generator must keep it (numpy's
  advance drops it)."""
  def draws(skip):
    rng = np.random.default_rng(0)
    rng.integers(7)
    if skip:
      datasets._advance(rng, 1000)
    else:
      rng.random(1000)
    return [int(rng.integers(1000)) for _ in range(4)]
  assert draws(True) == draws(False)


def test_a_producer_error_is_raised_by_next(tmp_path):
  """A file that does not decode raises in the consumer, not in the
  prefetch thread alone (where the consumer would wait forever)."""
  data = write_folder(tmp_path / "data", {"train": 4}, [(8, 8)])
  with open(os.path.join(data, "train", "0001.png"), "wb") as f:
    f.write(b"not an image")
  train_it, _ = datasets.get_dataset(config_for("FOLDER", 8, data, batch=4,
                                                dequant=False))
  with pytest.raises(OSError):
    next(train_it)
  with pytest.raises(OSError):
    next(train_it)


def test_fewer_images_than_a_batch_raise(tmp_path):
  data = write_folder(tmp_path / "data", {"train": 3}, [(8, 8)])
  source = datasets.load_raw_dataset(config_for("FOLDER", 8, data), "train")
  with pytest.raises(ValueError, match="fewer images than one batch"):
    next(datasets.StreamingDatasetIterator(source, 4))
  with pytest.raises(ValueError, match="no batch"):
    next(datasets.DatasetIterator(source.materialize(), 4, random_flip=False,
                                  uniform_dequantization=False, shuffle=True,
                                  seed=0))


# --- the native loader --------------------------------------------------------


@pytest.mark.parametrize("flags", [(True, True, True), (False, False, True),
                                   (True, True, False)])
def test_native_loader_equals_the_jax_packages(flags, tmp_path, monkeypatch):
  """nthreads=1 (a fixed order): the same library source, bit for bit; JAX's
  library is built into a directory of this test's own."""
  monkeypatch.setattr(jax_native_build, "_CACHE_DIR", str(tmp_path))
  monkeypatch.setattr(jax_native_build, "_lib", None)
  monkeypatch.setattr(jax_native_build, "_tried", False)
  shuffle, flip, dequant = flags
  images = np.random.default_rng(2).integers(0, 256, (13, 8, 6, 3),
                                             dtype=np.uint8)
  kwargs = dict(shuffle=shuffle, random_flip=flip,
                uniform_dequantization=dequant, seed=3, nthreads=1)
  got = native.NativeDataLoader(images, 4, **kwargs)
  want = jax_native_loader.NativeDataLoader(images, 4, **kwargs)
  try:
    assert got.batches_per_epoch == want.batches_per_epoch == 3
    assert_same_batches(got, want, 7)
  finally:
    got.close()
    want.close()


def test_native_backend_through_get_dataset(tmp_path):
  config = config_for("SVHN", 32, write_svhn(tmp_path / "svhn"))
  config.data.loader_backend = "native"
  train_it, eval_it = datasets.get_dataset(config)
  try:
    for it in (train_it, eval_it):
      assert isinstance(it, native.NativeDataLoader)
      batch = next(it)
      assert batch.shape == (4, 32, 32, 3) and 0 <= batch.min() <= 1
  finally:
    train_it.close()
    eval_it.close()


def test_a_native_resume_restarts_its_stream_and_logs_it(caplog):
  """The native loader has no fixed order to take up: run_lib leaves its
  stream at the start and logs that it did; other iterators skip."""
  from score_sde_pytorch_tpu_torch import run_lib
  images = np.random.default_rng(4).integers(0, 256, (8, 4, 4, 3),
                                             dtype=np.uint8)
  kwargs = dict(shuffle=False, random_flip=False,
                uniform_dequantization=False, seed=0)
  loader = native.NativeDataLoader(images, 2, nthreads=1, **kwargs)
  try:
    with caplog.at_level("WARNING"):
      run_lib._skip(loader, 3, "train")
    assert "restarts" in caplog.text and "3 batches not skipped" in caplog.text
    # the first batch, scaled as the C++ scales: by a float 1/255
    assert np.array_equal(next(loader), images[:2] * np.float32(1 / 255))
  finally:
    loader.close()
  skipped = datasets.DatasetIterator(images, 2, **kwargs)
  run_lib._skip(skipped, 3, "train")
  assert np.array_equal(next(skipped), images[6:] / np.float32(255.0))


def test_native_backend_raises_without_the_host_library(monkeypatch):
  """No fallback: 'native' raises where g++ cannot build the library."""
  native_build.load.cache_clear()
  monkeypatch.setattr(native_build, "library_path",
                      lambda: native_build.BUILD_DIR / "missing.so")
  monkeypatch.setattr(native_build, "SOURCES", ("no_such_file.cpp",))
  config = config_for("CIFAR10", 8, "", batch=8)
  config.data.loader_backend = "native"
  try:
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
      datasets.get_dataset(config)
  finally:
    native_build.load.cache_clear()


# --- the train loop -----------------------------------------------------------


def test_folder_train_resume_repeats_the_uninterrupted_losses(tmp_path):
  """``main --mode train`` on a FOLDER source (10 images, batch 4, so steps
  cross epochs; flips and dequantization on): 3 steps, a resume, 3 more
  equal 6 in one run, in every logged loss; the resume skips."""
  data = write_folder(tmp_path / "data", {"train": 10, "test": 4},
                      [(20, 18)], seed=3)
  flags = ["--config.data.dataset=FOLDER", f"--config.data.data_dir={data}",
           "--config.data.image_size=16", "--config.training.batch_size=4",
           "--config.data.uniform_dequantization=True",
           "--config.training.n_jitted_steps=1",
           "--config.training.log_freq=1", "--config.training.eval_freq=2",
           "--config.training.snapshot_freq=3",
           "--config.training.snapshot_freq_for_preemption=3",
           "--config.training.snapshot_sampling=False"] + [
               "--config." + o for o in TINY]

  def train(workdir, n_iters):
    return main.main(["--config", FLAGSHIP, "--workdir", str(workdir),
                      "--mode", "train", "--device", "cpu",
                      f"--config.training.n_iters={n_iters}", *flags])

  whole = train(tmp_path / "whole", 6)
  first = train(tmp_path / "split", 3)
  second = train(tmp_path / "split", 6)
  assert second["initial_step"] == 3
  log = (tmp_path / "split" / "stdout.txt").read_text()
  assert "Skipped 3 train batches" in log and "Skipped 1 eval batches" in log
  assert first["train_losses"] + second["train_losses"] == whole[
      "train_losses"]
  assert first["eval_losses"] + second["eval_losses"] == whole["eval_losses"]
  assert len(whole["eval_losses"]) == 3
