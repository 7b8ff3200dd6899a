"""The port's TensorFlow-free TFRecord reader and CRC-32C (CPU).

Records are written here by ``tf.io.TFRecordWriter`` (TensorFlow is in this
environment, not on the GPU machine) and read by the JAX package's reader,
which goes through ``tf.data``, and by the port's: the same images and the
same count. The framing's checksums are verified (a flipped byte raises),
both int64-list encodings decode, a malformed Example raises as
``tf.io.parse_single_example`` does, and the record writer of
``chip_smoke.py`` writes what TensorFlow reads. The host library's CRC-32C
is held to the plain-Python one and to the standard check value.
"""
import os
import struct

import numpy as np
import pytest

import chip_smoke
from score_sde_pytorch_tpu import datasets as jax_datasets
from score_sde_pytorch_tpu_torch import configs, datasets, tfrecord
from score_sde_pytorch_tpu_torch.native import build as native_build
from score_sde_pytorch_tpu_torch.native import crc32c as crc
from tests.torch_threads import one_torch_thread  # noqa: F401

FLAGSHIP = "score_sde_pytorch_tpu_torch/configs/ve/cifar10_ncsnpp_continuous.py"


@pytest.fixture(scope="module")
def tf():
  import tensorflow
  tensorflow.config.set_visible_devices([], "GPU")
  return tensorflow


def example(tf, image_chw, shape=None):
  return tf.train.Example(features=tf.train.Features(feature={
      "shape": tf.train.Feature(int64_list=tf.train.Int64List(
          value=image_chw.shape if shape is None else shape)),
      "data": tf.train.Feature(bytes_list=tf.train.BytesList(
          value=[image_chw.tobytes()])),
  })).SerializeToString()


def write_records(tf, path, images):
  with tf.io.TFRecordWriter(str(path)) as w:
    for image in images:
      w.write(example(tf, image))


def random_images(n, c, h, w, seed=0):
  rng = np.random.default_rng(seed)
  return [rng.integers(0, 256, (c, h, w), dtype=np.uint8) for _ in range(n)]


def config_for(data_dir, size, batch=4, dataset="FFHQ"):
  config = configs.load_config(FLAGSHIP, [
      f"data.dataset={dataset}", f"data.image_size={size}",
      f"training.batch_size={batch}", f"eval.batch_size={batch}"])
  config.data.tfrecords_path = str(data_dir)
  config.data.loader_backend = "python"
  return config


# --- CRC-32C ------------------------------------------------------------------


def test_crc32c_check_value():
  assert crc.crc32c(b"123456789") == 0xE3069283
  assert crc.crc32c_tables(b"123456789") == 0xE3069283
  assert crc.crc32c_plain(b"123456789") == 0xE3069283


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 63, 64, 1000, 4099])
def test_crc32c_routes_equal_the_plain_one(n):
  data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
  for buf in (data.tobytes(), bytearray(data.tobytes()),
              memoryview(data.tobytes())[1:] if n else b""):
    want = crc.crc32c_plain(buf)
    assert crc.crc32c(buf) == crc.crc32c_tables(buf) == want


def test_the_crc_raises_without_the_host_library(monkeypatch):
  """No unchecked read: where g++ cannot build the library, reading a
  record raises."""
  native_build.load.cache_clear()
  monkeypatch.setattr(native_build, "library_path",
                      lambda: native_build.BUILD_DIR / "missing.so")
  monkeypatch.setattr(native_build, "SOURCES", ("no_such_file.cpp",))
  try:
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
      crc.crc32c(b"abc")
  finally:
    native_build.load.cache_clear()


# --- records written by TensorFlow --------------------------------------------


@pytest.mark.parametrize("layout", ["file", "directory"])
def test_records_read_to_the_jax_packages_arrays(tf, layout, tmp_path):
  """Images at the config's size (read as they are) and not (crop_resize),
  non-square ones among them; a single-file tfrecords_path, and a
  directory of .tfrecords and .tfrecord files; the same count."""
  images = (random_images(3, 3, 20, 20, seed=1)
            + random_images(2, 3, 28, 36, seed=2)
            + random_images(2, 3, 20, 24, seed=3))
  if layout == "file":
    path = tmp_path / "one.tfrecords"
    write_records(tf, path, images)
  else:
    path = tmp_path / "records"
    (path / "sub").mkdir(parents=True)
    write_records(tf, path / "a.tfrecords", images[:4])
    write_records(tf, path / "sub" / "b.tfrecord", images[4:])
  config = config_for(path, 20)
  got = datasets.load_raw_dataset(config, "train")
  want = jax_datasets.load_raw_dataset(config, "train")
  assert got.count == want.count == 7
  got_images, want_images = list(got.images()), list(want.gen_factory())
  assert [i.shape for i in got_images] == [
      (20, 20, 3)] * 5 + [(20, 24, 3)] * 2
  for a, b in zip(got_images, want_images, strict=True):
    assert np.array_equal(a, b)
  assert [got.shape(h) for h in got.handles()] == [i.shape for i in got_images]


def test_streamed_batches_and_skip_equal_the_jax_packages(tf, tmp_path):
  """get_dataset's streamed batches from 2 shards, flips and dequantization
  on, with a reservoir of 5 images over 11 (replacements), past epochs;
  skip(k) lands on the batch k calls of next reach, reading no record."""
  (tmp_path / "records").mkdir()
  images = random_images(11, 3, 12, 12, seed=4)
  write_records(tf, tmp_path / "records" / "r-00.tfrecords", images[:6])
  write_records(tf, tmp_path / "records" / "r-01.tfrecords", images[6:])
  config = config_for(tmp_path / "records", 12, batch=2)
  config.data.random_flip = True
  config.data.uniform_dequantization = True
  kwargs = dict(random_flip=True, uniform_dequantization=True, seed=9,
                buffer_bytes=5 * 12 * 12 * 3)

  def port():
    return datasets.StreamingDatasetIterator(
        datasets.load_raw_dataset(config, "train"), 2, **kwargs)
  want = jax_datasets.StreamingDatasetIterator(
      jax_datasets.load_raw_dataset(config, "train"), 2, prefetch=False,
      **kwargs)
  got = port()
  batches = [next(want) for _ in range(12)]  # 5 an epoch
  for b in batches:
    assert np.array_equal(next(got), b)
  for k in (3, 7):
    skipped = port()
    skipped.skip(k)
    assert skipped.decoded == 0
    for b in batches[k:k + 3]:
      assert np.array_equal(next(skipped), b)
  train_it, eval_it = datasets.get_dataset(config)
  jax_train, jax_eval = jax_datasets.get_dataset(config, process_index=0,
                                                 process_count=1)
  assert eval_it.batches_per_epoch == jax_eval.batches_per_epoch == 5
  for g, w in ((train_it, jax_train), (eval_it, jax_eval)):
    for _ in range(6):
      assert np.array_equal(next(g), next(w))


def test_a_1024_record_reads_to_the_jax_packages_arrays(tf, tmp_path):
  """One record at FFHQ's 3x1024x1024: at 1024 (CHW to HWC only) and
  crop_resized to 256."""
  path = tmp_path / "ffhq.tfrecords"
  write_records(tf, path, random_images(1, 3, 1024, 1024, seed=5))
  for size in (1024, 256):
    config = config_for(path, size)
    (got,) = datasets.load_raw_dataset(config, "train").images()
    (want,) = jax_datasets.load_raw_dataset(config, "train").gen_factory()
    assert got.shape == (size, size, 3) and np.array_equal(got, want)


# --- framing and Example errors -----------------------------------------------


@pytest.mark.parametrize("where", ["length", "length_crc", "data", "data_crc",
                                   "truncated"])
def test_a_corrupted_record_raises(tf, where, tmp_path):
  path = tmp_path / "r.tfrecords"
  write_records(tf, path, random_images(2, 3, 8, 8, seed=6))
  raw = bytearray(path.read_bytes())
  length = struct.unpack("<Q", raw[:8])[0]
  if where == "truncated":
    raw = raw[:-3]
  else:
    offset = {"length": 0, "length_crc": 9, "data": 12 + length // 2,
              "data_crc": 12 + length + 1}[where]
    raw[offset] ^= 0x10
  path.write_bytes(bytes(raw))
  source = datasets.load_raw_dataset(config_for(path, 8), "train")
  with pytest.raises(tfrecord.DataLossError):
    list(source.images())
  # TensorFlow's own reader rejects the same file.
  with pytest.raises(tf.errors.DataLossError):
    list(tf.data.TFRecordDataset(str(path)))


def varint(n):
  return chip_smoke._pb_varint(n)


def field(number, payload):
  return chip_smoke._pb_bytes(number, payload)


def raw_example(shape_feature, data=b"\x01" * 12):
  entries = [(b"shape", shape_feature),
             (b"data", field(1, field(1, data)))]
  return field(1, b"".join(field(1, field(1, k) + field(2, v))
                           for k, v in entries))


@pytest.mark.parametrize("packed", [True, False])
def test_packed_and_unpacked_int64_lists_decode(tf, packed):
  """Int64List values as one packed field (what TensorFlow writes) or one
  varint field each (what protobuf also accepts)."""
  values = (3, 2, 2)
  if packed:
    int64s = field(1, b"".join(varint(v) for v in values))
  else:
    int64s = b"".join(varint(1 << 3) + varint(v) for v in values)
  record = raw_example(field(3, int64s))
  shape, data = tfrecord.parse_image_example(record)
  assert shape == values and bytes(data) == b"\x01" * 12
  parsed = tf.io.parse_single_example(record, {
      "shape": tf.io.FixedLenFeature([3], tf.int64),
      "data": tf.io.FixedLenFeature([], tf.string)})
  assert tuple(parsed["shape"].numpy()) == values


@pytest.mark.parametrize("case", ["missing", "kind", "count"])
def test_a_malformed_example_raises_as_tensorflow_does(tf, case):
  if case == "missing":
    record = field(1, field(1, field(1, b"data") + field(
        2, field(1, field(1, b"x")))))
  elif case == "kind":
    record = raw_example(field(1, field(1, b"abc")))  # a bytes_list
  else:
    record = raw_example(field(3, field(1, varint(3) + varint(2))))
  with pytest.raises(ValueError):
    tfrecord.parse_image_example(record)
  with pytest.raises(tf.errors.InvalidArgumentError):
    tf.io.parse_single_example(record, {
        "shape": tf.io.FixedLenFeature([3], tf.int64),
        "data": tf.io.FixedLenFeature([], tf.string)})


def test_chip_smoke_writer_is_read_by_tensorflow(tf, tmp_path):
  images = random_images(3, 3, 16, 10, seed=7)
  path = str(tmp_path / "smoke.tfrecords")
  chip_smoke.write_tfrecords(path, images)
  spec = {"shape": tf.io.FixedLenFeature([3], tf.int64),
          "data": tf.io.FixedLenFeature([], tf.string)}
  read = []
  for record in tf.data.TFRecordDataset(path):
    parsed = tf.io.parse_single_example(record, spec)
    read.append(np.frombuffer(parsed["data"].numpy(), np.uint8).reshape(
        parsed["shape"].numpy()))
  assert len(read) == 3
  for a, b in zip(read, images):
    assert np.array_equal(a, b)
  assert [tfrecord.parse_image_example(tfrecord.read(h))[0]
          for h in tfrecord.index(path)] == [(3, 16, 10)] * 3


def test_index_reads_headers_only(tf, tmp_path, monkeypatch):
  """Counting a source checks 12-byte headers and seeks over the data:
  no CRC over a record's data is taken."""
  path = tmp_path / "r.tfrecords"
  write_records(tf, path, random_images(4, 3, 16, 16, seed=8))
  sizes = []
  real = tfrecord.crc32c
  monkeypatch.setattr(tfrecord, "crc32c",
                      lambda data: sizes.append(len(data)) or real(data))
  assert datasets.load_raw_dataset(config_for(path, 16), "train").count == 4
  assert sizes == [8] * 4
  assert os.path.getsize(path) > 4 * 16 * 16 * 3
