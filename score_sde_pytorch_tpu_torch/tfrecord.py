"""TFRecord files of ``tf.train.Example`` images, read without TensorFlow.

Counterpart of the record reading in score_sde_pytorch_tpu/datasets.py
:134-172, which goes through ``tf.data.TFRecordDataset`` and
``tf.io.parse_single_example``. A record is framed as TensorFlow's
``RecordWriter`` writes it:

    uint64 length | uint32 masked_crc32c(length) | data | uint32 masked_crc32c(data)

(little-endian). Both checksums are verified, as TensorFlow's
``RecordReader`` verifies them, with the host library's CRC-32C
(:mod:`.native.crc32c`), and a mismatch or a truncated file raises
:class:`DataLossError`. :func:`index` reads only the 12-byte headers and
seeks over the data; :func:`read` fetches one record by its
``(path, offset, length)`` handle.

:func:`parse_image_example` decodes the protobuf wire format of a
``tf.train.Example`` far enough for the FFHQ/CelebAHQ layout: ``shape`` an
int64 list of 3 (packed or not) and ``data`` one bytes value; a feature
that is missing, of another kind or of another length raises ``ValueError``,
as ``parse_single_example`` does for its ``FixedLenFeature``s.
"""
from __future__ import annotations

import os
import struct

from score_sde_pytorch_tpu_torch.native.crc32c import crc32c, masked

_HEADER = struct.Struct("<QI")
_FOOTER = struct.Struct("<I")


class DataLossError(IOError):
  """A corrupted or truncated TFRecord file (TensorFlow's DataLossError)."""


def find_files(path: str) -> list:
  """The record files that ``path`` names: the file itself, or every
  ``.tfrecords`` and ``.tfrecord`` file under the directory, sorted."""
  if os.path.isfile(path):
    return [path]
  files = sorted(
      os.path.join(r, f)
      for r, _, fs in os.walk(path)
      for f in fs if f.endswith((".tfrecords", ".tfrecord")))
  if not files:
    raise FileNotFoundError(f"No tfrecords under {path}")
  return files


def index(path: str) -> list:
  """``(path, offset, length)`` of each record's data in the file, from
  its headers; each length's checksum is verified."""
  handles = []
  size = os.path.getsize(path)
  with open(path, "rb") as f:
    pos = 0
    while pos < size:
      header = f.read(_HEADER.size)
      if len(header) < _HEADER.size:
        raise DataLossError(f"truncated record header at byte {pos} of "
                            f"{path}")
      length, length_crc = _HEADER.unpack(header)
      if masked(crc32c(header[:8])) != length_crc:
        raise DataLossError(f"corrupted record at byte {pos} of {path}: "
                            "the length's CRC does not match")
      offset = pos + _HEADER.size
      pos = offset + length + _FOOTER.size
      if pos > size:
        raise DataLossError(f"truncated record at byte {offset - 12} of "
                            f"{path}: {length} bytes announced")
      handles.append((path, offset, length))
      f.seek(pos)
  return handles


def read(handle) -> memoryview:
  """The data of the record at ``handle``, its checksum verified."""
  path, offset, length = handle
  buf = bytearray(length + _FOOTER.size)
  with open(path, "rb") as f:
    f.seek(offset)
    got = f.readinto(buf)
  if got < len(buf):
    raise DataLossError(f"truncated record at byte {offset} of {path}")
  data = memoryview(buf)[:length]
  (data_crc,) = _FOOTER.unpack_from(buf, length)
  if masked(crc32c(data)) != data_crc:
    raise DataLossError(f"corrupted record at byte {offset - 12} of {path}: "
                        "the data's CRC does not match")
  return data


# --- protobuf wire format ---------------------------------------------------

_VARINT, _FIXED64, _LENGTH, _FIXED32 = 0, 1, 2, 5


def _varint(buf, pos: int, end: int) -> tuple:
  result = shift = 0
  while True:
    if pos >= end or shift > 63:
      raise ValueError("malformed protobuf varint")
    byte = buf[pos]
    pos += 1
    result |= (byte & 0x7F) << shift
    if not byte & 0x80:
      return result & 0xFFFFFFFFFFFFFFFF, pos
    shift += 7


def _fields(buf, start: int, end: int):
  """``(field, wire type, value)`` of each field of the message in
  ``buf[start:end]``: an int for a varint, ``(start, end)`` of the payload
  for a length-delimited field, None for fixed-width ones."""
  pos = start
  while pos < end:
    key, pos = _varint(buf, pos, end)
    field, wire = key >> 3, key & 7
    if wire == _VARINT:
      value, pos = _varint(buf, pos, end)
    elif wire == _LENGTH:
      n, pos = _varint(buf, pos, end)
      value, pos = (pos, pos + n), pos + n
    elif wire in (_FIXED64, _FIXED32):
      value, pos = None, pos + (8 if wire == _FIXED64 else 4)
    else:
      raise ValueError(f"unsupported protobuf wire type {wire}")
    if pos > end:
      raise ValueError("truncated protobuf field")
    yield field, wire, value


def _signed(v: int) -> int:
  return v - (1 << 64) if v >> 63 else v


# Feature's oneof kind: 1 bytes_list, 2 float_list, 3 int64_list.
_BYTES, _FLOATS, _INT64S = 1, 2, 3


def _feature(buf, start: int, end: int) -> tuple:
  """``(kind, values)`` of a Feature: bytes values as memoryview slices,
  int64 values as ints (packed or one per field), no values of a float
  list (no feature read here is one); kind None for an empty Feature."""
  kind, values = None, []
  for field, wire, value in _fields(buf, start, end):
    if field not in (_BYTES, _FLOATS, _INT64S) or wire != _LENGTH:
      continue
    if field != kind:  # a later member of the oneof replaces an earlier one
      kind, values = field, []
    for f, w, v in _fields(buf, *value):
      if f != 1:
        continue
      if kind == _BYTES and w == _LENGTH:
        values.append(buf[v[0]:v[1]])
      elif kind == _INT64S and w == _VARINT:
        values.append(_signed(v))
      elif kind == _INT64S and w == _LENGTH:  # packed
        pos, stop = v
        while pos < stop:
          x, pos = _varint(buf, pos, stop)
          values.append(_signed(x))
  return kind, values


def parse_example(record) -> dict:
  """``{key: (kind, values)}`` of a serialized ``tf.train.Example``; of a
  key given twice, the last entry counts (protobuf's map rule)."""
  buf = memoryview(record)
  features = {}
  for field, wire, value in _fields(buf, 0, len(buf)):
    if field != 1 or wire != _LENGTH:  # Example.features
      continue
    for f, w, entry in _fields(buf, *value):
      if f != 1 or w != _LENGTH:  # Features.feature map entry
        continue
      key, feature = None, (None, [])
      for ef, ew, ev in _fields(buf, *entry):
        if ef == 1 and ew == _LENGTH:
          key = bytes(buf[ev[0]:ev[1]]).decode("utf-8")
        elif ef == 2 and ew == _LENGTH:
          feature = _feature(buf, *ev)
      if key is not None:
        features[key] = feature
  return features


def parse_image_example(record) -> tuple:
  """``(shape, data)`` of an FFHQ/CelebAHQ record: ``shape`` a tuple of 3
  ints (C, H, W), ``data`` the image bytes."""
  features = parse_example(record)
  shape = _fixed(features, "shape", _INT64S, 3, "int64")
  (data,) = _fixed(features, "data", _BYTES, 1, "string")
  return tuple(shape), data


def _fixed(features: dict, key: str, kind: int, n: int, type_name: str):
  if key not in features or features[key][0] is None:
    raise ValueError(f"Feature: {key} (data type: {type_name}) is required "
                     "but could not be found.")
  got_kind, values = features[key]
  if got_kind != kind:
    raise ValueError(f"Feature: {key}: data types don't match; expected "
                     f"{type_name}")
  if len(values) != n:
    raise ValueError(f"Key: {key}. Number of values != expected. Values "
                     f"size: {len(values)} but output shape: [{n}]")
  return values
