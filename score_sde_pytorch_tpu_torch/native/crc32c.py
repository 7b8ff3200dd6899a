"""CRC-32C of the TFRecord framing.

:func:`crc32c` runs the host library's C++ (``crc32c.cpp``); it raises
where the library cannot be built, so a record is never read unchecked.
:func:`crc32c_plain` is the same function in plain Python, a byte at a
time (about a second per 3 MB record), kept as the tests' reference.
"""
from __future__ import annotations

import numpy as np

from score_sde_pytorch_tpu_torch.native import build

_POLY = 0x82F63B78
_MASK_DELTA = 0xA282EAD8


def crc32c(data) -> int:
  """CRC-32C of ``data`` (bytes, bytearray or memoryview; not copied)."""
  view = np.frombuffer(data, np.uint8)
  return build.load().crc32c(view.ctypes.data, view.size)


def crc32c_tables(data) -> int:
  """The library's slicing-by-8 route alone, whatever the CPU offers."""
  view = np.frombuffer(data, np.uint8)
  return build.load().crc32c_tables(view.ctypes.data, view.size)


def masked(crc: int) -> int:
  """TFRecord's masked form of a CRC: rotated right by 15, plus a delta."""
  return (((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF


def _table() -> list:
  table = []
  for i in range(256):
    c = i
    for _ in range(8):
      c = (c >> 1) ^ (_POLY if c & 1 else 0)
    table.append(c)
  return table


_TABLE = _table()


def crc32c_plain(data: bytes) -> int:
  """CRC-32C in plain Python."""
  crc = 0xFFFFFFFF
  for byte in bytes(data):
    crc = (crc >> 8) ^ _TABLE[(crc ^ byte) & 0xFF]
  return crc ^ 0xFFFFFFFF
