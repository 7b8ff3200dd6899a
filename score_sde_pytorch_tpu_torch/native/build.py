"""Build the port's host library with g++ and load it through ctypes.

The library holds the threaded batch producer (``dataloader.cpp``, a copy
of the JAX package's) and the CRC-32C of the TFRecord reader
(``crc32c.cpp``). It compiles on first use into
``_build/libscoresde_host-<digest>.so`` next to this file; the digest is of
the sources, the flags and the compiler's version, so an edited source or
another compiler rebuilds. Nothing is built when a module is imported.

There is no fallback: where the library cannot be built, :func:`load`
raises, and so do the native loader and the TFRecord reader.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import subprocess
import tempfile
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR / "_build"
SOURCES = ("dataloader.cpp", "crc32c.cpp")
# No -march=native: a library left in the build directory may be loaded on
# another machine of the same architecture. crc32c.cpp picks its SSE4.2
# route at run time.
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")


def _compiler_version() -> str:
  try:
    return subprocess.run(["g++", "-dumpfullversion"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
  except (OSError, subprocess.SubprocessError) as e:
    raise RuntimeError(f"g++ is needed to build the port's host library "
                       f"(native data loader, TFRecord CRC): {e}") from e


def library_path() -> Path:
  digest = hashlib.sha256()
  for name in SOURCES:
    digest.update((SRC_DIR / name).read_bytes())
  digest.update(" ".join(FLAGS).encode())
  digest.update(f"{_compiler_version()} {platform.machine()}".encode())
  return BUILD_DIR / f"libscoresde_host-{digest.hexdigest()[:12]}.so"


def build() -> Path:
  """Compile the library unless an up-to-date one exists; its path.

  The library is written to a temporary name and renamed into place, so a
  process building concurrently never loads a half-written file."""
  path = library_path()
  if path.is_file():
    return path
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
  os.close(fd)
  try:
    cmd = ["g++", *FLAGS, "-o", tmp] + [str(SRC_DIR / s) for s in SOURCES]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False,
                          timeout=300)
    if proc.returncode != 0:
      raise RuntimeError(f"g++ failed ({proc.returncode}) building the "
                         f"host library:\n{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, path)
  finally:
    if os.path.exists(tmp):
      os.remove(tmp)
  return path


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
  """Build (if needed) and load the host library once per process."""
  lib = ctypes.CDLL(str(build()))
  lib.dl_create.restype = ctypes.c_void_p
  lib.dl_create.argtypes = [
      ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
      ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
      ctypes.c_int, ctypes.c_int]
  lib.dl_next.restype = None
  lib.dl_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
  lib.dl_destroy.restype = None
  lib.dl_destroy.argtypes = [ctypes.c_void_p]
  for name in ("crc32c", "crc32c_tables"):
    fn = getattr(lib, name)
    fn.restype = ctypes.c_uint32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
  return lib
