"""Build the port's CUDA kernels with nvcc and load them through ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles, on first
use, into ``_build/lib<name>-<digest>.so`` next to this file (the digest is
of the source and the flags, so an edited source rebuilds). Nothing here
includes PyTorch's headers: one such file compiles in seconds, where
``torch.utils.cpp_extension.load`` takes minutes.

The target is Hopper only (``sm_90a``). Building needs ``nvcc`` (on PATH, or
under ``$CUDA_HOME/bin`` or ``/usr/local/cuda/bin``); nothing is built when a
module is imported.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo")


@dataclasses.dataclass(frozen=True)
class Library:
  """A loaded kernel library and how it was obtained."""
  name: str
  path: Path
  handle: ctypes.CDLL
  build_seconds: float  # 0.0 when an up-to-date library was already on disk
  compiler_log: str     # nvcc/ptxas output (registers, shared memory, spills)


def find_nvcc() -> str:
  candidates = [shutil.which("nvcc")]
  if os.environ.get("CUDA_HOME"):
    candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
  candidates.append("/usr/local/cuda/bin/nvcc")
  for path in candidates:
    if path and os.path.isfile(path):
      return path
  raise RuntimeError(
      "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
      "port's CUDA kernels are compiled on the machine with the GPU.")


def source_path(name: str) -> Path:
  path = CSRC_DIR / f"{name}.cu"
  if not path.is_file():
    raise FileNotFoundError(f"no kernel source {path}")
  return path


def library_path(name: str) -> Path:
  digest = hashlib.sha256(source_path(name).read_bytes())
  digest.update(" ".join(NVCC_FLAGS).encode())
  return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def nvcc_command(nvcc: str, source: Path, output: Path) -> list:
  return [nvcc, *NVCC_FLAGS, "-o", str(output), str(source)]


def build(name: str) -> tuple:
  """Compile ``csrc/<name>.cu`` unless an up-to-date library exists.

  Returns ``(path, seconds, compiler_log)``. The library is written to a
  temporary name and renamed into place, so a process building concurrently
  never loads a half-written file."""
  path = library_path(name)
  if path.is_file():
    return path, 0.0, ""
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
  os.close(fd)
  try:
    cmd = nvcc_command(find_nvcc(), source_path(name), Path(tmp))
    start = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - start
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
      raise RuntimeError(f"nvcc failed ({proc.returncode}) for {name}:\n"
                         f"{' '.join(cmd)}\n{log}")
    os.replace(tmp, path)
  finally:
    if os.path.exists(tmp):
      os.remove(tmp)
  return path, seconds, log


@functools.lru_cache(maxsize=None)
def load(name: str) -> Library:
  """Build (if needed) and load the kernel library ``name`` once per process."""
  path, seconds, log = build(name)
  return Library(name, path, ctypes.CDLL(str(path)), seconds, log)
