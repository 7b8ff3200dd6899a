"""The port's config files, and their loader with ``--config.a.b=value``
overrides.

This package holds a copy of the JAX package's declarative config tree
(``builder.py``, the ``default_*_configs.py`` bases and the leaf files under
``ve/``, ``vp/``, ``subvp/`` and ``tpu/``), with imports pointed at the port;
``tests/test_torch_copies.py`` holds every leaf equal to the JAX package's
key for key. Their comments are the JAX package's and speak of it. The files
call only ``ml_collections.ConfigDict()``. Where ``ml_collections`` is not
installed, a minimal attribute dictionary (:class:`ConfigDict`) is bound in
as ``ml_collections`` while a file loads, and removed again afterwards.

:func:`load_config` takes a path to a config file. A path into the JAX
package's tree (``.../score_sde_pytorch_tpu/configs/<rel>``) loads the
port's copy at ``<rel>``, so the JAX package's command lines keep working;
no file of the JAX package is ever run.

Keys with no PyTorch meaning: ``training.prng_impl`` and
``model.spatial_sharding`` are ignored. ``model.dtype`` other than float32
raises; ``model.remat`` and ``model.remat_min_res`` are honoured by NCSN++
(``models/ncsnpp.py``).
"""
from __future__ import annotations

import ast
import contextlib
import importlib.util
import sys
import types
from pathlib import Path
from typing import Iterable

CONFIG_DIR = Path(__file__).resolve().parent
_JAX_TREE = ("score_sde_pytorch_tpu", "configs")
_MISSING = object()


class ConfigDict:
  """The part of ``ml_collections.ConfigDict`` the config files and the port
  use: attribute and item access, ``in`` and ``get``."""

  def __init__(self, initial=None):
    object.__setattr__(self, "_fields", dict(initial or {}))

  def __getattr__(self, name):
    try:
      return self._fields[name]
    except KeyError:
      raise AttributeError(name) from None

  def __setattr__(self, name, value):
    self._fields[name] = value

  def __getitem__(self, name):
    return self._fields[name]

  def __setitem__(self, name, value):
    self._fields[name] = value

  def __contains__(self, name):
    return name in self._fields

  def get(self, name, default=None):
    return self._fields.get(name, default)

  def __repr__(self):
    return f"ConfigDict({self._fields!r})"


@contextlib.contextmanager
def _ml_collections_available():
  """Bind :class:`ConfigDict` in as ``ml_collections`` if it is not installed."""
  try:
    import ml_collections  # noqa: F401
  except ImportError:
    previous = sys.modules.get("ml_collections", _MISSING)
    stand_in = types.ModuleType("ml_collections")
    stand_in.ConfigDict = ConfigDict
    sys.modules["ml_collections"] = stand_in
    try:
      yield
    finally:
      if previous is _MISSING:
        del sys.modules["ml_collections"]
      else:
        sys.modules["ml_collections"] = previous
  else:
    yield


def _parse_value(text: str, current):
  """Parse an override the way its current value is typed."""
  if isinstance(current, str):
    return text
  try:
    value = ast.literal_eval(text)
  except (ValueError, SyntaxError):
    if isinstance(current, bool) or current is None:
      raise ValueError(f"cannot parse {text!r}") from None
    return text
  if isinstance(current, bool) and not isinstance(value, bool):
    raise ValueError(f"expected True or False, got {text!r}")
  if isinstance(current, float) and isinstance(value, int) and not isinstance(
      value, bool):
    return float(value)
  return value


def apply_overrides(config, overrides: Iterable[str]) -> None:
  """Apply ``a.b=value`` strings (without the ``--config.`` prefix)."""
  for item in overrides:
    path, sep, text = item.partition("=")
    if not sep:
      raise ValueError(f"override {item!r} is not of the form key=value")
    *parents, leaf = path.split(".")
    node = config
    for part in parents:
      if part not in node:
        raise KeyError(f"unknown config section {path!r}")
      node = node[part]
    if leaf not in node:
      raise KeyError(f"unknown config key {path!r}")
    node[leaf] = _parse_value(text, node[leaf])


def check_supported(config) -> None:
  """Raise on settings the port cannot honour yet."""
  dtype = config.model.get("dtype", "float32")
  if dtype != "float32":
    raise NotImplementedError(f"model.dtype={dtype!r} is not ported yet; the "
                              "port computes in float32 (bf16 autocast is an "
                              "open question in PERF.md)")


def resolve(path: str) -> Path:
  """The config file that ``path`` names: the port's copy for a path into
  the JAX package's config tree (FileNotFoundError if the port has none),
  else ``path`` itself."""
  parts = Path(path).parts
  for i in range(len(parts) - len(_JAX_TREE), -1, -1):
    if parts[i:i + len(_JAX_TREE)] == _JAX_TREE:
      copy = CONFIG_DIR.joinpath(*parts[i + len(_JAX_TREE):])
      if copy == CONFIG_DIR or not copy.is_file():
        raise FileNotFoundError(
            f"{path} is a JAX-package config path and the port has no copy "
            f"at {copy}; the port's configs live under {CONFIG_DIR}")
      return copy
  return Path(path)


def read_config(path: str):
  """``get_config()`` of the config file at ``path`` (see :func:`resolve`),
  as written: no overrides, no support check."""
  path = resolve(path)
  if not path.is_file():
    raise FileNotFoundError(f"no config file at {path}")
  spec = importlib.util.spec_from_file_location("_port_config_file", path)
  if spec is None or spec.loader is None:
    raise FileNotFoundError(f"no config file at {path}")
  module = importlib.util.module_from_spec(spec)
  with _ml_collections_available():
    spec.loader.exec_module(module)
    return module.get_config()


def load_config(path: str, overrides: Iterable[str] = ()):
  """:func:`read_config`, then ``overrides`` applied and the result checked
  to be one the port supports."""
  config = read_config(path)
  apply_overrides(config, overrides)
  check_supported(config)
  return config
