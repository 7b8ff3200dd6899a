"""Load the JAX package's config files, with ``--config.a.b=value`` overrides.

The port keeps one source of hyperparameters: the files under
score_sde_pytorch_tpu/configs/. They call only ``ml_collections.ConfigDict()``
and need no JAX. Where ``ml_collections`` is not installed, a minimal
attribute dictionary (:class:`ConfigDict`) is bound in as ``ml_collections``
while the files load, and removed again afterwards.

Keys with no PyTorch meaning: ``training.prng_impl`` and
``model.spatial_sharding`` are ignored. ``model.remat=True`` and
``model.dtype`` other than float32 raise.
"""
from __future__ import annotations

import ast
import contextlib
import importlib.util
import sys
import types
from typing import Iterable

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
  if config.model.get("remat", False):
    raise NotImplementedError("model.remat (activation recomputation in "
                              "training) is not ported yet; see ROADMAP.md "
                              "queue 1 item 1")
  dtype = config.model.get("dtype", "float32")
  if dtype != "float32":
    raise NotImplementedError(f"model.dtype={dtype!r} is not ported yet; the "
                              "port computes in float32 (bf16 autocast is an "
                              "open question in PERF.md)")


def load_config(path: str, overrides: Iterable[str] = ()):
  """Run ``get_config()`` of the config file at ``path``, then apply
  ``overrides`` and check that the port supports the result."""
  spec = importlib.util.spec_from_file_location("_port_config_file", path)
  if spec is None or spec.loader is None:
    raise FileNotFoundError(f"no config file at {path}")
  module = importlib.util.module_from_spec(spec)
  with _ml_collections_available():
    spec.loader.exec_module(module)
    config = module.get_config()
  apply_overrides(config, overrides)
  check_supported(config)
  return config
