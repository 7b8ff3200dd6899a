"""The program under test, as the benchmark builds it.

The configuration file under ``configs/`` holds the whole configuration as
it is run (``config``). The program's own config file (``port_config``)
is loaded, every value of the benchmark's file is set on it, and the two
are then held equal key for key, so what runs is what the file says. The
run's seed replaces ``seed``.
"""
from __future__ import annotations

import copy
from pathlib import Path

import torch


def _plain(value):
  if hasattr(value, "keys"):
    return {k: _plain(value[k]) for k in value.keys()}
  if hasattr(value, "_fields"):
    return {k: _plain(v) for k, v in value._fields.items()}
  if isinstance(value, tuple):
    return [_plain(v) for v in value]
  return value


def merged(base: dict, overrides: dict | None) -> dict:
  """``base`` with the sections of ``overrides`` laid over it."""
  out = copy.deepcopy(base)
  for section, values in (overrides or {}).items():
    for key, value in values.items():
      out[section][key] = value
  return out


def port_config(config_file: dict, plain: dict, seed: int):
  """The program's ConfigDict holding ``plain`` (the configuration as run)
  and ``seed``."""
  import score_sde_pytorch_tpu_torch
  from score_sde_pytorch_tpu_torch import configs
  root = Path(score_sde_pytorch_tpu_torch.__file__).resolve().parents[1]
  cfg = configs.load_config(str(root / config_file["port_config"]))
  for section, values in plain.items():
    for key, value in values.items():
      current = cfg[section][key]
      cfg[section][key] = tuple(value) if isinstance(current,
                                                     (tuple, list)) else value
  cfg.seed = seed
  have = _plain(cfg)
  have.pop("seed")
  if have != plain:
    diff = sorted(f"{s}.{k}" for s in set(have) | set(plain)
                  for k in set(have.get(s, {})) | set(plain.get(s, {}))
                  if have.get(s, {}).get(k) != plain.get(s, {}).get(k))
    raise ValueError(f"the program's config differs from the benchmark's "
                     f"file at {diff}")
  return cfg


def build_model(cfg, plain: dict, seed: int, device, mark=None):
  """The program's score network on ``device`` holding the seed's weights
  (the same tensors the reference is given); ``mark('create_model')`` is
  called once the program has built it."""
  from score_sde_pytorch_tpu_torch.models import utils as mutils

  from bench_port import weights
  model = mutils.create_model(cfg, device, torch.Generator().manual_seed(0))
  if mark:
    mark("create_model")
  shapes = weights.reference_model(plain, "meta")
  weights.load_into(model, weights.draw(shapes, seed, device))
  return model
