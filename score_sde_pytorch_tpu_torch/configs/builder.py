"""Declarative config builder.

Leaf configs declare only their deltas over a dataset base:

    get_config = declare("cifar10",
                         training=dict(sde="vesde"),
                         model=dict(name="ncsnpp", ...))

Schema-compatible with the reference's imperative config files
(SURVEY.md §2.1); every leaf remains CLI-overridable via
``--config.section.key=value``.
"""
from __future__ import annotations

from typing import Callable


def _bases():
  from score_sde_pytorch_tpu_torch.configs import (
      default_cifar10_configs, default_celeba_configs, default_lsun_configs)
  return {
      "cifar10": default_cifar10_configs.get_default_configs,
      "celeba": default_celeba_configs.get_default_configs,
      "lsun": default_lsun_configs.get_default_configs,
  }


def declare(base: str, **sections) -> Callable:
  """Return a ``get_config`` applying ``sections`` deltas onto ``base``."""

  def get_config():
    config = _bases()[base]()
    for section_name, values in sections.items():
      section = getattr(config, section_name)
      for key, value in values.items():
        setattr(section, key, value)
    return config

  return get_config
