"""Load the JAX package's parameters into the port's modules.

``score_sde_pytorch_tpu.interop`` (numpy only, no JAX) already maps a flax
params tree to the torch reference's state_dict layout; the port's modules
use that layout, so loading is that map plus ``load_state_dict(strict=True)``.
"""
from __future__ import annotations

import numpy as np
import torch

from score_sde_pytorch_tpu import interop as jax_interop


def load_jax_params(model: torch.nn.Module, params, config) -> None:
  """Copy a JAX params tree (leaves convertible to numpy) into ``model``.

  Every parameter and buffer must be covered and nothing left over."""
  state = jax_interop.flax_params_to_torch_state_dict(params, config)
  tensors = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in state.items()}
  model.load_state_dict(tensors, strict=True)
