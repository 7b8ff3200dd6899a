"""Controllable generation: inpainting and colorization by projected PC
sampling.

Counterpart of score_sde_pytorch_tpu/controllable_generation.py. After each
corrector and each predictor update, the known part of the image (the
masked pixels, or the gray channel of a decoupled color basis) is replaced
by the data diffused to time t: ``x = x·(1−mask) + (mean + std·z)·mask``,
and ``x_mean`` is rebuilt from the projected ``x`` with the diffused mean,
as in the JAX package (JAX controllable_generation.py:63-69, 139-145).

The samplers draw their noise through :func:`sampling.normal` in the JAX
package's order (its five-way key split per step, JAX :78, :155): the prior
first, then per step the corrector's noise (one draw per Langevin step,
when that step runs; none for the ``none`` corrector), its projection's,
the predictor's and its projection's, so tests can inject the noise the
JAX package sees. Images are NHWC at the entry points, as in the JAX package;
states are NCHW. There is no ``mesh`` argument: one device per call.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from score_sde_pytorch_tpu_torch import sampling
from score_sde_pytorch_tpu_torch import sde as sde_lib
from score_sde_pytorch_tpu_torch.models import utils as mutils
from score_sde_pytorch_tpu_torch.sde import batch_mul


def _nchw(images: torch.Tensor, device) -> torch.Tensor:
  return images.to(device).permute(0, 3, 1, 2).contiguous()


def _projected_pc(sde, model, predictor, corrector, snr, n_steps,
                  probability_flow, continuous, eps, generator, x, project):
  """The PC chain of both samplers from ``x`` (NCHW), ``project(x, t, z)``
  after every update; returns the last ``(x, x_mean)``."""
  predictor = predictor or sampling.get_predictor("none")
  corrector = corrector or sampling.get_corrector("none")
  score_fn = mutils.get_score_fn(sde, model, train=False,
                                 continuous=continuous)
  predictor_update = predictor(sde, score_fn, probability_flow)
  corrector_update = corrector(sde, score_fn, snr, n_steps)
  shape, device = tuple(x.shape), x.device
  x_mean = x
  timesteps = sde_lib.linspace(sde.T, eps, sde.N, device)
  for i in range(sde.N):
    t = timesteps[i].expand(shape[0])
    x, x_mean = corrector_update(
        x, t, sampling.step_noise(shape, generator, device))
    x, x_mean = project(x, t, sampling.normal(shape, generator, device))
    x, x_mean = predictor_update(x, t, sampling.normal(shape, generator,
                                                       device))
    x, x_mean = project(x, t, sampling.normal(shape, generator, device))
  return x, x_mean


def get_pc_inpainter(sde, model, predictor, corrector,
                     inverse_scaler: Callable, snr: float, n_steps: int = 1,
                     probability_flow: bool = False, continuous: bool = False,
                     denoise: bool = True, eps: float = 1e-5, device=None):
  """PC inpainter (JAX controllable_generation.py:38-88).

  Returns ``inpainter(generator, data, mask) -> images``: ``data`` and
  ``mask`` are NHWC tensors, ``mask`` 1 on the known pixels; the images are
  NHWC on ``device`` (None: the model's device). The chain starts from
  ``data·mask + prior·(1−mask)``."""
  device = sampling._model_device(model, device)

  def inpainter(generator: torch.Generator, data: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    data, mask = _nchw(data, device), _nchw(mask, device)

    def project(x, t, z):
      masked_data_mean, std = sde.marginal_prob(data, t)
      masked_data = masked_data_mean + batch_mul(std, z)
      x = x * (1.0 - mask) + masked_data * mask
      x_mean = x * (1.0 - mask) + masked_data_mean * mask
      return x, x_mean

    with torch.no_grad():
      prior = sde.prior_sampling(data.shape, generator, device)
      x = data * mask + prior * (1.0 - mask)
      x, x_mean = _projected_pc(sde, model, predictor, corrector, snr,
                                n_steps, probability_flow, continuous, eps,
                                generator, x, project)
      out = inverse_scaler(x_mean if denoise else x)
    return out.permute(0, 2, 3, 1)

  return inpainter


# Orthonormal basis that isolates the gray channel (JAX
# controllable_generation.py:93-97, the reference's values).
_M = np.array([[5.7735014e-01, -8.1649649e-01, 4.7008697e-08],
               [5.7735026e-01, 4.0824834e-01, 7.0710671e-01],
               [5.7735026e-01, 4.0824822e-01, -7.0710683e-01]],
              dtype=np.float32)
_INV_M = np.linalg.inv(_M)


def _basis(matrix: np.ndarray, like: torch.Tensor) -> torch.Tensor:
  return torch.from_numpy(matrix).to(device=like.device, dtype=like.dtype)


def decouple(inputs: torch.Tensor) -> torch.Tensor:
  """RGB (NCHW) into the decoupled basis, whose channel 0 is gray."""
  return torch.einsum("bihw,ij->bjhw", inputs, _basis(_M, inputs))


def couple(inputs: torch.Tensor) -> torch.Tensor:
  """The decoupled basis (NCHW) back to RGB."""
  return torch.einsum("bihw,ij->bjhw", inputs, _basis(_INV_M, inputs))


def get_mask(image: torch.Tensor) -> torch.Tensor:
  """1 on the gray channel of the decoupled basis, 0 elsewhere (NCHW)."""
  return torch.cat([torch.ones_like(image[:, :1]),
                    torch.zeros_like(image[:, 1:])], dim=1)


def get_pc_colorizer(sde, model, predictor, corrector,
                     inverse_scaler: Callable, snr: float, n_steps: int = 1,
                     probability_flow: bool = False, continuous: bool = False,
                     denoise: bool = True, eps: float = 1e-5, device=None):
  """PC colorizer (JAX controllable_generation.py:116-165).

  Returns ``colorizer(generator, gray_scale_img) -> images``: the NHWC gray
  image has equal R, G and B; the images are NHWC on ``device`` (None: the
  model's device), with the gray channel of the decoupled basis kept."""
  device = sampling._model_device(model, device)

  def colorizer(generator: torch.Generator,
                gray_scale_img: torch.Tensor) -> torch.Tensor:
    gray = _nchw(gray_scale_img, device)
    mask = get_mask(gray)

    def project(x, t, z):
      masked_data_mean, std = sde.marginal_prob(decouple(gray), t)
      masked_data = masked_data_mean + batch_mul(std, z)
      x = couple(decouple(x) * (1.0 - mask) + masked_data * mask)
      x_mean = couple(decouple(x) * (1.0 - mask) + masked_data_mean * mask)
      return x, x_mean

    with torch.no_grad():
      prior = sde.prior_sampling(gray.shape, generator, device)
      x = couple(decouple(gray) * mask + decouple(prior) * (1.0 - mask))
      x, x_mean = _projected_pc(sde, model, predictor, corrector, snr,
                                n_steps, probability_flow, continuous, eps,
                                generator, x, project)
      out = inverse_scaler(x_mean if denoise else x)
    return out.permute(0, 2, 3, 1)

  return colorizer
