"""Pipelines of the port: standalone sampling from a checkpoint.

Counterpart of score_sde_pytorch_tpu/run_lib.py:467-588 (``sample``).
Training and evaluation are not ported yet (ROADMAP.md queue 1 items 4, 7
and 12).
"""
from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from score_sde_pytorch_tpu.utils.image import make_grid, save_image
from score_sde_pytorch_tpu_torch import checkpoint as ckpt_lib
from score_sde_pytorch_tpu_torch import sampling
from score_sde_pytorch_tpu_torch import sde as sde_lib
from score_sde_pytorch_tpu_torch.models import utils as mutils


def get_data_inverse_scaler(config):
  """Inverse of the data scaler (reference datasets.py:33-38)."""
  if config.data.centered:
    return lambda x: (x + 1.0) / 2.0
  return lambda x: x


def _resolve_checkpoint(workdir: str, checkpoint: int):
  if checkpoint >= 0:
    path = ckpt_lib.numbered_path(workdir, checkpoint)
    if not os.path.isfile(path):
      raise FileNotFoundError(f"checkpoint_{checkpoint} not found: {path}")
    return path, f"checkpoint_{checkpoint}"
  latest = ckpt_lib.latest_numbered(workdir)
  if latest is not None:
    return ckpt_lib.numbered_path(workdir, latest), f"checkpoint_{latest}"
  if os.path.isfile(ckpt_lib.meta_path(workdir)):
    return ckpt_lib.meta_path(workdir), "checkpoints-meta"
  raise FileNotFoundError(
      f"no checkpoint under {workdir} (checkpoints/checkpoint_N.pth or "
      "checkpoints-meta/checkpoint.pth)")


def sample(config, workdir: str, sample_folder: str = "generated",
           checkpoint: int = -1, num_samples: int = 0,
           device: str = "cuda") -> list:
  """Generate samples from a checkpoint's EMA weights.

  Runs the configured sampler in rounds of ``config.eval.batch_size``,
  checks every round is finite, trims the last round to ``num_samples``
  (0 means one batch), and writes ``samples_<r>.npz`` (uint8, NHWC) and a
  PNG grid per round under ``workdir/<sample_folder>/``.

  Returns one dict per round: ``samples``, ``nfe`` and ``seconds`` (wall
  time of the round's sampler call, ended by the copy to the host)."""
  device = torch.device(device)
  out_dir = os.path.join(workdir, sample_folder)
  os.makedirs(out_dir, exist_ok=True)

  model = mutils.create_model(config, device,
                              torch.Generator().manual_seed(config.seed))
  path, label = _resolve_checkpoint(workdir, checkpoint)
  step = ckpt_lib.restore_ema(path, model)
  logging.info("Sampling from %s (step %d) on %s.", label, step, device)

  sde = sde_lib.build_sde(config)
  batch = config.eval.batch_size
  shape = (batch, config.data.image_size, config.data.image_size,
           config.data.num_channels)
  sampling_fn = sampling.get_sampling_fn(
      config, sde, model, shape, get_data_inverse_scaler(config),
      device=device)

  generator = torch.Generator(device=device).manual_seed(config.seed + 2)
  num_samples = num_samples or batch
  num_rounds = (num_samples - 1) // batch + 1
  rounds = []
  for r in range(num_rounds):
    start = time.perf_counter()
    samples, nfe = sampling_fn(generator)
    samples_np = samples.cpu().numpy()
    seconds = time.perf_counter() - start
    if not np.isfinite(samples_np).all():
      raise RuntimeError(f"non-finite samples in round {r} "
                         f"(sampler={config.sampling.method})")
    samples_np = samples_np[:min(batch, num_samples - r * batch)]
    samples_u8 = np.clip(samples_np * 255.0, 0, 255).astype(np.uint8)
    np.savez_compressed(os.path.join(out_dir, f"samples_{r}.npz"),
                        samples=samples_u8)
    nrow = int(np.ceil(np.sqrt(samples_np.shape[0])))
    save_image(make_grid(samples_np, nrow, padding=2),
               os.path.join(out_dir, f"samples_{r}.png"))
    logging.info("round %d/%d: %d samples (NFE %d, %.3f s) -> %s", r + 1,
                 num_rounds, samples_np.shape[0], nfe, seconds, out_dir)
    rounds.append({"samples": int(samples_np.shape[0]), "nfe": int(nfe),
                   "seconds": seconds})
  return rounds
