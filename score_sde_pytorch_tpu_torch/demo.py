"""Demo: PC sampling, the probability-flow ODE, DPM-Solver++, likelihood and
controllable generation on the flagship NCSN++ (the JAX package's
examples/demo.py, section for section).

    python -m score_sde_pytorch_tpu_torch.demo [--workdir RUN_DIR] \\
        [--ckpt N] [--out demo_out] [--tiny] [--device cuda|cuda:N|cpu] \\
        [--config.section.key=value ...]

Without ``--workdir`` the model is freshly initialized from a seed and
shrunk (nf 32, 2 res blocks, 100 noise scales), so the samples are noise;
``--workdir`` restores a checkpoint's EMA weights (``--ckpt N`` the
numbered one, else the rolling one). ``--tiny`` shrinks hard (16², nf 8)
for a CPU run. ``--config.*`` overrides apply last. Writes
``pc_samples.png``, ``ode_samples.png``, ``dpmpp_samples.png``,
``inpainted.png`` and ``colorized.png`` to ``--out``.
"""
from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from score_sde_pytorch_tpu_torch import main as cli
from score_sde_pytorch_tpu_torch.utils import io

FLAGSHIP = (Path(__file__).resolve().parent / "configs" / "ve"
            / "cifar10_ncsnpp_continuous.py")


def parse_args(argv: Sequence[str]):
  parser = argparse.ArgumentParser(
      prog="python -m score_sde_pytorch_tpu_torch.demo",
      description="PC/ODE/dpmpp sampling, bits/dim, inpainting and "
                  "colorization on the flagship NCSN++.")
  parser.add_argument("--workdir", default="")
  parser.add_argument("--ckpt", type=int, default=-1)
  parser.add_argument("--out", default="demo_out")
  parser.add_argument("--tiny", action="store_true",
                      help="shrink the model/shapes hard (smoke tests / "
                           "1-core CI; samples are noise)")
  parser.add_argument("--device", default="cuda", type=cli._device,
                      help="cuda, cuda:N or cpu (default cuda)")
  overrides, rest = cli.split_overrides(argv)
  return parser.parse_args(rest), overrides


def _save(samples: torch.Tensor, nrow: int, path: str) -> None:
  from score_sde_pytorch_tpu_torch.utils.image import make_grid, save_image
  save_image(make_grid(np.clip(samples.cpu().numpy(), 0, 1), nrow), path)


def main(argv: Optional[Sequence[str]] = None) -> dict:
  """Runs every section; returns the NFE of each sampler and the bits/dim
  (``{"pc_nfe", "ode_nfe", "dpmpp_nfe", "bpd", "bpd_nfe"}``)."""
  from score_sde_pytorch_tpu_torch import configs, datasets, sampling
  from score_sde_pytorch_tpu_torch import controllable_generation as cg
  from score_sde_pytorch_tpu_torch import likelihood as likelihood_lib
  from score_sde_pytorch_tpu_torch import sde as sde_lib
  from score_sde_pytorch_tpu_torch.models import utils as mutils

  args, overrides = parse_args(sys.argv[1:] if argv is None else list(argv))
  device = torch.device(args.device)
  io.makedirs(args.out)
  shrink = []
  if not args.workdir:
    # Tiny model so the demo runs quickly without a checkpoint.
    shrink += ["model.nf=32", "model.num_res_blocks=2", "model.num_scales=100"]
  if args.tiny:
    shrink += ["model.nf=8", "model.num_res_blocks=1", "model.ch_mult=(1,2)",
               "model.attn_resolutions=(8,)", "model.num_scales=8",
               "data.image_size=16"]
  config = configs.load_config(str(FLAGSHIP), shrink + overrides)

  def gen(seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)

  model = mutils.create_model(config, device, torch.Generator().manual_seed(0))
  if args.workdir:
    from score_sde_pytorch_tpu_torch import checkpoint as ckpt_lib
    path = (ckpt_lib.numbered_path(args.workdir, args.ckpt)
            if args.ckpt >= 0 else ckpt_lib.meta_path(args.workdir))
    print(f"restored step {ckpt_lib.restore_ema(path, model)}")

  sde = sde_lib.build_sde(config)
  inverse_scaler = datasets.get_data_inverse_scaler(config)
  scaler = datasets.get_data_scaler(config)
  shape = (16, config.data.image_size, config.data.image_size, 3)
  predictor = sampling.get_predictor("reverse_diffusion")
  corrector = sampling.get_corrector("langevin")
  out = {}

  # --- Predictor-Corrector sampling ---
  sampler = sampling.get_pc_sampler(sde, model, shape, predictor, corrector,
                                    inverse_scaler, snr=0.16, continuous=True)
  samples, out["pc_nfe"] = sampler(gen(1))
  print(f"PC sampling: {int(out['pc_nfe'])} network evaluations")
  _save(samples, 4, os.path.join(args.out, "pc_samples.png"))

  # --- Probability flow ODE ---
  ode_sampler = sampling.get_ode_sampler(sde, model, shape, inverse_scaler,
                                         denoise=True)
  ode_samples, out["ode_nfe"] = ode_sampler(gen(2))
  print(f"ODE sampling: {int(out['ode_nfe'])} network evaluations")
  _save(ode_samples, 4, os.path.join(args.out, "ode_samples.png"))

  # --- DPM-Solver++(2M) fast sampling (beyond-reference; 1 NFE/step) ---
  dpmpp_sampler = sampling.get_dpmpp_sampler(sde, model, shape,
                                             inverse_scaler, n_steps=20,
                                             denoise=True, continuous=True)
  dpmpp_samples, out["dpmpp_nfe"] = dpmpp_sampler(gen(9))
  print(f"dpmpp sampling: {int(out['dpmpp_nfe'])} network evaluations")
  _save(dpmpp_samples, 4, os.path.join(args.out, "dpmpp_samples.png"))

  # --- Likelihood (bits/dim) ---
  likelihood_fn = likelihood_lib.get_likelihood_fn(sde, model,
                                                   inverse_scaler)
  data = torch.rand((4,) + shape[1:], generator=gen(3), device=device)
  bpd, _, out["bpd_nfe"] = likelihood_fn(
      model, scaler(data).permute(0, 3, 1, 2).contiguous(), gen(4))
  out["bpd"] = bpd.cpu().numpy()
  print(f"bits/dim: {out['bpd']} ({int(out['bpd_nfe'])} NFE)")

  # --- Controllable generation: inpainting ---
  inpainter = cg.get_pc_inpainter(sde, model, predictor, corrector,
                                  inverse_scaler, snr=0.16, continuous=True)
  img = data[:1].expand((4,) + shape[1:])
  mask = torch.ones_like(img)
  mask[:, :, shape[2] // 2:, :] = 0.0
  inpainted = inpainter(gen(5), scaler(img), mask)
  _save(inpainted, 2, os.path.join(args.out, "inpainted.png"))

  # --- Controllable generation: colorization ---
  gray = img.mean(dim=-1, keepdim=True).expand(img.shape)
  colorizer = cg.get_pc_colorizer(sde, model, predictor, corrector,
                                  inverse_scaler, snr=0.16, continuous=True)
  colorized = colorizer(gen(6), scaler(gray))
  _save(colorized, 2, os.path.join(args.out, "colorized.png"))
  print(f"wrote demo outputs to {args.out}/")
  return out


if __name__ == "__main__":
  main()
