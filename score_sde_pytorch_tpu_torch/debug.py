"""Interactive debug harness: restore a checkpoint, run one score
evaluation, then stop in the debugger (the JAX package's debug.py).

    python -m score_sde_pytorch_tpu_torch.debug --config <cfg.py> \\
        --workdir <dir> [--ckpt N] [--device cuda|cuda:N|cpu] \\
        [--config.section.key=value ...]

``--ckpt N`` restores ``checkpoints/checkpoint_N.pth``; the default, -1,
the rolling ``checkpoints-meta/checkpoint.pth``. The workdir may be a URI
of a registered scheme (``utils.io``). The score is that of the EMA
weights on 4 seeded normal inputs at ``t = 0.5``; at the breakpoint
``model`` holds the trained weights, ``ema`` their average, and
``score_fn``, ``sde``, ``x`` and ``score`` are in scope.
``PYTHONBREAKPOINT=0`` runs it through without stopping.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import torch

from score_sde_pytorch_tpu_torch import main as cli


def parse_args(argv: Sequence[str]):
  parser = argparse.ArgumentParser(
      prog="python -m score_sde_pytorch_tpu_torch.debug",
      description="Restore a checkpoint, evaluate the score once, then "
                  "breakpoint().")
  parser.add_argument("--config", required=True, help="config file path")
  parser.add_argument("--workdir", required=True,
                      help="work directory with checkpoints")
  parser.add_argument("--ckpt", type=int, default=-1,
                      help="numbered checkpoint to load (-1 = meta)")
  parser.add_argument("--device", default="cuda", type=cli._device,
                      help="cuda, cuda:N or cpu (default cuda)")
  overrides, rest = cli.split_overrides(argv)
  return parser.parse_args(rest), overrides


def main(argv: Optional[Sequence[str]] = None) -> dict:
  """Returns what it printed, as ``{"step", "mean", "std"}``."""
  from score_sde_pytorch_tpu_torch import checkpoint as ckpt_lib
  from score_sde_pytorch_tpu_torch import configs
  from score_sde_pytorch_tpu_torch import sde as sde_lib
  from score_sde_pytorch_tpu_torch.models import utils as mutils
  from score_sde_pytorch_tpu_torch.models.ema import ExponentialMovingAverage

  args, overrides = parse_args(sys.argv[1:] if argv is None else list(argv))
  config = configs.load_config(args.config, overrides)
  device = torch.device(args.device)
  model = mutils.create_model(config, device,
                              torch.Generator().manual_seed(config.seed))
  ema = ExponentialMovingAverage(model.parameters(),
                                 decay=config.model.ema_rate)
  path = (ckpt_lib.numbered_path(args.workdir, args.ckpt) if args.ckpt >= 0
          else ckpt_lib.meta_path(args.workdir))
  step = ckpt_lib.restore_model_and_ema(path, model, ema)
  print(f"loaded state at step {step}")

  sde = sde_lib.build_sde(config)
  score_fn = mutils.get_score_fn(sde, model, train=False,
                                 continuous=config.training.continuous)
  size = config.data.image_size
  x = torch.randn(4, config.data.num_channels, size, size,
                  generator=torch.Generator(device=device).manual_seed(1),
                  device=device)
  t = torch.full((4,), 0.5, device=device)
  ema.store(model.parameters())
  ema.copy_to(model.parameters())
  try:
    with torch.no_grad():
      score = score_fn(x, t)
  finally:
    ema.restore(model.parameters())
  stats = {"step": step, "mean": float(score.mean()),
           "std": float(score.std(correction=0))}  # jnp.std's, ddof 0
  print("score stats:", stats["mean"], stats["std"])
  breakpoint()  # inspect `model`, `ema`, `score_fn`, `sde` interactively
  return stats


if __name__ == "__main__":
  main()
