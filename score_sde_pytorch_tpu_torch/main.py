"""Command line of the port.

    python -m score_sde_pytorch_tpu_torch.main \\
        --config score_sde_pytorch_tpu_torch/configs/ve/cifar10_ncsnpp_continuous.py \\
        --workdir RUN_DIR --mode train|eval|sample [--eval_folder eval] \\
        [--num_samples N] [--checkpoint N] [--device cuda|cpu] \\
        [--config.section.key=value ...]

The flags are those of the JAX package's ``main.py``. They are parsed with
argparse: the JAX CLI's ``ml_collections.config_flags`` is not installed on
every machine the port runs on. ``--mode train`` trains, ``--mode eval``
scores the numbered checkpoints (eval loss, bits/dim, samples with
FID/IS/KID; ``run_lib.evaluate``) and ``--mode sample`` generates from one
checkpoint. The device is ``cuda`` unless ``--device cpu`` is given; there
is no silent CPU fallback.
"""
from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import Optional, Sequence

import torch

_CONFIG_PREFIX = "--config."


def parse_args(argv: Sequence[str]):
  parser = argparse.ArgumentParser(
      prog="python -m score_sde_pytorch_tpu_torch.main",
      description="Score SDE (PyTorch/CUDA port). Config overrides are given "
                  "as --config.section.key=value.")
  parser.add_argument("--config", required=True, help="config file path")
  parser.add_argument("--workdir", required=True, help="work directory")
  parser.add_argument("--mode", required=True,
                      choices=["train", "eval", "sample"])
  parser.add_argument("--eval_folder", default="eval",
                      help="folder under workdir for --mode eval outputs")
  parser.add_argument("--sample_folder", default="generated",
                      help="folder under workdir for --mode sample outputs")
  parser.add_argument("--checkpoint", type=int, default=-1,
                      help="numbered checkpoint to sample from; -1 = latest")
  parser.add_argument("--num_samples", type=int, default=0,
                      help="total images for --mode sample; 0 = one batch")
  parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                      help="device to run on (default cuda)")
  overrides = [a[len(_CONFIG_PREFIX):] for a in argv
               if a.startswith(_CONFIG_PREFIX)]
  rest = [a for a in argv if not a.startswith(_CONFIG_PREFIX)]
  args = parser.parse_args(rest)
  return args, overrides


def main(argv: Optional[Sequence[str]] = None):
  """Run the CLI on ``argv`` (default ``sys.argv[1:]``); returns what the
  mode's pipeline returns (for ``train``, the logged losses; for ``eval``,
  the per-checkpoint records; for ``sample``, the per-round records)."""
  args, overrides = parse_args(sys.argv[1:] if argv is None else list(argv))
  if args.device == "cuda" and not torch.cuda.is_available():
    raise RuntimeError("--device cuda, but torch sees no CUDA device; pass "
                       "--device cpu to run on the CPU")

  from score_sde_pytorch_tpu_torch import configs, run_lib
  config = configs.load_config(args.config, overrides)

  os.makedirs(args.workdir, exist_ok=True)
  formatter = logging.Formatter(
      "%(levelname)s - %(filename)s - %(asctime)s - %(message)s")
  handlers = [logging.StreamHandler(sys.stdout),
              logging.FileHandler(os.path.join(args.workdir, "stdout.txt"))]
  logger = logging.getLogger()
  previous_level = logger.level
  for handler in handlers:
    handler.setFormatter(formatter)
    logger.addHandler(handler)
  logger.setLevel(logging.INFO)
  try:
    if args.mode == "train":
      return run_lib.train(config, args.workdir, device=args.device)
    if args.mode == "eval":
      return run_lib.evaluate(config, args.workdir, args.eval_folder,
                              device=args.device)
    return run_lib.sample(config, args.workdir, args.sample_folder,
                          checkpoint=args.checkpoint,
                          num_samples=args.num_samples, device=args.device)
  finally:
    for handler in handlers:
      logger.removeHandler(handler)
      handler.close()
    logger.setLevel(previous_level)


if __name__ == "__main__":
  main()
