"""Command line of the port.

    python -m score_sde_pytorch_tpu_torch.main \\
        --config score_sde_pytorch_tpu_torch/configs/ve/cifar10_ncsnpp_continuous.py \\
        --workdir RUN_DIR --mode train|eval|sample [--eval_folder eval] \\
        [--num_samples N] [--checkpoint N] [--device cuda|cuda:N|cpu] \\
        [--dist_backend nccl|gloo] [--config.section.key=value ...]

Over N GPUs, one process each (the JAX package's ``--multihost``):

    torchrun --nproc_per_node=N -m score_sde_pytorch_tpu_torch.main ...

The flags are those of the JAX package's ``main.py``. They are parsed with
argparse: the JAX CLI's ``ml_collections.config_flags`` is not installed on
every machine the port runs on. ``--mode train`` trains, ``--mode eval``
scores the numbered checkpoints (eval loss, bits/dim, samples with
FID/IS/KID; ``run_lib.evaluate``) and ``--mode sample`` generates from one
checkpoint. The device is ``cuda`` unless ``--device cpu`` is given; there
is no silent CPU fallback.

Under torchrun (``WORLD_SIZE`` set) the CLI joins the process group before
the mode runs and leaves it after: ``--dist_backend`` nccl, the default on
CUDA, or gloo, the default on the CPU and the way to put several ranks on
one card (each given ``--device cuda:0``); neither falls back to the other.
Plain ``cuda`` is ``cuda:LOCAL_RANK``. Rank 0 logs at INFO and writes
``stdout.txt``; the other ranks log warnings only.

``--workdir`` may be a URI (``myfs://bucket/run``) of a scheme that the
calling program registered with ``utils.io.register_scheme``; every
artifact then goes through the scheme's handler. A scheme without a
handler raises before anything runs.
"""
from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import Optional, Sequence

import torch

from score_sde_pytorch_tpu_torch import parallel
from score_sde_pytorch_tpu_torch.utils import io

_CONFIG_PREFIX = "--config."


def _device(value: str) -> str:
  """``cuda``, ``cuda:N`` or ``cpu``."""
  try:
    device = torch.device(value)
  except RuntimeError as e:
    raise argparse.ArgumentTypeError(str(e)) from None
  if device.type not in ("cuda", "cpu") or (device.type == "cpu"
                                            and device.index is not None):
    raise argparse.ArgumentTypeError(
        f"{value!r}: expected cuda, cuda:N or cpu")
  return value


def require_device(value: str) -> torch.device:
  """The device of ``--device``; a CUDA device on a machine where torch sees
  no card raises: there is no silent CPU fallback."""
  device = torch.device(value)
  if device.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError(f"--device {value}, but torch sees no CUDA "
                       "device; pass --device cpu to run on the CPU")
  return device


def split_overrides(argv: Sequence[str]) -> tuple:
  """``(overrides, rest)``: the ``--config.a.b=value`` arguments without
  their prefix, and the others."""
  overrides = [a[len(_CONFIG_PREFIX):] for a in argv
               if a.startswith(_CONFIG_PREFIX)]
  return overrides, [a for a in argv if not a.startswith(_CONFIG_PREFIX)]


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
  parser.add_argument("--device", default="cuda", type=_device,
                      help="cuda, cuda:N or cpu (default cuda; under "
                           "torchrun cuda is cuda:LOCAL_RANK)")
  parser.add_argument("--dist_backend", choices=parallel.BACKENDS,
                      help="torch.distributed backend under torchrun "
                           "(default nccl on cuda, gloo on cpu)")
  overrides, rest = split_overrides(argv)
  return parser.parse_args(rest), overrides


def main(argv: Optional[Sequence[str]] = None):
  """Run the CLI on ``argv`` (default ``sys.argv[1:]``); returns what the
  mode's pipeline returns (for ``train``, the logged losses; for ``eval``,
  the per-checkpoint records; for ``sample``, the per-round records)."""
  args, overrides = parse_args(sys.argv[1:] if argv is None else list(argv))
  device = require_device(args.device)
  distributed = parallel.launched()
  if distributed:
    if device.type == "cuda" and device.index is None:
      device = torch.device("cuda", parallel.local_rank())
    parallel.init(args.dist_backend
                  or ("nccl" if device.type == "cuda" else "gloo"), device)

  try:
    return _run(args, overrides, device)
  finally:
    if distributed:
      parallel.shutdown()


def _run(args, overrides, device: torch.device):
  """The mode's pipeline with the log set up: rank 0 at INFO, to stdout and
  ``stdout.txt``; the other ranks at WARNING, to stdout."""
  from score_sde_pytorch_tpu_torch import configs, run_lib
  config = configs.load_config(args.config, overrides)

  io.makedirs(args.workdir)
  main_rank = parallel.is_main()
  formatter = logging.Formatter(
      "%(levelname)s - %(filename)s - %(asctime)s - %(message)s")
  handlers = [logging.StreamHandler(sys.stdout)]
  log_file = None
  if main_rank:
    log_path = os.path.join(args.workdir, "stdout.txt")
    if "://" in log_path:
      # Through the scheme's handler, as the JAX package's main.py writes
      # its log (a new file per run: a remote store does not append).
      log_file = io.open_file(log_path, "w")
      handlers.append(logging.StreamHandler(log_file))
    else:
      handlers.append(logging.FileHandler(log_path))
  logger = logging.getLogger()
  previous_level = logger.level
  for handler in handlers:
    handler.setFormatter(formatter)
    logger.addHandler(handler)
  logger.setLevel(logging.INFO if main_rank else logging.WARNING)
  try:
    if args.mode == "train":
      return run_lib.train(config, args.workdir, device=device)
    if args.mode == "eval":
      return run_lib.evaluate(config, args.workdir, args.eval_folder,
                              device=device)
    return run_lib.sample(config, args.workdir, args.sample_folder,
                          checkpoint=args.checkpoint,
                          num_samples=args.num_samples, device=device)
  finally:
    for handler in handlers:
      logger.removeHandler(handler)
      handler.close()
    if log_file is not None:
      log_file.close()
    logger.setLevel(previous_level)

if __name__ == "__main__":
  main()
