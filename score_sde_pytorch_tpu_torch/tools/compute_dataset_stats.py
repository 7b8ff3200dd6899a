"""FID reference statistics of a dataset split, the files under
``assets/stats/`` that FID reads (``evaluation.load_dataset_stats``).

The port's counterpart of the JAX package's tools/compute_dataset_stats.py:

    python -m score_sde_pytorch_tpu_torch.tools.compute_dataset_stats \\
        --config <cfg.py> [--split train] [--out assets/stats] \\
        [--max_examples N] [--device cuda|cuda:N|cpu] \\
        [--config.section.key=value ...]

Reads the split through ``datasets.load_raw_dataset`` (every source of the
port), runs the config's Inception protocol on it
(``evaluation.run_inception``; the weights from ``INCEPTION_WEIGHTS_NPZ``,
or ``INCEPTION_V3_FEATURE_WEIGHTS_NPZ`` at 256 px and above) and writes
``<out>/<dataset>_<image_size>_stats.npz`` with ``mu``, ``sigma`` (the
covariance of ``pool_3``, ``np.cov``) and ``pool_3``. ``--out`` may be a URI
of a registered scheme (``utils.io``).
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence

import numpy as np

from score_sde_pytorch_tpu_torch import main as cli


def parse_args(argv: Sequence[str]):
  parser = argparse.ArgumentParser(
      prog="python -m score_sde_pytorch_tpu_torch.tools.compute_dataset_stats",
      description="FID statistics of a dataset split.")
  parser.add_argument("--config", required=True, help="config file path")
  parser.add_argument("--split", default="train", help="dataset split")
  parser.add_argument("--out", default="assets/stats",
                      help="output directory")
  parser.add_argument("--max_examples", type=int, default=0,
                      help="cap the number of images (0 = full split)")
  parser.add_argument("--device", default="cuda", type=cli._device,
                      help="cuda, cuda:N or cpu (default cuda)")
  overrides, rest = cli.split_overrides(argv)
  return parser.parse_args(rest), overrides


def main(argv: Optional[Sequence[str]] = None) -> str:
  """Writes the statistics; returns the file's path."""
  from score_sde_pytorch_tpu_torch import configs, datasets, evaluation
  from score_sde_pytorch_tpu_torch.utils import io

  args, overrides = parse_args(sys.argv[1:] if argv is None else list(argv))
  config = configs.load_config(args.config, overrides)
  images = datasets.materialize(datasets.load_raw_dataset(config, args.split))
  if args.max_examples:
    images = images[:args.max_examples]
  stats = evaluation.run_inception(images, config, args.device)
  if stats is None:
    raise SystemExit("Inception weights unavailable "
                     "(set INCEPTION_WEIGHTS_NPZ)")
  pool = stats["pool_3"]
  mu = pool.mean(axis=0)
  sigma = np.cov(pool, rowvar=False)
  io.makedirs(args.out)
  name = config.data.dataset.lower()
  out = os.path.join(args.out, f"{name}_{config.data.image_size}_stats.npz")
  io.save_npz(out, mu=mu, sigma=sigma, pool_3=pool)
  print(f"wrote {out}: pool {pool.shape}")
  return out


if __name__ == "__main__":
  main()
