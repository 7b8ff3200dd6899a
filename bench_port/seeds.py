"""Seeds derived from the run's ``--seed``: every draw of the benchmark
comes from ``derive(seed, *keys)``, so one seed gives one set of inputs."""
from __future__ import annotations

import numpy as np


def derive(seed: int, *keys: int) -> int:
  """A 63-bit seed for the stream named by ``keys`` (non-negative ints)."""
  state = np.random.SeedSequence([seed % 2 ** 64, *keys]).generate_state(
      1, np.uint64)[0]
  return int(state >> np.uint64(1))


def rng(seed: int, *keys: int) -> np.random.Generator:
  return np.random.default_rng(derive(seed, *keys))
