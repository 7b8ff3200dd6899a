"""``spans.py`` with NCSN++'s level and pyramid spans read too.

The port opens ``ncsnpp.res<R>`` around each U-Net level's work and
``ncsnpp.pyramid`` around each pyramid step (``models/ncsnpp.py``).
``spans.py`` keeps a fixed list of the port's span names, and the
harness records no spans; this entry point adds those names to the list
and the readers ``layer_metrics/{pyramid_ms_per_step,
full_res_ms_per_step}.py`` to the readings, then runs ``spans.py``::

    python3 bench_port/level_spans.py --workload <cell> --seed <n> \\
        --seconds <s> --trace 1

Its last line is ``spans.py``'s, with every ``ncsnpp.res<R>`` span's
device seconds under ``spans``.
"""
from __future__ import annotations

import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
  sys.path.insert(0, _ROOT)

from bench_port import spans  # noqa: E402

LEVELS = ("ncsnpp.pyramid",) + tuple(f"ncsnpp.res{2 ** k}"
                                     for k in range(13))
READERS = ("pyramid_ms_per_step.train256", "full_res_ms_per_step.train256")


def main(argv=None) -> int:
  spans.PROGRAM = spans.PROGRAM + LEVELS
  spans.READERS = spans.READERS + READERS
  return spans.main(argv)


if __name__ == "__main__":
  sys.exit(main())
