"""The readings the limits of ``correct`` are set from, on the card.

    python3 bench_port/calibrate.py --workload <cell> --seeds 1 2 ... \
        [--control-seeds 1 2 3] [--fault-seeds 1 2 3] [--out FILE]

In one process, for the cell at its own size: each number the run
compares, on each seed, from

- the program as the cell runs it (the lower readings);
- the control: the program with its bfloat16 path on
  (``model.dtype='bfloat16'``; the upper readings);
- each fault of ``faults.py`` planted in the program.

Each run is a benchmark run with the shortest window (one or two blocks).
The benchmark's own runs never do this. Writes the readings as JSON.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
import traceback

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
  sys.path.insert(0, _ROOT)


def _run(cell, config_file, seed, **kw) -> dict:
  import torch

  from bench_port import harness
  start = time.time()
  try:
    rec = harness.run_cell(cell, config_file, seed, 0.0, False, "cuda",
                           limits={}, **kw)
    out = {c["name"]: c["value"] for c in rec["checks"]}
    out["failed"] = rec["failed"]
    out["work"] = rec["work"]
  except Exception as e:  # a control or fault that crashes gives no number
    out = {"error": f"{type(e).__name__}: {e}"[:500],
           "trace": traceback.format_exc()[-1500:]}
  out["seconds"] = time.time() - start
  gc.collect()
  torch.cuda.empty_cache()
  return out


def main(argv=None) -> int:
  p = argparse.ArgumentParser()
  p.add_argument("--workload", required=True)
  p.add_argument("--seeds", type=int, nargs="*", default=[])
  p.add_argument("--control-seeds", type=int, nargs="*", default=[])
  p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
  p.add_argument("--faults", nargs="*", default=None)
  p.add_argument("--out", default=None)
  args = p.parse_args(argv)
  from bench_port import faults, registry
  bench = registry.benchmark()
  cell = registry.cell(args.workload, bench)
  config_file = registry.config(cell["config"])
  out = {"workload": args.workload, "program": {}, "control": {},
         "faults": {}}

  def dump():
    if args.out:
      with open(args.out, "w") as f:
        json.dump(out, f, indent=1)

  for seed in args.seeds:
    out["program"][seed] = _run(cell, config_file, seed)
    print("program", seed, out["program"][seed], flush=True)
    dump()
  for seed in args.control_seeds:
    r = _run(cell, config_file, seed,
             overrides={"model": {"dtype": "bfloat16"}})
    out["control"][seed] = r
    print("control", seed, r, flush=True)
    dump()
  for fault in (faults.FAULTS if args.faults is None else args.faults):
    out["faults"][fault] = {}
    for seed in args.fault_seeds:
      r = _run(cell, config_file, seed, fault=fault)
      out["faults"][fault][seed] = r
      print("fault", fault, seed, r, flush=True)
      dump()
  return 0


if __name__ == "__main__":
  sys.exit(main())
