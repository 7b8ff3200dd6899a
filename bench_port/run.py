"""One run of one cell of the port's benchmark.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Builds the cell's program from its files under ``bench_port/``, warms it
up, measures for about ``--seconds`` seconds, compares what the window
produced with the plain reference, and prints one JSON object as the last
line of standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device`` and, traced, ``breakdown``, then
``checks``, each number compared beside its limit. The line before it
records the card, its clock and power over the window and the work done.
Exits 2 without a result where the cell's cards are not there, and 3
where JAX or the JAX package was loaded.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
  sys.path.insert(0, _ROOT)


def _args(argv):
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  p.add_argument("--workload", required=True)
  p.add_argument("--seed", type=int, required=True)
  p.add_argument("--seconds", type=float, required=True)
  p.add_argument("--trace", type=int, choices=(0, 1), default=0)
  return p.parse_args(argv)


def _cache_dirs() -> None:
  """Keep the program's kernel caches inside the checkout, at fixed
  paths (the attention library builds into the program's own
  ``ops/_build/``)."""
  cache = os.path.join(_ROOT, "bench_port", ".cache")
  os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
  os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")


def result_line(rec: dict, workload: str, bench: dict, traced: bool,
                device_name: str, chips: int) -> dict:
  """The result's last line: the contract's keys, ``checks`` last."""
  from bench_port import harness
  device = {"platform": "gpu", "kind": device_name, "count": chips,
            "memory_peak_bytes": rec["peak_bytes"]}
  if traced:
    device.update(busy_s=rec["trace"]["busy_s"],
                  window_s=rec["trace"]["window_s"])
  result = {"correct": rec["correct"], "attempted": rec["attempted"],
            "failed": rec["failed"],
            "metrics": harness.metrics(rec, workload, bench, traced,
                                       device_name),
            "device": device}
  if traced:
    result["breakdown"] = {"device_ops": rec["trace"]["device_ops"],
                           "idle_gaps": rec["trace"]["idle_gaps"]}
  result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                      for c in rec["checks"]}
  return result


def main(argv=None) -> int:
  from bench_port import harness
  started = harness.process_start_wall()
  args = _args(argv)
  _cache_dirs()
  import torch

  from bench_port import card, registry
  bench = registry.benchmark()
  cell = registry.cell(args.workload, bench)
  if not torch.cuda.is_available() or torch.cuda.device_count() < \
      cell["chips"]:
    print(f"bench_port: {args.workload} needs {cell['chips']} CUDA device(s); "
          f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
          file=sys.stderr)
    return 2
  config_file = registry.config(cell["config"])
  rec = harness.run_cell(cell, config_file, args.seed, args.seconds,
                         bool(args.trace), "cuda", started)
  banned = harness.banned_modules()
  if banned:
    print(f"bench_port: loaded {banned} (JAX or the JAX package)",
          file=sys.stderr)
    return 3
  name = torch.cuda.get_device_name(0)
  built = None
  from score_sde_pytorch_tpu_torch.ops import attention
  if attention.kernel_library.cache_info().currsize:
    built = attention.kernel_library().build_seconds > 0
  print(json.dumps({"record": {
      "card": {**card.limits(), **rec["card"]}, "workload": args.workload,
      "seed": args.seed, "setup_s": rec["setup_s"],
      "setup_phases": rec["setup_phases"],
      "window_s": rec["window_s"], "blocks": rec["blocks"],
      "work": rec["work"], "trace_work": rec.get("trace_work"),
      "attention_calls_traced": len(rec.get("attention_calls", [])),
      "nvcc_built_this_run": built}}))
  result = result_line(rec, args.workload, bench, bool(args.trace), name,
                       cell["chips"])
  for c in rec["checks"]:
    print(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r})",
          file=sys.stderr)
  sys.stderr.flush()
  print(json.dumps(result), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
