"""Train-step grid of the 256² and 1024² NCSN++ on one CUDA card: images/s
and peak memory over model.dtype (float32, bfloat16) x model.remat (on,
off) x batch sizes, the measurements the ``configs/h100/`` leaves were
chosen from.

    python -m score_sde_pytorch_tpu_torch.tools.train_step_grid \\
        [--out grid.json] [--steps 3] [--repeats 1] \\
        [--points church_256/float32/off/24,...]

Each run of a point builds the config's model at full width from a seed,
runs one warm-up train step (continuous VE loss, Adam, EMA) on a random
batch, then ``--steps`` timed steps that end in a synchronize, while
``nvidia-smi`` samples the card's SM clock and power draw every 100 ms; the
peak is ``max_memory_allocated`` from before the model was built. A batch
that does not fit is recorded as out of memory. ``--repeats`` runs every
point that many times, the points in turn, and a point's images/s is the
median of its runs. ``--points`` limits the grid to the listed points
(``config/dtype/remat/batch``, remat ``on`` or ``off``). For each config
the choice is the point of highest median images/s whose peak leaves at
least ``FREE_SHARE`` of the card's memory free. Needs a CUDA card;
PyTorch's default TF32 settings.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import statistics
import subprocess
import time
from pathlib import Path

import torch

from score_sde_pytorch_tpu_torch import configs, losses
from score_sde_pytorch_tpu_torch import sde as sde_lib
from score_sde_pytorch_tpu_torch.models import utils as mutils

CONFIG_DIR = Path(configs.__file__).resolve().parent
# The JAX package's variants of the two configs, whose dtype and remat
# this grid varies.
CONFIGS = {"church_256": CONFIG_DIR / "tpu" / "church_256_ncsnpp_tpu.py",
           "celebahq_1024": CONFIG_DIR / "tpu" / "celebahq_1024_ncsnpp_tpu.py"}
BATCHES = {("church_256", True): (32, 48, 64, 80),
           ("church_256", False): (8, 16, 24, 32),
           ("celebahq_1024", True): (8, 16, 24, 32),
           ("celebahq_1024", False): (4, 8, 12, 16)}
FREE_SHARE = 0.10


def card_line() -> str:
  return subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def _sample_card():
  """A running ``nvidia-smi`` that prints the SM clock (MHz) and power draw
  (W) every 100 ms."""
  return subprocess.Popen(
      ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
       "--format=csv,noheader,nounits", "-lms", "100"],
      stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)


def _read_samples(proc) -> dict:
  proc.terminate()
  out, _ = proc.communicate()
  rows = [line.split(",") for line in out.splitlines() if "," in line]
  clocks = [float(r[0]) for r in rows if r[0].strip().isdigit()]
  watts = [float(r[1]) for r in rows
           if r[1].strip().replace(".", "", 1).isdigit()]
  return {"sm_mhz": statistics.median(clocks) if clocks else None,
          "watts": statistics.median(watts) if watts else None}


def measure(config, batch_size: int, steps: int, after=None) -> dict:
  """One run of a grid point on cuda:0: ms/step, images/s, peak GiB and the
  median SM clock and power draw over the timed steps, or
  ``{"oom": True}``. ``after``, where given, is called with a function
  that runs n more steps and synchronizes, before the model is freed."""
  gc.collect()
  torch.cuda.empty_cache()
  torch.cuda.reset_peak_memory_stats()
  state = None
  try:
    model = mutils.create_model(config, "cuda",
                                torch.Generator().manual_seed(config.seed))
    state = losses.init_train_state(config, model, "cuda")
    tcfg = config.training
    step_fn = losses.get_step_fn(
        sde_lib.build_sde(config), train=True,
        optimize_fn=losses.optimization_manager(config),
        reduce_mean=tcfg.reduce_mean, continuous=tcfg.continuous,
        likelihood_weighting=tcfg.likelihood_weighting)
    size = config.data.image_size
    batch = torch.rand(batch_size, config.data.num_channels, size, size,
                       device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(5))

    def run_steps(n):
      for _ in range(n):
        loss = step_fn(state, batch, state["generator"])
      torch.cuda.synchronize()
      if not math.isfinite(loss.item()):
        raise RuntimeError(f"non-finite loss {loss.item()} at batch "
                           f"{batch_size}")

    run_steps(1)  # warm-up: cuDNN's first-call set-up, Adam's state
    sampler = _sample_card()
    start = time.perf_counter()
    run_steps(steps)
    ms = (time.perf_counter() - start) * 1e3 / steps
    result = {"ms": ms, "images_per_s": batch_size * 1e3 / ms,
              "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
              **_read_samples(sampler)}
    if after is not None:
      after(run_steps)
    return result
  except torch.cuda.OutOfMemoryError:
    return {"oom": True}
  finally:
    del state
    gc.collect()
    torch.cuda.empty_cache()


def _point_name(p: dict) -> str:
  return (f"{p['config']}/{p['dtype']}/{'on' if p['remat'] else 'off'}/"
          f"{p['batch']}")


def grid_points(only=()) -> list:
  """The grid's points in order, or those named in ``only``."""
  points = [{"config": name, "dtype": dtype, "remat": remat, "batch": b}
            for name in CONFIGS for dtype in ("float32", "bfloat16")
            for remat in (True, False) for b in BATCHES[name, remat]]
  if only:
    unknown = set(only) - {_point_name(p) for p in points}
    if unknown:
      raise SystemExit(f"not points of the grid: {sorted(unknown)}")
    points = [p for p in points if _point_name(p) in only]
  return points


def run(steps: int, repeats: int = 1, only=()) -> dict:
  total_gib = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
  points = grid_points(only)
  result = {"card": card_line(), "torch": torch.__version__,
            "total_gib": total_gib, "steps": steps, "repeats": repeats,
            "points": points, "choice": {}}
  print(f"[grid] {result['card']}; {total_gib:.2f} GiB; {repeats} runs of "
        f"{steps} timed steps a point after one warm-up each, the points in "
        "turn", flush=True)
  for p in points:
    p["runs"] = []
  for r in range(repeats):
    for p in points:
      if p["runs"] and p["runs"][-1].get("oom"):
        continue
      config = configs.load_config(str(CONFIGS[p["config"]]), [
          f"model.dtype={p['dtype']}", f"model.remat={p['remat']}",
          f"training.batch_size={p['batch']}"])
      p["runs"].append(measure(config, p["batch"], steps))
      print(f"[grid] run {r + 1} {_point_name(p)}",
            json.dumps(p["runs"][-1]), flush=True)
  for p in points:
    if p["runs"][-1].get("oom"):
      p["oom"] = True
      continue
    rates = [x["images_per_s"] for x in p["runs"]]
    p.update(images_per_s=statistics.median(rates), min=min(rates),
             max=max(rates), peak_gib=max(x["peak_gib"] for x in p["runs"]))
    print(f"[grid] {_point_name(p)}: median {p['images_per_s']:.2f} images/s "
          f"(min {p['min']:.2f}, max {p['max']:.2f}), peak "
          f"{p['peak_gib']:.2f} GiB", flush=True)
  for name in CONFIGS:
    fits = [p for p in points if p["config"] == name and not p.get("oom")
            and p["peak_gib"] <= (1 - FREE_SHARE) * total_gib]
    if fits:
      result["choice"][name] = max(fits, key=lambda p: p["images_per_s"])
      print(f"[grid] choice for {name}: "
            f"{_point_name(result['choice'][name])}", flush=True)
  return result


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  parser.add_argument("--out", default="", help="write the grid as JSON")
  parser.add_argument("--steps", type=int, default=3)
  parser.add_argument("--repeats", type=int, default=1,
                      help="runs of each point, the points in turn")
  parser.add_argument("--points", default="",
                      help="comma-separated config/dtype/remat/batch points "
                           "(default: the whole grid)")
  args = parser.parse_args(argv)
  only = tuple(filter(None, args.points.split(",")))
  grid_points(only)  # an unknown point fails before the card is asked
  if not torch.cuda.is_available():
    raise SystemExit("train_step_grid needs a CUDA card")
  result = run(args.steps, args.repeats, only)
  if args.out:
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
  return 0


if __name__ == "__main__":
  raise SystemExit(main())
