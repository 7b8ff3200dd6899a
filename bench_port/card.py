"""The card's name, power limit, and its SM clock and power draw sampled
by ``nvidia-smi`` every 100 ms over the measured window (the sampling of
the program's ``tools/train_step_grid.py``, copied here)."""
from __future__ import annotations

import shutil
import statistics
import subprocess


def limits() -> dict:
  """``{"name", "power_limit_w"}`` as ``nvidia-smi`` reads them, or {}."""
  if shutil.which("nvidia-smi") is None:
    return {}
  proc = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader,nounits", "--id=0"],
      capture_output=True, text=True, check=False)
  parts = [p.strip() for p in proc.stdout.strip().split(",")]
  if proc.returncode != 0 or len(parts) != 2:
    return {}
  return {"name": parts[0], "power_limit_w": parts[1]}


class Sampler:
  """A running ``nvidia-smi`` that samples clock and draw until
  :meth:`stop`, which ends it and waits for it."""

  def __init__(self):
    self.proc = None
    if shutil.which("nvidia-smi") is not None:
      self.proc = subprocess.Popen(
          ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
           "--format=csv,noheader,nounits", "-lms", "100", "--id=0"],
          stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)

  def stop(self) -> dict:
    if self.proc is None:
      return {}
    self.proc.terminate()
    out, _ = self.proc.communicate()
    self.proc = None
    rows = [line.split(",") for line in out.splitlines() if "," in line]
    clocks, watts = [], []
    for row in rows:
      try:
        clocks.append(float(row[0]))
        watts.append(float(row[1]))
      except ValueError:
        continue
    if not clocks:
      return {}
    return {"sm_mhz_median": statistics.median(clocks),
            "sm_mhz_min": min(clocks), "power_w_median":
            statistics.median(watts), "power_w_max": max(watts),
            "samples": len(clocks)}
