"""One run of one cell: set-up, the measured window, the traced segment,
the comparison with the reference, and the result.

A mode (``modes/<mode>.py``) supplies a ``Session`` built from a
:class:`Context`: its constructor is the cell's set-up (the program built,
the seed's weights, every shape of the window warmed up), ``block()``
enqueues one unit of the cell's traffic and returns the work it does,
``traced_blocks()`` runs the fixed work of the traced segment,
``readings`` keeps what the program produced for the comparison, and
``release()`` frees the program's state. The mode's ``check(ctx,
readings)`` then runs the reference and returns the numbers compared.

The window: blocks are enqueued back to back; after each, the host waits
for the block before it, so it runs at most one block ahead of the card;
no block is started that would end past ``seconds``, about; the window
closes when the last block has finished on the card. Every rate is all
the work of the window over all its time.
"""
from __future__ import annotations

import collections
import dataclasses
import gc
import math
import os
import sys
import time

import torch

from bench_port import card, program, registry, trace

BANNED = ("jax", "jaxlib", "flax", "score_sde_pytorch_tpu")


def banned_modules() -> list:
  """Top-level names of loaded modules that are JAX or the JAX package,
  compared whole (the port's name begins with the JAX package's)."""
  return sorted({name.split(".")[0] for name in list(sys.modules)}
                & set(BANNED))


def process_start_wall() -> float:
  """The wall-clock time at which this process started (from /proc), or
  now where that cannot be read."""
  try:
    with open("/proc/self/stat") as f:
      fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
      uptime = float(f.read().split()[0])
    started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.time() - (uptime - started)
  except (OSError, ValueError, IndexError):
    return time.time()


@dataclasses.dataclass
class Context:
  """What a mode's session is built from."""
  cell: dict            # the cell: BENCHMARK.json entry + traffic file
  config_file: dict     # configs/<config>.json
  plain: dict           # the configuration as run (sections of keys)
  cfg: object           # the program's ConfigDict of ``plain``
  seed: int
  device: torch.device
  fault: str | None = None  # a planted fault (tests and calibration only)
  marks: list = dataclasses.field(default_factory=list)

  def mark(self, name: str) -> None:
    """Notes the wall-clock time at which a phase of set-up ended."""
    self.marks.append((name, time.time()))

  def sync(self):
    if self.device.type == "cuda":
      torch.cuda.synchronize(self.device)


def make_context(cell: dict, config_file: dict, seed: int, device,
                 overrides: dict | None = None, fault=None) -> Context:
  plain = program.merged(config_file["config"], overrides)
  cfg = program.port_config(config_file, plain, seed)
  return Context(cell, config_file, plain, cfg, seed, torch.device(device),
                 fault)


def measure_window(ctx: Context, session, seconds: float) -> tuple:
  """``(work, window seconds, blocks)`` of the measured window."""
  work = collections.Counter()
  cuda = ctx.device.type == "cuda"
  ctx.sync()
  start = time.perf_counter()
  events, blocks = [], 0
  while True:
    work.update(session.block())
    blocks += 1
    if cuda:
      events.append(torch.cuda.Event())
      events[-1].record()
      if len(events) >= 2:
        events[-2].synchronize()
    if seconds <= 0:  # the shortest window: one block
      break
    elapsed = time.perf_counter() - start
    done = blocks - 1 if cuda else blocks
    if done >= 1 and elapsed + elapsed / done >= seconds:
      break
  ctx.sync()
  return work, time.perf_counter() - start, blocks


def run_cell(cell: dict, config_file: dict, seed: int, seconds: float,
             traced: bool, device="cuda", started: float | None = None,
             overrides: dict | None = None, fault: str | None = None,
             limits: dict | None = None) -> dict:
  """One run; returns the record the result is printed from."""
  started = time.time() if started is None else started
  entered = time.time()
  ctx = make_context(cell, config_file, seed, device, overrides, fault)
  ctx.marks[:0] = [("start", started), ("imports", entered)]
  ctx.mark("config")
  cuda = ctx.device.type == "cuda"
  if cuda:
    torch.cuda.reset_peak_memory_stats(ctx.device)
    ctx.mark("cuda")
  mode = registry.mode(cell["mode"])
  session = mode.Session(ctx)
  ctx.sync()
  ctx.mark("warm_up")
  setup_s = time.time() - started
  sampler = card.Sampler() if cuda else None
  work, window_s, blocks = measure_window(ctx, session, seconds)
  card_record = sampler.stop() if sampler else {}
  rec = {"config": cell["config"], "setup_s": setup_s,
         "setup_phases": {name: t - ctx.marks[i][1] for i, (name, t)
                          in enumerate(ctx.marks[1:])},
         "work": dict(work),
         "window_s": window_s,
         "blocks": blocks, "flops": session.flops, "card": card_record}
  if traced:
    trace_work, summary, calls = trace.run(session.traced_blocks)
    rec.update(trace_work=dict(trace_work), trace=summary,
               attention_calls=calls)
  rec["peak_bytes"] = torch.cuda.max_memory_allocated(ctx.device) if cuda \
      else 0
  rec["attempted"], rec["failed"] = session.attempted, session.failed
  readings = session.readings
  session.release()
  del session
  gc.collect()
  if cuda:
    torch.cuda.empty_cache()
  rec["checks"] = _checks(mode, ctx, readings, limits, cell)
  bad = [c for c in rec["checks"]
         if c["limit"] is None or not c["value"] <= c["limit"]]
  rec["correct"] = not bad and rec["failed"] == 0 and bool(rec["checks"])
  return rec


def _checks(mode, ctx: Context, readings: dict, limits: dict | None,
            cell: dict) -> list:
  """The reference's comparison, each number beside its limit (the cell's
  ``limits`` unless ``limits`` is given)."""
  limits = cell.get("limits", {}) if limits is None else limits
  values = mode.check(ctx, readings)
  return [{"name": name, "value": float(value), "limit": limits.get(name)}
          for name, value in values.items()]


def metrics(rec: dict, cell_name: str, bench: dict, traced: bool,
            device_name: str) -> dict:
  """The cell's end-to-end metrics (``traced`` false) or per-layer
  metrics, each from its reader; a reader that finds nothing to read
  leaves its metric out."""
  out = {}
  rec = {**rec, "device_name": device_name}
  for m in registry.metrics_of(cell_name, bench, per_layer=traced):
    kind = "layer_metrics" if traced else "end_to_end"
    value = registry.metric_reader(kind, m["name"]).read(rec, m)
    if value is not None and math.isfinite(value):
      out[m["name"]] = {"value": value, "unit": m["unit"]}
  return out
