"""The port's own spans and counters, as the benchmark reads them.

The port marks its hot paths as ``torch.profiler`` user annotations and
counts the host seconds of its train loop
(``score_sde_pytorch_tpu_torch/utils/tracing.py``). :func:`reduce` puts
the device time of a traced segment down to those spans by correlation
id, as ``trace._attention_seconds`` does for the benchmark's attention
spans; :func:`difference` takes the counters of the untraced window from
two snapshots. The readers ``layer_metrics/{host_ms_per_step,
data_wait_ms_per_step, network_ms_per_nfe, norm_act_ms_per_nfe,
fir_ms_per_nfe, sampler_ms_per_nfe}.py`` read a record's
``program_counters`` and ``spans``.

``harness.py`` and ``trace.py`` do not record those two keys yet. This
entry point runs a cell as ``run.py`` does, with both recorded, and after
``run.py``'s lines prints one more JSON line: the two keys and the six
readers' values (a cell reports what it finds)::

    python3 bench_port/spans.py --workload <cell> --seed <n> \
        --seconds <s> --trace 1
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
  sys.path.insert(0, _ROOT)

from bench_port import trace  # noqa: E402

PROGRAM = ("train.step", "train.loss", "train.backward", "train.optimize",
           "train.ema", "eval.step", "data.next", "pc.step", "pc.corrector",
           "pc.predictor", "ncsnpp.forward", "op.norm_act", "op.fir",
           "op.attention")
BACKWARD = "train.backward"
READERS = ("host_ms_per_step.train", "data_wait_ms_per_step.train",
           "network_ms_per_nfe.sample", "norm_act_ms_per_nfe.sample",
           "fir_ms_per_nfe.sample", "sampler_ms_per_nfe.sample")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _window(events: list):
  for e in events:
    if (e.get("name") == trace.WINDOW and e.get("ph") == "X"
        and e.get("cat") == "user_annotation"):
      return float(e["ts"]), float(e["ts"]) + float(e["dur"])
  return None


def _device_ops(events: list, w0: float, w1: float) -> dict:
  """Correlation id -> ``[seconds, name]`` of its device operations
  inside the window."""
  out = {}
  for e in events:
    if e.get("ph") != "X" or e.get("cat") not in trace._DEVICE_CATS:
      continue
    s = float(e["ts"])
    d = min(s + float(e.get("dur", 0.0)), w1) - max(s, w0)
    corr = e.get("args", {}).get("correlation")
    if d > 0 and corr is not None:
      op = out.setdefault(corr, [0.0, e.get("name", "?")[:trace._NAME]])
      op[0] += d * 1e-6
  return out


def _attributed(events: list):
  """``(spans, launches)``: the port's spans in the traced window, each
  ``(name, host seconds)``, and each launch of device operations in it
  as ``(names of the port's spans open, seconds, operation's name)``,
  outermost span first; None where there is no window."""
  window = _window(events)
  if window is None:
    return None
  w0, w1 = window
  device = _device_ops(events, w0, w1)
  by_thread = collections.defaultdict(list)
  found = []
  for e in events:
    if e.get("ph") != "X":
      continue
    s, end = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
    key = (e.get("pid"), e.get("tid"))
    if (e.get("cat") == "user_annotation" and e.get("name") in PROGRAM
        and end > w0 and s < w1):
      by_thread[key].append((s, 0, -end, e["name"]))
      found.append((e["name"], (end - s) * 1e-6))
    elif (e.get("cat") in _LAUNCH_CATS
          and e.get("args", {}).get("correlation") in device):
      by_thread[key].append((s, 1, 0.0, e["args"]["correlation"]))
  backward, launches = [], []  # (start, end, names) / (ts, names, corr)
  for items in by_thread.values():
    stack = []  # (end, name)
    for s, kind, neg_end, what in sorted(items):
      while stack and stack[-1][0] <= s:
        stack.pop()
      names = tuple(name for _, name in stack)
      if kind == 0:
        stack.append((-neg_end, what))
        if what == BACKWARD:
          backward.append((s, -neg_end, names + (what,)))
      else:
        launches.append((s, names, what))
  backward.sort()
  starts = [b[0] for b in backward]
  out = []
  for ts, names, corr in launches:
    i = bisect.bisect_right(starts, ts) - 1
    if BACKWARD not in names and i >= 0 and ts <= backward[i][1]:
      names = backward[i][2] + names
    out.append((names, *device[corr]))
  return found, out


def reduce(events: list) -> dict:
  """``{span: {"count", "host_s", "device_s", "self_device_s"}}`` of the
  port's spans in the traced window of Chrome trace ``events``.

  ``device_s`` sums the device operations (kernels, copies, sets, clipped
  to the window) launched while the span was open on the launching
  thread; ``self_device_s`` those whose innermost port span it is. A
  launch made outside ``train.backward`` on its own thread while a
  ``train.backward`` span is open on another (the autograd engine's
  launches) goes to that span and the spans around it as well."""
  attributed = _attributed(events)
  if attributed is None:
    return {}
  found, launches = attributed
  out = {}
  for name, host_s in found:
    stats = out.setdefault(name, {"count": 0, "host_s": 0.0, "device_s": 0.0,
                                  "self_device_s": 0.0})
    stats["count"] += 1
    stats["host_s"] += host_s
  for names, seconds, _ in launches:
    for name in set(names):
      out[name]["device_s"] += seconds
    if names:
      out[names[-1]]["self_device_s"] += seconds
  return out


def ops_by_span(events: list, top: int = 10) -> list:
  """The ``top`` device operations by seconds (named as the breakdown
  names them), each with its seconds split by the innermost port span
  that launched it (``"(none)"``: outside every span)."""
  attributed = _attributed(events)
  if attributed is None:
    return []
  split = collections.defaultdict(collections.Counter)
  for names, seconds, op in attributed[1]:
    split[op][names[-1] if names else "(none)"] += seconds
  ranked = sorted(split.items(), key=lambda kv: -sum(kv[1].values()))
  return [[op, sum(by.values()), by.most_common(4)]
          for op, by in ranked[:top]]


def difference(after: dict, before: dict) -> dict:
  """The counters (``{name: {"count", "seconds"}}``) of ``after`` less
  those of ``before``."""
  return {name: {key: value - before.get(name, {}).get(key, 0)
                 for key, value in counts.items()}
          for name, counts in after.items()}


def per_nfe_ms(rec: dict, name: str, less: str | None = None):
  """Device ms of span ``name`` (less span ``less``'s) per network
  evaluation of the traced segment, or None where there is none."""
  spans = rec.get("spans") or {}
  nfe = (rec.get("trace_work") or {}).get("nfe")
  if name not in spans or not nfe:
    return None
  seconds = spans[name]["device_s"]
  if less is not None:
    seconds -= spans.get(less, {}).get("device_s", 0.0)
  return 1e3 * seconds / nfe


@contextlib.contextmanager
def recorded():
  """Inside, a run of ``harness.run_cell`` also records the port's
  counters over its untraced window and the port's spans of its traced
  segment, into the dict yielded (``program_counters``, ``spans``, and
  ``ops_by_span`` for reading the trace)."""
  from bench_port import harness
  from score_sde_pytorch_tpu_torch.utils import tracing
  found = {}
  measure, summarize = harness.measure_window, trace.summarize

  def measure_window(ctx, session, seconds):
    before = tracing.counters()
    out = measure(ctx, session, seconds)
    found["program_counters"] = difference(tracing.counters(), before)
    return out

  def summarize_with_spans(events):
    found["spans"] = reduce(events)
    found["ops_by_span"] = ops_by_span(events)
    return summarize(events)

  harness.measure_window, trace.summarize = measure_window, summarize_with_spans
  try:
    yield found
  finally:
    harness.measure_window, trace.summarize = measure, summarize


def readings(rec: dict) -> dict:
  """The six readers' values on ``rec`` (those that find something)."""
  from bench_port import registry
  out = {}
  for name in READERS:
    value = registry.metric_reader("layer_metrics", name).read(rec, {})
    if value is not None:
      out[name] = value
  return out


def main(argv=None) -> int:
  from bench_port import harness, run
  records = []
  run_cell = harness.run_cell

  def keep(*args, **kwargs):
    records.append(run_cell(*args, **kwargs))
    return records[-1]

  harness.run_cell = keep
  try:
    with recorded() as found:
      code = run.main(argv)
  finally:
    harness.run_cell = run_cell
  if records:
    rec = {**records[0], **found}
    print(json.dumps({"program": {**found, "readings": readings(rec)}}),
          flush=True)
  return code


if __name__ == "__main__":
  sys.exit(main())
