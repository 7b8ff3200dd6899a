"""The traced segment of a ``--trace 1`` run and its reduction.

A few whole blocks of the cell's work run under ``torch.profiler`` (host
and CUDA activity) inside a ``bench_port.window`` span that ends with a
synchronize. The Chrome trace is written to the run's temporary directory,
read back and deleted. From it: the device intervals (kernels, copies,
sets) inside the window, their count, their union (busy time), the device
operations that took most time, the idle gaps named by what the main host
thread was doing in them, and the device time of the kernels launched
inside the benchmark's own attention spans (:class:`AttentionSpans`).
"""
from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile

import torch

WINDOW = "bench_port.window"
ATTN_FWD = "bench_port.attention.fwd"
ATTN_BWD = "bench_port.attention.bwd"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_NAME = 160  # characters of a kernel's name kept in the breakdown
_HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
              "python_function")


class AttentionSpans:
  """Wraps the program's attention entry and its backward launcher in
  spans of the benchmark's own, recording each call's shapes, while
  active. The program's code is not touched: the module attributes are
  swapped and put back."""

  def __init__(self):
    self.calls = []
    self._saved = []

  def __enter__(self):
    from torch.profiler import record_function

    from score_sde_pytorch_tpu_torch.ops import attention as mod
    calls = self.calls

    def shape(q, k, backward):
      return (int(q.shape[0]), int(q.shape[1]), int(k.shape[1]),
              int(q.shape[2]), str(q.dtype).replace("torch.", ""), backward)

    def wrap(name, span, backward):
      fn = getattr(mod, name, None)
      if fn is None:
        return

      def wrapped(q, k, v, *rest):
        if q.is_cuda:
          calls.append(shape(q, k, backward))
        with record_function(span):
          return fn(q, k, v, *rest)

      self._saved.append((name, fn))
      setattr(mod, name, wrapped)

    wrap("attention", ATTN_FWD, False)
    wrap("_launch_flash_attention_backward", ATTN_BWD, True)
    self._mod = mod
    return self

  def __exit__(self, *exc):
    for name, fn in self._saved:
      setattr(self._mod, name, fn)
    self._saved = []


def run(blocks) -> tuple:
  """Runs ``blocks()`` (which returns the work it did) under the profiler;
  returns ``(work, summary, attention_calls)``."""
  from torch.profiler import ProfilerActivity, profile, record_function
  acts = [ProfilerActivity.CPU]
  if torch.cuda.is_available():
    acts.append(ProfilerActivity.CUDA)
  with AttentionSpans() as spans, profile(activities=acts) as prof:
    with record_function(WINDOW):
      work = blocks()
      if torch.cuda.is_available():
        torch.cuda.synchronize()
  with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
      events = json.load(f)["traceEvents"]
  return work, summarize(events), list(spans.calls)


def _union(intervals):
  total, end = 0.0, None
  for s, e in sorted(intervals):
    if end is None or s > end:
      total += e - s
      end = e
    elif e > end:
      total += e - end
      end = e
  return total


def _merged(intervals):
  out = []
  for s, e in sorted(intervals):
    if out and s <= out[-1][1]:
      out[-1][1] = max(out[-1][1], e)
    else:
      out.append([s, e])
  return out


def _name_gaps(gaps, host_events):
  """Each gap ``(start, end)`` named by the innermost host event of the
  main thread that holds its midpoint; seconds summed per name."""
  events = sorted(host_events, key=lambda e: (e[0], -e[1]))
  totals = collections.Counter()
  stack, i = [], 0
  for start, end in sorted(gaps, key=lambda g: g[0] + g[1]):
    mid = 0.5 * (start + end)
    while i < len(events) and events[i][0] <= mid:
      while stack and stack[-1][1] <= events[i][0]:
        stack.pop()
      stack.append(events[i])
      i += 1
    while stack and stack[-1][1] < mid:
      stack.pop()
    name = stack[-1][2] if stack else "(python between ops)"
    totals[name] += (end - start) * 1e-6
  return totals


def summarize(events: list) -> dict:
  """The window's device record from Chrome trace events (times in µs)."""
  windows = [e for e in events if e.get("name") == WINDOW
             and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
  if not windows:
    return {}
  win = windows[0]
  w0, w1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
  device = []
  for e in events:
    if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS:
      s, d = float(e["ts"]), float(e.get("dur", 0.0))
      if s + d > w0 and s < w1:
        device.append((max(s, w0), min(s + d, w1), e))
  busy = _union([(s, e) for s, e, _ in device])
  by_name = collections.Counter()
  for s, e, ev in device:
    by_name[ev.get("name", "?")[:_NAME]] += (e - s) * 1e-6
  merged = _merged([(s, e) for s, e, _ in device])
  gaps, cursor = [], w0
  for s, e in merged:
    if s > cursor:
      gaps.append((cursor, s))
    cursor = max(cursor, e)
  if w1 > cursor:
    gaps.append((cursor, w1))
  main = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
           e.get("name", "?")) for e in events
          if e.get("ph") == "X" and e.get("cat") in _HOST_CATS
          and e.get("tid") == win.get("tid") and e.get("pid") == win.get("pid")
          and e.get("name") != WINDOW]
  idle = _name_gaps(gaps, main)
  return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy * 1e-6,
          "launches": len(device),
          "device_ops": by_name.most_common(10),
          "idle_gaps": idle.most_common(10),
          "attention_device_s": _attention_seconds(events)}


def _attention_seconds(events: list) -> float:
  """Device seconds of the kernels launched inside the attention spans:
  the launches (runtime calls) that fall inside a span on its thread,
  matched to their kernels by correlation id."""
  spans = collections.defaultdict(list)
  for e in events:
    if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
        and e.get("name") in (ATTN_FWD, ATTN_BWD)):
      spans[(e.get("pid"), e.get("tid"))].append(
          (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
  if not spans:
    return 0.0
  for key in spans:
    spans[key].sort()
  starts = {key: [s for s, _ in v] for key, v in spans.items()}
  ids = set()
  for e in events:
    key = (e.get("pid"), e.get("tid"))
    if (e.get("ph") != "X" or key not in spans
        or e.get("cat") not in ("cuda_runtime", "cuda_driver")):
      continue
    ts = float(e["ts"])
    i = bisect.bisect_right(starts[key], ts) - 1
    if i >= 0 and ts <= spans[key][i][1]:
      ids.add(e.get("args", {}).get("correlation"))
  ids.discard(None)
  if ids:
    return sum(float(e.get("dur", 0.0)) * 1e-6 for e in events
               if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS
               and e.get("args", {}).get("correlation") in ids)
  # No launch seen inside a span (the profiler did not record the runtime
  # calls of the kernels' library): the attention kernels by name.
  return sum(float(e.get("dur", 0.0)) * 1e-6 for e in events
             if e.get("ph") == "X" and e.get("cat") == "kernel"
             and "attention" in e.get("name", ""))
