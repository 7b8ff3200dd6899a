"""Spans and counters of the port's hot paths.

``span(name, args)`` marks a block as a ``torch.profiler`` user
annotation, so that a trace (``training.trace_steps``, or any profiler the
caller runs) holds the block on the same clock as the kernels it
launched. It enters ``record_function`` only while a profiler is
recording: otherwise it returns one shared no-op context, and costs a
check of the profiler's state.

``counted(name)`` is a span that also adds the block's host seconds to a
process-wide counter of that name, with or without a profiler. The
counters sit at the train loop's boundaries (a few a step): ``train.step``
and its parts ``train.loss``, ``train.backward``, ``train.optimize``,
``train.ema``; ``eval.step``; ``data.wait``, the time the host waits for
the input pipeline's next batch; ``graph.replay`` around each replayed
resblock graph (``models/graphs.py``). ``count(name)`` adds to a count
alone: ``graph.eager``, ``graph.capture``, ``graph.capture_refused``,
``graph.capture_failed``; and, at each launch of a hand-written kernel
(``ops/``), ``kernel.attention.fwd`` (a forward launch),
``kernel.attention.bwd`` (a backward call: its three kernels),
``kernel.fused_act.fwd``, ``kernel.fused_act.bwd``, and
``kernel.group_norm.onchip_fwd``, ``.onchip_bwd``, ``.split_fwd``,
``.split_bwd`` (a call on each GroupNorm path). A CUDA graph's replay
launches its kernels without the Python that counts them: they count at
its capture. ``counters()`` returns the totals, ``count_of(name)`` one
count.
"""
from __future__ import annotations

import collections
import contextlib
import time

import torch

_recording = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()
_totals = collections.defaultdict(lambda: [0, 0.0])


def span(name: str, args=None):
  """A ``record_function(name, str(args))`` context while a profiler
  records, else a no-op one."""
  if not _recording():
    return _OFF
  return torch.profiler.record_function(
      name, None if args is None else str(args))


class counted:
  """``span(span_name or name, args)`` around a block whose host seconds
  (``time.perf_counter``) and count add to counter ``name``."""

  __slots__ = ("name", "span", "start")

  def __init__(self, name: str, span_name: str | None = None, args=None):
    self.name = name
    self.span = span(span_name or name, args)

  def __enter__(self):
    self.span.__enter__()
    self.start = time.perf_counter()
    return self

  def __exit__(self, *exc):
    total = _totals[self.name]
    total[0] += 1
    total[1] += time.perf_counter() - self.start
    return self.span.__exit__(*exc)


def count(name: str) -> None:
  """Adds one to counter ``name``'s count, and no seconds."""
  _totals[name][0] += 1


def count_of(name: str) -> int:
  """Counter ``name``'s count since the process started (0 before its
  first): the per-name reader that the kernel-launch checks of the tests
  and ``chip_smoke.py`` take differences of, without copying every
  counter as :func:`counters` does."""
  return _totals[name][0] if name in _totals else 0


def counters() -> dict:
  """``{name: {"count": n, "seconds": s}}``: the counters' totals since the
  process started."""
  return {name: {"count": n, "seconds": s}
          for name, (n, s) in list(_totals.items())}
