"""The reduction of a traced segment by the port's spans, the counters of
the untraced window, and the six readers of ``spans.py``: on synthetic
Chrome trace events, on tiny runs of both cells on the CPU, and (``cuda``)
on the card, where the readings have to agree with each other.

Run: ``python -m pytest bench_port/tests -q``.
"""
from __future__ import annotations

import pytest
import torch

from bench_port import harness, registry, spans, trace
from bench_port.tests.test_bench_port_harness import BENCH, TINY, tiny_run

TRAIN, SAMPLE = "cifar10_ncsnpp.train_b128", "cifar10_ncsnpp.sample_pc_b1024"


def _x(name, cat, ts, dur, tid=1, **args):
  return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
          "ts": ts, "dur": dur, "args": args}


def _span(name, ts, dur, tid=1):
  return _x(name, "user_annotation", ts, dur, tid)


def _launch(ts, corr, tid=1):
  return _x("cudaLaunchKernel", "cuda_runtime", ts, 2, tid, correlation=corr)


def _kernel(ts, dur, corr, cat="kernel"):
  return _x(f"k{corr}", cat, ts, dur, 7, correlation=corr)


# A train step on thread 1 and the autograd engine's thread 2 (with a
# recomputed norm under remat); µs. Kernel k4 was launched outside every
# span and k6 ends past the window, which clips it.
EVENTS = [
    _span(trace.WINDOW, 0, 1000),
    _span("train.step", 10, 500),
    _span("train.loss", 20, 100),
    _span("ncsnpp.forward", 25, 90),
    _span("op.norm_act", 30, 20),
    _launch(35, 1), _launch(60, 2),
    _span("train.backward", 150, 200),
    _launch(200, 3, tid=2),
    _span("op.norm_act", 295, 20, tid=2), _launch(300, 5, tid=2),
    _launch(600, 4),
    _span("pc.step", 700, 200), _launch(720, 6),
    _kernel(100, 10, 1), _kernel(120, 20, 2), _kernel(140, 4, 2, "gpu_memcpy"),
    _kernel(400, 40, 3), _kernel(610, 8, 4), _kernel(450, 16, 5),
    _kernel(990, 30, 6),
]


def test_device_time_goes_to_the_spans_that_launched_it():
  got = spans.reduce(EVENTS)
  us = {name: (s["count"], round(s["host_s"] * 1e6, 6),
               round(s["device_s"] * 1e6, 6),
               round(s["self_device_s"] * 1e6, 6))
        for name, s in got.items()}
  assert us == {
      "train.step": (1, 500, 10 + 24 + 40 + 16, 0),
      "train.loss": (1, 100, 10 + 24, 0),
      "ncsnpp.forward": (1, 90, 10 + 24, 24),
      "op.norm_act": (2, 40, 10 + 16, 10 + 16),
      "train.backward": (1, 200, 40 + 16, 40),
      "pc.step": (1, 200, 10, 10),
  }


def test_no_window_no_spans():
  assert spans.reduce(EVENTS[1:]) == {}


def test_the_summary_reads_the_same_with_the_program_spans():
  """trace.summarize's keys but the names of the idle gaps are the same
  with and without the port's spans; the gaps' seconds too."""
  host = [_x("aten::conv", "cpu_op", 30, 10), _x("aten::add", "cpu_op", 600,
                                                  5)]
  plain = [e for e in EVENTS if e["name"] not in spans.PROGRAM] + host
  with_spans = spans.reduce(EVENTS)
  a, b = trace.summarize(plain), trace.summarize(EVENTS + host)
  assert with_spans and set(a) == set(b)
  for key in a:
    if key != "idle_gaps":
      assert a[key] == b[key], key
  assert sum(s for _, s in a["idle_gaps"]) == pytest.approx(
      sum(s for _, s in b["idle_gaps"]))
  assert {n for n, _ in b["idle_gaps"]} & set(spans.PROGRAM)


def _reader(name):
  return registry.metric_reader("layer_metrics", name)


def test_the_six_readers():
  rec = {"program_counters": {"train.step": {"count": 10, "seconds": 2.0},
                              "data.wait": {"count": 12, "seconds": 0.01}},
         "spans": {"ncsnpp.forward": {"device_s": 0.8},
                   "op.norm_act": {"device_s": 0.2},
                   "op.fir": {"device_s": 0.1},
                   "pc.step": {"device_s": 0.9}},
         "trace_work": {"nfe": 4}}
  want = {"host_ms_per_step.train": 200.0,
          "data_wait_ms_per_step.train": 1.0,
          "network_ms_per_nfe.sample": 200.0,
          "norm_act_ms_per_nfe.sample": 50.0,
          "fir_ms_per_nfe.sample": 25.0,
          "sampler_ms_per_nfe.sample": 25.0}
  assert spans.readings(rec) == pytest.approx(want)
  # A program without the spans and counters: nothing, and no error.
  assert spans.readings({"trace_work": {"nfe": 4}, "work": {}}) == {}
  for name in spans.READERS:
    assert _reader(name).read({}, {}) is None


@pytest.mark.parametrize("name", [TRAIN, SAMPLE])
def test_a_tiny_traced_run_records_the_spans_and_counters(name):
  with spans.recorded() as found:
    rec = tiny_run(name)
  assert rec["correct"]
  got, counters = found["spans"], found["program_counters"]
  if name == TRAIN:
    steps = rec["trace_work"]["steps"]
    for span in ("train.step", "train.loss", "train.backward",
                 "train.optimize", "train.ema"):
      assert got[span]["count"] == steps, span
    assert counters["train.step"]["count"] == rec["work"]["steps"]
    assert counters["data.wait"]["count"] >= rec["work"]["steps"]
    host = _reader("host_ms_per_step.train").read({**rec, **found}, {})
    assert 0 < host <= 1e3 * rec["window_s"] / rec["work"]["steps"]
  else:
    levels = rec["trace_work"]["nfe"] // 2
    assert got["pc.step"]["count"] == got["pc.corrector"]["count"] == levels
    assert got["ncsnpp.forward"]["count"] == rec["trace_work"]["nfe"]
    assert counters.get("train.step", {}).get("count", 0) == 0
    assert _reader("host_ms_per_step.train").read({**rec, **found}, {}) \
        is None
  assert harness.metrics(rec, name, BENCH, True, "cpu").keys() == \
      harness.metrics({**rec, **found}, name, BENCH, True, "cpu").keys()


@pytest.mark.cuda
def test_on_the_card_the_readings_agree():
  """norm_act + fir <= network <= busy per evaluation, the sampler's time
  outside the network, and the host's ms a step inside the wall's."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device")
  out = {}
  for name in (TRAIN, SAMPLE):
    cell = registry.cell(name, BENCH)
    with spans.recorded() as found:
      rec = harness.run_cell(cell, registry.config(cell["config"]), 21, 2.0,
                             True, "cuda", overrides=TINY)
    out[name] = rec = {**rec, **found}
    out.update(spans.readings(rec))
  nfe = out[SAMPLE]["trace_work"]["nfe"]
  busy = 1e3 * out[SAMPLE]["trace"]["busy_s"] / nfe
  network = out["network_ms_per_nfe.sample"]
  assert 0 < out["norm_act_ms_per_nfe.sample"] + out["fir_ms_per_nfe.sample"] \
      <= network <= busy
  assert 0 <= out["sampler_ms_per_nfe.sample"] <= busy - network + 1e-9
  train = out[TRAIN]
  assert 0 < out["host_ms_per_step.train"] <= \
      1e3 * train["window_s"] / train["work"]["steps"]
