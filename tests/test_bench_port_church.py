"""The benchmark's LSUN church 256² NCSN++ training cell on the CPU.

The cell ``church256_ncsnpp_h100.train_b24`` at a tiny size (16² images,
two levels, batch 4; its input and output pyramids kept) is correct
against the plain reference (``bench_port/reference/``), and each planted
fault of ``bench_port/faults.py`` is not; its mode ``train_grads`` adds
``grad_diff``, the worst leaf's norm of the gradients' difference; a run
loads neither JAX nor the JAX package; the cell reports its metrics, and
the level-span readers read a traced run's spans.
"""
from __future__ import annotations

import importlib
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from bench_port import faults, harness, level_spans, registry, spans
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
CELL = "church256_ncsnpp_h100.train_b24"
TINY = {"model": {"nf": 16, "ch_mult": [1, 2], "num_res_blocks": 1,
                  "attn_resolutions": [8]},
        "data": {"image_size": 16}, "training": {"batch_size": 4}}
SEED = 2 ** 31 + 11


def tiny_run(fault=None, traced=False) -> dict:
  bench = registry.benchmark()
  cell = registry.cell(CELL, bench)
  return harness.run_cell(cell, registry.config(cell["config"]), SEED, 0.0,
                          traced, "cpu", overrides=TINY, fault=fault)


def test_the_cell_keeps_its_pyramids_and_reports_its_metrics():
  model = registry.config("church256_ncsnpp_h100")["config"]["model"]
  assert (model["progressive"], model["progressive_input"]) == (
      "output_skip", "input_skip")
  bench = registry.benchmark()
  e2e = {m["name"] for m in registry.metrics_of(CELL, bench, False)}
  layers = {m["name"] for m in registry.metrics_of(CELL, bench, True)}
  assert e2e == {"train_images_per_s", "setup_s"}
  assert layers == {f"{base}.train256" for base in (
      "mfu", "idle_share", "launches_per_step", "attention_roofline",
      "peak_gib")}


def test_the_tiny_cell_is_correct_against_the_reference():
  rec = tiny_run()
  checks = {c["name"]: c for c in rec["checks"]}
  assert set(checks) == {"loss_gap", "grad_gap", "change_gap", "ema_gap",
                         "grad_diff"}
  assert rec["correct"], checks
  assert rec["failed"] == 0 and rec["work"]["images"] == 5 * 4


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_a_planted_fault_is_not_correct(fault):
  rec = tiny_run(fault=fault)
  checks = {c["name"]: c for c in rec["checks"]}
  assert not rec["correct"], checks
  assert checks["grad_diff"]["value"] > checks["grad_diff"]["limit"]
  assert not faults._undo


def test_grad_diff_is_zero_on_equal_gradients_and_grows_with_one_leaf():
  grads_mode = registry.mode("train_grads")
  gen = torch.Generator().manual_seed(0)
  ref = [torch.randn(shape, generator=gen)
         for shape in ((8, 4), (16,), (3, 3, 2), (5,))]
  assert grads_mode.grad_diff([r.clone() for r in ref], ref) == 0.0
  noise = torch.randn(ref[2].shape, generator=gen)
  readings = []
  for scale in (1e-6, 1e-4, 1e-2):
    program = [r.clone() for r in ref]
    program[2] += scale * noise
    readings.append(grads_mode.grad_diff(program, ref))
  assert 0 < readings[0] < readings[1] < readings[2]
  norms = sorted(float(torch.linalg.vector_norm(r)) for r in ref)
  want = 1e-2 * float(torch.linalg.vector_norm(noise)) / max(
      float(torch.linalg.vector_norm(ref[2])), norms[len(norms) // 2])
  assert readings[2] == pytest.approx(want, rel=1e-4)


def test_gradients_not_read_are_not_correct(monkeypatch):
  """Where the step hook reads no gradient (the parameters stepped
  outside ``Optimizer.step``), ``grad_diff`` is infinite and the run is
  not correct; so are gradients of other shapes."""
  grads_mode = registry.mode("train_grads")

  class _Handle:
    def remove(self):
      pass

  monkeypatch.setattr(importlib.import_module("torch.optim.optimizer"),
                      "register_optimizer_step_post_hook",
                      lambda hook: _Handle())
  rec = tiny_run()
  checks = {c["name"]: c for c in rec["checks"]}
  assert not rec["correct"] and checks["grad_diff"]["value"] == float("inf")
  ref = [torch.ones(4, 2), torch.ones(3)]
  assert grads_mode.grad_diff([], ref) == float("inf")
  assert grads_mode.grad_diff([torch.ones(8), torch.ones(3)], ref) == float(
      "inf")
  assert grads_mode.grad_diff(ref[:1], ref) == float("inf")


def test_a_run_loads_neither_jax_nor_the_jax_package():
  code = ("import sys, json, torch; torch.set_num_threads(1)\n"
          f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'tests')!r}]\n"
          "import test_bench_port_church as t\n"
          "rec = t.tiny_run()\n"
          "from bench_port import harness\n"
          "print(json.dumps([rec['correct'], harness.banned_modules(),\n"
          "                  'jax' in sys.modules]))\n")
  out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=ROOT)
  assert out.returncode == 0, out.stderr[-3000:]
  assert json.loads(out.stdout.strip().splitlines()[-1]) == [True, [], False]


def test_the_level_readers_read_a_traced_run(monkeypatch):
  """A traced run with the level spans recorded: one ``ncsnpp.pyramid``
  span per pyramid step of each forward (input 1, output 2 at two
  levels; one forward a train step), each level's spans; the readers give
  device ms a step (none on the CPU)."""
  monkeypatch.setattr(spans, "PROGRAM", spans.PROGRAM + level_spans.LEVELS)
  with spans.recorded() as found:
    rec = tiny_run(traced=True)
  rec = {**rec, **found}
  steps = rec["trace_work"]["steps"]
  assert rec["spans"]["ncsnpp.pyramid"]["count"] == 3 * steps
  assert rec["spans"]["ncsnpp.res16"]["count"] == 3 * steps
  assert rec["spans"]["ncsnpp.res8"]["count"] == 3 * steps
  for name in level_spans.READERS:
    reader = registry.metric_reader("layer_metrics", name)
    assert reader.read(rec, {}) == 0.0
    assert reader.read({**rec, "spans": {}}, {}) is None
