"""CPU tests of the port's benchmark: its files found by name, a new cell
added by files alone, the reference against the program at a tiny size,
the result line's keys, import isolation and the FLOP and byte counters.

Run: ``python -m pytest bench_port/tests -q`` (the ``cuda``-marked tests
skip without a card; on the card they hold the control and the planted
faults to the cells' limits).
"""
from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from bench_port import faults, harness, registry
from bench_port.counters import attention as attention_counter
from bench_port.counters import ncsnpp as ncsnpp_counter

ROOT = Path(__file__).resolve().parents[2]
BENCH = registry.benchmark()
TINY = {"model": {"nf": 16, "ch_mult": [1, 2], "num_res_blocks": 1,
                  "attn_resolutions": [8]},
        "data": {"image_size": 16},
        "training": {"batch_size": 4}, "eval": {"batch_size": 6}}
CELLS = [w["name"] for w in BENCH["workloads"]]


def tiny_run(name: str, fault=None, seed=2 ** 31 + 7) -> dict:
  torch.set_num_threads(4)
  cell = registry.cell(name, BENCH)
  return harness.run_cell(cell, registry.config(cell["config"]), seed, 0.0,
                          True, "cpu", overrides=TINY, fault=fault)


def test_every_piece_is_found_by_name():
  for w in BENCH["workloads"]:
    cell = registry.cell(w["name"], BENCH)
    assert registry.config(cell["config"])["config"]
    assert hasattr(registry.mode(cell["mode"]), "Session")
  for c in BENCH["configs"]:
    assert (ROOT / c["file"]).is_file()
    assert registry.config(c["name"])["source"] == c["source"]
  for m in BENCH["end_to_end"]:
    assert hasattr(registry.metric_reader("end_to_end", m["name"]), "read")
  for m in BENCH["per_layer"]:
    assert hasattr(registry.metric_reader("layer_metrics", m["name"]), "read")


def test_every_cell_reports_its_metrics():
  for name in CELLS:
    e2e = registry.metrics_of(name, BENCH, per_layer=False)
    layers = registry.metrics_of(name, BENCH, per_layer=True)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert layers


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_program_at_a_tiny_size(name):
  rec = tiny_run(name)
  assert rec["checks"], rec
  assert rec["correct"], rec["checks"]
  assert rec["failed"] == 0


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_a_planted_fault_is_not_correct(name, fault):
  rec = tiny_run(name, fault=fault)
  assert not rec["correct"], rec["checks"]
  assert not faults._undo


def test_a_new_cell_needs_only_new_files(tmp_path):
  copy = tmp_path / "checkout"
  shutil.copytree(ROOT / "bench_port", copy / "bench_port",
                  ignore=shutil.ignore_patterns("__pycache__", ".cache"))
  bench = json.loads((ROOT / "BENCHMARK.json").read_text())
  config = json.loads(
      (ROOT / "bench_port/configs/cifar10_ncsnpp.json").read_text())
  for section, values in TINY.items():
    config["config"][section].update(values)
  (copy / "bench_port/configs/tiny_ncsnpp.json").write_text(json.dumps(config))
  (copy / "bench_port/workloads/tiny_ncsnpp.train_b4.json").write_text(
      json.dumps({"config": "tiny_ncsnpp", "traffic": "train_b4",
                  "mode": "train", "why": "a test cell",
                  "limits": {"loss_gap": 1e-3, "grad_gap": 1e-3,
                             "change_gap": 1e-2, "ema_gap": 1e-2}}))
  bench["configs"].append({"name": "tiny_ncsnpp", "source": "test",
                           "file": "bench_port/configs/tiny_ncsnpp.json",
                           "reduced": [], "why": "test"})
  bench["workloads"].append({"name": "tiny_ncsnpp.train_b4",
                             "config": "tiny_ncsnpp", "traffic": "train_b4",
                             "chips": 1, "why": "test"})
  for m in bench["end_to_end"] + bench["per_layer"]:
    if "train_b128" in str(m.get("workloads")):
      m["workloads"].append("tiny_ncsnpp.train_b4")
  (copy / "BENCHMARK.json").write_text(json.dumps(bench))
  code = (
      "import sys, json, torch; torch.set_num_threads(4)\n"
      f"sys.path[:0] = [{str(copy)!r}, {str(ROOT)!r}]\n"
      "from bench_port import harness, registry\n"
      "import bench_port; assert bench_port.__file__.startswith("
      f"{str(copy)!r})\n"
      "b = registry.benchmark(); c = registry.cell('tiny_ncsnpp.train_b4', b)\n"
      "r = harness.run_cell(c, registry.config('tiny_ncsnpp'), 3, 0.0, False,"
      " 'cpu')\n"
      "m = harness.metrics(r, 'tiny_ncsnpp.train_b4', b, False, 'cpu')\n"
      "print(json.dumps({'correct': r['correct'], 'metrics': sorted(m)}))\n")
  out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=tmp_path, timeout=300)
  assert out.returncode == 0, out.stderr[-3000:]
  last = json.loads(out.stdout.strip().splitlines()[-1])
  assert last == {"correct": True,
                  "metrics": ["setup_s", "train_images_per_s"]}


def test_the_last_line_has_the_contract_keys():
  from bench_port import run
  rec = tiny_run("cifar10_ncsnpp.train_b128")
  rec["trace"].update(busy_s=0.5, window_s=1.0)
  for traced in (False, True):
    line = run.result_line(rec, "cifar10_ncsnpp.train_b128", BENCH, traced,
                           "cpu", 1)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown"] if traced else []
    assert list(line) == keys + ["checks"]
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for check in line["checks"].values():
      assert set(check) == {"value", "limit"}
    json.dumps(line)


def test_a_run_loads_neither_jax_nor_the_jax_package():
  code = ("import sys, torch; torch.set_num_threads(4)\n"
          f"sys.path.insert(0, {str(ROOT)!r})\n"
          "from bench_port.tests import test_bench_port_harness as t\n"
          "for name in t.CELLS: t.tiny_run(name)\n"
          "from bench_port import harness\n"
          "print(harness.banned_modules())\n")
  out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=ROOT)
  assert out.returncode == 0, out.stderr[-3000:]
  assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_banned_names_are_compared_whole(monkeypatch):
  monkeypatch.setitem(sys.modules, "score_sde_pytorch_tpu.sde", object())
  assert harness.banned_modules() == ["score_sde_pytorch_tpu"]
  monkeypatch.delitem(sys.modules, "score_sde_pytorch_tpu.sde")
  monkeypatch.setitem(sys.modules, "jaxlike", object())
  assert "score_sde_pytorch_tpu" not in harness.banned_modules()
  assert "jaxlike" not in harness.banned_modules()


def test_the_reference_imports_nothing_of_the_program():
  for path in (ROOT / "bench_port/reference").glob("*.py"):
    for node in ast.walk(ast.parse(path.read_text())):
      names = []
      if isinstance(node, ast.Import):
        names = [a.name for a in node.names]
      elif isinstance(node, ast.ImportFrom):
        names = [node.module or ""]
      for name in names:
        assert name.split(".")[0] not in (
            "score_sde_pytorch_tpu_torch", "score_sde_pytorch_tpu", "jax",
            "jaxlib", "flax"), (path, name)
  code = ("import sys\n"
          f"sys.path.insert(0, {str(ROOT)!r})\n"
          "sys.modules['score_sde_pytorch_tpu_torch'] = None\n"
          "import torch\n"
          "from bench_port import weights\n"
          "from bench_port.reference import data, ncsnpp, sampling, train\n"
          "from bench_port.tests import test_bench_port_harness as t\n"
          "print('ok')\n")
  out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=ROOT)
  assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("shape,ms", [((64, 256, 256, 256), 0.0200),
                                      ((1024, 256, 256, 256), 0.3205)])
def test_attention_bound_is_perf_md_table(shape, ms):
  seconds, by = attention_counter.bound_seconds(
      *shape, "float32", False, "NVIDIA H100 80GB HBM3")
  assert by == "bytes"
  assert round(seconds * 1e3, 4) == ms


def test_ncsnpp_forward_flops_match_the_flop_counter():
  from torch.utils.flop_counter import FlopCounterMode

  from bench_port import program
  config_file = registry.config("cifar10_ncsnpp")
  plain = config_file["config"]
  cfg = program.port_config(config_file, plain, 0)
  torch.set_num_threads(4)
  model = program.build_model(cfg, plain, 0, "cpu")
  x = torch.rand(1, 3, 32, 32)
  with FlopCounterMode(display=False) as counter, torch.no_grad():
    model(x, torch.tensor([1.0]))
  assert counter.get_total_flops() == ncsnpp_counter.forward_flops(plain, 1)


def test_ncsnpp_flops_of_the_pyramids_match_the_flop_counter():
  from torch.utils.flop_counter import FlopCounterMode

  from bench_port import program
  config_file = registry.config("cifar10_ncsnpp")
  plain = program.merged(config_file["config"], {
      "model": {"nf": 16, "ch_mult": [1, 1, 2], "num_res_blocks": 1,
                "attn_resolutions": [8], "progressive": "output_skip",
                "progressive_input": "input_skip"}})
  cfg = program.port_config(config_file, plain, 0)
  model = program.build_model(cfg, plain, 0, "cpu")
  with FlopCounterMode(display=False) as counter, torch.no_grad():
    model(torch.rand(2, 3, 32, 32), torch.tensor([1.0, 2.0]))
  assert counter.get_total_flops() == ncsnpp_counter.forward_flops(plain, 2)


@pytest.fixture
def cuda_device():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device")
  return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(cuda_device, name):
  """The program's own path in the precision below the configuration's,
  at a size a test can hold, held to the cell's limits."""
  cell = registry.cell(name, BENCH)
  for seed in (11, 12, 13):
    rec = harness.run_cell(
        cell, registry.config(cell["config"]), seed, 0.0, False, "cuda",
        overrides={**TINY, "model": {**TINY["model"], "dtype": "bfloat16"}})
    assert not rec["correct"], rec["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_a_planted_fault_is_not_correct_on_the_card(cuda_device, name, fault):
  cell = registry.cell(name, BENCH)
  rec = harness.run_cell(cell, registry.config(cell["config"]), 5, 0.0,
                         False, "cuda", overrides=TINY, fault=fault)
  assert not rec["correct"], rec["checks"]
