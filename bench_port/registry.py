"""Finds the benchmark's pieces by name.

Everything that belongs to one configuration, one cell, one mode or one
metric is a file of its own under ``bench_port/``:

- ``configs/<config>.json``: the configuration as it is run;
- ``workloads/<cell>.json``: a cell's traffic (its mode and parameters);
- ``modes/<mode>.py``: the generator of one kind of traffic;
- ``end_to_end/<metric>.py`` and ``layer_metrics/<metric>.py``: a reader
  for each metric. A metric ``base.split`` (``mfu.train``) is read by
  ``<base.split>.py`` where that file exists, else by ``<base>.py``.

``BENCHMARK.json`` at the root of the checkout says which cells exist and
which metrics each cell reports. A new cell, configuration or metric is a
new file and a new entry there; no file is edited.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"


def read_json(path: Path) -> dict:
  with open(path) as f:
    return json.load(f)


def benchmark(path: Path = BENCHMARK) -> dict:
  return read_json(path)


def cell(name: str, bench: dict) -> dict:
  """The ``workloads`` entry of BENCHMARK.json and the cell's traffic
  file, merged: ``name``, ``config``, ``traffic``, ``chips``, ``mode`` and
  the mode's parameters."""
  entries = [w for w in bench["workloads"] if w["name"] == name]
  if len(entries) != 1:
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")
  entry = entries[0]
  traffic = read_json(HERE / "workloads" / f"{name}.json")
  for key in ("config", "traffic"):
    if traffic[key] != entry[key]:
      raise ValueError(f"workloads/{name}.json says {key}={traffic[key]!r}, "
                       f"BENCHMARK.json {entry[key]!r}")
  return {**traffic, "name": name, "chips": entry["chips"]}


def config(name: str) -> dict:
  return read_json(HERE / "configs" / f"{name}.json")


def _load(path: Path, module_name: str):
  spec = importlib.util.spec_from_file_location(module_name, path)
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


def mode(name: str):
  path = HERE / "modes" / f"{name}.py"
  if not path.is_file():
    raise FileNotFoundError(f"no mode {name!r} ({path})")
  return _load(path, f"bench_port.modes.{name}")


def metric_reader(kind: str, name: str):
  """The module that reads metric ``name``; ``kind`` is ``end_to_end`` or
  ``layer_metrics``."""
  folder = HERE / kind
  for stem in (name, name.split(".")[0]):
    path = folder / f"{stem}.py"
    if path.is_file():
      return _load(path, f"bench_port.{kind}.{stem.replace('.', '_')}")
  raise FileNotFoundError(f"no reader for {kind} metric {name!r}")


def metrics_of(cell_name: str, bench: dict, per_layer: bool) -> list:
  """The metrics a cell reports: the end-to-end ones whose ``workloads``
  name it (or that have none), or the per-layer ones likewise, keeping to
  those that move an end-to-end metric the cell reports."""
  def applies(m):
    return "workloads" not in m or cell_name in m["workloads"]

  e2e = [m for m in bench["end_to_end"] if applies(m)]
  if not per_layer:
    return e2e
  names = {m["name"] for m in e2e}
  return [m for m in bench["per_layer"]
          if applies(m) and m["moves"] in names]
