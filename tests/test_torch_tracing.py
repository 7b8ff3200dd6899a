"""The port's spans and counters (``utils/tracing.py``) on the CPU.

Under ``torch.profiler``, one train step, one eval step, one batch of the
prefetching iterator and one 2-level PC chain of a tiny flagship NCSN++
emit exactly the port's spans, each under its parent and with its args;
every GroupNorm of the network sits in an ``op.norm_act`` span and every
FIR filter in an ``op.fir`` span, whatever the resblocks and pyramids;
each U-Net level and each pyramid step sits in its own span.
With no profiler recording, no ``record_function`` is entered and the
counters still count; the train loop logs them per step.
"""
import collections
import logging
import re
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch
from torch.profiler import profile

from score_sde_pytorch_tpu_torch import (configs, datasets, losses, run_lib,
                                         sampling)
from score_sde_pytorch_tpu_torch import sde as sde_lib
from score_sde_pytorch_tpu_torch.models import layers, layerspp
from score_sde_pytorch_tpu_torch.models import utils as mutils
from score_sde_pytorch_tpu_torch.ops import upfirdn2d
from score_sde_pytorch_tpu_torch.utils import tracing
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

FLAGSHIP = str(Path(__file__).resolve().parents[1]
               / "score_sde_pytorch_tpu_torch" / "configs" / "ve"
               / "cifar10_ncsnpp_continuous.py")
TINY = ["model.nf=16", "model.ch_mult=(1,2)", "model.num_res_blocks=1",
        "model.attn_resolutions=(4,)", "data.image_size=8",
        "model.num_scales=2", "training.batch_size=2", "eval.batch_size=2"]
# Each span and the program span it sits in (None: none).
PARENTS = {
    "train.step": {None}, "train.loss": {"train.step"},
    "train.backward": {"train.step"}, "train.optimize": {"train.step"},
    "train.ema": {"train.step"}, "eval.step": {None}, "data.next": {None},
    "pc.step": {None}, "pc.corrector": {"pc.step"},
    "pc.predictor": {"pc.step"},
    "ncsnpp.forward": {"train.loss", "eval.step", "pc.corrector",
                       "pc.predictor"},
    "op.norm_act": {"ncsnpp.forward"}, "op.fir": {"ncsnpp.forward"},
    "op.attention": {"ncsnpp.forward"},
}


def _config(*extra):
  return configs.load_config(FLAGSHIP, TINY + list(extra))


class _Program:
  """The tiny flagship's train and eval steps, data and PC sampler."""

  def __init__(self, *extra):
    config = self.config = _config(*extra)
    self.model = mutils.create_model(config, "cpu",
                                     torch.Generator().manual_seed(0))
    self.state = losses.init_train_state(config, self.model, "cpu")
    sde = sde_lib.build_sde(config)
    self.train = losses.get_step_fn(
        sde, train=True, optimize_fn=losses.optimization_manager(config),
        continuous=True)
    self.eval = losses.get_step_fn(sde, train=False, continuous=True)
    self.data = datasets.DatasetIterator(
        np.zeros((4, 8, 8, 3), np.uint8), 2, random_flip=False,
        uniform_dequantization=False, shuffle=False, seed=0)
    self.sampler = sampling.get_sampling_fn(
        config, sde, self.model, (2, 8, 8, 3),
        datasets.get_data_inverse_scaler(config), device="cpu")

  def batch(self):
    return torch.from_numpy(next(self.data)).permute(0, 3, 1, 2)

  def run(self, train_steps: int = 1) -> None:
    """A batch and ``train_steps`` train steps, an eval step, a chain."""
    gen = torch.Generator().manual_seed(1)
    batch = self.batch()
    for _ in range(train_steps):
      self.train(self.state, batch, gen)
    self.eval(self.state, batch, gen)
    self.sampler(gen)


@pytest.fixture(scope="module")
def program():
  return _Program()


def _program_spans(prof) -> list:
  """``(name, parent)`` of each of the port's spans in ``prof``, the parent
  the innermost enclosing span of the port (None where there is none)."""
  out = []
  for e in prof.events():
    if e.name not in PARENTS:
      continue
    parent = e.cpu_parent
    while parent is not None and parent.name not in PARENTS:
      parent = parent.cpu_parent
    out.append((e.name, None if parent is None else parent.name))
  return out


def _recording_args(monkeypatch) -> list:
  """``(name, args)`` of every ``record_function`` the port enters from
  now on; the real one still runs."""
  entered, real = [], torch.profiler.record_function

  def record(name, args=None):
    entered.append((name, args))
    return real(name, args)

  monkeypatch.setattr(torch.profiler, "record_function", record)
  return entered


def test_a_profiled_run_emits_exactly_the_spans_under_their_parents(
    program, monkeypatch):
  program.run()  # first calls outside the profile
  entered = _recording_args(monkeypatch)
  step = program.state["step"]
  with profile() as prof:
    program.run()
  spans = _program_spans(prof)
  assert {name for name, _ in spans} == set(PARENTS)
  for name, parent in spans:
    assert parent in PARENTS[name], (name, parent)
  counts = collections.Counter(name for name, _ in spans)
  forwards = 1 + 1 + 2 * 2  # train, eval, 2 levels of corrector + predictor
  modules = list(program.model.modules())
  norms = sum(isinstance(m, layers.GroupNorm) for m in modules)
  attns = sum(isinstance(m, layerspp.AttnBlockpp) for m in modules)
  assert counts["ncsnpp.forward"] == forwards
  assert counts["op.norm_act"] == forwards * norms
  assert counts["op.attention"] == forwards * attns
  assert counts["pc.step"] == counts["pc.corrector"] == 2
  args = collections.defaultdict(list)
  for name, arg in entered:
    args[name].append(arg)
  assert args["train.step"] == [str(step)]
  for name in ("pc.step", "pc.corrector", "pc.predictor"):
    assert args[name] == ["0", "1"]
  assert {a for name, a in entered if not name.startswith(("train.step",
                                                           "pc."))} == {None}


@pytest.mark.parametrize("extra", [
    (),
    ("model.resblock_type=ddpm", "model.progressive=output_skip",
     "model.progressive_input=input_skip"),
    ("model.progressive=residual", "model.progressive_input=none"),
])
def test_every_norm_and_fir_filter_of_a_forward_is_spanned(extra):
  """One forward: an ``op.norm_act`` span per GroupNorm of the network and
  an ``op.fir`` span per call of the filter every FIR path reaches."""
  model = mutils.create_model(_config(*extra), "cpu",
                              torch.Generator().manual_seed(0))
  x = torch.rand(2, 3, 8, 8)
  with (mock.patch.object(upfirdn2d, "_upfirdn",
                          wraps=upfirdn2d._upfirdn) as fir,
        torch.no_grad(), profile() as prof):
    model(x, torch.full((2,), 0.5))
  counts = collections.Counter(name for name, _ in _program_spans(prof))
  norms = sum(isinstance(m, layers.GroupNorm) for m in model.modules())
  assert counts["ncsnpp.forward"] == 1
  assert counts["op.norm_act"] == norms > 0
  assert counts["op.fir"] == fir.call_count > 0


LEVELS = ("model.ch_mult=(1,2,2)", "data.image_size=16")


@pytest.mark.parametrize("extra", [
    ("model.progressive=output_skip", "model.progressive_input=input_skip"),
    (),  # the flagship's layout: a residual input pyramid, no output pyramid
])
def test_the_levels_and_pyramids_of_a_forward_are_spanned(extra):
  """One forward at 16², 8² and 4²: each level's span opens on the way
  down and on the way up, the first level's also around ``conv_in`` (and
  the output head without an output pyramid), the last's around the
  middle blocks; one ``ncsnpp.pyramid`` span per pyramid step, inside a
  level's span."""
  config = _config(*LEVELS, *extra)
  model = mutils.create_model(config, "cpu", torch.Generator().manual_seed(0))
  with torch.no_grad(), profile() as prof:
    model(torch.rand(2, 3, 16, 16), torch.full((2,), 0.5))
  names = {"ncsnpp.forward", "ncsnpp.pyramid", "ncsnpp.res16", "ncsnpp.res8",
           "ncsnpp.res4"}
  counts, parents = collections.Counter(), collections.defaultdict(set)
  for e in prof.events():
    if e.name in names:
      counts[e.name] += 1
      parent = e.cpu_parent
      while parent is not None and parent.name not in names:
        parent = parent.cpu_parent
      parents[e.name].add(None if parent is None else parent.name)
  head = config.model.progressive != "output_skip"
  assert counts == {"ncsnpp.forward": 1, "ncsnpp.res16": 3 + head,
                    "ncsnpp.res8": 2, "ncsnpp.res4": 3,
                    "ncsnpp.pyramid": 2 + 3 * (not head)}
  assert parents["ncsnpp.pyramid"] <= {"ncsnpp.res16", "ncsnpp.res8",
                                       "ncsnpp.res4"}
  for name in ("ncsnpp.res16", "ncsnpp.res8", "ncsnpp.res4"):
    assert parents[name] == {"ncsnpp.forward"}


def test_without_a_profiler_no_span_is_entered_and_the_counters_count(
    program, monkeypatch):
  entered = _recording_args(monkeypatch)
  before = tracing.counters()
  program.run(train_steps=2)
  after = tracing.counters()
  assert entered == []

  def count(name):
    return after[name]["count"] - before.get(name, {}).get("count", 0)

  for name in ("train.step", "train.loss", "train.backward",
               "train.optimize", "train.ema"):
    assert count(name) == 2, name
  assert count("eval.step") == 1 and count("data.wait") == 1
  for name in after:
    assert after[name]["seconds"] >= before.get(name, {}).get("seconds", 0)
  assert (after["train.step"]["seconds"] - before["train.step"]["seconds"]
          > after["train.loss"]["seconds"] - before["train.loss"]["seconds"]
          > 0)


def test_a_span_off_the_profiler_is_one_shared_no_op():
  assert tracing.span("op.fir") is tracing.span("train.step", 3)
  with tracing.counted("test.block") as block:
    pass
  assert block.name == "test.block"
  assert tracing.counters()["test.block"]["count"] >= 1


def test_the_train_log_line_gives_the_counters_per_step(tmp_path, caplog):
  assert run_lib._host_ms_per_step(
      {"train.step": {"count": 2, "seconds": 1.0},
       "data.wait": {"count": 2, "seconds": 0.1}},
      {"train.step": {"count": 6, "seconds": 1.8},
       "data.wait": {"count": 7, "seconds": 0.14}}) == pytest.approx(
           (200.0, 10.0))
  with caplog.at_level(logging.INFO):
    run_lib.train(_config("training.n_iters=2", "training.n_jitted_steps=1",
                          "training.log_freq=1", "training.eval_freq=100",
                          "training.snapshot_freq=100",
                          "training.snapshot_freq_for_preemption=100",
                          "training.snapshot_sampling=False"),
                  str(tmp_path), device="cpu")
  lines = re.findall(r"s/step\), host ([\d.]+) ms/step in the step "
                     r"function, data wait ([\d.]+) ms/step", caplog.text)
  assert len(lines) == 2 and all(float(host) > 0 for host, _ in lines)
  # On the CPU every resblock call of a train step runs eagerly.
  assert len(re.findall(r"ms/step, resblock calls replayed 0\.0%",
                        caplog.text)) == 2
