"""CUDA graphs of NCSN++'s resblocks in a train step (``models/graphs.py``).

On the CPU: every call that does not qualify runs the block eagerly, bit
for bit, and the ``graph.replay`` and ``graph.eager`` counters say so; a
call that qualifies goes to its graph. The conditions are taken one at a
time: the card is faked where a case needs it, and the graph is a stand-in.
A capture on a faked card without room is refused, and counted so.

On the card, with cuDNN's deterministic algorithms: five train steps with
the graphs and five eager ones from the same weights, batches, draws and
dropout seed agree in each step's loss and gradients and in the parameters
and the EMA after them; a batch of another shape, the eval loss and the PC
sampler run eagerly. A capture that fails (a block that synchronizes) or
is refused (a card without room for the graphs) leaves the steps eager and
as the eager run's, each counted under its own name.
"""
import contextlib
import gc
import types
from pathlib import Path

import pytest
import torch

from score_sde_pytorch_tpu_torch import (configs, datasets, losses, run_lib,
                                         sampling)
from score_sde_pytorch_tpu_torch import sde as sde_lib
from score_sde_pytorch_tpu_torch.models import graphs
from score_sde_pytorch_tpu_torch.models import utils as mutils
from score_sde_pytorch_tpu_torch.utils import tracing
# Imported from this directory, which pytest puts on the path: an installed
# package named `tests` can shadow the repository's.
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

FLAGSHIP = str(Path(__file__).resolve().parents[1]
               / "score_sde_pytorch_tpu_torch" / "configs" / "ve"
               / "cifar10_ncsnpp_continuous.py")
TINY = ["model.nf=16", "model.ch_mult=(1,2)", "model.num_res_blocks=1",
        "model.attn_resolutions=(8,)", "data.image_size=8",
        "model.num_scales=2", "training.batch_size=2", "eval.batch_size=2"]
N_BLOCKS = 10  # 2 down, 1 downsampling, 2 mid, 4 up, 1 upsampling


def _counts() -> tuple:
  c = tracing.counters()
  return tuple(c.get(name, {}).get("count", 0)
               for name in ("graph.replay", "graph.eager"))


def _captures() -> int:
  return tracing.counters().get("graph.capture", {}).get("count", 0)


def _block_calls(model, x, t) -> list:
  """``(block, (x, temb))`` of each resblock call of a forward, in order."""
  calls = []

  def record(block, xs, temb):
    calls.append((block, (xs, temb)))

  model._graphs.replay = record
  try:
    with torch.no_grad():
      model._layers(x, t)
  finally:
    del model._graphs.replay
  return calls


def _space_group(monkeypatch):
  monkeypatch.setattr(graphs, "spatial",
                      types.SimpleNamespace(group=lambda: "space"))


def _ranks(n: int):
  def fake(monkeypatch):
    monkeypatch.setattr(graphs, "dist", types.SimpleNamespace(
        is_initialized=lambda: True, get_world_size=lambda: n))
  return fake


# Case: (what it changes, the card faked, train-step calls, replays).
CASES = {
    "cpu": (None, False, True, False),
    "eval": (lambda m, mp: m.eval(), True, False, False),
    "no_grad": (None, True, False, False),
    "remat": (lambda m, mp: setattr(m, "remat", True), True, True, False),
    "space_group": (lambda m, mp: _space_group(mp), True, True, False),
    "two_ranks": (lambda m, mp: _ranks(2)(mp), True, True, False),
    # DDP wraps the model under any process group, one rank's too.
    "one_rank": (lambda m, mp: _ranks(1)(mp), True, True, False),
    "other_shape": (None, True, True, False),
    "qualifies": (None, True, True, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_a_block_call_replays_only_where_it_qualifies(case, monkeypatch):
  change, card, train_step, replays = CASES[case]
  config = configs.load_config(FLAGSHIP, TINY)
  model = mutils.create_model(config, "cpu", torch.Generator().manual_seed(0))
  model.train()
  x = torch.rand(2, 3, 8, 8, generator=torch.Generator().manual_seed(1))
  t = torch.full((2,), 0.5)
  calls = _block_calls(model, x, t)
  assert len(calls) == N_BLOCKS
  stand_in = []

  def graph_of(block):
    def replay(x, temb):
      stand_in.append(block)
      return block(x, temb)
    return replay

  g = model._graphs
  g._params = tuple(p.data_ptr() for p in model.parameters())
  g._graphed = {block: (graph_of(block), xs.shape, temb.shape, xs.dtype)
                for block, (xs, temb) in calls}
  if card:
    monkeypatch.setattr(graphs, "_on_card", lambda x: True)
  if change is not None:
    change(model, monkeypatch)
  if case == "other_shape":
    calls = [(block, (xs[:1], temb[:1])) for block, (xs, temb) in calls]
  grad = contextlib.nullcontext() if case != "no_grad" else torch.no_grad()
  before = _counts()
  with grad:
    g.prepare(model, x, t)  # decides for the forward; captures nothing here
    for block, (xs, temb) in calls:
      xs = xs.clone().requires_grad_(torch.is_grad_enabled())
      torch.manual_seed(2)
      got = model._resblock(block, xs, temb)
      torch.manual_seed(2)
      want = block(xs, temb)
      assert torch.equal(got, want), block
  replayed, eager = (a - b for a, b in zip(_counts(), before))
  assert stand_in == ([block for block, _ in calls] if replays else [])
  assert replayed == (N_BLOCKS if replays else 0)
  assert eager == (N_BLOCKS if train_step and not replays else 0)


def test_a_forward_on_the_cpu_captures_nothing():
  config = configs.load_config(FLAGSHIP, TINY)
  model = mutils.create_model(config, "cpu", torch.Generator().manual_seed(0))
  model.train()
  before = _counts()
  model(torch.rand(2, 3, 8, 8), torch.full((2,), 0.5)).sum().backward()
  assert _counts()[0] == before[0]
  assert _counts()[1] == before[1] + N_BLOCKS
  assert model._graphs._graphed == {} and not model._graphs._eager


def _count(name: str) -> int:
  return tracing.counters().get(name, {}).get("count", 0)


def test_a_capture_without_room_is_refused_and_the_model_stays_eager(
    monkeypatch):
  """The card faked, with 1 MiB free: the recording forward runs, the
  capture is refused (``graph.capture_refused``, not
  ``graph.capture_failed``), and every later block call runs eagerly, bit
  for bit as on the CPU."""
  config = configs.load_config(FLAGSHIP, TINY)
  model = mutils.create_model(config, "cpu", torch.Generator().manual_seed(0))
  model.train()
  x = torch.rand(2, 3, 8, 8, generator=torch.Generator().manual_seed(1))
  t = torch.full((2,), 0.5)
  torch.manual_seed(2)
  want = model(x, t)
  monkeypatch.setattr(graphs, "_on_card", lambda x: True)
  for name, value in (("current_stream", None), ("get_rng_state", None),
                      ("set_rng_state", None), ("memory_allocated", 0),
                      ("mem_get_info", (2 ** 20, 80 * 2 ** 30))):
    monkeypatch.setattr(torch.cuda, name,
                        lambda *args, value=value, **kwargs: value)
  names = ("graph.capture", "graph.capture_refused", "graph.capture_failed")
  before = [_count(name) for name in names]
  model(x, t)  # its recording forward draws dropout masks of the CPU's
  assert [_count(name) - n for name, n in zip(names, before)] == [1, 1, 0]
  assert model._graphs._eager and model._graphs._graphed == {}
  counts = _counts()
  torch.manual_seed(2)
  got = model(x, t)
  assert [_count(name) - n for name, n in zip(names, before)] == [1, 1, 0]
  assert tuple(a - b for a, b in zip(_counts(), counts)) == (0, N_BLOCKS)
  assert torch.equal(got, want)
  got.sum().backward()
  assert all(p.grad is not None for p in model.parameters()
             if p.requires_grad)


def test_the_train_log_line_gives_the_replayed_share():
  before = {"graph.replay": {"count": 44, "seconds": 0.1}}
  assert run_lib._replayed_share(before, {
      "graph.replay": {"count": 77, "seconds": 0.2},
      "graph.eager": {"count": 11, "seconds": 0.0}}) == "75.0%"
  assert run_lib._replayed_share(before, before) == "-"


# On the card: a small flagship with FIR, dropout 0.1 and attention at 8².
CARD = ["model.nf=32", "model.ch_mult=(1,2,2)", "model.num_res_blocks=2",
        "model.attn_resolutions=(8,)", "data.image_size=16",
        "model.num_scales=10", "training.batch_size=8", "eval.batch_size=8"]
CARD_BLOCKS = 21  # 6 down, 2 downsampling, 2 mid, 9 up, 2 upsampling


@pytest.fixture
def cuda_device():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: CUDA graphs run only on the card")
  return torch.device("cuda")


def _gap(a: torch.Tensor, b: torch.Tensor, floor: float = 1e-30) -> float:
  """``|a - b| / |b|``, with ``|b|`` taken as at least ``floor``."""
  return float(torch.linalg.vector_norm((a - b).double())
               / max(float(torch.linalg.vector_norm(b.double())), floor))


def _worst_leaf(leaves, leaves_e) -> float:
  """The largest gap of one leaf, relative to the norm of all the leaves
  together. Some leaves are zero but for rounding, or nearly: an attention
  key's bias (the softmax ignores it, so its gradient reads ~1e-21 and the
  bias stays near zero) and the gradients inside a resblock whose last
  conv starts near zero, which come out of sums that cancel. Around a
  graphed block the autograd engine sums in another order, and these move
  by up to some tenths of their own norm, by rounding alone."""
  whole = float(torch.linalg.vector_norm(torch.stack(
      [torch.linalg.vector_norm(t.double()) for t in leaves_e])))
  return max(_gap(a, b, whole) for a, b in zip(leaves, leaves_e))


class _Run:
  """Train steps of the small flagship on the card, from seed 0."""

  def __init__(self, device, graphed: bool, unsafe_block: bool = False,
               extra=()):
    config = self.config = configs.load_config(FLAGSHIP, CARD + list(extra))
    torch.manual_seed(0)  # dropout's default generator
    self.model = mutils.create_model(config, device,
                                     torch.Generator().manual_seed(0))
    if unsafe_block:  # a block that synchronizes, which no capture allows
      block = self.model.all_modules[4]
      forward = block.forward

      def synchronizing(x, temb):
        torch.cuda.synchronize()
        return forward(x, temb)

      block.forward = synchronizing
    self.model._graphs._eager = not graphed
    self.state = losses.init_train_state(config, self.model, device)
    self.sde = sde_lib.build_sde(config)
    self.step = losses.get_step_fn(
        self.sde, train=True, continuous=True,
        optimize_fn=losses.optimization_manager(config))
    self.leaves = [p for p in self.model.parameters() if p.requires_grad]

  def train(self, batch) -> tuple:
    """A step's loss, then each leaf's gradient."""
    loss = self.step(self.state, batch, self.state["generator"])
    return loss, [p.grad.clone() for p in self.leaves]


@pytest.fixture
def deterministic_cudnn():
  """cuDNN's deterministic algorithms, so that two runs can agree bit for
  bit; the setting comes back after the test."""
  saved = torch.backends.cudnn.deterministic
  torch.backends.cudnn.deterministic = True
  yield
  torch.backends.cudnn.deterministic = saved


@pytest.mark.cuda
def test_graphed_train_steps_match_the_eager_ones(cuda_device,
                                                  deterministic_cudnn):
  gen = torch.Generator(device=cuda_device).manual_seed(3)
  batches = [torch.rand(8, 3, 16, 16, device=cuda_device, generator=gen)
             for _ in range(5)]
  other = torch.rand(4, 3, 16, 16, device=cuda_device, generator=gen)
  runs, counts, captures = [], [], []
  for graphed in (True, False):
    run = _Run(cuda_device, graphed)
    before, captured = _counts(), _captures()
    readings = [run.train(b) for b in batches]
    middle = _counts()
    readings.append(run.train(other))
    counts += [tuple(a - b for a, b in zip(middle, before)),
               tuple(a - b for a, b in zip(_counts(), middle))]
    captures.append(_captures() - captured)
    runs.append((run, readings))
  (graphed, with_graphs), (eager, without) = runs
  assert counts == [(5 * CARD_BLOCKS, 0), (0, CARD_BLOCKS),
                    (0, 5 * CARD_BLOCKS), (0, CARD_BLOCKS)]
  assert captures == [1, 0]
  assert len(graphed.model._graphs._graphed) == CARD_BLOCKS
  for (loss, grads), (loss_e, grads_e) in zip(with_graphs, without):
    assert _gap(loss, loss_e) <= 1e-6
    assert _worst_leaf(grads, grads_e) <= 1e-6
  with torch.no_grad():
    assert _worst_leaf(graphed.leaves, eager.leaves) <= 1e-6
    assert _worst_leaf(graphed.state["ema"].shadow_params,
                       eager.state["ema"].shadow_params) <= 1e-6

  before = _counts()
  evaluate = losses.get_step_fn(graphed.sde, train=False, continuous=True)
  evaluate(graphed.state, batches[0],
           torch.Generator(device=cuda_device).manual_seed(4))
  sampler = sampling.get_sampling_fn(
      graphed.config, graphed.sde, graphed.model, (8, 16, 16, 3),
      datasets.get_data_inverse_scaler(graphed.config), device=cuda_device)
  sampler(torch.Generator(device=cuda_device).manual_seed(5))
  assert _counts()[0] == before[0]


def _no_room(monkeypatch):
  """The card as if full."""
  monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (
      0, torch.cuda.get_device_properties(device).total_memory))


@pytest.mark.cuda
@pytest.mark.parametrize("cause", ["synchronizes", "no_room"])
def test_a_capture_that_fails_leaves_the_steps_eager(cause, cuda_device,
                                                     deterministic_cudnn,
                                                     monkeypatch):
  if cause == "no_room":
    _no_room(monkeypatch)
  gen = torch.Generator(device=cuda_device).manual_seed(6)
  batches = [torch.rand(8, 3, 16, 16, device=cuda_device, generator=gen)
             for _ in range(2)]
  readings, counts = [], []
  names = ("graph.capture_refused", "graph.capture_failed")
  for graphed in (True, False):
    run = _Run(cuda_device, graphed, unsafe_block=cause == "synchronizes")
    before = [_count(name) for name in names]
    readings.append([run.train(b) for b in batches])
    counts.append([_count(name) - n for name, n in zip(names, before)])
    assert run.model._graphs._graphed == {} and run.model._graphs._eager
  assert counts == [[1, 0] if cause == "no_room" else [0, 1], [0, 0]]
  for (loss, grads), (loss_e, grads_e) in zip(*readings):
    assert _gap(loss, loss_e) <= 1e-6
    assert _worst_leaf(grads, grads_e) <= 1e-6


@pytest.mark.cuda
def test_a_dropped_model_takes_its_graphs_along(cuda_device):
  def graphs_alive() -> int:
    return sum(isinstance(o, torch.cuda.CUDAGraph) for o in gc.get_objects())

  before = graphs_alive()
  run = _Run(cuda_device, True)
  run.train(torch.rand(8, 3, 16, 16, device=cuda_device))
  assert graphs_alive() == before + 2 * CARD_BLOCKS  # a forward, a backward
  del run
  assert graphs_alive() == before


@pytest.mark.cuda
def test_an_unconditional_model_trains_eagerly(cuda_device):
  run = _Run(cuda_device, True, extra=["model.conditional=False"])
  before = _counts()
  loss = run.step(run.state, torch.rand(8, 3, 16, 16, device=cuda_device),
                  run.state["generator"])
  assert torch.isfinite(loss)
  assert run.model._graphs._eager and run.model._graphs._graphed == {}
  assert tuple(a - b for a, b in zip(_counts(), before)) == (0, CARD_BLOCKS)
