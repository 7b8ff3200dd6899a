"""CUDA graphs of NCSN++'s residual blocks in a train step.

Every resblock call of NCSN++ and DDPM++ goes through ``NCSNpp._resblock``.
In a train step on one card, each call replays a captured CUDA graph of
that block's forward, and its backward replays a captured graph of the
block's backward (``torch.cuda.make_graphed_callables``): a few launches
where the block's dozens of kernels each cost the host a dispatch.
Everything else stays eager: attention, the glue between the blocks, the
loss, clipping, the optimizer and the EMA.

A block call replays only when all of these hold, each read from the call:

- its tensors are on CUDA, gradients are enabled and the block is training;
- the model has no ``model.remat`` (its checkpointed path keeps priority);
- the layers split over no space group, and no process group exists
  (DDP, at any world size, and NCCL stay out of capture);
- its ``(x.shape, temb.shape, dtype)`` are those captured.

Any other call runs ``block(x, temb)`` eagerly: the samplers and bits/dim
(eval mode), the eval loss (no gradient), the space axis, DDP, remat, a
batch of another shape and an unconditional model (whose blocks take no
time embedding).

Capture comes at the first forward that qualifies, before it runs
(:meth:`BlockGraphs.prepare`), so that forward already replays. A forward
of its own, with gradients as the step runs it, records each block's input
shapes in call order (it launches the network's attention kernels once
more than the train step does) and reads the memory the forward keeps for
its backward. The graphs hold that in their own memory pool, with their
copies of each block's input and output gradient and the parameters'
gradients; with Adam's two moments, all of it may take at most half of
what the card has free, or the capture is refused. The pool and the
eager rest of the step cannot lend each other memory, and a step that
fills the card is bound by the device, where graphs save nothing (church
256² at batch 24 and CelebA-HQ 1024² at 8 on an H100 stay eager). All
blocks then go to one ``make_graphed_callables`` call in that order, so
they share one memory pool. The default CUDA generator's state is saved before and restored
after, so dropout draws the masks that the eager loop would. If the
capture is refused or fails, the model stays eager for the rest of the
process, with one warning that says which.

What a replay asks of its caller:

- a block's output lives in the graphs' memory until the next forward
  replay: the forward's backward runs (or its graph is dropped) before the
  next qualifying forward of the model;
- the parameters keep their storage: the optimizer, ``ema.copy_to`` and
  ``restore`` and ``load_state_dict`` copy in place. A forward that finds
  a parameter moved drops the graphs and captures again;
- parameter gradients may alias the graphs' memory until the next backward
  replay, so ``.grad`` is set to None between steps
  (``optimizer.zero_grad(set_to_none=True)``, as the train step does).

``make_graphed_callables`` wraps each graph in a class, and classes sit in
reference cycles, which only a cycle collection frees. So dropping the
graphs (with their model, or when a parameter moved) runs one and empties
the allocator's cache: the graphs' memory leaves with them.

The parameters' gradient accumulators are made inside the capture and keep
its side stream, so each backward accumulates there after a wait on the
caller's stream; PyTorch warns once that the streams differ. Made on the
caller's stream instead, they would join the legacy default stream to the
capture of the backward and invalidate it.

Counters (``utils/tracing.py``): ``graph.replay`` (and its span) around
each replayed block call; ``graph.eager`` for each block call in training
mode with gradients that ran eagerly; ``graph.capture`` for each recording
forward; ``graph.capture_refused`` for a capture declined because the
graphs would take over half of the free card, and ``graph.capture_failed``
for one that raised.
"""
from __future__ import annotations

import gc
import logging
import sys

import torch
import torch.distributed as dist

from score_sde_pytorch_tpu_torch.parallel import spatial
from score_sde_pytorch_tpu_torch.utils import tracing


class _Refused(Exception):
  """The graphs would take more than half of the card's free memory."""


def _on_card(x: torch.Tensor) -> bool:
  return x.is_cuda


def _qualifies(model, x: torch.Tensor) -> bool:
  """Whether ``model``'s forward on ``x`` is a train step on one card."""
  return (_on_card(x) and torch.is_grad_enabled() and model.training
          and not model.remat and spatial.group() is None
          and not dist.is_initialized())


class BlockGraphs:
  """The graphed resblocks of one model, captured at its first qualifying
  forward."""

  def __init__(self):
    self._graphed = {}      # block -> (replay, x shape, temb shape, dtype)
    self._params = None     # the parameters' addresses at capture
    self._recording = None  # (block, (x, temb) on "meta") of each call
    self._eager = False     # no graphs for this model, for good
    self._live = False      # whether the current forward may replay

  def prepare(self, model, x: torch.Tensor, time_cond: torch.Tensor) -> None:
    """Before ``model``'s forward on ``x``: decides whether its block calls
    may replay, and captures the graphs if so and none are held (or the
    parameters moved)."""
    self._live = not self._eager and _qualifies(model, x)
    if not self._live:
      return
    params = tuple(p.data_ptr() for p in model.parameters())
    if self._graphed and params == self._params:
      return
    self._drop()
    self._params = params
    stream = torch.cuda.current_stream(x.device)
    rng = torch.cuda.get_rng_state(x.device)
    failed = None
    try:
      self._capture(model, x, time_cond)
    except _Refused as e:
      self._eager = True
      tracing.count("graph.capture_refused")
      logging.warning("CUDA graphs of the resblocks refused (%s); they run "
                      "eagerly from now on.", e)
    except RuntimeError as e:  # torch's CUDA and out-of-memory errors
      # A capture that fails can leave its side stream the current one, and
      # the default generator counting draws inside a capture.
      torch.cuda.set_stream(stream)
      fresh = torch.Generator(device=x.device)
      fresh.set_state(rng)
      torch.cuda.default_generators[x.device.index].graphsafe_set_state(fresh)
      self._graphed, self._eager = {}, True
      failed = str(e)
    if failed is None:
      torch.cuda.set_rng_state(rng, x.device)
    else:  # the traceback is gone: free what the capture held
      torch.cuda.empty_cache()
      tracing.count("graph.capture_failed")
      logging.warning("CUDA graphs of the resblocks not captured (%s); "
                      "they run eagerly from now on.", failed)
    self._live = not self._eager

  def _drop(self) -> None:
    if self._graphed and not sys.is_finalizing():
      self._graphed = {}
      gc.collect()
      torch.cuda.empty_cache()

  __del__ = _drop

  def _capture(self, model, x: torch.Tensor, time_cond: torch.Tensor) -> None:
    tracing.count("graph.capture")
    calls = self._recording = []
    before = torch.cuda.memory_allocated(x.device)
    try:
      out = model._layers(x, time_cond)  # fills the FIR weights' cache too
      kept = torch.cuda.memory_allocated(x.device) - before  # for backward
      del out
    finally:
      self._recording = None
    if any(temb is None for _, (_, temb) in calls):
      self._eager = True  # an unconditional model's blocks take no temb
      return
    copies = sum(2 * t.numel() * t.element_size()
                 for _, args in calls for t in args)
    grads = sum(3 * p.numel() * p.element_size()
                for p in model.parameters() if p.requires_grad)
    torch.cuda.empty_cache()  # the recording forward's memory, to the card
    free, _ = torch.cuda.mem_get_info(x.device)
    if 2 * (kept + copies + grads) > free:
      raise _Refused(
          f"the graphs need {(kept + copies + grads) / 2 ** 30:.2f} GiB, "
          f"more than half of the card's {free / 2 ** 30:.2f} GiB free")
    blocks = tuple(block for block, _ in calls)
    sample = tuple(tuple(torch.zeros_like(t, device=x.device,
                                          requires_grad=True)
                         for t in args) for _, args in calls)
    del calls
    torch.cuda.make_graphed_callables(blocks, sample, num_warmup_iters=1)
    for block, (xs, temb) in zip(blocks, sample):
      # make_graphed_callables puts the graphs behind the module's own
      # forward; take them off it, so every other call stays eager.
      replay = block.__dict__.pop("forward")
      self._graphed[block] = (replay, xs.shape, temb.shape, xs.dtype)

  def replay(self, block, x: torch.Tensor, temb):
    """The block's graphs replayed on ``(x, temb)``, or None where the
    call runs eagerly."""
    if self._recording is not None:
      meta = (None if t is None else torch.empty_like(t, device="meta")
              for t in (x, temb))
      self._recording.append((block, tuple(meta)))
      return None
    if not (torch.is_grad_enabled() and block.training):
      return None
    entry = self._graphed.get(block)
    if (not self._live or entry is None or x.shape != entry[1]
        or temb.shape != entry[2] or x.dtype != entry[3]):
      tracing.count("graph.eager")
      return None
    with tracing.counted("graph.replay"):
      return entry[0](x, temb)
