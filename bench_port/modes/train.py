"""Training traffic: the loop of the program's ``run_lib.train``.

Each block is one call of the program's n-step train function
(``losses.get_n_step_fn(losses.get_step_fn(...), training.n_jitted_steps)``)
on the next batches of the program's own train iterator, fed as the loop
feeds it: ``datasets.get_dataset(config)`` with the run's seed as the
configuration's ``seed`` (with no data directory, its seeded synthetic
source: shuffled, flipped, float32 NHWC in [0, 1]), each batch scaled by
``datasets.get_data_scaler``, copied to the card and made NCHW as
``run_lib._to_device`` does. The loss is read to the host every
``log_freq`` steps and the eval-loss step (EMA weights, no gradient) runs
every ``eval_freq`` steps on the eval iterator's batches, on the loop's
step counts. No checkpoint is written in the window.

Set-up builds the train state and the iterators, runs the first call (its
first three steps are the ones the reference follows) and one eval call,
so every shape of the window has run. The traced segment is
``trace_calls`` more calls with neither loss read nor eval.

Compared with the reference (``reference/train.py`` on the batches of
``reference/data.py``, worked out again from the seed): each of the first
three steps' loss; each leaf's gradient norm as Adam got it (its first
moment after one step over 1 − β₁); each leaf's change after three steps
and its EMA's, read as step 4 starts. Norms by the worst leaf (see
``reference.train.leaf_gap``); leaves whose reference gradient is under a
thousandth of the median leaf's are left out of the two changes.
"""
from __future__ import annotations

import math

import torch

from bench_port import faults, program, reference, seeds, weights
from bench_port.counters import ncsnpp as counters
from bench_port.reference import data as ref_data
from bench_port.reference import train as ref_train

_COMPARED_STEPS = 3
_KEEP_GRAD = 1e-3


def _norms(tensors) -> list:
  return [float(torch.linalg.vector_norm(t.float())) for t in tensors]


class Session:

  def __init__(self, ctx):
    from score_sde_pytorch_tpu_torch import datasets, losses
    from score_sde_pytorch_tpu_torch import sde as sde_lib
    self.ctx = ctx
    cfg, dev = ctx.cfg, ctx.device
    faults.plant(ctx)
    tc = cfg.training
    self.n, self.batch = tc.n_jitted_steps, tc.batch_size
    self.log_freq, self.eval_freq = tc.log_freq, tc.eval_freq
    torch.manual_seed(ctx.seed)  # dropout's default generators
    self.model = program.build_model(cfg, ctx.plain, ctx.seed, dev,
                                     ctx.mark)
    ctx.mark("model")
    self.state = losses.init_train_state(cfg, self.model, dev)
    self.leaves = [p for p in self.model.parameters() if p.requires_grad]
    self.p0 = [p.detach().to("cpu", copy=True) for p in self.leaves]
    self.readings = {}
    optimize = losses.optimization_manager(cfg)
    beta1 = cfg.optim.beta1

    def optimize_and_read(optimizer, params, step):
      if step == _COMPARED_STEPS:
        self._read_changes()
      optimize(optimizer, params, step)
      if step == 0:
        moments = [optimizer.state.get(p, {}).get("exp_avg")
                   for p in self.leaves]
        self.readings["grad_norms"] = [
            0.0 if m is None else float(torch.linalg.vector_norm(m))
            / (1 - beta1) for m in moments]

    sde = sde_lib.build_sde(cfg)
    kw = dict(reduce_mean=tc.reduce_mean, continuous=tc.continuous,
              likelihood_weighting=tc.likelihood_weighting)
    self.train_step = losses.get_n_step_fn(losses.get_step_fn(
        sde, train=True, optimize_fn=optimize_and_read, **kw), self.n)
    self.eval_step = losses.get_n_step_fn(
        losses.get_step_fn(sde, train=False, **kw), self.n)
    self.scaler = datasets.get_data_scaler(cfg)
    self.iters = datasets.get_dataset(cfg)
    ctx.mark("state")
    self.step = 0
    self.attempted = self.failed = 0
    self.flops = {"steps": counters.TRAIN_FACTOR
                  * counters.forward_flops(ctx.plain, self.batch)}
    first = []
    while self.step <= _COMPARED_STEPS:
      first += self.train_step(self.state, self._batches(0),
                               self.state["generator"]).tolist()
      self.step += self.n
    self.readings["losses"] = first[:_COMPARED_STEPS]
    self._eval()

  def _batches(self, kind: int) -> list:
    it = self.iters[kind]
    return [torch.from_numpy(self.scaler(next(it))).to(
        self.ctx.device).permute(0, 3, 1, 2).contiguous()
            for _ in range(self.n)]

  def _eval(self) -> float:
    gen = torch.Generator(device=self.ctx.device).manual_seed(
        seeds.derive(self.ctx.seed, 3, self.step))
    return float(self.eval_step(self.state, self._batches(1), gen).mean())

  def _read_changes(self) -> None:
    dev = self.ctx.device
    shadow = self.state["ema"].shadow_params
    self.readings["change_norms"] = _norms(
        p.detach() - p0.to(dev) for p, p0 in zip(self.leaves, self.p0))
    self.readings["ema_norms"] = _norms(
        s - p0.to(dev) for s, p0 in zip(shadow, self.p0))
    self.p0 = None

  def block(self) -> dict:
    loss = self.train_step(self.state, self._batches(0),
                           self.state["generator"])
    self.step += self.n
    self.attempted += self.n
    if self.step % self.log_freq < self.n:
      if not math.isfinite(float(loss.mean())):
        self.failed += self.n
    if self.step % self.eval_freq < self.n:
      if not math.isfinite(self._eval()):
        self.failed += self.n
    return {"steps": self.n, "images": self.n * self.batch}

  def traced_blocks(self) -> dict:
    calls = self.ctx.cell.get("trace_calls", 1)
    for _ in range(calls):
      self.train_step(self.state, self._batches(0), self.state["generator"])
    self.step += calls * self.n
    return {"steps": calls * self.n, "images": calls * self.n * self.batch}

  def release(self) -> None:
    faults.remove()
    self.state = self.model = self.leaves = self.train_step = None
    self.eval_step = self.iters = None


def _reference_batches(ctx) -> list:
  """The first compared steps' batches, NCHW on the card, as the
  reference works them out from the seed."""
  data = ctx.plain["data"]
  if data["data_dir"] or data["uniform_dequantization"] or data["centered"]:
    raise NotImplementedError("reference data: the synthetic source in "
                              "[0, 1] only")
  arrays = ref_data.batches(data, "train", ctx.plain["training"]["batch_size"],
                            ctx.seed, _COMPARED_STEPS)
  return [torch.from_numpy(a).to(ctx.device).permute(0, 3, 1, 2).contiguous()
          for a in arrays]


def check(ctx, readings: dict) -> dict:
  """The reference's first three steps from the same weights, images,
  draws and dropout seed; the gaps of the program's readings to them."""
  plain, dev = ctx.plain, ctx.device
  net = weights.reference_with_weights(plain, ctx.seed, dev).train()
  leaves0 = [p.detach().clone() for p in net.parameters() if p.requires_grad]
  batches = _reference_batches(ctx)
  gen = torch.Generator(device=dev).manual_seed(ctx.seed)
  with reference.plain_precision():
    torch.manual_seed(ctx.seed)
    ref = ref_train.steps(net, plain, batches, gen)
  grads = _norms(ref["first_grads"])
  median = sorted(grads)[len(grads) // 2]
  keep = [g >= _KEEP_GRAD * median for g in grads]
  changes = _norms(w - w0 for w, w0 in zip(ref["weights"], leaves0))
  emas = _norms(e - w0 for e, w0 in zip(ref["ema"], leaves0))
  loss_gap = max(abs(a - b) / abs(b) for a, b in
                 zip(readings["losses"], ref["losses"]))
  return {"loss_gap": loss_gap if math.isfinite(loss_gap) else math.inf,
          "grad_gap": ref_train.leaf_gap(readings["grad_norms"], grads),
          "change_gap": ref_train.leaf_gap(readings["change_norms"], changes,
                                           keep),
          "ema_gap": ref_train.leaf_gap(readings["ema_norms"], emas, keep)}
