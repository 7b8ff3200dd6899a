"""Pipelines of the port: training, evaluation, and sampling from a
checkpoint.

Counterpart of score_sde_pytorch_tpu/run_lib.py:66-248 (``train``),
:251-464 (``evaluate``) and :467-588 (``sample``). Each runs in one process
or in each rank of a torch.distributed group (``main`` under torchrun; the
group is ``parallel.default_group()``): every rank feeds its shard of the
data and computes its rows of each global batch, and rank 0 alone writes
files, TensorBoard, sample grids and scores. ``workdir`` may be a URI of a
scheme registered with ``utils.io.register_scheme``: every file goes
through ``utils.io``.
"""
from __future__ import annotations

import logging
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from score_sde_pytorch_tpu_torch import checkpoint as ckpt_lib
from score_sde_pytorch_tpu_torch import datasets, evaluation, losses, sampling
from score_sde_pytorch_tpu_torch import likelihood as likelihood_lib
from score_sde_pytorch_tpu_torch import native, parallel
from score_sde_pytorch_tpu_torch import sde as sde_lib
from score_sde_pytorch_tpu_torch.models import utils as mutils
from score_sde_pytorch_tpu_torch.models.ema import ExponentialMovingAverage
from score_sde_pytorch_tpu_torch.utils import io, tracing
from score_sde_pytorch_tpu_torch.utils.image import make_grid, save_image

try:
  from tensorboardX import SummaryWriter
except ImportError:
  SummaryWriter = None


class _NullWriter:
  """Stands in for TensorBoard's writer where tensorboardX is missing (as
  the JAX package's run_lib does); training itself is unchanged."""

  def add_scalar(self, *args, **kwargs):
    pass

  def flush(self):
    pass


def _writer(workdir: str):
  """TensorBoard's writer on the workdir's local path; a scheme whose
  handler has none gets no TensorBoard files (the writer does its own
  I/O), and the log says so."""
  path = io.localize(os.path.join(workdir, "tensorboard"))
  if SummaryWriter is None:
    return _NullWriter()
  if "://" in path:
    logging.warning("No TensorBoard files: %s has no local path.", path)
    return _NullWriter()
  return SummaryWriter(path)


_META = -1       # the rolling checkpoint, where a number names a snapshot
_NOT_FOUND = -2


def _checkpoint(workdir: str, number: int):
  """``(path, label)`` of snapshot ``number``, or of the rolling
  checkpoint for ``_META``."""
  if number == _META:
    return ckpt_lib.meta_path(workdir), "checkpoints-meta"
  return ckpt_lib.numbered_path(workdir, number), f"checkpoint_{number}"


def _resolve_number(workdir: str, checkpoint: int) -> int:
  """The snapshot to sample from: ``checkpoint``, or with -1 the latest
  one, else the rolling checkpoint (``_META``)."""
  if checkpoint >= 0:
    path = ckpt_lib.numbered_path(workdir, checkpoint)
    if not io.exists(path):
      raise FileNotFoundError(f"checkpoint_{checkpoint} not found: {path}")
    return checkpoint
  latest = ckpt_lib.latest_numbered(workdir)
  if latest is not None:
    return latest
  if io.exists(ckpt_lib.meta_path(workdir)):
    return _META
  raise FileNotFoundError(
      f"no checkpoint under {workdir} (checkpoints/checkpoint_N.pth or "
      "checkpoints-meta/checkpoint.pth)")


def _resolve_checkpoint(workdir: str, checkpoint: int):
  return _checkpoint(workdir, _resolve_number(workdir, checkpoint))


def _agreed_checkpoint(workdir: str, checkpoint: int, group):
  """Rank 0 resolves the checkpoint and broadcasts its choice (JAX
  run_lib.py:515-528), so every rank restores the same file even while
  training writes new ones; where rank 0 finds none, every rank raises."""
  number, error = _NOT_FOUND, None
  if parallel.group_rank(group) == 0:
    try:
      number = _resolve_number(workdir, checkpoint)
    except FileNotFoundError as e:
      error = e
  number = parallel.broadcast_int(number, group)
  if error is not None:
    raise error
  if number == _NOT_FOUND:
    raise FileNotFoundError(f"rank 0 found no checkpoint {checkpoint} under "
                            f"{workdir}")
  return _checkpoint(workdir, number)


def sample(config, workdir: str, sample_folder: str = "generated",
           checkpoint: int = -1, num_samples: int = 0,
           device: str = "cuda") -> list:
  """Generate samples from a checkpoint's EMA weights.

  Runs the configured sampler in rounds of ``config.eval.batch_size``,
  checks every round is finite, trims the last round to ``num_samples``
  (0 means one batch), and writes ``samples_<r>.npz`` (uint8, NHWC) and a
  PNG grid per round under ``workdir/<sample_folder>/``. Over several
  ranks each samples its rows of every round, and rank 0 gathers and
  writes them.

  Returns one dict per round: ``samples``, ``nfe`` and ``seconds`` (wall
  time of the round's sampler call, ended by the gather to the host)."""
  device = torch.device(device)
  group = parallel.default_group()
  parallel.check_data_axis(config, parallel.group_size(group))
  main_rank = parallel.group_rank(group) == 0
  out_dir = os.path.join(workdir, sample_folder)
  if main_rank:
    io.makedirs(out_dir)

  model = mutils.create_model(config, device,
                              torch.Generator().manual_seed(config.seed))
  path, label = _agreed_checkpoint(workdir, checkpoint, group)
  step = ckpt_lib.restore_ema(path, model)
  logging.info("Sampling from %s (step %d) on %s.", label, step, device)

  sde = sde_lib.build_sde(config)
  batch = config.eval.batch_size
  shape = (batch, config.data.image_size, config.data.image_size,
           config.data.num_channels)
  sampling_fn = sampling.get_sampling_fn(
      config, sde, model, shape, datasets.get_data_inverse_scaler(config),
      device=device, group=group)

  generator = torch.Generator(device=device).manual_seed(config.seed + 2)
  num_samples = num_samples or batch
  num_rounds = (num_samples - 1) // batch + 1
  rounds = []
  for r in range(num_rounds):
    start = time.perf_counter()
    samples, nfe = sampling_fn(generator)
    samples_np = parallel.gather_to_host(samples, group).numpy()
    seconds = time.perf_counter() - start
    if not np.isfinite(samples_np).all():
      raise RuntimeError(f"non-finite samples in round {r} "
                         f"(sampler={config.sampling.method})")
    samples_np = samples_np[:min(batch, num_samples - r * batch)]
    if main_rank:
      samples_u8 = np.clip(samples_np * 255.0, 0, 255).astype(np.uint8)
      io.save_npz(os.path.join(out_dir, f"samples_{r}.npz"),
                  samples=samples_u8)
      nrow = int(np.ceil(np.sqrt(samples_np.shape[0])))
      save_image(make_grid(samples_np, nrow, padding=2),
                 os.path.join(out_dir, f"samples_{r}.png"))
    logging.info("round %d/%d: %d samples (NFE %d, %.3f s) -> %s", r + 1,
                 num_rounds, samples_np.shape[0], nfe, seconds, out_dir)
    rounds.append({"samples": int(samples_np.shape[0]), "nfe": int(nfe),
                   "seconds": seconds})
  return rounds


def _to_device(batch: np.ndarray, scaler, device: torch.device
               ) -> torch.Tensor:
  """A numpy NHWC batch, scaled, as an NCHW tensor on ``device``."""
  return torch.from_numpy(scaler(batch)).to(device).permute(
      0, 3, 1, 2).contiguous()


def _seeded_generator(device: torch.device, seed: int, step: int,
                      stream: int) -> torch.Generator:
  """A generator that depends only on (seed, step, stream): the eval loss
  and the snapshot samples of a step are the same in a resumed run."""
  key = np.random.SeedSequence([seed, step, stream]).generate_state(
      1, np.uint64)[0]
  return torch.Generator(device=device).manual_seed(int(key >> np.uint64(1)))


def _evals_before(step: int, n_jitted: int, eval_freq: int) -> int:
  """Eval calls the loop has made when it reaches ``step``."""
  return sum(1 for s in range(n_jitted, step + 1, n_jitted)
             if s % eval_freq < n_jitted)


def _skip(it, batches: int, name: str) -> None:
  """Takes the ``name`` stream up after ``batches`` batches: ``skip`` draws
  their random numbers without reading an image. The native loader has no
  fixed order to take up: its stream restarts, as the JAX package's
  streams do on a resume, and the log says so."""
  if not batches:
    return
  if isinstance(it, native.NativeDataLoader):
    logging.warning("data.loader_backend='native': the %s stream restarts "
                    "from its start on resume (%d batches not skipped)",
                    name, batches)
    return
  start = time.perf_counter()
  it.skip(batches)
  logging.info("Skipped %d %s batches in %.3f s.", batches, name,
               time.perf_counter() - start)


def _start_trace(device: torch.device):
  """A running ``torch.profiler`` of the host and, on a card, its CUDA
  activity."""
  from torch.profiler import ProfilerActivity, profile
  activities = [ProfilerActivity.CPU]
  if device.type == "cuda":
    activities.append(ProfilerActivity.CUDA)
  profiler = profile(activities=activities)
  profiler.start()
  return profiler


def _stop_trace(profiler, device: torch.device, workdir: str, rank: int,
                first: int, last: int) -> None:
  """Waits for the device, stops ``profiler`` and writes its Chrome trace
  to ``workdir/profile/`` through ``utils.io``."""
  if device.type == "cuda":
    torch.cuda.synchronize(device)
  profiler.stop()
  name = f"steps_{first + 1}-{last}_rank{rank}.pt.trace.json"
  path = os.path.join(workdir, "profile", name)
  io.makedirs(os.path.dirname(path))
  with tempfile.TemporaryDirectory() as tmp:
    local = os.path.join(tmp, name)
    profiler.export_chrome_trace(local)
    with open(local, "rb") as src, io.open_file(path, "wb") as dst:
      shutil.copyfileobj(src, dst)
  logging.info("Wrote the trace of steps %d-%d to %s.", first + 1, last, path)


def _host_ms_per_step(before: dict, after: dict) -> tuple:
  """Host ms a train step spent in the step function, and waiting for the
  input pipeline, between two snapshots of ``tracing.counters()``."""

  def delta(name: str, key: str) -> float:
    return after.get(name, {}).get(key, 0) - before.get(name, {}).get(key, 0)

  steps = max(delta("train.step", "count"), 1)
  return (1e3 * delta("train.step", "seconds") / steps,
          1e3 * delta("data.wait", "seconds") / steps)


def _replayed_share(before: dict, after: dict) -> str:
  """The share of the resblocks' train-step calls that replayed CUDA
  graphs between two snapshots of ``tracing.counters()``, as text ('-'
  where none ran)."""

  def delta(name: str) -> int:
    return (after.get(name, {}).get("count", 0)
            - before.get(name, {}).get("count", 0))

  replayed = delta("graph.replay")
  calls = replayed + delta("graph.eager")
  return f"{100 * replayed / calls:.1f}%" if calls else "-"


def train(config, workdir: str, device: str = "cuda") -> dict:
  """Train loop (JAX run_lib.py:66-248).

  Resumes from ``checkpoints-meta/checkpoint.pth`` when it exists. Each
  call of the n-step function runs ``training.n_jitted_steps`` eager steps;
  logs, the rolling snapshot, the eval loss and the numbered snapshots
  (with a sample grid from the EMA weights) land on the JAX package's
  steps (``step % freq < n_jitted_steps``). The host syncs with the device
  only where a loss is logged.

  A resumed run repeats an uninterrupted one: the checkpoint carries the
  generators' states, the data streams skip to where the run stopped (the
  port's batches have one fixed order; ``skip`` reads no image), and the
  eval and sampling draws depend only on the step. The native loader's
  streams restart instead.

  Over several ranks (JAX run_lib.py:66-98) the train step's forward runs
  under DistributedDataParallel, each rank feeds its shard of the data
  (local batches of ``batch_size // world``), the logged losses are the
  means over the ranks, and rank 0 writes the checkpoints (with every
  rank's generator states), TensorBoard and the sample grids. The grid is
  sampled on rank 0 alone, without the group, at ``batch_size // world``
  samples (JAX :145-156). Dropout's default generators are seeded
  ``seed + rank``.

  ``training.trace_steps = k > 0`` (JAX :161-169, :193-197) runs the first
  ``k`` steps after the start or resume under ``torch.profiler`` (with the
  card's activity on CUDA) and writes each rank's Chrome trace to
  ``workdir/profile/steps_<a>-<b>_rank<r>.pt.trace.json``, the device
  synchronized before the profiler stops; the trace carries the port's
  spans (``utils/tracing.py``: the train step and its parts, the data
  wait, the network, its norms, FIR filters and attention). The JAX
  package's trace server, ``training.profiler_port``, has no PyTorch
  counterpart: a nonzero value raises.

  Every ``log_freq`` steps the log line gives, beside the wall's s/step,
  the host ms a step spent inside the step function and waiting for the
  input pipeline (the ``train.step`` and ``data.wait`` counters), and the
  share of the resblocks' train-step calls that replayed CUDA graphs
  (``models/graphs.py``; the ``graph.replay`` and ``graph.eager``
  counters). Under replay the ``train.backward`` counter times the
  autograd engine over the graphed nodes, not a dispatch per op.

  Returns ``{"initial_step", "step", "train_losses", "eval_losses"}``, the
  losses as ``(step, value)`` pairs of the logged values."""
  device = torch.device(device)
  group = parallel.default_group()
  world, rank = parallel.group_size(group), parallel.group_rank(group)
  parallel.check_data_axis(config, world)
  tcfg = config.training
  if tcfg.get("profiler_port", 0):
    raise ValueError(
        f"training.profiler_port={tcfg.profiler_port}: the JAX package's "
        "trace server has no PyTorch counterpart; set training.trace_steps "
        "to write a trace of the first steps to workdir/profile")
  if tcfg.batch_size % world:
    raise ValueError(f"training.batch_size ({tcfg.batch_size}) must be "
                     f"divisible by the number of ranks ({world})")
  main_rank = rank == 0
  io.makedirs(workdir)
  writer = _writer(workdir) if main_rank else _NullWriter()
  sample_dir = os.path.join(workdir, "samples")
  if main_rank:
    io.makedirs(sample_dir)

  torch.manual_seed(config.seed + rank)  # dropout's default generators
  model = mutils.create_model(config, device,
                              torch.Generator().manual_seed(config.seed))
  state = losses.init_train_state(config, model, device)
  if group is not None:
    # An unconditional model leaves its resblocks' Dense_0 out of the
    # graph; every other config uses each trainable parameter.
    state["forward"] = parallel.wrap(
        model, device,
        find_unused_parameters=not config.model.get("conditional", True))
  meta = ckpt_lib.meta_path(workdir)
  if io.exists(meta):
    ckpt_lib.restore_train_state(meta, state, group)
  initial_step = state["step"]

  train_iter, eval_iter = datasets.get_dataset(config)
  scaler = datasets.get_data_scaler(config)
  n_jitted = config.training.get("n_jitted_steps", 1)
  _skip(train_iter, initial_step, "train")
  _skip(eval_iter, n_jitted * _evals_before(initial_step, n_jitted,
                                            tcfg.eval_freq), "eval")

  sde = sde_lib.build_sde(config)
  step_kwargs = dict(reduce_mean=tcfg.reduce_mean, continuous=tcfg.continuous,
                     likelihood_weighting=tcfg.likelihood_weighting)
  train_step = losses.get_n_step_fn(
      losses.get_step_fn(sde, train=True,
                         optimize_fn=losses.optimization_manager(config),
                         group=group, **step_kwargs), n_jitted)
  eval_step = losses.get_n_step_fn(
      losses.get_step_fn(sde, train=False, group=group, **step_kwargs),
      n_jitted)

  def next_batches(it):
    return [_to_device(next(it), scaler, device) for _ in range(n_jitted)]

  # Rank 0 samples the grid alone: no group, so it runs no collective that
  # the other ranks would have to enter.
  snapshot_sampling = tcfg.snapshot_sampling and main_rank
  if snapshot_sampling:
    sampling_shape = (tcfg.batch_size // world, config.data.image_size,
                      config.data.image_size, config.data.num_channels)
    sampling_fn = sampling.get_sampling_fn(
        config, sde, model, sampling_shape,
        datasets.get_data_inverse_scaler(config), device=device)

  logging.info("Starting training loop at step %d.", initial_step)
  step = initial_step
  trace_steps = tcfg.get("trace_steps", 0)
  profiler = (_start_trace(device) if trace_steps > 0
              and step < tcfg.n_iters else None)
  t_last = time.time()
  counted_last = tracing.counters()
  train_losses, eval_losses = [], []
  while step < tcfg.n_iters:
    loss = train_step(state, next_batches(train_iter), state["generator"])
    step += n_jitted
    if profiler is not None and step - initial_step >= trace_steps:
      _stop_trace(profiler, device, workdir, rank, initial_step, step)
      profiler = None

    if step % tcfg.log_freq < n_jitted:
      loss_val = float(loss.mean())
      dt = time.time() - t_last
      t_last = time.time()
      counted = tracing.counters()
      host_ms, wait_ms = _host_ms_per_step(counted_last, counted)
      replayed = _replayed_share(counted_last, counted)
      counted_last = counted
      logging.info("step: %d, training_loss: %.5e (%.3f s/step), host "
                   "%.1f ms/step in the step function, data wait %.2f "
                   "ms/step, resblock calls replayed %s", step, loss_val,
                   dt / max(tcfg.log_freq, 1), host_ms, wait_ms, replayed)
      writer.add_scalar("training_loss", loss_val, step)
      train_losses.append((step, loss_val))

    if step != 0 and step % tcfg.snapshot_freq_for_preemption < n_jitted:
      ckpt_lib.save_train_state(meta, state, group)

    if step % tcfg.eval_freq < n_jitted:
      eval_loss = eval_step(state, next_batches(eval_iter),
                            _seeded_generator(device, config.seed, step, 0))
      eval_loss_val = float(eval_loss.mean())
      logging.info("step: %d, eval_loss: %.5e", step, eval_loss_val)
      writer.add_scalar("eval_loss", eval_loss_val, step)
      eval_losses.append((step, eval_loss_val))

    if step % tcfg.snapshot_freq < n_jitted or step >= tcfg.n_iters:
      if step != state["step"]:
        raise RuntimeError(f"loop step {step} != state step {state['step']}")
      ckpt_lib.save_train_state(
          ckpt_lib.numbered_path(workdir, step // tcfg.snapshot_freq), state,
          group)
      if snapshot_sampling:
        ema = state["ema"]
        ema.store(model.parameters())
        ema.copy_to(model.parameters())
        try:
          samples, _ = sampling_fn(_seeded_generator(device, config.seed,
                                                     step, 1))
        finally:
          ema.restore(model.parameters())
        this_dir = os.path.join(sample_dir, f"iter_{step}")
        io.makedirs(this_dir)
        samples_np = samples.cpu().numpy()
        with io.open_file(os.path.join(this_dir, "sample.np"), "wb") as fout:
          np.save(fout, samples_np)  # the reference's file name, no .npy
        nrow = int(np.sqrt(samples_np.shape[0]))
        save_image(make_grid(samples_np, nrow, padding=2),
                   os.path.join(this_dir, "sample.png"))
  if profiler is not None:  # the run ended inside the window
    _stop_trace(profiler, device, workdir, rank, initial_step, step)
  writer.flush()
  return {"initial_step": initial_step, "step": step,
          "train_losses": train_losses, "eval_losses": eval_losses}


# The checkpoint-wait loop of evaluate (JAX run_lib.py:354-362).
WAIT_SECONDS = 60
MAX_WAITS = 600


def _epoch_batches(it) -> int:
  """Exact number of batches in one pass over a finite split."""
  n = getattr(it, "batches_per_epoch", None)
  if n is None:
    raise ValueError(
        "eval needs an iterator with a known epoch size; the data source "
        "does not expose one (batches_per_epoch is None).")
  return max(1, int(n))


def _passes(it, repeats: int, group):
  """The batches of ``repeats`` passes over a split, the same number on
  every rank: strided shards of an uneven split differ by a batch, and a
  rank with one more would enter a collective that the others never do.
  Every rank takes the least count (a departure from the JAX package,
  whose global batches are all whole); a rank's extra batch is read and
  dropped, so each pass starts at the split's start."""
  own = _epoch_batches(it)
  n = parallel.all_reduce_min(own, group)
  for _ in range(repeats):
    for _ in range(n):
      yield next(it)
    for _ in range(own - n):
      next(it)


def _wait_for_checkpoint(workdir: str, ckpt: int) -> None:
  waiting = 0
  while not ckpt_lib.has_numbered(workdir, ckpt):
    if waiting == 0:
      logging.warning("Waiting for checkpoint_%d ...", ckpt)
    time.sleep(WAIT_SECONDS)
    waiting += 1
    if waiting > MAX_WAITS:
      raise FileNotFoundError(f"checkpoint_{ckpt} never appeared")


def _timed(device: torch.device, fn, *args):
  """``(fn(*args), seconds)``, the device synced at both ends."""
  if device.type == "cuda":
    torch.cuda.synchronize(device)
  start = time.perf_counter()
  out = fn(*args)
  if device.type == "cuda":
    torch.cuda.synchronize(device)
  return out, time.perf_counter() - start


def evaluate(config, workdir: str, eval_folder: str = "eval",
             device: str = "cuda") -> list:
  """Evaluate every numbered checkpoint from ``eval.begin_ckpt`` to
  ``eval.end_ckpt`` (JAX run_lib.py:261-464), waiting for each to appear.

  Three stages, each behind its ``config.eval.enable_*`` flag, write under
  ``workdir/<eval_folder>/`` the JAX package's files and keys:

  - loss: the eval loss at the EMA weights (``losses.get_step_fn(train=
    False)``) over one pass of the eval split: ``ckpt_<N>_loss.npz``
    (``all_losses``, ``mean_loss``);
  - bpd: bits/dim through the probability-flow ODE over the
    ``eval.bpd_dataset`` split, dequantized, the test split 5 times:
    ``<split>_ckpt_<N>_bpd.npz`` (``bpd``);
  - sampling: ``ceil(num_samples / batch_size)`` rounds of the configured
    sampler, whole batches (no trim, as the JAX package), each
    ``ckpt_<N>_samples_<r>.npz`` (uint8 NHWC ``samples``) and, with
    Inception weights, ``ckpt_<N>_statistics_<r>.npz`` (``pool_3``,
    ``logits``); then ``report_<N>.npz`` (``inception_score``, ``fid``,
    ``kid``, as far as the weights and the dataset statistics allow).
    Non-finite samples raise RuntimeError.

  Over several ranks (JAX run_lib.py:281-470) each rank evaluates its
  shard and its rows of every batch: the eval losses are the means over
  the ranks, bits/dim and samples are gathered, and rank 0 writes the files
  and runs Inception and the scores. ``eval.batch_size`` must divide over
  the ranks; there is no fallback to one device.

  Returns one record per checkpoint with the stages' numbers and times
  (``bpd_nfe`` and ``bpd_seconds`` per batch, ``sampling_nfe`` and
  ``sampling_seconds`` per round, ``inception_seconds``; the scores on
  rank 0)."""
  device = torch.device(device)
  group = parallel.default_group()
  world = parallel.group_size(group)
  parallel.check_data_axis(config, world)
  if config.eval.batch_size % world:
    raise ValueError(f"eval.batch_size ({config.eval.batch_size}) must be "
                     f"divisible by the number of ranks ({world})")
  main_rank = parallel.group_rank(group) == 0
  eval_dir = os.path.join(workdir, eval_folder)
  if main_rank:
    io.makedirs(eval_dir)

  model = mutils.create_model(config, device,
                              torch.Generator().manual_seed(config.seed))
  ema = ExponentialMovingAverage(model.parameters(),
                                 decay=config.model.ema_rate)
  state = {"model": model, "ema": ema}
  generator = torch.Generator(device=device).manual_seed(config.seed + 1)

  sde = sde_lib.build_sde(config)
  scaler = datasets.get_data_scaler(config)
  inverse_scaler = datasets.get_data_inverse_scaler(config)
  _, eval_iter = datasets.get_dataset(config, evaluation=True)
  tcfg, ecfg = config.training, config.eval
  eval_step = losses.get_step_fn(
      sde, train=False, reduce_mean=tcfg.reduce_mean,
      continuous=tcfg.continuous,
      likelihood_weighting=tcfg.likelihood_weighting, group=group)

  if ecfg.enable_bpd:
    likelihood_fn = likelihood_lib.get_likelihood_fn(sde, model,
                                                     inverse_scaler,
                                                     group=group)
    bpd_train_iter, bpd_test_iter = datasets.get_dataset(
        config, evaluation=True, uniform_dequantization=True)
    test_split = ecfg.bpd_dataset.lower() == "test"
    bpd_iter = bpd_test_iter if test_split else bpd_train_iter
    # The test split 5 times over for tighter intervals (reference
    # run_lib.py:236-242).
    bpd_num_repeats = 5 if test_split else 1

  if ecfg.enable_sampling:
    sampling_shape = (ecfg.batch_size, config.data.image_size,
                      config.data.image_size, config.data.num_channels)
    sampling_fn = sampling.get_sampling_fn(config, sde, model, sampling_shape,
                                           inverse_scaler, device=device,
                                           group=group)

  records = []
  for ckpt in range(ecfg.begin_ckpt, ecfg.end_ckpt + 1):
    # Every rank waits until it sees the file it restores (JAX: rank 0
    # waits, which would hold the others in a barrier for hours), then all
    # pass a barrier (JAX run_lib.py:360-367).
    _wait_for_checkpoint(workdir, ckpt)
    parallel.barrier(group)
    step = ckpt_lib.restore_model_and_ema(
        ckpt_lib.numbered_path(workdir, ckpt), model, ema)
    logging.info("Evaluating checkpoint_%d (step %d) on %s.", ckpt, step,
                 device)
    record = {"ckpt": ckpt, "step": step}

    if ecfg.enable_loss:
      all_losses = [float(eval_step(state, _to_device(b, scaler, device),
                                    generator))
                    for b in _passes(eval_iter, 1, group)]
      if main_rank:
        io.save_npz(
            os.path.join(eval_dir, f"ckpt_{ckpt}_loss.npz"),
            all_losses=np.asarray(all_losses), mean_loss=np.mean(all_losses))
      record["mean_loss"] = float(np.mean(all_losses))
      logging.info("ckpt %d: mean eval loss %.5e", ckpt, record["mean_loss"])

    # The likelihood and the sampler run at the EMA weights.
    ema.copy_to(model.parameters())

    if ecfg.enable_bpd:
      bpds, record["bpd_nfe"], record["bpd_seconds"] = [], [], []
      for batch in _passes(bpd_iter, bpd_num_repeats, group):
        (bpd, _, nfe), seconds = _timed(
            device, likelihood_fn, model, _to_device(batch, scaler, device),
            generator)
        bpds.append(parallel.gather_to_host(bpd, group).numpy())
        record["bpd_nfe"].append(nfe)
        record["bpd_seconds"].append(seconds)
      bpds = np.concatenate(bpds)
      if main_rank:
        io.save_npz(
            os.path.join(eval_dir,
                         f"{ecfg.bpd_dataset}_ckpt_{ckpt}_bpd.npz"),
            bpd=bpds.astype(np.float64))  # the JAX package saves a float list
      record["bpd"] = float(np.mean(bpds))
      logging.info("ckpt %d: mean bpd %.4f (NFE %s)", ckpt, record["bpd"],
                   record["bpd_nfe"])

    if ecfg.enable_sampling:
      num_rounds = (ecfg.num_samples - 1) // ecfg.batch_size + 1
      all_pools, all_logits = [], []
      record["sampling_nfe"], record["sampling_seconds"] = [], []
      record["inception_seconds"] = []
      for r in range(num_rounds):
        (samples, nfe), seconds = _timed(device, sampling_fn, generator)
        samples_np = parallel.gather_to_host(samples, group).numpy()
        record["sampling_nfe"].append(int(nfe))
        record["sampling_seconds"].append(seconds)
        if not np.isfinite(samples_np).all():
          # The ODE sampler returns all-NaN when its solver does not
          # converge; clipping to uint8 would turn that into black images
          # and a finite, meaningless FID.
          raise RuntimeError(
              f"non-finite samples at ckpt {ckpt} round {r} "
              f"(sampler={config.sampling.method}; ODE non-convergence?)")
        logging.info("ckpt %d round %d/%d: %d samples (NFE %d, %.3f s)", ckpt,
                     r + 1, num_rounds, samples_np.shape[0], nfe,
                     record["sampling_seconds"][-1])
        if not main_rank:
          continue
        samples_u8 = np.clip(samples_np * 255.0, 0, 255).astype(np.uint8)
        io.save_npz(
            os.path.join(eval_dir, f"ckpt_{ckpt}_samples_{r}.npz"),
            samples=samples_u8)
        stats, seconds = _timed(device, evaluation.run_inception, samples_u8,
                                config, device)
        if stats is not None:
          record["inception_seconds"].append(seconds)
          io.save_npz(
              os.path.join(eval_dir, f"ckpt_{ckpt}_statistics_{r}.npz"),
              **stats)
          all_pools.append(stats["pool_3"])
          if "logits" in stats:
            all_logits.append(stats["logits"])
      if all_pools:
        scores = evaluation.compute_scores(
            np.concatenate(all_pools), config,
            logits=np.concatenate(all_logits) if all_logits else None,
            device=device)
        io.save_npz(os.path.join(eval_dir, f"report_{ckpt}.npz"), **scores)
        record["scores"] = scores
        logging.info("ckpt %d: %s", ckpt, scores)
    records.append(record)
  return records
