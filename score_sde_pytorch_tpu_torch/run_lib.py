"""Pipelines of the port: training, evaluation, and sampling from a
checkpoint.

Counterpart of score_sde_pytorch_tpu/run_lib.py:66-248 (``train``),
:251-464 (``evaluate``) and :467-588 (``sample``). One process; the JAX
package's multi-host paths are ROADMAP.md queue 1 item 8.
"""
from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from score_sde_pytorch_tpu_torch import checkpoint as ckpt_lib
from score_sde_pytorch_tpu_torch import datasets, evaluation, losses, sampling
from score_sde_pytorch_tpu_torch import likelihood as likelihood_lib
from score_sde_pytorch_tpu_torch import sde as sde_lib
from score_sde_pytorch_tpu_torch.models import utils as mutils
from score_sde_pytorch_tpu_torch.models.ema import ExponentialMovingAverage
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
  if SummaryWriter is None:
    return _NullWriter()
  return SummaryWriter(os.path.join(workdir, "tensorboard"))


def _resolve_checkpoint(workdir: str, checkpoint: int):
  if checkpoint >= 0:
    path = ckpt_lib.numbered_path(workdir, checkpoint)
    if not os.path.isfile(path):
      raise FileNotFoundError(f"checkpoint_{checkpoint} not found: {path}")
    return path, f"checkpoint_{checkpoint}"
  latest = ckpt_lib.latest_numbered(workdir)
  if latest is not None:
    return ckpt_lib.numbered_path(workdir, latest), f"checkpoint_{latest}"
  if os.path.isfile(ckpt_lib.meta_path(workdir)):
    return ckpt_lib.meta_path(workdir), "checkpoints-meta"
  raise FileNotFoundError(
      f"no checkpoint under {workdir} (checkpoints/checkpoint_N.pth or "
      "checkpoints-meta/checkpoint.pth)")


def sample(config, workdir: str, sample_folder: str = "generated",
           checkpoint: int = -1, num_samples: int = 0,
           device: str = "cuda") -> list:
  """Generate samples from a checkpoint's EMA weights.

  Runs the configured sampler in rounds of ``config.eval.batch_size``,
  checks every round is finite, trims the last round to ``num_samples``
  (0 means one batch), and writes ``samples_<r>.npz`` (uint8, NHWC) and a
  PNG grid per round under ``workdir/<sample_folder>/``.

  Returns one dict per round: ``samples``, ``nfe`` and ``seconds`` (wall
  time of the round's sampler call, ended by the copy to the host)."""
  device = torch.device(device)
  out_dir = os.path.join(workdir, sample_folder)
  os.makedirs(out_dir, exist_ok=True)

  model = mutils.create_model(config, device,
                              torch.Generator().manual_seed(config.seed))
  path, label = _resolve_checkpoint(workdir, checkpoint)
  step = ckpt_lib.restore_ema(path, model)
  logging.info("Sampling from %s (step %d) on %s.", label, step, device)

  sde = sde_lib.build_sde(config)
  batch = config.eval.batch_size
  shape = (batch, config.data.image_size, config.data.image_size,
           config.data.num_channels)
  sampling_fn = sampling.get_sampling_fn(
      config, sde, model, shape, datasets.get_data_inverse_scaler(config),
      device=device)

  generator = torch.Generator(device=device).manual_seed(config.seed + 2)
  num_samples = num_samples or batch
  num_rounds = (num_samples - 1) // batch + 1
  rounds = []
  for r in range(num_rounds):
    start = time.perf_counter()
    samples, nfe = sampling_fn(generator)
    samples_np = samples.cpu().numpy()
    seconds = time.perf_counter() - start
    if not np.isfinite(samples_np).all():
      raise RuntimeError(f"non-finite samples in round {r} "
                         f"(sampler={config.sampling.method})")
    samples_np = samples_np[:min(batch, num_samples - r * batch)]
    samples_u8 = np.clip(samples_np * 255.0, 0, 255).astype(np.uint8)
    np.savez_compressed(os.path.join(out_dir, f"samples_{r}.npz"),
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


def train(config, workdir: str, device: str = "cuda") -> dict:
  """Train loop (JAX run_lib.py:66-248).

  Resumes from ``checkpoints-meta/checkpoint.pth`` when it exists. Each
  call of the n-step function runs ``training.n_jitted_steps`` eager steps;
  logs, the rolling snapshot, the eval loss and the numbered snapshots
  (with a sample grid from the EMA weights) land on the JAX package's
  steps (``step % freq < n_jitted_steps``). The host syncs with the device
  only where a loss is logged.

  A resumed run repeats an uninterrupted one: the checkpoint carries the
  generators' states, the data streams are replayed to where the run
  stopped (the port's numpy batches, in one fixed order), and the eval and
  sampling draws depend only on the step.

  Returns ``{"initial_step", "step", "train_losses", "eval_losses"}``, the
  losses as ``(step, value)`` pairs of the logged values."""
  device = torch.device(device)
  os.makedirs(workdir, exist_ok=True)
  writer = _writer(workdir)
  sample_dir = os.path.join(workdir, "samples")
  os.makedirs(sample_dir, exist_ok=True)

  torch.manual_seed(config.seed)  # dropout's default generators
  model = mutils.create_model(config, device,
                              torch.Generator().manual_seed(config.seed))
  state = losses.init_train_state(config, model, device)
  meta = ckpt_lib.meta_path(workdir)
  if os.path.isfile(meta):
    ckpt_lib.restore_train_state(meta, state)
  initial_step = state["step"]

  # The numpy pipeline's order is fixed, so a resumed run can replay it.
  train_iter, eval_iter = datasets.get_dataset(config)
  scaler = datasets.get_data_scaler(config)
  n_jitted = config.training.get("n_jitted_steps", 1)
  tcfg = config.training
  for _ in range(initial_step):
    next(train_iter)
  for _ in range(n_jitted * _evals_before(initial_step, n_jitted,
                                          tcfg.eval_freq)):
    next(eval_iter)

  sde = sde_lib.build_sde(config)
  step_kwargs = dict(reduce_mean=tcfg.reduce_mean, continuous=tcfg.continuous,
                     likelihood_weighting=tcfg.likelihood_weighting)
  train_step = losses.get_n_step_fn(
      losses.get_step_fn(sde, train=True,
                         optimize_fn=losses.optimization_manager(config),
                         **step_kwargs), n_jitted)
  eval_step = losses.get_n_step_fn(
      losses.get_step_fn(sde, train=False, **step_kwargs), n_jitted)

  def next_batches(it):
    return [_to_device(next(it), scaler, device) for _ in range(n_jitted)]

  if tcfg.snapshot_sampling:
    sampling_shape = (tcfg.batch_size, config.data.image_size,
                      config.data.image_size, config.data.num_channels)
    sampling_fn = sampling.get_sampling_fn(
        config, sde, model, sampling_shape,
        datasets.get_data_inverse_scaler(config), device=device)

  logging.info("Starting training loop at step %d.", initial_step)
  step = initial_step
  t_last = time.time()
  train_losses, eval_losses = [], []
  while step < tcfg.n_iters:
    loss = train_step(state, next_batches(train_iter), state["generator"])
    step += n_jitted

    if step % tcfg.log_freq < n_jitted:
      loss_val = float(loss.mean())
      dt = time.time() - t_last
      t_last = time.time()
      logging.info("step: %d, training_loss: %.5e (%.3f s/step)", step,
                   loss_val, dt / max(tcfg.log_freq, 1))
      writer.add_scalar("training_loss", loss_val, step)
      train_losses.append((step, loss_val))

    if step != 0 and step % tcfg.snapshot_freq_for_preemption < n_jitted:
      ckpt_lib.save_train_state(meta, state)

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
          ckpt_lib.numbered_path(workdir, step // tcfg.snapshot_freq), state)
      if tcfg.snapshot_sampling:
        ema = state["ema"]
        ema.store(model.parameters())
        ema.copy_to(model.parameters())
        try:
          samples, _ = sampling_fn(_seeded_generator(device, config.seed,
                                                     step, 1))
        finally:
          ema.restore(model.parameters())
        this_dir = os.path.join(sample_dir, f"iter_{step}")
        os.makedirs(this_dir, exist_ok=True)
        samples_np = samples.cpu().numpy()
        with open(os.path.join(this_dir, "sample.np"), "wb") as fout:
          np.save(fout, samples_np)  # the reference's file name, no .npy
        nrow = int(np.sqrt(samples_np.shape[0]))
        save_image(make_grid(samples_np, nrow, padding=2),
                   os.path.join(this_dir, "sample.png"))
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

  Returns one record per checkpoint with the stages' numbers and times
  (``bpd_nfe`` and ``bpd_seconds`` per batch, ``sampling_nfe`` and
  ``sampling_seconds`` per round, ``inception_seconds``)."""
  device = torch.device(device)
  eval_dir = os.path.join(workdir, eval_folder)
  os.makedirs(eval_dir, exist_ok=True)

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
      likelihood_weighting=tcfg.likelihood_weighting)

  if ecfg.enable_bpd:
    likelihood_fn = likelihood_lib.get_likelihood_fn(sde, model,
                                                     inverse_scaler)
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
                                           inverse_scaler, device=device)

  records = []
  for ckpt in range(ecfg.begin_ckpt, ecfg.end_ckpt + 1):
    _wait_for_checkpoint(workdir, ckpt)
    step = ckpt_lib.restore_model_and_ema(
        ckpt_lib.numbered_path(workdir, ckpt), model, ema)
    logging.info("Evaluating checkpoint_%d (step %d) on %s.", ckpt, step,
                 device)
    record = {"ckpt": ckpt, "step": step}

    if ecfg.enable_loss:
      all_losses = [float(eval_step(
          state, _to_device(next(eval_iter), scaler, device), generator))
                    for _ in range(_epoch_batches(eval_iter))]
      np.savez_compressed(os.path.join(eval_dir, f"ckpt_{ckpt}_loss.npz"),
                          all_losses=np.asarray(all_losses),
                          mean_loss=np.mean(all_losses))
      record["mean_loss"] = float(np.mean(all_losses))
      logging.info("ckpt %d: mean eval loss %.5e", ckpt, record["mean_loss"])

    # The likelihood and the sampler run at the EMA weights.
    ema.copy_to(model.parameters())

    if ecfg.enable_bpd:
      bpds, record["bpd_nfe"], record["bpd_seconds"] = [], [], []
      for _ in range(_epoch_batches(bpd_iter) * bpd_num_repeats):
        (bpd, _, nfe), seconds = _timed(
            device, likelihood_fn, model,
            _to_device(next(bpd_iter), scaler, device), generator)
        bpds.append(bpd.cpu().numpy())
        record["bpd_nfe"].append(nfe)
        record["bpd_seconds"].append(seconds)
      bpds = np.concatenate(bpds)
      np.savez_compressed(
          os.path.join(eval_dir, f"{ecfg.bpd_dataset}_ckpt_{ckpt}_bpd.npz"),
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
        samples_np = samples.cpu().numpy()
        record["sampling_nfe"].append(int(nfe))
        record["sampling_seconds"].append(seconds)
        if not np.isfinite(samples_np).all():
          # The ODE sampler returns all-NaN when its solver does not
          # converge; clipping to uint8 would turn that into black images
          # and a finite, meaningless FID.
          raise RuntimeError(
              f"non-finite samples at ckpt {ckpt} round {r} "
              f"(sampler={config.sampling.method}; ODE non-convergence?)")
        samples_u8 = np.clip(samples_np * 255.0, 0, 255).astype(np.uint8)
        np.savez_compressed(
            os.path.join(eval_dir, f"ckpt_{ckpt}_samples_{r}.npz"),
            samples=samples_u8)
        stats, seconds = _timed(device, evaluation.run_inception, samples_u8,
                                config, device)
        if stats is not None:
          record["inception_seconds"].append(seconds)
          np.savez_compressed(
              os.path.join(eval_dir, f"ckpt_{ckpt}_statistics_{r}.npz"),
              **stats)
          all_pools.append(stats["pool_3"])
          if "logits" in stats:
            all_logits.append(stats["logits"])
        logging.info("ckpt %d round %d/%d: %d samples (NFE %d, %.3f s)", ckpt,
                     r + 1, num_rounds, samples_u8.shape[0], nfe,
                     record["sampling_seconds"][-1])
      if all_pools:
        scores = evaluation.compute_scores(
            np.concatenate(all_pools), config,
            logits=np.concatenate(all_logits) if all_logits else None,
            device=device)
        np.savez_compressed(os.path.join(eval_dir, f"report_{ckpt}.npz"),
                            **scores)
        record["scores"] = scores
        logging.info("ckpt %d: %s", ckpt, scores)
    records.append(record)
  return records
