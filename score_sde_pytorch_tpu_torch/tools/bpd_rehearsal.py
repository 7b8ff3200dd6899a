"""Bits/dim chain on data whose optimal bits/dim is known in closed form.

The port's counterpart of the JAX package's tools/bpd_rehearsal_tpu.py:

    python -m score_sde_pytorch_tpu_torch.tools.bpd_rehearsal \\
        --workdir DIR [--n_iters 3000] [--snapshot_freq 1000] [--batch 128] \\
        [--num_train 4096] [--num_test 256] [--tf32 on,off] \\
        [--device cuda|cuda:N|cpu] [--tiny] [--skip_train] \\
        [--config.section.key=value ...]

The data are uint8 images with iid pixels, a quantized clipped
N(127.5, 51²) (:func:`make_dataset`, ``DIR/data/{train,test}.npz``). For
uniformly dequantized data no continuous density does better than the
pixels' discrete entropy, :func:`analytic_bpd_bound` (7.6495 bits/dim),
and a perfect model attains it; so the chain is held from both sides: its
bits/dim must fall toward the bound as training goes on, and never cross
below it by more than the estimate's noise.

The chain is the port's own: the subVP DDPM++ continuous config
(``configs/subvp/cifar10_ddpmpp_continuous.py``, full width, fp32) on
``data.dataset = "NPZ"``; ``checkpoints/checkpoint_0.pth`` the untrained
state; ``run_lib.train`` for ``--n_iters`` steps (10 a call) with numbered
snapshots every ``--snapshot_freq``; then ``run_lib.evaluate``'s bits/dim
stage on the test split (dequantized, repeated 5 times; RK45 through the
probability-flow ODE with the Hutchinson divergence by vjp) into
``DIR/eval_tf32_<setting>/test_ckpt_<N>_bpd.npz``. Each TF32 setting of
``--tf32`` is evaluated by its own process, started with the training and
waiting for each checkpoint as ``--mode eval`` waits: ``on`` is PyTorch's
default (TF32 in cuDNN's convolutions; matmuls in full fp32), ``off`` is
fp32 throughout. ``--skip_train`` evaluates checkpoints already in
``DIR``, so a run cut short can resume; config overrides come after the
tool's own (``--config.eval.begin_ckpt=2`` evaluates from checkpoint 2).

Printed last: for each setting and checkpoint the mean bits/dim, its
standard error, the finite count and the gap to the bound, the gates
(:func:`check_gates`), and ``FINAL {...}`` with the card's ``nvidia-smi`` name
and power limit. ``--tiny`` shrinks the model and images for the CPU.
"""
from __future__ import annotations

import argparse
import json
import logging
import math
import multiprocessing
import os
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from score_sde_pytorch_tpu_torch import checkpoint as ckpt_lib
from score_sde_pytorch_tpu_torch import configs, losses, run_lib
from score_sde_pytorch_tpu_torch import main as cli
from score_sde_pytorch_tpu_torch.models import utils as mutils
from score_sde_pytorch_tpu_torch.tools.learning_proof import card_description

CONFIG = str(configs.CONFIG_DIR / "subvp" / "cifar10_ddpmpp_continuous.py")
TINY_OVERRIDES = ["model.nf=16", "model.num_res_blocks=1",
                  "model.ch_mult=(1,2)", "model.attn_resolutions=(8,)",
                  "data.image_size=16"]
TF32 = {"on": None, "off": (False, False)}  # None: PyTorch's defaults
# The gates of a full run, for each TF32 setting.
MAX_FINAL_GAP = 0.15   # bits/dim above the bound at the last checkpoint
MAX_BELOW_SE = 3.0     # standard errors a mean may fall below the bound


def make_dataset(root: str, size: int = 32, n_train: int = 4096,
                 n_test: int = 256):
  """``root/train.npz`` and ``root/test.npz`` (``images``, uint8 NHWC),
  the pixels 255 · N(0.5, 0.2²) clipped to [0, 255], seeds 7 and 8."""
  def gen(n, seed):
    r = np.random.default_rng(seed)
    x = r.normal(0.5, 0.2, size=(n, size, size, 3))
    return np.clip(x * 255.0, 0, 255).astype(np.uint8)
  os.makedirs(root, exist_ok=True)
  np.savez(os.path.join(root, "train.npz"), images=gen(n_train, 7))
  np.savez(os.path.join(root, "test.npz"), images=gen(n_test, 8))


def analytic_bpd_bound(mu: float = 127.5, sigma: float = 51.0) -> float:
  """Discrete entropy (bits) of the per-pixel quantized clipped Gaussian:
  bin k holds the Gaussian mass of [k, k+1), the clipped tails go to bins
  0 and 255."""
  edges = np.arange(257, dtype=np.float64)
  cdf = 0.5 * (1.0 + np.vectorize(math.erf)(
      (edges - mu) / (sigma * math.sqrt(2.0))))
  p = np.diff(cdf)
  p[0] += cdf[0]          # clipped lower tail -> bin 0
  p[-1] += 1.0 - cdf[-1]  # clipped upper tail -> bin 255
  p = p[p > 0]
  return float(-(p * np.log2(p)).sum())


def overrides(args) -> list:
  """The config's overrides for this run (the JAX tool's settings)."""
  end = args.n_iters // args.snapshot_freq
  out = [
      "data.dataset=NPZ", f"data.data_dir={os.path.join(args.workdir, 'data')}",
      f"training.batch_size={args.batch}", f"training.n_iters={args.n_iters}",
      f"training.snapshot_freq={args.snapshot_freq}",
      f"training.snapshot_freq_for_preemption={args.n_iters + 1}",
      f"training.eval_freq={args.n_iters + 1}", "training.log_freq=200",
      "training.snapshot_sampling=False", "training.n_jitted_steps=10",
      "eval.begin_ckpt=0", f"eval.end_ckpt={end}",
      f"eval.batch_size={args.batch}", "eval.enable_loss=False",
      "eval.enable_bpd=True", "eval.bpd_dataset=test",
      "eval.enable_sampling=False"]
  return out + (TINY_OVERRIDES if args.tiny else []) + args.overrides


def eval_folder(setting: str) -> str:
  return f"eval_tf32_{setting}"


def _log_to_stdout(prefix: str) -> None:
  logging.basicConfig(level=logging.INFO, stream=sys.stdout, force=True,
                      format=f"{prefix}%(asctime)s %(message)s")


def evaluate(config_overrides: list, workdir: str, setting: str,
             device: str, threads: int) -> None:
  """One TF32 setting's ``run_lib.evaluate`` (a process of its own, on
  ``threads`` host threads); its records go to
  ``<folder>/bpd_records.json``."""
  torch.set_num_threads(threads)
  _log_to_stdout(f"[eval tf32 {setting}] ")
  if TF32[setting] is not None:
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = TF32[setting]
  config = configs.load_config(CONFIG, config_overrides)
  start = time.perf_counter()
  records = run_lib.evaluate(config, workdir, eval_folder(setting), device)
  with open(os.path.join(workdir, eval_folder(setting),
                         "bpd_records.json"), "w") as f:
    json.dump({"records": records, "seconds": time.perf_counter() - start,
               "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                        "cudnn": torch.backends.cudnn.allow_tf32}}, f)


def trajectory(workdir: str, setting: str, ckpts: range,
               bound: float) -> dict:
  """Each checkpoint's mean bits/dim, standard error, finite count and gap
  to ``bound`` (the JAX tool's report)."""
  traj = {}
  for k in ckpts:
    path = os.path.join(workdir, eval_folder(setting), f"test_ckpt_{k}_bpd.npz")
    with np.load(path) as z:
      v = np.asarray(z["bpd"], np.float64)
    finite = v[np.isfinite(v)]
    traj[k] = {
        "mean_bpd": float(finite.mean()) if finite.size else None,
        "stderr": (float(finite.std(ddof=1) / np.sqrt(finite.size))
                   if finite.size > 1 else None),
        "n_finite": int(finite.size), "n_total": int(v.size),
        "gap_to_bound": (float(finite.mean() - bound) if finite.size
                         else None),
    }
  return traj


def check_gates(traj: dict, bound: float) -> dict:
  """``{gate: passed}`` of one setting's trajectory."""
  first, last = traj[min(traj)], traj[max(traj)]
  means = [r["mean_bpd"] for r in traj.values()]
  return {
      "all_finite": all(r["n_finite"] == r["n_total"] for r in traj.values()),
      "falls": None not in (first["mean_bpd"], last["mean_bpd"])
               and last["mean_bpd"] < first["mean_bpd"],
      "final_gap_le_0.15": last["gap_to_bound"] is not None
                           and last["gap_to_bound"] <= MAX_FINAL_GAP,
      "none_below_bound_by_3se": None not in means and all(
          r["mean_bpd"] >= bound - MAX_BELOW_SE * (r["stderr"] or 0.0)
          for r in traj.values()),
  }


def parse_args(argv: Sequence[str]):
  parser = argparse.ArgumentParser(
      prog="python -m score_sde_pytorch_tpu_torch.tools.bpd_rehearsal",
      description="Train and evaluate bits/dim against its entropy bound.")
  parser.add_argument("--workdir", required=True)
  parser.add_argument("--n_iters", type=int, default=3000)
  parser.add_argument("--snapshot_freq", type=int, default=1000)
  parser.add_argument("--batch", type=int, default=128,
                      help="train and eval batch size")
  parser.add_argument("--num_train", type=int, default=4096)
  parser.add_argument("--num_test", type=int, default=256,
                      help="test images (the bits/dim split, 5 passes)")
  parser.add_argument("--tf32", default="on,off",
                      help="comma-separated TF32 settings to evaluate under")
  parser.add_argument("--device", default="cuda", type=cli._device,
                      help="cuda, cuda:N or cpu (default cuda)")
  parser.add_argument("--tiny", action="store_true",
                      help="a tiny model and 16x16 images, for the CPU")
  parser.add_argument("--skip_train", action="store_true",
                      help="evaluate the numbered checkpoints in --workdir")
  overrides, rest = cli.split_overrides(argv)
  args = parser.parse_args(rest)
  args.overrides = overrides
  args.tf32 = [s for s in args.tf32.split(",") if s]
  unknown = set(args.tf32) - set(TF32)
  if unknown:
    parser.error(f"--tf32: unknown settings {sorted(unknown)}")
  return args


def main(argv: Optional[Sequence[str]] = None) -> dict:
  """Runs the chain; returns what ``FINAL`` prints."""
  args = parse_args(sys.argv[1:] if argv is None else list(argv))
  device = cli.require_device(args.device)
  _log_to_stdout("[train] ")
  workdir = os.path.abspath(args.workdir)
  args.workdir = workdir
  config_overrides = overrides(args)
  config = configs.load_config(CONFIG, config_overrides)
  ckpts = range(config.eval.begin_ckpt, config.eval.end_ckpt + 1)
  if not args.skip_train:
    make_dataset(os.path.join(workdir, "data"),
                 size=config.data.image_size, n_train=args.num_train,
                 n_test=args.num_test)
    # checkpoint_0: the untrained state, the baseline the others must beat.
    model = mutils.create_model(config, device,
                                torch.Generator().manual_seed(config.seed))
    ckpt_lib.save_train_state(ckpt_lib.numbered_path(workdir, 0),
                              losses.init_train_state(config, model, device))
    del model
  # The host's threads shared among this process and the evaluations.
  threads = max(1, torch.get_num_threads() // (len(args.tf32) + 1))
  torch.set_num_threads(threads)
  ctx = multiprocessing.get_context("spawn")
  evals = [ctx.Process(target=evaluate, daemon=True,
                       args=(config_overrides, workdir, s, str(device),
                             threads))
           for s in args.tf32]
  for p in evals:
    p.start()
  out = {"bound_bpd": round(analytic_bpd_bound(), 4),
         "config": os.path.relpath(CONFIG, os.getcwd()),
         "tiny": args.tiny, **card_description(device)}
  try:
    if not args.skip_train:
      start = time.perf_counter()
      result = run_lib.train(config, workdir, device=device)
      seconds = time.perf_counter() - start
      out["train"] = {"steps": result["step"], "train_s": round(seconds, 1),
                      "ms_per_step": round(seconds / result["step"] * 1e3, 2),
                      "losses": result["train_losses"]}
      print(json.dumps({"train": out["train"]}), flush=True)
    for p in evals:
      p.join()
  finally:
    for p in evals:
      if p.is_alive():
        p.terminate()
        p.join()
  failed = [s for s, p in zip(args.tf32, evals) if p.exitcode != 0]
  if failed:
    raise RuntimeError(f"the evaluation under TF32 {failed} failed")

  bound = analytic_bpd_bound()
  out["settings"] = {}
  for s in args.tf32:
    traj = trajectory(workdir, s, ckpts, bound)
    with open(os.path.join(workdir, eval_folder(s), "bpd_records.json")) as f:
      records = json.load(f)
    out["settings"][s] = {
        "tf32": records["tf32"], "eval_s": round(records["seconds"], 1),
        "nfe": {r["ckpt"]: r["bpd_nfe"] for r in records["records"]},
        "s_per_batch": {r["ckpt"]: round(float(np.mean(r["bpd_seconds"])), 3)
                        for r in records["records"]},
        "trajectory": traj, "gates": check_gates(traj, bound)}
    print(json.dumps({s: out["settings"][s]}), flush=True)
  out["side_by_side"] = {
      k: {s: out["settings"][s]["trajectory"][k]["mean_bpd"]
          for s in args.tf32} for k in ckpts}
  out["gates_passed"] = all(all(v["gates"].values())
                            for v in out["settings"].values())
  print("FINAL " + json.dumps(out), flush=True)
  return out


if __name__ == "__main__":
  main()
