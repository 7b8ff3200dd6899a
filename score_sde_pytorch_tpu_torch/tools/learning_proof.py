"""Learning proof of the flagship: train the full-width CIFAR-10 NCSN++
(``configs/ve/cifar10_ncsnpp_continuous.py``, continuous VE) on synthetic
images whose perturbed score is closed-form, then hold what it learned to
that closed form.

The port's counterpart of the JAX package's tools/learning_proof_tpu.py
(``--task gaussian``) and tools/learning_proof_mixture_tpu.py (``--task
mixture``):

    python -m score_sde_pytorch_tpu_torch.tools.learning_proof \\
        --task gaussian|mixture [--n_outer N] [--dtype float32|bfloat16] \\
        [--device cuda|cuda:N|cpu] [--tiny]

Data, drawn from ``np.random.default_rng(0)``:

- gaussian: pixels iid N(0.5, 0.2²); p_t = N(0.5, v_t I) with
  v_t = 0.2² + sigma(t)², score ``-(x - 0.5) / v_t``;
- mixture: per image a mode k ~ Bernoulli(1/2), x0 = mu_k + 0.1 z with
  mu = (0.25, 0.75); the score is ``-(x - sum_k r_k(x) mu_k) / v_t`` with
  the mode posterior r_k(x) a softmax over the whole image
  (:func:`analytic_score`), so matching it needs global context.

Training is the port's train path at the config's settings: Adam at lr
2e-4 with warm-up 5000 and clipping 1, the EMA at 0.999, batch 128,
``losses.get_n_step_fn`` over 10 steps a call (``--n_outer`` calls: 300
for gaussian, 400 for mixture, the JAX tools' counts), fp32 under
PyTorch's default TF32 settings unless ``--dtype bfloat16``. On a CUDA
card every attention call runs the flash-attention kernels, forward and
backward.

Printed as JSON lines as it goes: each call's mean loss (``chunk_loss``,
the mean of its 10 step losses) and, every 10 calls, the EMA score's
rel-L2 at t = 0.5 and 0.9 on fixed draws. Then the checks, from
the EMA weights: the score's rel-L2 against the closed form at t = 0.05,
0.2, 0.5 and 0.9 on 64 draws of x ~ p_t; gaussian: the PC sampler at N =
200 (reverse diffusion + Langevin, the config's snr) and heun at 50 steps,
mean and std of 256 samples; mixture: PC at N = 200 and DPM-Solver++(2M)
at 20 steps, :func:`mode_stats` of 256 samples. Last, ``FINAL {...}`` with
everything, the gates of :data:`GATES` and the card's ``nvidia-smi`` name
and power limit. ``--tiny`` shrinks the model, the images and the counts
for a run on the CPU (the protocol unchanged).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from score_sde_pytorch_tpu_torch import configs, losses, sampling
from score_sde_pytorch_tpu_torch import main as cli
from score_sde_pytorch_tpu_torch import sde as sde_lib
from score_sde_pytorch_tpu_torch.models import utils as mutils
from score_sde_pytorch_tpu_torch.tools.train_step_grid import card_line

FLAGSHIP = str(configs.CONFIG_DIR / "ve" / "cifar10_ncsnpp_continuous.py")
MU, SIGMA_D = 0.5, 0.2                 # gaussian
MU0, MU1, MIX_SIGMA_D = 0.25, 0.75, 0.1  # mixture
N_INNER = 10                           # train steps per n-step call
N_OUTER = {"gaussian": 300, "mixture": 400}
TIMES = (0.05, 0.2, 0.5, 0.9)
PROBE_TIMES = (0.5, 0.9)
PROBE_EVERY = 10                       # n-step calls between probes
SEED = 0                               # weights, data and draws
EPS = 1e-5
# Batch, images, score draws, samples, PC steps, heun and DPM-Solver++ steps.
FULL = dict(batch=128, size=32, draws=64, samples=256, pc_n=200,
            heun_steps=50, dpmpp_steps=20)
TINY = dict(batch=16, size=8, draws=16, samples=32, pc_n=20,
            heun_steps=5, dpmpp_steps=5)
TINY_OVERRIDES = ["model.nf=16", "model.ch_mult=(1,2)",
                  "model.num_res_blocks=1", "model.attn_resolutions=(4,)",
                  "data.image_size=8"]
# The full runs' gates, from the JAX package's records with a margin:
# (value's key, bound, "max" for value <= bound, "abs" for |value - target|
# <= bound, "range" for bound[0] < value < bound[1]).
GATES = {
    "gaussian": [
        ("score_rel_err.0.05", 0.15, "max"),
        ("score_rel_err.0.2", 0.06, "max"),
        ("score_rel_err.0.5", 0.06, "max"),
        ("score_rel_err.0.9", 0.06, "max"),
        ("pc.mean", (MU, 0.01), "abs"),
        ("pc.std", (SIGMA_D, 0.01), "abs"),
    ],
    "mixture": [
        ("score_rel_err.0.05", 0.2, "max"),
        ("score_rel_err.0.2", 0.2, "max"),
        ("score_rel_err.0.5", 0.2, "max"),
        ("score_rel_err.0.9", 0.2, "max"),
        ("pc.frac_hi", (0.35, 0.65), "range"),
        ("pc.lo_mean", (MU0, 0.08), "abs"),
        ("pc.hi_mean", (MU1, 0.08), "abs"),
        ("pc.lo_std", (MIX_SIGMA_D, 0.1), "abs"),
        ("pc.hi_std", (MIX_SIGMA_D, 0.1), "abs"),
    ],
}


def analytic_score(np_mod, x, var_t):
  """Closed-form mixture score for x of shape (b, h, w, c) (any layout with
  the image first)."""
  b = x.shape[0]
  flat = x.reshape(b, -1)
  # log responsibilities (equal weights cancel)
  l0 = -np_mod.sum((flat - MU0) ** 2, -1) / (2 * var_t)
  l1 = -np_mod.sum((flat - MU1) ** 2, -1) / (2 * var_t)
  m = np_mod.maximum(l0, l1)
  e0, e1 = np_mod.exp(l0 - m), np_mod.exp(l1 - m)
  r1 = e1 / (e0 + e1)
  mu_post = (MU0 + (MU1 - MU0) * r1)[:, None, None, None]
  return -(x - mu_post) / var_t


def mode_stats(samples):
  """Per-image mode split + within-mode pixel moments."""
  s = np.asarray(samples, np.float32)
  img_mean = s.reshape(s.shape[0], -1).mean(-1)
  hi = img_mean > (MU0 + MU1) / 2
  out = {"frac_hi": round(float(hi.mean()), 4)}
  for name, sel, mu in (("lo", ~hi, MU0), ("hi", hi, MU1)):
    if sel.sum() == 0:
      out[f"{name}_mean"] = None
      continue
    grp = s[sel]
    out[f"{name}_mean"] = round(float(grp.mean()), 4)
    out[f"{name}_std"] = round(float(grp.std()), 4)
    out[f"{name}_target_mean"] = mu
  return out


def gaussian_score(x: np.ndarray, var_t: float) -> np.ndarray:
  return -(x - MU) / var_t


def draw_x0(rng: np.random.Generator, task: str, shape: tuple) -> np.ndarray:
  """Clean images of ``task``, float32, of ``shape`` (..., C, H, W): for
  the mixture, a mode per image."""
  z = rng.standard_normal(shape, dtype=np.float32)
  if task == "gaussian":
    return MU + SIGMA_D * z
  mode = rng.random(shape[:-3]) < 0.5
  mu = np.where(mode, MU1, MU0).astype(np.float32)
  return mu[..., None, None, None] + MIX_SIGMA_D * z


def draw_xt(rng: np.random.Generator, task: str, n: int, size: int,
            var_t: float) -> np.ndarray:
  """``n`` draws of x ~ p_t, float64 NCHW: the data's centre (per image for
  the mixture) plus N(0, v_t) noise."""
  shape = (n, 3, size, size)
  if task == "gaussian":
    centre = np.full((n, 1, 1, 1), MU)
  else:
    centre = np.where(rng.random(n) < 0.5, MU1, MU0).reshape(n, 1, 1, 1)
  return centre + np.sqrt(var_t) * rng.standard_normal(shape)


def load_config(tiny: bool, dtype: str, seed: int):
  overrides = [f"model.dtype={dtype}", f"seed={seed}"]
  return configs.load_config(FLAGSHIP,
                             overrides + (TINY_OVERRIDES if tiny else []))


class Proof:
  """The flagship's model, train state and n-step function on ``device``,
  and the closed-form checks of ``task`` at the EMA weights."""

  def __init__(self, config, task: str, device, sizes: dict):
    self.config, self.task, self.sizes = config, task, sizes
    self.device = torch.device(device)
    torch.manual_seed(config.seed)  # dropout's default generators
    self.model = mutils.create_model(
        config, self.device, torch.Generator().manual_seed(config.seed))
    self.state = losses.init_train_state(config, self.model, self.device)
    self.sde = sde_lib.build_sde(config)
    tcfg = config.training
    self.n_step_fn = losses.get_n_step_fn(
        losses.get_step_fn(self.sde, train=True,
                           optimize_fn=losses.optimization_manager(config),
                           reduce_mean=tcfg.reduce_mean,
                           continuous=tcfg.continuous,
                           likelihood_weighting=tcfg.likelihood_weighting),
        N_INNER)
    self.data_rng = np.random.default_rng(config.seed)

  def train_call(self) -> torch.Tensor:
    """One n-step call on fresh batches; the [N_INNER] losses (device)."""
    size = self.sizes["size"]
    x = draw_x0(self.data_rng, self.task,
                (N_INNER, self.sizes["batch"], 3, size, size))
    batches = torch.from_numpy(x).to(self.device)
    return self.n_step_fn(self.state, list(batches), self.state["generator"])

  def var_t(self, t: float) -> float:
    sigma = float(self.sde.marginal_prob(torch.zeros(1), torch.tensor([t]))[1])
    sigma_d = SIGMA_D if self.task == "gaussian" else MIX_SIGMA_D
    return sigma_d ** 2 + sigma ** 2

  def score_rel_err(self, times: Sequence[float], seed: int) -> dict:
    """The EMA score's rel-L2 against the closed form at each of ``times``,
    on draws of x ~ p_t from ``default_rng(seed)``; the model's own weights
    are put back."""
    ema = self.state["ema"]
    ema.store(self.model.parameters())
    ema.copy_to(self.model.parameters())
    try:
      score_fn = mutils.get_score_fn(self.sde, self.model, train=False,
                                     continuous=True)
      rng = np.random.default_rng(seed)
      n = self.sizes["draws"]
      out = {}
      for t in times:
        var_t = self.var_t(t)
        x = draw_xt(rng, self.task, n, self.sizes["size"], var_t)
        with torch.no_grad():
          learned = score_fn(
              torch.from_numpy(x.astype(np.float32)).to(self.device),
              torch.full((n,), t, device=self.device))
        learned = learned.double().cpu().numpy()
        analytic = (gaussian_score(x, var_t) if self.task == "gaussian"
                    else analytic_score(np, x, var_t))
        out[str(t)] = round(float(np.linalg.norm(learned - analytic)
                                  / np.linalg.norm(analytic)), 4)
      return out
    finally:
      ema.restore(self.model.parameters())

  def samples(self) -> dict:
    """The task's samplers at the EMA weights (the model keeps them)."""
    self.state["ema"].copy_to(self.model.parameters())
    size, n = self.sizes["size"], self.sizes["samples"]
    shape = (n, size, size, 3)
    identity = lambda x: x  # noqa: E731  (the data are not scaled)
    pc = sampling.get_pc_sampler(
        dataclasses.replace(self.sde, N=self.sizes["pc_n"]), self.model,
        shape, sampling.get_predictor("reverse_diffusion"),
        sampling.get_corrector("langevin"), identity,
        snr=self.config.sampling.snr, n_steps=1, continuous=True,
        denoise=True, eps=EPS)
    if self.task == "gaussian":
      second = ("heun", sampling.get_heun_sampler(
          self.sde, self.model, shape, identity,
          n_steps=self.sizes["heun_steps"], denoise=True, continuous=True,
          eps=EPS))
      stats = moments
    else:
      second = ("dpmpp", sampling.get_dpmpp_sampler(
          self.sde, self.model, shape, identity,
          n_steps=self.sizes["dpmpp_steps"], continuous=True, eps=EPS))
      stats = mode_stats
    out = {}
    for seed, (name, fn) in enumerate((("pc", pc), second), start=8):
      start = time.perf_counter()
      samples, nfe = fn(torch.Generator(self.device).manual_seed(seed))
      samples = samples.float().cpu().numpy()
      out[name] = dict(stats(samples), nfe=int(nfe),
                       finite=bool(np.isfinite(samples).all()),
                       seconds=round(time.perf_counter() - start, 3))
      emit({name: out[name]})
    return out


def moments(samples) -> dict:
  s = np.asarray(samples, np.float32)
  return {"mean": round(float(s.mean()), 4), "std": round(float(s.std()), 4)}


def emit(record: dict, prefix: str = "") -> None:
  print(prefix + json.dumps(record), flush=True)


def check_gates(task: str, out: dict) -> dict:
  """``{key: [value, bound, passed]}`` for each gate of ``task``; a key
  ``a.b`` reads ``out[a][b]``."""
  result = {}
  for key, bound, kind in GATES[task]:
    head, rest = key.split(".", 1)
    value = out[head][rest]
    if value is None:
      ok = False
    elif kind == "max":
      ok = value <= bound
    elif kind == "abs":
      ok = abs(value - bound[0]) <= bound[1]
    else:
      ok = bound[0] < value < bound[1]
    result[key] = [value, bound, bool(ok)]
  return result


def card_description(device: torch.device) -> dict:
  """The card's name and ``nvidia-smi`` power limit, or the CPU."""
  if device.type != "cuda":
    return {"device": "cpu", "card": None}
  return {"device": torch.cuda.get_device_name(device), "card": card_line()}


def train(proof: Proof, n_outer: int, probe_every: int) -> dict:
  """``n_outer`` n-step calls, a JSON line each, the probes between them;
  returns the loss curve and the wall time (device synchronized)."""
  curve, probes, first = [], [], None
  sync = (torch.cuda.synchronize if proof.device.type == "cuda"
          else lambda *a: None)
  sync(proof.device)
  start = time.perf_counter()
  for i in range(n_outer):
    ls = proof.train_call().float().cpu().numpy()
    step = (i + 1) * N_INNER
    if first is None:
      first = float(ls[0])
    curve.append(round(float(ls.mean()), 4))
    emit({"step": step, "chunk_loss": curve[-1]})
    if probe_every and (i + 1) % probe_every == 0 and i + 1 < n_outer:
      probes.append({"step": step,
                     "rel": proof.score_rel_err(PROBE_TIMES, seed=42)})
      emit({"probe": probes[-1]})
  sync(proof.device)
  seconds = time.perf_counter() - start
  steps = n_outer * N_INNER
  return {"steps": steps, "train_s": round(seconds, 1),
          "ms_per_step": round(seconds / steps * 1e3, 2),
          "first_step_loss": round(first, 2), "loss_curve": curve,
          "probes": probes}


def parse_args(argv: Sequence[str]):
  parser = argparse.ArgumentParser(
      prog="python -m score_sde_pytorch_tpu_torch.tools.learning_proof",
      description="Train the flagship on closed-form data and check it.")
  parser.add_argument("--task", choices=sorted(N_OUTER), default="gaussian")
  parser.add_argument("--n_outer", type=int, default=0,
                      help="n-step calls of 10 steps (0: the task's count)")
  parser.add_argument("--dtype", choices=("float32", "bfloat16"),
                      default="float32")
  parser.add_argument("--device", default="cuda", type=cli._device,
                      help="cuda, cuda:N or cpu (default cuda)")
  parser.add_argument("--tiny", action="store_true",
                      help="a tiny model and tiny counts, for the CPU")
  return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
  """Runs the proof; returns what ``FINAL`` prints."""
  args = parse_args(sys.argv[1:] if argv is None else list(argv))
  device = cli.require_device(args.device)
  config = load_config(args.tiny, args.dtype, SEED)
  proof = Proof(config, args.task, device, TINY if args.tiny else FULL)
  n_params = sum(p.numel() for p in proof.model.parameters())
  emit({"task": args.task, "dtype": args.dtype, "tiny": args.tiny,
        "parameters": n_params, "batch": proof.sizes["batch"],
        "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                 "cudnn": torch.backends.cudnn.allow_tf32},
        **card_description(device)})
  out = train(proof, args.n_outer or N_OUTER[args.task], PROBE_EVERY)
  out["score_rel_err"] = proof.score_rel_err(TIMES, seed=42)
  emit({"score_rel_err": out["score_rel_err"]})
  out.update(proof.samples())
  out["gates"] = check_gates(args.task, out)
  out["gates_passed"] = all(g[2] for g in out["gates"].values())
  out.update(task=args.task, dtype=args.dtype, tiny=args.tiny,
             parameters=n_params, **card_description(device))
  emit(out, prefix="FINAL ")
  return out


if __name__ == "__main__":
  main()
