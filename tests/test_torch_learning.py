"""The port learns the right distribution: the counterpart of
tests/test_learning.py, on the CPU, and the learning tools' CPU paths.

Tiny score networks of the port are trained with the JAX test's configs
and settings (``_learn_config``: 8x8x1 images, N(0.3, 0.4²) pixels,
60 x 25 steps at batch 128, VE with sigma_min 0.1 and sigma_max 5, a VP
DDPM, and the two-mode mixture with attention at 4x4), on batches drawn
with numpy from a seed, and held to the closed-form scores and the data's
moments with the JAX test's tolerances: score rel-L2 ≤ 0.15 (the mixture
< 0.2), moments within 0.06 (mean) and 0.08 (std), inter-pixel
correlation < 0.12, mode balance in (0.35, 0.65). The JAX test's helpers
(``_check_moments``, ``_check_modes``, ``_mixture_score``) are the
checks. Each training fixture takes well over a minute on one torch
thread, so its tests are marked slow, as the JAX test's are.

The tools (``score_sde_pytorch_tpu_torch/tools/learning_proof.py`` and
``bpd_rehearsal.py``) run here at ``--tiny`` size on ``--device cpu``:
their JSON records' keys, and that ``--device cuda`` without a card
raises.
"""
import json

import numpy as np
import pytest
import torch

from score_sde_pytorch_tpu_torch import losses, sampling
from score_sde_pytorch_tpu_torch import sde as sde_lib
from score_sde_pytorch_tpu_torch.models import utils as mutils
from score_sde_pytorch_tpu_torch.tools import bpd_rehearsal, learning_proof
from tests.test_learning import (MIX_MU0, MIX_MU1, MIX_SIGMA_D, MU, SHAPE,
                                 SIGMA_D, _check_modes, _check_moments,
                                 _learn_config, _mixture_score)
from tests.torch_threads import one_torch_thread  # noqa: F401

CHW = (SHAPE[2], SHAPE[0], SHAPE[1])
BATCH = 128
N_DRAWS = 256
slow = pytest.mark.slow  # trains networks to convergence: minutes


def gaussian_batches(rng, shape):
  return MU + SIGMA_D * rng.standard_normal(shape)


def mixture_batches(rng, shape):
  mode = rng.random(shape[:2]) < 0.5
  mu = np.where(mode, MIX_MU1, MIX_MU0)[:, :, None, None, None]
  return mu + MIX_SIGMA_D * rng.standard_normal(shape)


def train(cfg, n_outer, n_inner, draw, seed):
  """The JAX test's ``_train`` on the port: ``n_outer`` calls of the n-step
  function, each on ``n_inner`` batches of ``draw``; the model holds the
  EMA weights after."""
  cfg.seed = seed
  torch.manual_seed(seed)
  sde = sde_lib.build_sde(cfg)
  model = mutils.create_model(cfg, "cpu", torch.Generator().manual_seed(seed))
  state = losses.init_train_state(cfg, model, "cpu")
  n_fn = losses.get_n_step_fn(
      losses.get_step_fn(sde, train=True,
                         optimize_fn=losses.optimization_manager(cfg),
                         reduce_mean=True), n_inner)
  rng = np.random.default_rng(seed + 1)
  first_step_loss, loss_curve = None, []
  for _ in range(n_outer):
    batches = torch.from_numpy(
        draw(rng, (n_inner, BATCH) + CHW).astype(np.float32))
    ls = n_fn(state, list(batches), state["generator"])
    if first_step_loss is None:
      first_step_loss = float(ls[0])  # untrained net: score ≈ 0, loss ≈ 1
    loss_curve.append(float(ls.mean()))
  state["ema"].copy_to(model.parameters())
  return sde, model, (first_step_loss, loss_curve)


def score_fn_at(sde, model):
  fn = mutils.get_score_fn(sde, model, train=False, continuous=True)

  def score(x_nhwc, t_val):
    x = torch.from_numpy(np.asarray(x_nhwc, np.float32)).permute(0, 3, 1, 2)
    with torch.no_grad():
      out = fn(x, torch.full((x.shape[0],), t_val))
    return out.permute(0, 2, 3, 1).double().numpy()

  return score


def sigma_and_mean(sde, t_val):
  """std(t) and the mean coefficient m(t) of the perturbation kernel."""
  mean, std = sde.marginal_prob(torch.ones((1,) + CHW),
                                torch.full((1,), t_val))
  return float(std[0]), float(mean.reshape(-1)[0])


def pc_sampler(sde, model, eps):
  return sampling.get_pc_sampler(
      sde, model, (N_DRAWS,) + SHAPE,
      sampling.get_predictor("reverse_diffusion"),
      sampling.get_corrector("langevin"), lambda x: x, snr=0.16, n_steps=1,
      continuous=True, denoise=True, eps=eps)


def run(fn, seed):
  samples, nfe = fn(torch.Generator().manual_seed(seed))
  return samples.numpy(), nfe


@pytest.fixture(scope="module")
def trained_ve():
  return train(_learn_config("vesde"), 60, 25, gaussian_batches, seed=0)


@pytest.fixture(scope="module")
def trained_vp():
  cfg = _learn_config("vpsde", name="ddpm", embedding_type="positional",
                      scale_by_sigma=False)
  return train(cfg, 50, 25, gaussian_batches, seed=3)


@pytest.fixture(scope="module")
def trained_mixture():
  cfg = _learn_config("vesde")
  cfg.model.attn_resolutions = (4,)  # global mixing at the downsampled level
  return train(cfg, 60, 25, mixture_batches, seed=5)


@slow
def test_ve_loss_decreases(trained_ve):
  _, _, (first_step_loss, loss_curve) = trained_ve
  assert np.mean(loss_curve[-5:]) < 0.75 * first_step_loss, \
      (first_step_loss, loss_curve[:3], loss_curve[-5:])


@slow
def test_ve_learned_score_matches_analytic(trained_ve):
  sde, model, _ = trained_ve
  score = score_fn_at(sde, model)
  rng = np.random.default_rng(42)
  for t_val in (0.05, 0.2, 0.5, 0.9):
    sigma_t, _ = sigma_and_mean(sde, t_val)
    var_t = SIGMA_D ** 2 + sigma_t ** 2
    x = MU + np.sqrt(var_t) * rng.standard_normal((N_DRAWS,) + SHAPE)
    learned = score(x, t_val)
    analytic = -(x - MU) / var_t
    rel = np.linalg.norm(learned - analytic) / np.linalg.norm(analytic)
    assert rel < 0.15, (t_val, sigma_t, rel)


@slow
def test_ve_pc_samples_match_data_moments(trained_ve):
  sde, model, _ = trained_ve
  samples, _ = run(pc_sampler(sde, model, eps=1e-5), 7)
  _check_moments(samples, "pc")


@slow
def test_ve_ode_samples_match_data_moments(trained_ve):
  sde, model, _ = trained_ve
  fn = sampling.get_ode_sampler(sde, model, (N_DRAWS,) + SHAPE, lambda x: x,
                                denoise=True, rtol=1e-4, atol=1e-4, eps=1e-5)
  samples, _ = run(fn, 8)
  _check_moments(samples, "ode")


@slow
def test_ve_heun_samples_match_data_moments(trained_ve):
  sde, model, _ = trained_ve
  fn = sampling.get_heun_sampler(sde, model, (N_DRAWS,) + SHAPE, lambda x: x,
                                 n_steps=50, denoise=True, continuous=True,
                                 eps=1e-5)
  samples, _ = run(fn, 9)
  _check_moments(samples, "heun")


@slow
def test_ve_dpmpp_samples_match_data_moments(trained_ve):
  sde, model, _ = trained_ve
  fn = sampling.get_dpmpp_sampler(sde, model, (N_DRAWS,) + SHAPE,
                                  lambda x: x, n_steps=20, denoise=True,
                                  continuous=True, eps=1e-5)
  samples, nfe = run(fn, 10)
  assert int(nfe) == 21
  _check_moments(samples, "dpmpp")


@slow
def test_vp_learned_score_matches_analytic(trained_vp):
  """t >= 0.2, as the JAX test: below it the ~std² loss weight leaves the
  absolute score under-trained at this budget."""
  sde, model, _ = trained_vp
  score = score_fn_at(sde, model)
  rng = np.random.default_rng(43)
  for t_val in (0.2, 0.4, 0.8):
    std, m = sigma_and_mean(sde, t_val)
    var_t = m ** 2 * SIGMA_D ** 2 + std ** 2
    x = m * MU + np.sqrt(var_t) * rng.standard_normal((N_DRAWS,) + SHAPE)
    learned = score(x, t_val)
    analytic = -(x - m * MU) / var_t
    rel = np.linalg.norm(learned - analytic) / np.linalg.norm(analytic)
    assert rel < 0.15, (t_val, rel)


@slow
def test_vp_pc_samples_match_data_moments(trained_vp):
  sde, model, _ = trained_vp
  samples, _ = run(pc_sampler(sde, model, eps=1e-3), 11)
  _check_moments(samples, "vp-pc")


@slow
def test_mixture_loss_decreases(trained_mixture):
  _, _, (first_step_loss, loss_curve) = trained_mixture
  assert np.mean(loss_curve[-5:]) < 0.75 * first_step_loss, \
      (first_step_loss, loss_curve[:3], loss_curve[-5:])


@slow
def test_mixture_learned_score_matches_analytic(trained_mixture):
  sde, model, _ = trained_mixture
  score = score_fn_at(sde, model)
  rng = np.random.default_rng(44)
  for t_val in (0.05, 0.2, 0.5, 0.9):
    sigma_t, _ = sigma_and_mean(sde, t_val)
    var_t = MIX_SIGMA_D ** 2 + sigma_t ** 2
    mu = np.where(rng.random(N_DRAWS) < 0.5, MIX_MU1,
                  MIX_MU0)[:, None, None, None]
    x = mu + np.sqrt(var_t) * rng.standard_normal((N_DRAWS,) + SHAPE)
    rel = (np.linalg.norm(score(x, t_val) - _mixture_score(x, var_t))
           / np.linalg.norm(_mixture_score(x, var_t)))
    assert rel < 0.2, (t_val, rel)


@slow
def test_mixture_pc_recovers_both_modes(trained_mixture):
  sde, model, _ = trained_mixture
  samples, _ = run(pc_sampler(sde, model, eps=1e-5), 12)
  _check_modes(samples, "mixture-pc")


def _dpmpp_samples(trained, stochastic):
  sde, model, _ = trained
  fn = sampling.get_dpmpp_sampler(sde, model, (N_DRAWS,) + SHAPE,
                                  lambda x: x, n_steps=20, denoise=True,
                                  continuous=True, eps=1e-5,
                                  stochastic=stochastic)
  return run(fn, 13)[0]


@slow
def test_mixture_dpmpp_recovers_both_modes(trained_mixture):
  """Both modes reached; the split checked loosely, as in the JAX test
  (the deterministic flow's split rides an underfit global component)."""
  _check_modes(_dpmpp_samples(trained_mixture, False), "mixture-dpmpp",
               balance=(0.02, 0.98), std_tol=0.3)


@slow
def test_mixture_sde_dpmpp_improves_mode_balance(trained_mixture):
  def frac_hi(stochastic):
    s = _dpmpp_samples(trained_mixture, stochastic)
    assert np.isfinite(s).all()
    return (s.reshape(s.shape[0], -1).mean(-1)
            > (MIX_MU0 + MIX_MU1) / 2).mean()

  det, sto = frac_hi(False), frac_hi(True)
  assert 0.2 < sto < 0.8, (det, sto)
  assert sto > det + 0.05, (det, sto)


# ---------------------------------------------------------------------------
# The tools' CPU paths
# ---------------------------------------------------------------------------

def _final(out: str) -> dict:
  lines = [l for l in out.splitlines() if l.startswith("FINAL ")]
  assert len(lines) == 1, out[-2000:]
  return json.loads(lines[0][len("FINAL "):])


@pytest.mark.parametrize("task,dtype,second", [
    ("gaussian", "float32", "heun"), ("mixture", "float32", "dpmpp"),
    ("gaussian", "bfloat16", "heun")])
def test_learning_proof_tiny_on_the_cpu(task, dtype, second, capsys):
  out = learning_proof.main(["--task", task, "--dtype", dtype, "--device",
                             "cpu", "--tiny", "--n_outer", "2"])
  printed = capsys.readouterr().out
  assert _final(printed) == json.loads(json.dumps(out))
  head = json.loads(printed.splitlines()[0])
  assert (head["task"], head["dtype"], head["device"], head["card"]) == (
      task, dtype, "cpu", None)
  assert [json.loads(l)["step"] for l in printed.splitlines()
          if l.startswith('{"step"')] == [10, 20]
  assert out["steps"] == 20 and len(out["loss_curve"]) == 2
  assert out["probes"] == []  # every 10 calls, none at the last
  assert set(out["score_rel_err"]) == {"0.05", "0.2", "0.5", "0.9"}
  assert np.isfinite(out["first_step_loss"])
  sizes = learning_proof.TINY
  assert out["pc"]["nfe"] == 2 * sizes["pc_n"] and out["pc"]["finite"]
  want = ({"mean", "std"} if task == "gaussian"
          else {"frac_hi", "lo_mean", "hi_mean"})
  assert want <= set(out["pc"]) and want <= set(out[second])
  assert set(out["gates"]) == {g[0] for g in learning_proof.GATES[task]}
  assert out["gates_passed"] is all(g[2] for g in out["gates"].values())


def test_learning_proof_probes_between_calls(capsys):
  config = learning_proof.load_config(tiny=True, dtype="float32", seed=0)
  proof = learning_proof.Proof(config, "mixture", "cpu", learning_proof.TINY)
  out = learning_proof.train(proof, 3, probe_every=1)
  assert [p["step"] for p in out["probes"]] == [10, 20]
  assert all(set(p["rel"]) == {"0.5", "0.9"} for p in out["probes"])
  printed = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
  assert [list(r) for r in printed] == [["step", "chunk_loss"], ["probe"]] * 2 + [
      ["step", "chunk_loss"]]
  # A probe leaves the model at its own weights.
  weights = [p.detach().clone() for p in proof.model.parameters()]
  proof.score_rel_err((0.5,), seed=1)
  assert all(torch.equal(a, b) for a, b in zip(weights,
                                               proof.model.parameters()))


def test_bpd_rehearsal_tiny_on_the_cpu(tmp_path, capsys):
  """Train to step 10 with the evaluation beside it, then ``--skip_train``
  under the other TF32 setting from checkpoint 1 (a config override)."""
  common = ["--workdir", str(tmp_path), "--device", "cpu", "--tiny",
            "--n_iters", "10", "--snapshot_freq", "10", "--batch", "4",
            "--num_train", "16", "--num_test", "4"]
  first = bpd_rehearsal.main(common + ["--tf32", "off"])
  assert first["train"]["steps"] == 10
  assert _final(capsys.readouterr().out) == json.loads(json.dumps(first))
  second = bpd_rehearsal.main(common + ["--tf32", "on", "--skip_train",
                                        "--config.eval.begin_ckpt=1"])
  assert "train" not in second and _final(capsys.readouterr().out) == (
      json.loads(json.dumps(second)))
  for out, setting in ((first, "off"), (second, "on")):
    assert out["bound_bpd"] == 7.6495
    record = out["settings"][setting]
    assert record["tf32"] == {"matmul": False, "cudnn": setting == "on"}
    assert set(record["trajectory"]) == ({0, 1} if setting == "off" else {1})
    for row in record["trajectory"].values():
      # 4 test images, 5 passes
      assert (row["n_total"], row["n_finite"]) == (20, 20)
      assert row["gap_to_bound"] == pytest.approx(
          row["mean_bpd"] - bpd_rehearsal.analytic_bpd_bound())
    assert set(record["gates"]) == {
        "all_finite", "falls", "final_gap_le_0.15",
        "none_below_bound_by_3se"}
    assert (tmp_path / f"eval_tf32_{setting}" / "test_ckpt_1_bpd.npz").is_file()
  # The same checkpoint and test split, other Hutchinson probes and
  # dequantization draws (the evaluation's generator runs on from
  # checkpoint 0 in the first run): within the estimate's noise (stderr
  # ~1e-4 here).
  assert first["side_by_side"][1]["off"] == pytest.approx(
      second["side_by_side"][1]["on"], abs=1e-3)
  assert not (tmp_path / "eval_tf32_on" / "test_ckpt_0_bpd.npz").exists()
  assert sorted(p.name for p in (tmp_path / "checkpoints").iterdir()) == [
      "checkpoint_0.pth", "checkpoint_1.pth"]


@pytest.mark.parametrize("tool,args", [
    (learning_proof, ["--tiny"]),
    (bpd_rehearsal, ["--tiny", "--workdir", "unused"])])
def test_tools_refuse_a_missing_card(tool, args, monkeypatch, tmp_path):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  monkeypatch.chdir(tmp_path)
  with pytest.raises(RuntimeError, match="--device cpu"):
    tool.main(args)
  assert not any(tmp_path.iterdir())  # nothing written before the check
