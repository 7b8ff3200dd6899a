"""``main --mode eval`` / ``run_lib.evaluate`` of the port on the CPU.

A tiny flagship-shaped run with all three stages: a reference-schema
checkpoint, an ``.npz`` dataset, a random Inception npz (the raw pytorch-fid
layout) and dataset statistics with ``pool_3`` in the working directory.
It writes the JAX package's files under the same names and keys
(score_sde_pytorch_tpu/run_lib.py:389-463).
"""
import os
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from score_sde_pytorch_tpu_torch import (checkpoint, configs, inception,
                                         likelihood, main, run_lib, sampling)
from score_sde_pytorch_tpu_torch.models import utils as mutils
from tests.test_torch_ncsnpp import TINY
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

# Absolute: the runs below change the working directory.
FLAGSHIP = str(Path(__file__).resolve().parents[1]
               / "score_sde_pytorch_tpu_torch" / "configs" / "ve"
               / "cifar10_ncsnpp_continuous.py")
BATCH = 4
# The JAX package's eval files and their keys, checkpoint 1.
JAX_FILES = {
    "ckpt_1_loss.npz": {"all_losses", "mean_loss"},
    "test_ckpt_1_bpd.npz": {"bpd"},
    "ckpt_1_samples_0.npz": {"samples"},
    "ckpt_1_samples_1.npz": {"samples"},
    "ckpt_1_statistics_0.npz": {"pool_3", "logits"},
    "ckpt_1_statistics_1.npz": {"pool_3", "logits"},
    "report_1.npz": {"inception_score", "fid", "kid"},
}


def _overrides(data_dir, **extra):
  flags = {"eval.begin_ckpt": 1, "eval.end_ckpt": 1,
           "eval.batch_size": BATCH, "eval.enable_loss": True,
           "eval.enable_bpd": True, "eval.enable_sampling": True,
           "eval.num_samples": BATCH + 2, "sampling.method": "ode",
           "data.dataset": "NPZ", "data.data_dir": data_dir,
           "model.num_scales": 2}
  flags.update(extra)
  return list(TINY) + [f"{k}={v}" for k, v in flags.items()]


@pytest.fixture
def run(tmp_path, monkeypatch):
  """A workdir with checkpoint_1, an .npz dataset (one eval batch), random
  Inception weights in INCEPTION_WEIGHTS_NPZ and statistics with pool_3 in
  a working directory of its own."""
  rng = np.random.default_rng(0)
  data_dir = tmp_path / "data"
  data_dir.mkdir()
  for split, n in (("train", 8), ("test", BATCH)):
    np.savez(data_dir / f"{split}.npz",
             images=rng.integers(0, 256, (n, 16, 16, 3), dtype=np.uint8))
  workdir = tmp_path / "wd"
  config = configs.load_config(FLAGSHIP, _overrides(str(data_dir)))
  model = mutils.create_model(config, "cpu", torch.Generator().manual_seed(1))
  checkpoint.save_checkpoint(checkpoint.numbered_path(str(workdir), 1), model,
                             config, step=5)
  weights = inception.write_random_npz(str(tmp_path / "incep.npz"), seed=0)
  monkeypatch.setenv("INCEPTION_WEIGHTS_NPZ", weights)
  cwd = tmp_path / "cwd"
  (cwd / "assets" / "stats").mkdir(parents=True)
  np.savez(cwd / "assets" / "stats" / "npz_16_stats.npz",
           pool_3=rng.normal(size=(12, 2048)).astype(np.float32))
  monkeypatch.chdir(cwd)
  return {"workdir": str(workdir), "data_dir": str(data_dir),
          "config": config}


def _cli(run, *extra, device="cpu"):
  return main.main(["--config", FLAGSHIP, "--workdir", run["workdir"],
                    "--mode", "eval", "--device", device]
                   + ["--config." + o for o in _overrides(run["data_dir"])]
                   + list(extra))


def test_eval_mode_writes_the_jax_packages_files_and_keys(run):
  (record,) = _cli(run)
  eval_dir = os.path.join(run["workdir"], "eval")
  assert set(os.listdir(eval_dir)) == set(JAX_FILES)
  for name, keys in JAX_FILES.items():
    with np.load(os.path.join(eval_dir, name)) as z:
      assert set(z.files) == keys, name
      if name.startswith("ckpt_1_samples"):
        # Whole batches: num_samples = 6 at batch 4 is two full rounds,
        # untrimmed, as the JAX package scores them.
        assert z["samples"].dtype == np.uint8
        assert z["samples"].shape == (BATCH, 16, 16, 3)
      else:
        assert all(np.isfinite(z[k]).all() for k in keys), name
  with np.load(os.path.join(eval_dir, "test_ckpt_1_bpd.npz")) as z:
    # One test batch, repeated 5 times.
    assert z["bpd"].shape == (5 * BATCH,) and z["bpd"].dtype == np.float64
    np.testing.assert_allclose(z["bpd"].mean(), record["bpd"], rtol=1e-6)
  with np.load(os.path.join(eval_dir, "ckpt_1_loss.npz")) as z:
    assert z["all_losses"].shape == (1,)
    assert float(z["mean_loss"]) == pytest.approx(record["mean_loss"])
  with np.load(os.path.join(eval_dir, "report_1.npz")) as z:
    assert {k: float(z[k]) for k in z.files} == pytest.approx(
        record["scores"])
  assert record["step"] == 5 and len(record["bpd_nfe"]) == 5
  assert len(record["sampling_nfe"]) == 2
  assert "Evaluating checkpoint_1" in open(
      os.path.join(run["workdir"], "stdout.txt")).read()


def test_eval_folder_and_stages_follow_the_flags(run):
  _cli(run, "--eval_folder", "scores", "--config.eval.enable_bpd=False",
       "--config.eval.enable_sampling=False")
  assert os.listdir(os.path.join(run["workdir"], "scores")) == [
      "ckpt_1_loss.npz"]


def test_sampling_without_inception_weights_writes_samples_only(
    run, monkeypatch):
  monkeypatch.delenv("INCEPTION_WEIGHTS_NPZ")
  _cli(run, "--config.eval.enable_loss=False",
       "--config.eval.enable_bpd=False", "--config.sampling.method=pc")
  assert sorted(os.listdir(os.path.join(run["workdir"], "eval"))) == [
      "ckpt_1_samples_0.npz", "ckpt_1_samples_1.npz"]


def test_evaluate_raises_on_non_finite_samples(run, monkeypatch):
  """The ODE sampler NaNs its samples when the solver stops short; the
  sampling stage must not turn them into black images and a finite FID."""
  def nan_sampling_fn(config, sde, model, shape, inverse_scaler, eps=None,
                      device=None):
    return lambda generator: (torch.full(shape, float("nan")), 0)

  monkeypatch.setattr(sampling, "get_sampling_fn", nan_sampling_fn)
  with pytest.raises(RuntimeError, match="non-finite samples"):
    _cli(run, "--config.eval.enable_loss=False",
         "--config.eval.enable_bpd=False")


@pytest.mark.parametrize("split,repeats", [("test", 5), ("train", 1)])
def test_bpd_stage_repeats_the_test_split_five_times(run, monkeypatch, split,
                                                     repeats):
  """One pass over the train split (8 images: two batches), five over the
  test split (one batch), with a stub likelihood."""
  calls = []

  def stub(sde, model, inverse_scaler):
    def likelihood_fn(mdl, data, generator):
      calls.append(tuple(data.shape))
      return torch.full((data.shape[0],), 3.25), data, 8
    return likelihood_fn

  monkeypatch.setattr(likelihood, "get_likelihood_fn", stub)
  (record,) = _cli(run, "--config.eval.enable_loss=False",
                   "--config.eval.enable_sampling=False",
                   f"--config.eval.bpd_dataset={split}")
  batches = {"test": 1, "train": 2}[split] * repeats
  assert calls == [(BATCH, 3, 16, 16)] * batches
  with np.load(os.path.join(run["workdir"], "eval",
                            f"{split}_ckpt_1_bpd.npz")) as z:
    np.testing.assert_array_equal(z["bpd"], np.full(batches * BATCH, 3.25))
  assert record["bpd_nfe"] == [8] * batches


def test_evaluate_waits_for_a_checkpoint(run, monkeypatch):
  """The checkpoint-wait loop: checkpoint_2 appears while evaluate sleeps;
  one that never appears raises after MAX_WAITS sleeps."""
  slept = []
  ckpt2 = checkpoint.numbered_path(run["workdir"], 2)

  def sleep(seconds):
    slept.append(seconds)
    os.link(checkpoint.numbered_path(run["workdir"], 1), ckpt2)

  monkeypatch.setattr(time, "sleep", sleep)
  records = _cli(run, "--config.eval.end_ckpt=2",
                 "--config.eval.enable_bpd=False",
                 "--config.eval.enable_sampling=False")
  assert [r["ckpt"] for r in records] == [1, 2]
  assert slept == [run_lib.WAIT_SECONDS]

  monkeypatch.setattr(time, "sleep", lambda s: slept.append(s))
  monkeypatch.setattr(run_lib, "MAX_WAITS", 3)
  with pytest.raises(FileNotFoundError, match="checkpoint_3 never appeared"):
    _cli(run, "--config.eval.begin_ckpt=3", "--config.eval.end_ckpt=3")
  assert len(slept) == 1 + 4


def test_eval_on_cuda_without_a_card_raises(run, monkeypatch):
  """No silent CPU path: --mode eval on the default device needs a card."""
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="--device cpu"):
    _cli(run, device="cuda")


def test_eval_restores_the_ema_weights(run, tmp_path):
  """The likelihood and the sampler run at the checkpoint's EMA weights,
  the loss at the EMA weights through the eval step (the model's own
  weights are put back after it)."""
  config = run["config"]
  source = mutils.create_model(config, "cpu", torch.Generator().manual_seed(2))
  ema = [p.detach() * 0.5 for p in source.parameters() if p.requires_grad]
  path = checkpoint.numbered_path(str(tmp_path / "wd2"), 1)
  checkpoint.save_checkpoint(path, source, config, step=9, ema_params=ema)
  model = mutils.create_model(config, "cpu", torch.Generator().manual_seed(3))
  from score_sde_pytorch_tpu_torch.models.ema import ExponentialMovingAverage
  shadow = ExponentialMovingAverage(model.parameters(), 0.999)
  assert checkpoint.restore_model_and_ema(path, model, shadow) == 9
  for got, want in zip(shadow.shadow_params, ema, strict=True):
    assert torch.equal(got, want)
  for got, want in zip(model.parameters(), source.parameters()):
    assert torch.equal(got, want)
