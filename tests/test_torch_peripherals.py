"""The port's peripherals on the CPU: ``training.trace_steps`` and
``training.profiler_port``, ``debug.py``, ``demo.py`` and the tools
(``tools/compute_dataset_stats.py``, ``tools/convert_inception_weights.py``).

The demo prints the JAX package's line heads and writes its PNG names
(examples/demo.py, read as text here). The debug harness's score
statistics are held to the JAX package's score function on the same input
at the same EMA weights (unit-gain draws for the JAX NCSN++, mapped by
``interop`` into the checkpoint), the model's own weights a different draw;
the statistics tool's ``pool_3``, ``mu`` and ``sigma`` to the JAX tool's
body (tools/compute_dataset_stats.py:33-49) on the same ``.npz`` splits and
seeded random Inception weights, within 1e-5 of their largest magnitude.
These modules import neither JAX, the JAX package nor TensorFlow; only the
tests do.
"""
import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from score_sde_pytorch_tpu import datasets as jax_datasets
from score_sde_pytorch_tpu import evaluation as jax_evaluation
from score_sde_pytorch_tpu import inception as jax_inception
from score_sde_pytorch_tpu import sde as jax_sde
from score_sde_pytorch_tpu.models import utils as jax_mutils
import score_sde_pytorch_tpu.models  # noqa: F401  (registers the JAX models)
from score_sde_pytorch_tpu_torch import (checkpoint, configs, debug, demo,
                                         evaluation, inception, interop, main,
                                         run_lib)
from score_sde_pytorch_tpu_torch import sde as sde_lib
from score_sde_pytorch_tpu_torch.models import utils as mutils
from score_sde_pytorch_tpu_torch.models.ema import ExponentialMovingAverage
from score_sde_pytorch_tpu_torch.tools import compute_dataset_stats
from score_sde_pytorch_tpu_torch.tools import convert_inception_weights
from tests.subproc_env import cpu_child_env
from tests.test_torch_ncsnpp import init_params, nhwc, unit_gain
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
FLAGSHIP = str(ROOT / "score_sde_pytorch_tpu_torch" / "configs" / "ve"
               / "cifar10_ncsnpp_continuous.py")
TINY = ["--config.model.nf=16", "--config.model.ch_mult=(1,2)",
        "--config.model.num_res_blocks=1",
        "--config.model.attn_resolutions=(8,)",
        "--config.data.image_size=16", "--config.model.num_scales=2"]
TRAIN = ["--mode", "train", "--device", "cpu",
         "--config.training.batch_size=4",
         "--config.training.n_jitted_steps=1", "--config.training.log_freq=1",
         "--config.training.eval_freq=2", "--config.training.snapshot_freq=2",
         "--config.training.snapshot_freq_for_preemption=2",
         "--config.training.snapshot_sampling=False"]
JAX_DEMO = (ROOT / "examples" / "demo.py").read_text()


def _config(*extra):
  return configs.load_config(
      FLAGSHIP, [a[len("--config."):] for a in TINY] + list(extra))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
  """A tiny flagship run trained to step 4: checkpoint_1 (step 2),
  checkpoint_2 (step 4) and the rolling checkpoint (step 4)."""
  wd = str(tmp_path_factory.mktemp("trained"))
  main.main(["--config", FLAGSHIP, "--workdir", wd] + TINY + TRAIN
            + ["--config.training.n_iters=4"])
  return wd


def _trace_files(workdir: str) -> list:
  return sorted(os.listdir(os.path.join(workdir, "profile")))


def test_trace_steps_writes_a_trace_of_the_first_steps(tmp_path):
  """trace_steps = 2 traces steps 1-2 of a run and steps 3-4 of its
  resume: a Chrome trace each, whose events include the train step's
  convolutions and the attention."""
  wd = str(tmp_path / "wd")
  for n_iters in (2, 6):
    run_lib.train(_config("training.batch_size=4", "training.n_jitted_steps=1",
                          f"training.n_iters={n_iters}",
                          "training.snapshot_freq=2",
                          "training.snapshot_freq_for_preemption=2",
                          "training.snapshot_sampling=False",
                          "training.trace_steps=2"), wd, device="cpu")
  assert _trace_files(wd) == ["steps_1-2_rank0.pt.trace.json",
                              "steps_3-4_rank0.pt.trace.json"]
  with open(os.path.join(wd, "profile", "steps_3-4_rank0.pt.trace.json")) as f:
    names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
  assert "aten::convolution" in names
  assert "aten::bmm" in names  # the plain attention on the CPU


def test_trace_steps_longer_than_the_run_stops_at_its_end(tmp_path):
  wd = str(tmp_path / "wd")
  run_lib.train(_config("training.batch_size=4", "training.n_jitted_steps=1",
                        "training.n_iters=1", "training.snapshot_freq=1",
                        "training.snapshot_sampling=False",
                        "training.trace_steps=5"), wd, device="cpu")
  assert _trace_files(wd) == ["steps_1-1_rank0.pt.trace.json"]


def test_trace_steps_zero_writes_nothing(tmp_path):
  wd = str(tmp_path / "wd")
  run_lib.train(_config("training.batch_size=4", "training.n_jitted_steps=1",
                        "training.n_iters=1", "training.snapshot_freq=1",
                        "training.snapshot_sampling=False"), wd,
                device="cpu")
  assert not os.path.exists(os.path.join(wd, "profile"))


def test_profiler_port_raises_naming_trace_steps(tmp_path):
  wd = tmp_path / "wd"
  with pytest.raises(ValueError, match="trace_steps"):
    main.main(["--config", FLAGSHIP, "--workdir", str(wd)] + TINY + TRAIN
              + ["--config.training.n_iters=2",
                 "--config.training.profiler_port=9012"])
  assert not (wd / "checkpoints").exists()


@pytest.mark.parametrize("key", ["training.trace_steps",
                                 "training.profiler_port"])
def test_optional_training_keys_take_overrides(key):
  assert key.split(".")[1] not in _config().training
  assert _config(f"{key}=3").training[key.split(".")[1]] == 3
  with pytest.raises(KeyError):
    _config("training.trace_stepz=3")


def _ema_score(config, path: str):
  """The score at ``path``'s EMA weights on debug.py's inputs."""
  model = mutils.create_model(config, "cpu", torch.Generator().manual_seed(0))
  ema = ExponentialMovingAverage(model.parameters(),
                                 decay=config.model.ema_rate)
  checkpoint.restore_model_and_ema(path, model, ema)
  ema.copy_to(model.parameters())
  size = config.data.image_size
  x = torch.randn(4, 3, size, size, generator=torch.Generator().manual_seed(1))
  score_fn = mutils.get_score_fn(sde_lib.build_sde(config), model,
                                 train=False, continuous=True)
  with torch.no_grad():
    return score_fn(x, torch.full((4,), 0.5))


@pytest.mark.parametrize("ckpt", [-1, 1])
def test_debug_prints_the_step_and_the_ema_score(trained, ckpt):
  """debug.py in a subprocess with PYTHONBREAKPOINT=0: the step of the
  rolling (or numbered) checkpoint and the mean and std of the score."""
  proc = subprocess.run(
      [sys.executable, "-m", "score_sde_pytorch_tpu_torch.debug", "--config",
       FLAGSHIP, "--workdir", trained, "--ckpt", str(ckpt), "--device", "cpu"]
      + TINY, capture_output=True, text=True, timeout=300, cwd=ROOT,
      env=cpu_child_env(PYTHONBREAKPOINT="0", OMP_NUM_THREADS=1))
  assert proc.returncode == 0, proc.stderr[-3000:]
  step = re.search(r"loaded state at step (\d+)", proc.stdout)
  stats = re.search(r"score stats: (\S+) (\S+)", proc.stdout)
  assert step and stats, proc.stdout
  path = (checkpoint.meta_path(trained) if ckpt < 0
          else checkpoint.numbered_path(trained, ckpt))
  assert int(step.group(1)) == (4 if ckpt < 0 else 2)
  score = _ema_score(_config(), path)
  np.testing.assert_allclose(
      [float(stats.group(1)), float(stats.group(2))],
      [float(score.mean()), float(score.std(correction=0))], rtol=1e-5)


def test_debug_stops_at_the_breakpoint(trained, monkeypatch):
  """In process, the breakpoint hook is reached after the stats, with the
  model's trained weights (not the EMA's) in place."""
  hits = []
  monkeypatch.setattr(sys, "breakpointhook", lambda: hits.append(1))
  stats = debug.main(["--config", FLAGSHIP, "--workdir", trained, "--device",
                      "cpu"] + TINY)
  assert hits == [1] and stats["step"] == 4
  assert np.isfinite(stats["mean"]) and np.isfinite(stats["std"])


JAX_TOL = 1e-5


@pytest.fixture(scope="module")
def jax_weighted(tmp_path_factory):
  """A workdir whose checkpoint_3 (step 7) holds the JAX NCSN++'s weights at
  one unit-gain draw as its EMA and another as the model's trainable
  weights, mapped by ``interop``; returns the workdir, the JAX model and
  its EMA params."""
  config = _config()
  model_def = jax_mutils.get_model(config.model.name)(config)
  ema_params = init_params(model_def, jnp.zeros((1, 16, 16, 3)),
                           jnp.ones((1,)))
  model, ema_model = (mutils.create_model(config, "cpu",
                                          torch.Generator().manual_seed(0))
                      for _ in range(2))
  interop.load_jax_params(model, unit_gain(ema_params, seed=1), config)
  interop.load_jax_params(ema_model, ema_params, config)
  with torch.no_grad():  # the Fourier W, which training never changes
    for p, q in zip(model.parameters(), ema_model.parameters()):
      if not p.requires_grad:
        p.copy_(q)
  wd = str(tmp_path_factory.mktemp("jax_weighted"))
  checkpoint.save_checkpoint(
      checkpoint.numbered_path(wd, 3), model, config, step=7,
      ema_params=[p for p in ema_model.parameters() if p.requires_grad])
  return wd, model_def, ema_params


def test_debug_score_stats_match_the_jax_score_fn(jax_weighted, monkeypatch,
                                                  capsys):
  """debug.py's mean and std of the score are those of the JAX package's
  ``get_score_fn`` (what JAX debug.py:39-47 evaluates) at the checkpoint's
  EMA weights, on debug.py's input at t = 0.5."""
  wd, model_def, ema_params = jax_weighted
  monkeypatch.setattr(sys, "breakpointhook", lambda: None)
  stats = debug.main(["--config", FLAGSHIP, "--workdir", wd, "--ckpt", "3",
                      "--device", "cpu"] + TINY)
  assert capsys.readouterr().out.splitlines()[0] == "loaded state at step 7"
  config = _config()
  x = torch.randn(4, 3, 16, 16, generator=torch.Generator().manual_seed(1))
  score_fn = jax_mutils.get_score_fn(jax_sde.build_sde(config), model_def,
                                     ema_params, train=False,
                                     continuous=config.training.continuous)
  want = np.asarray(score_fn(jnp.asarray(nhwc(x)), jnp.full((4,), 0.5)))
  assert stats["step"] == 7 and want.std() > 0.1
  assert abs(stats["mean"] - want.mean()) <= JAX_TOL * want.std()
  assert abs(stats["std"] - want.std()) <= JAX_TOL * want.std()


def test_demo_tiny_prints_the_jax_demos_lines_and_pngs(tmp_path, capsys):
  """``demo --tiny --device cpu``: every section's line head of the JAX
  package's demo, in its order, finite bits/dim, and its PNG names."""
  out_dir = tmp_path / "demo_out"
  result = demo.main(["--tiny", "--device", "cpu", "--out", str(out_dir)])
  printed = capsys.readouterr().out
  heads = re.findall(r'print\(f"([^:{]+):', JAX_DEMO)
  assert heads == ["PC sampling", "ODE sampling", "dpmpp sampling",
                   "bits/dim"]
  assert [line.split(":")[0] for line in printed.splitlines()] == heads + [
      f"wrote demo outputs to {out_dir}/"]
  assert result["pc_nfe"] == 8 * 2 and result["dpmpp_nfe"] == 21
  assert result["ode_nfe"] > 1 and result["bpd_nfe"] > 1
  assert result["bpd"].shape == (4,) and np.isfinite(result["bpd"]).all()
  pngs = sorted(re.findall(r'"(\w+\.png)"', JAX_DEMO))
  assert len(pngs) == 5
  assert sorted(os.listdir(out_dir)) == pngs
  for name in pngs:
    assert (out_dir / name).read_bytes()[:4] == b"\x89PNG"


def test_demo_restores_a_checkpoint(trained, tmp_path, capsys):
  demo_args = ["--tiny", "--device", "cpu", "--out", str(tmp_path / "out"),
               "--workdir", trained, "--ckpt", "1"] + [
                   a for a in TINY if "num_scales" not in a]
  with mock.patch.object(demo, "_save"):
    demo.main(demo_args)
  assert capsys.readouterr().out.splitlines()[0] == "restored step 2"


@pytest.fixture
def random_inception(tmp_path, monkeypatch):
  path = inception.write_random_npz(str(tmp_path / "incep.npz"), seed=3)
  monkeypatch.setenv("INCEPTION_WEIGHTS_NPZ", path)
  evaluation._INCEPTION_CACHE.clear()
  yield path
  evaluation._INCEPTION_CACHE.clear()


def test_dataset_stats_tool_matches_run_inception(tmp_path, monkeypatch,
                                                  random_inception):
  """The tool's mu and sigma are the mean and covariance of the port's
  run_inception on the split; load_dataset_stats reads the file."""
  rng = np.random.default_rng(0)
  data = tmp_path / "data"
  data.mkdir()
  images = rng.integers(0, 256, (6, 16, 16, 3), dtype=np.uint8)
  for split in ("train", "test"):
    np.savez(data / f"{split}.npz", images=images)
  monkeypatch.chdir(tmp_path)
  overrides = ["--config.data.dataset=NPZ", f"--config.data.data_dir={data}",
               "--config.data.image_size=16"]
  out = compute_dataset_stats.main(["--config", FLAGSHIP, "--split", "test",
                                    "--device", "cpu", "--max_examples", "5"]
                                   + overrides)
  assert out == os.path.join("assets", "stats", "npz_16_stats.npz")
  config = configs.load_config(FLAGSHIP, [a[len("--config."):]
                                          for a in overrides])
  pool = evaluation.run_inception(images[:5], config, "cpu")["pool_3"]
  stats = evaluation.load_dataset_stats(config)
  assert set(stats) == {"mu", "sigma", "pool_3"}
  np.testing.assert_allclose(stats["pool_3"], pool, rtol=0, atol=1e-6)
  np.testing.assert_allclose(stats["mu"], pool.mean(0), rtol=0, atol=1e-6)
  np.testing.assert_allclose(stats["sigma"], np.cov(pool, rowvar=False),
                             rtol=0, atol=1e-6)
  assert stats["sigma"].shape == (2048, 2048)


def test_dataset_stats_tool_matches_the_jax_tool(tmp_path, monkeypatch,
                                              random_inception):
  """The JAX tool's body (tools/compute_dataset_stats.py:33-49) and the
  port's tool on the same ``.npz`` splits (train and test differ) with
  ``max_examples`` 5 and the same Inception weights: the same file name
  and keys, and ``pool_3``, ``mu`` and ``sigma`` within JAX_TOL of their
  largest magnitude. The JAX extractor is that of ``run_inception`` at
  batch 8, unsharded, where its default pads every call to 64 images."""
  rng = np.random.default_rng(4)
  data = tmp_path / "data"
  data.mkdir()
  for split, n in (("train", 7), ("test", 6)):
    np.savez(data / f"{split}.npz",
             images=rng.integers(0, 256, (n, 16, 16, 3), dtype=np.uint8))
  overrides = ["data.dataset=NPZ", f"data.data_dir={data}",
               "data.image_size=16"]
  config = configs.load_config(FLAGSHIP, overrides)
  images = jax_datasets.materialize(
      jax_datasets.load_raw_dataset(config, "test"))[:5]
  jax_evaluation._INCEPTION_CACHE.clear()
  monkeypatch.setitem(jax_evaluation._INCEPTION_CACHE, random_inception,
                      jax_inception.InceptionV3Features(random_inception,
                                                        batch=8, shard=False))
  pool = jax_evaluation.run_inception(images, config)["pool_3"]
  want = {"pool_3": pool, "mu": pool.mean(axis=0),
          "sigma": np.cov(pool, rowvar=False)}
  want_name = f"{config.data.dataset.lower()}_{config.data.image_size}_stats.npz"
  out = compute_dataset_stats.main(
      ["--config", FLAGSHIP, "--split", "test", "--device", "cpu",
       "--max_examples", "5", "--out", str(tmp_path / "stats")]
      + [f"--config.{o}" for o in overrides])
  assert out == str(tmp_path / "stats" / want_name)
  with np.load(out) as z:
    got = dict(z)
  assert sorted(got) == sorted(want)
  for key in want:
    assert got[key].shape == want[key].shape, key
    np.testing.assert_allclose(got[key], want[key], rtol=0,
                               atol=JAX_TOL * np.abs(want[key]).max(),
                               err_msg=key)


def test_dataset_stats_tool_without_weights_exits(tmp_path, monkeypatch):
  monkeypatch.delenv("INCEPTION_WEIGHTS_NPZ", raising=False)
  monkeypatch.chdir(tmp_path)
  with pytest.raises(SystemExit, match="INCEPTION_WEIGHTS_NPZ"):
    compute_dataset_stats.main(["--config", FLAGSHIP, "--device", "cpu",
                                "--max_examples", "2"] + TINY[-2:-1])
  assert not (tmp_path / "assets").exists()


def test_convert_inception_weights_drops_batch_counters(tmp_path,
                                                        monkeypatch, capsys):
  net = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.BatchNorm2d(4))
  src, dst = tmp_path / "w.pth", tmp_path / "w.npz"
  torch.save(net.state_dict(), src)
  monkeypatch.setattr(sys, "argv", ["convert", str(src), str(dst)])
  convert_inception_weights.main()
  with np.load(dst) as z:
    assert sorted(z.files) == sorted(k for k in net.state_dict()
                                     if "num_batches_tracked" not in k)
    np.testing.assert_array_equal(z["0.weight"], net[0].weight.detach())
  assert "with 6 arrays" in capsys.readouterr().out


def test_peripherals_import_no_jax_and_no_tensorflow():
  """In a child where JAX, the JAX package and TensorFlow cannot be
  imported, every new module imports."""
  blocked = ("jax", "jaxlib", "flax", "optax", "orbax",
             "score_sde_pytorch_tpu", "tensorflow")
  modules = ["score_sde_pytorch_tpu_torch.utils.io",
             "score_sde_pytorch_tpu_torch.debug",
             "score_sde_pytorch_tpu_torch.demo",
             "score_sde_pytorch_tpu_torch.tools.compute_dataset_stats",
             "score_sde_pytorch_tpu_torch.tools.convert_inception_weights",
             "score_sde_pytorch_tpu_torch.tools.train_step_grid",
             "score_sde_pytorch_tpu_torch.run_lib"]
  code = textwrap.dedent(f"""
      import importlib, sys
      for m in {blocked!r}:
        sys.modules[m] = None
      for name in {modules!r}:
        importlib.import_module(name)
      print('ok')
      """)
  proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                        text=True, timeout=300, cwd=ROOT, env=cpu_child_env())
  assert proc.returncode == 0, proc.stderr[-3000:]
  assert proc.stdout.strip() == "ok"
