"""The port imports no JAX and nothing of the JAX package, and its config
loader and CLI contract.

JAX and the JAX package ``score_sde_pytorch_tpu`` are blocked in a fresh
subprocess (``sys.modules['jax'] = None`` makes any ``import jax`` raise):
this test process has imported both already (tests/conftest.py), so an
in-process check would prove nothing.
"""
import subprocess
import sys
import textwrap

import pytest
import torch

from score_sde_pytorch_tpu_torch import configs, main
from tests.subproc_env import cpu_child_env

FLAGSHIP = "score_sde_pytorch_tpu_torch/configs/ve/cifar10_ncsnpp_continuous.py"
JAX_FLAGSHIP = "score_sde_pytorch_tpu/configs/ve/cifar10_ncsnpp_continuous.py"
MAIN_PATH_MODULES = [
    "score_sde_pytorch_tpu_torch",
    "score_sde_pytorch_tpu_torch.configs",
    "score_sde_pytorch_tpu_torch.configs.builder",
    "score_sde_pytorch_tpu_torch.datasets",
    "score_sde_pytorch_tpu_torch.tfrecord",
    "score_sde_pytorch_tpu_torch.native",
    "score_sde_pytorch_tpu_torch.native.build",
    "score_sde_pytorch_tpu_torch.native.crc32c",
    "score_sde_pytorch_tpu_torch.native.loader",
    "score_sde_pytorch_tpu_torch.utils",
    "score_sde_pytorch_tpu_torch.utils.image",
    "score_sde_pytorch_tpu_torch.sde",
    "score_sde_pytorch_tpu_torch.ops.attention",
    "score_sde_pytorch_tpu_torch.ops.fused_act",
    "score_sde_pytorch_tpu_torch.ops.build",
    "score_sde_pytorch_tpu_torch.ops.upfirdn2d",
    "score_sde_pytorch_tpu_torch.models",
    "score_sde_pytorch_tpu_torch.models.layers",
    "score_sde_pytorch_tpu_torch.models.layerspp",
    "score_sde_pytorch_tpu_torch.models.ncsnpp",
    "score_sde_pytorch_tpu_torch.models.ncsnv2",
    "score_sde_pytorch_tpu_torch.models.normalization",
    "score_sde_pytorch_tpu_torch.models.utils",
    "score_sde_pytorch_tpu_torch.models.ema",
    "score_sde_pytorch_tpu_torch.losses",
    "score_sde_pytorch_tpu_torch.interop",
    "score_sde_pytorch_tpu_torch.sampling",
    "score_sde_pytorch_tpu_torch.controllable_generation",
    "score_sde_pytorch_tpu_torch.ode",
    "score_sde_pytorch_tpu_torch.likelihood",
    "score_sde_pytorch_tpu_torch.inception",
    "score_sde_pytorch_tpu_torch.evaluation",
    "score_sde_pytorch_tpu_torch.checkpoint",
    "score_sde_pytorch_tpu_torch.parallel",
    "score_sde_pytorch_tpu_torch.parallel.distributed",
    "score_sde_pytorch_tpu_torch.run_lib",
    "score_sde_pytorch_tpu_torch.main",
    "score_sde_pytorch_tpu_torch.utils.io",
    "score_sde_pytorch_tpu_torch.debug",
    "score_sde_pytorch_tpu_torch.demo",
    "score_sde_pytorch_tpu_torch.tools",
    "score_sde_pytorch_tpu_torch.tools.compute_dataset_stats",
    "score_sde_pytorch_tpu_torch.tools.convert_inception_weights",
    "score_sde_pytorch_tpu_torch.tools.train_step_grid",
    "score_sde_pytorch_tpu_torch.tools.learning_proof",
    "score_sde_pytorch_tpu_torch.tools.bpd_rehearsal",
    "score_sde_pytorch_tpu_torch.configs.h100.church_256_ncsnpp_h100",
    "score_sde_pytorch_tpu_torch.configs.h100.celebahq_1024_ncsnpp_h100",
]
BLOCK = "import sys\nfor _m in {!r}: sys.modules[_m] = None\n"
JAX_NAMES = ("jax", "jaxlib", "flax", "optax", "orbax", "score_sde_pytorch_tpu")


def run_child(code: str, blocked=JAX_NAMES, **env):
  proc = subprocess.run(
      [sys.executable, "-c", BLOCK.format(tuple(blocked)) + code],
      capture_output=True, text=True, timeout=300, env=cpu_child_env(**env))
  assert proc.returncode == 0, proc.stderr[-3000:]
  return proc.stdout


def test_main_path_imports_with_jax_blocked():
  out = run_child(textwrap.dedent(f"""
      import importlib
      for name in {MAIN_PATH_MODULES!r}:
        importlib.import_module(name)
      leaked = [m for m, v in sys.modules.items()
                if v is not None and m.split('.')[0] in {JAX_NAMES!r}]
      assert not leaked, leaked
      print('ok')
      """))
  assert out.strip().endswith("ok")


def test_learning_tools_run_with_jax_and_the_jax_tools_blocked(tmp_path):
  """Both learning tools import nothing of JAX, of the JAX package or of
  the repository's ``tools/`` (the JAX package's tools): one tiny call of
  each learning proof, and the bits/dim tool's dataset and bound."""
  out = run_child(textwrap.dedent(f"""
      from score_sde_pytorch_tpu_torch.tools import bpd_rehearsal
      from score_sde_pytorch_tpu_torch.tools import learning_proof
      for task in ("gaussian", "mixture"):
        out = learning_proof.main(["--task", task, "--device", "cpu",
                                   "--tiny", "--n_outer", "1"])
        assert out["steps"] == 10, out
      bpd_rehearsal.make_dataset({str(tmp_path)!r}, size=8, n_train=4,
                                 n_test=4)
      assert round(bpd_rehearsal.analytic_bpd_bound(), 4) == 7.6495
      leaked = [m for m, v in sys.modules.items() if v is not None
                and m.split('.')[0] in {JAX_NAMES + ("tools",)!r}]
      assert not leaked, leaked
      print('ok')
      """), blocked=JAX_NAMES + ("tools",), OMP_NUM_THREADS=1)
  assert out.strip().endswith("ok")


def test_cli_recipe_runs_with_the_jax_package_blocked(tmp_path):
  """The tiny train (2 steps) -> resume (to 4) -> sample recipe of the CLI,
  in a child where the JAX package, jax and flax cannot be imported."""
  tiny = ["--config.model.nf=16", "--config.model.ch_mult=(1,2)",
          "--config.model.num_res_blocks=1",
          "--config.model.attn_resolutions=(8,)",
          "--config.data.image_size=16", "--config.model.num_scales=2"]
  train = ["--mode", "train", "--config.training.batch_size=4",
           "--config.training.n_jitted_steps=1",
           "--config.training.log_freq=1", "--config.training.eval_freq=2",
           "--config.training.snapshot_freq=2",
           "--config.training.snapshot_freq_for_preemption=2"]
  common = ["--config", FLAGSHIP, "--workdir", str(tmp_path), "--device",
            "cpu"] + tiny
  out = run_child(textwrap.dedent(f"""
      from score_sde_pytorch_tpu_torch import main
      first = main.main({common + train + ["--config.training.n_iters=2"]!r})
      second = main.main({common + train + ["--config.training.n_iters=4"]!r})
      assert (first['initial_step'], second['initial_step']) == (0, 2)
      rounds = main.main({common + ["--mode", "sample",
                                    "--config.eval.batch_size=2"]!r})
      assert [r['nfe'] for r in rounds] == [4], rounds
      leaked = [m for m, v in sys.modules.items()
                if v is not None and m.split('.')[0] in {JAX_NAMES!r}]
      assert not leaked, leaked
      print('ok')
      """), OMP_NUM_THREADS=1)  # one torch thread: see tests/torch_threads.py
  assert out.strip().endswith("ok")
  assert "Starting training loop at step 2" in (
      tmp_path / "stdout.txt").read_text()
  for sub in ("checkpoints/checkpoint_2.pth", "samples/iter_4/sample.png",
              "generated/samples_0.npz"):
    assert (tmp_path / sub).is_file(), sub


TINY_NCSN = ["--config.model.nf=8", "--config.data.image_size=16",
             "--config.model.num_scales=2", "--config.sampling.n_steps_each=2"]
TINY_CHURCH = ["--config.model.nf=16", "--config.model.ch_mult=(1,2,2)",
               "--config.model.num_res_blocks=1",
               "--config.model.attn_resolutions=(8,)",
               "--config.data.image_size=16", "--config.model.num_scales=2"]


@pytest.mark.parametrize("rel,tiny,nfe", [
    ("ve/ncsn/cifar10.py", TINY_NCSN, 6),
    ("ve/ncsnv2/cifar10.py", TINY_NCSN, 6),
    ("tpu/church_256_ncsnpp_tpu.py", TINY_CHURCH, 4)])
def test_refinenet_and_bf16_recipes_run_with_the_jax_package_blocked(
    tmp_path, rel, tiny, nfe):
  """The tiny train (2 steps) -> sample recipe of ve/ncsn/cifar10.py (NCSN
  v1, the SMLD loss, annealed Langevin dynamics), ve/ncsnv2/cifar10.py and
  the bf16 church file, in a child where the JAX package, jax and flax
  cannot be imported."""
  common = ["--config", "score_sde_pytorch_tpu_torch/configs/" + rel,
            "--workdir", str(tmp_path), "--device", "cpu"] + tiny
  train = ["--mode", "train", "--config.training.batch_size=4",
           "--config.training.n_jitted_steps=1",
           "--config.training.n_iters=2", "--config.training.log_freq=1",
           "--config.training.eval_freq=2",
           "--config.training.snapshot_freq=2",
           "--config.training.snapshot_freq_for_preemption=2",
           "--config.training.snapshot_sampling=False"]
  out = run_child(textwrap.dedent(f"""
      import math
      from score_sde_pytorch_tpu_torch import main
      run = main.main({common + train!r})
      assert all(math.isfinite(v) for _, v in run['train_losses']), run
      rounds = main.main({common + ["--mode", "sample",
                                    "--config.eval.batch_size=2"]!r})
      assert [r['nfe'] for r in rounds] == [{nfe}], rounds
      leaked = [m for m, v in sys.modules.items()
                if v is not None and m.split('.')[0] in {JAX_NAMES!r}]
      assert not leaked, leaked
      print('ok')
      """), OMP_NUM_THREADS=1)  # one torch thread: see tests/torch_threads.py
  assert out.strip().endswith("ok")
  for sub in ("checkpoints/checkpoint_1.pth", "generated/samples_0.npz"):
    assert (tmp_path / sub).is_file(), sub


def test_eval_recipe_runs_with_the_jax_package_blocked(tmp_path):
  """The tiny --mode eval recipe (eval loss, bits/dim, ODE samples,
  Inception and FID/IS/KID on random weights, a one-batch .npz dataset)
  from a 2-step train, in a child where the JAX package, jax and flax
  cannot be imported."""
  tiny = ["--config.model.nf=16", "--config.model.ch_mult=(1,2)",
          "--config.model.num_res_blocks=1",
          "--config.model.attn_resolutions=(8,)",
          "--config.data.image_size=16", "--config.model.num_scales=2"]
  common = ["--config", str(configs.resolve(FLAGSHIP).resolve()),
            "--workdir", str(tmp_path / "wd"), "--device", "cpu"] + tiny
  train = ["--mode", "train", "--config.training.batch_size=4",
           "--config.training.n_jitted_steps=1",
           "--config.training.n_iters=2", "--config.training.snapshot_freq=2",
           "--config.training.snapshot_sampling=False"]
  evaluate = ["--mode", "eval", "--config.eval.begin_ckpt=1",
              "--config.eval.end_ckpt=1", "--config.eval.batch_size=4",
              "--config.eval.enable_bpd=True",
              "--config.eval.enable_sampling=True",
              "--config.eval.num_samples=4", "--config.sampling.method=ode",
              "--config.data.dataset=NPZ",
              f"--config.data.data_dir={tmp_path / 'data'}"]
  out = run_child(textwrap.dedent(f"""
      import os
      import numpy as np
      from score_sde_pytorch_tpu_torch import inception, main
      main.main({common + train!r})
      os.chdir({str(tmp_path)!r})
      rng = np.random.default_rng(0)
      os.makedirs('data')
      for split in ('train', 'test'):  # one eval batch each
        np.savez(f'data/{{split}}.npz', images=rng.integers(
            0, 256, (4, 16, 16, 3), dtype=np.uint8))
      os.environ['INCEPTION_WEIGHTS_NPZ'] = inception.write_random_npz(
          'incep.npz')
      os.makedirs('assets/stats')
      np.savez('assets/stats/npz_16_stats.npz',
               pool_3=rng.normal(size=(8, 2048)))
      (record,) = main.main({common + evaluate!r})
      assert set(record['scores']) == {{'inception_score', 'fid', 'kid'}}
      leaked = [m for m, v in sys.modules.items()
                if v is not None and m.split('.')[0] in {JAX_NAMES!r}]
      assert not leaked, leaked
      print('ok')
      """), OMP_NUM_THREADS=1)  # one torch thread: see tests/torch_threads.py
  assert out.strip().endswith("ok")
  for name in ("ckpt_1_loss.npz", "test_ckpt_1_bpd.npz",
               "ckpt_1_samples_0.npz", "ckpt_1_statistics_0.npz",
               "report_1.npz"):
    assert (tmp_path / "wd" / "eval" / name).is_file(), name


VP_SLICE_CONFIGS = ["vp/cifar10_ddpmpp_continuous.py",
                    "subvp/cifar10_ddpmpp_continuous.py",
                    "vp/cifar10_ncsnpp_continuous.py", "vp/cifar10_ddpmpp.py",
                    "vp/ddpm/cifar10.py", "ve/cifar10_ncsnpp.py"]


def test_vp_slice_configs_train_and_sample_with_the_jax_package_blocked():
  """Each config of the VP/subVP slice, at tiny width, builds its model and
  takes one train step (its own loss: continuous, DDPM or SMLD) and one PC
  step (its own predictor and corrector), all finite, with jax, flax and
  the JAX package blocked."""
  out = run_child(textwrap.dedent(f"""
      import torch
      from score_sde_pytorch_tpu_torch import configs, losses, sampling
      from score_sde_pytorch_tpu_torch import sde as sde_lib
      from score_sde_pytorch_tpu_torch.models import utils as mutils
      tiny = ['model.nf=16', 'model.ch_mult=(1,2)', 'model.num_res_blocks=1',
              'model.attn_resolutions=(8,)', 'data.image_size=16']
      for rel in {VP_SLICE_CONFIGS!r}:
        cfg = configs.load_config(
            'score_sde_pytorch_tpu_torch/configs/' + rel, tiny)
        model = mutils.create_model(cfg, 'cpu',
                                    torch.Generator().manual_seed(0))
        state = losses.init_train_state(cfg, model, 'cpu')
        sde, tc, sc = sde_lib.build_sde(cfg), cfg.training, cfg.sampling
        step = losses.get_step_fn(
            sde, train=True, optimize_fn=losses.optimization_manager(cfg),
            reduce_mean=tc.reduce_mean, continuous=tc.continuous,
            likelihood_weighting=tc.likelihood_weighting)
        loss = step(state, torch.rand(2, 3, 16, 16), state['generator'])
        score_fn = mutils.get_score_fn(sde, model, continuous=tc.continuous)
        predictor = sampling.get_predictor(sc.predictor)(sde, score_fn)
        corrector = sampling.get_corrector(sc.corrector)(
            sde, score_fn, sc.snr, sc.n_steps_each)
        g = torch.Generator().manual_seed(1)
        x = sde.prior_sampling((2, 3, 16, 16), g, 'cpu')
        t = torch.full((2,), sde.T)
        with torch.no_grad():
          x, _ = corrector(x, t, lambda step: torch.randn((2, 3, 16, 16),
                                                          generator=g))
          x, x_mean = predictor(x, t, torch.randn((2, 3, 16, 16),
                                                  generator=g))
        assert torch.isfinite(loss) and torch.isfinite(x_mean).all(), rel
        print(rel, type(sde).__name__, sc.predictor, float(loss))
      leaked = [m for m, v in sys.modules.items()
                if v is not None and m.split('.')[0] in {JAX_NAMES!r}]
      assert not leaked, leaked
      print('ok')
      """), OMP_NUM_THREADS=1)
  assert out.strip().endswith("ok")
  assert out.count(" VPSDE ") == 4 and " SubVPSDE " in out


HIRES_CONFIGS = ["ve/church_ncsnpp_continuous.py",
                 "ve/celebahq_ncsnpp_continuous.py", "vp/ddpm/church.py"]


def test_hires_and_controllable_run_with_the_jax_package_blocked():
  """The 256² and 1024² configs at tiny width (NCSN++ with both pyramids
  and remat, the 256² DDPM) take one train step each, and the church
  NCSN++ inpaints and colorizes, in a child where jax, flax and the JAX
  package cannot be imported."""
  out = run_child(textwrap.dedent(f"""
      import torch
      from score_sde_pytorch_tpu_torch import configs, losses, sampling
      from score_sde_pytorch_tpu_torch import controllable_generation as cg
      from score_sde_pytorch_tpu_torch import sde as sde_lib
      from score_sde_pytorch_tpu_torch.models import utils as mutils
      tiny = ['model.nf=16', 'model.ch_mult=(1,2,2)',
              'model.num_res_blocks=1', 'model.attn_resolutions=(8,)',
              'data.image_size=16']
      for rel in {HIRES_CONFIGS!r}:
        cfg = configs.load_config(
            'score_sde_pytorch_tpu_torch/configs/' + rel, tiny)
        model = mutils.create_model(cfg, 'cpu',
                                    torch.Generator().manual_seed(0))
        state = losses.init_train_state(cfg, model, 'cpu')
        sde, tc = sde_lib.build_sde(cfg), cfg.training
        step = losses.get_step_fn(
            sde, train=True, optimize_fn=losses.optimization_manager(cfg),
            reduce_mean=tc.reduce_mean, continuous=tc.continuous,
            likelihood_weighting=tc.likelihood_weighting)
        loss = step(state, torch.rand(2, 3, 16, 16), state['generator'])
        assert torch.isfinite(loss), rel
        print(rel, cfg.model.get('remat', False), float(loss))
      cfg = configs.load_config(
          'score_sde_pytorch_tpu_torch/configs/' + {HIRES_CONFIGS[0]!r},
          tiny + ['model.num_scales=2'])
      model = mutils.create_model(cfg, 'cpu',
                                  torch.Generator().manual_seed(0))
      sde = sde_lib.build_sde(cfg)
      args = (sde, model, sampling.get_predictor('reverse_diffusion'),
              sampling.get_corrector('langevin'), lambda x: x, 0.16)
      data = torch.rand(2, 16, 16, 3)
      mask = torch.zeros_like(data)
      mask[:, :8] = 1.0
      g = torch.Generator().manual_seed(1)
      out = cg.get_pc_inpainter(*args, continuous=True)(g, data, mask)
      assert torch.isfinite(out).all() and out.shape == data.shape
      gray = data[..., :1].expand(-1, -1, -1, 3)
      out = cg.get_pc_colorizer(*args, continuous=True)(g, gray)
      assert torch.isfinite(out).all() and out.shape == data.shape
      leaked = [m for m, v in sys.modules.items()
                if v is not None and m.split('.')[0] in {JAX_NAMES!r}]
      assert not leaked, leaked
      print('ok')
      """), OMP_NUM_THREADS=1)
  assert out.strip().endswith("ok")
  assert out.count(" True ") == 2  # the NCSN++ configs train with remat


def test_vp_cli_recipe_runs_with_the_jax_package_blocked(tmp_path):
  """The tiny VP CLI recipe on vp/cifar10_ddpmpp_continuous.py:
  train (2 steps, an Euler–Maruyama snapshot grid), sample, and eval with
  the loss and bits/dim, in a child where the JAX package, jax and flax
  cannot be imported."""
  tiny = ["--config.model.nf=16", "--config.model.ch_mult=(1,2)",
          "--config.model.num_res_blocks=1",
          "--config.model.attn_resolutions=(8,)",
          "--config.data.image_size=16", "--config.model.num_scales=4"]
  common = ["--config", "score_sde_pytorch_tpu_torch/configs/vp/"
            "cifar10_ddpmpp_continuous.py", "--workdir", str(tmp_path),
            "--device", "cpu"] + tiny
  train = ["--mode", "train", "--config.training.batch_size=4",
           "--config.training.n_jitted_steps=1", "--config.training.n_iters=2",
           "--config.training.snapshot_freq=2"]
  evaluate = ["--mode", "eval", "--config.eval.begin_ckpt=1",
              "--config.eval.end_ckpt=1", "--config.eval.batch_size=4",
              "--config.eval.enable_bpd=True",
              "--config.eval.bpd_dataset=train", "--config.data.dataset=NPZ",
              f"--config.data.data_dir={tmp_path / 'data'}"]
  out = run_child(textwrap.dedent(f"""
      import os
      import numpy as np
      from score_sde_pytorch_tpu_torch import main
      main.main({common + train!r})
      rounds = main.main({common + ["--mode", "sample",
                                    "--config.eval.batch_size=2"]!r})
      assert [r['nfe'] for r in rounds] == [8], rounds
      os.makedirs({str(tmp_path / 'data')!r})
      for split in ('train', 'test'):  # one eval batch each
        np.savez({str(tmp_path / 'data')!r} + f'/{{split}}.npz',
                 images=np.random.default_rng(0).integers(
                     0, 256, (4, 16, 16, 3), dtype=np.uint8))
      (record,) = main.main({common + evaluate!r})
      assert np.isfinite(record['mean_loss']) and np.isfinite(record['bpd'])
      leaked = [m for m, v in sys.modules.items()
                if v is not None and m.split('.')[0] in {JAX_NAMES!r}]
      assert not leaked, leaked
      print('ok')
      """), OMP_NUM_THREADS=1)
  assert out.strip().endswith("ok")
  for sub in ("checkpoints/checkpoint_1.pth", "samples/iter_2/sample.png",
              "generated/samples_0.npz", "eval/ckpt_1_loss.npz",
              "eval/train_ckpt_1_bpd.npz"):
    assert (tmp_path / sub).is_file(), sub


def test_jax_package_config_paths_load_the_ports_copy():
  """A --config path into the JAX package's tree loads the port's copy at
  the same relative path; a path with no copy there raises."""
  assert configs.resolve(JAX_FLAGSHIP) == configs.resolve(FLAGSHIP).resolve()
  assert configs.resolve("/elsewhere/" + JAX_FLAGSHIP).is_relative_to(
      configs.CONFIG_DIR)
  with pytest.raises(FileNotFoundError, match="no copy"):
    configs.resolve("score_sde_pytorch_tpu/configs/ve/no_such_config.py")


def test_config_stand_in_loads_the_flagship_without_ml_collections():
  """With ml_collections missing too, the JAX config files load through the
  port's stand-in, which is unbound again afterwards."""
  out = run_child(textwrap.dedent(f"""
      from score_sde_pytorch_tpu_torch import configs
      cfg = configs.load_config({FLAGSHIP!r},
                                ['model.num_scales=100', 'eval.batch_size=16'])
      assert isinstance(cfg, configs.ConfigDict), type(cfg)
      m = cfg.model
      assert (m.nf, tuple(m.ch_mult), m.num_res_blocks) == (128, (1, 2, 2, 2), 4)
      assert (m.attn_resolutions, m.progressive_input) == ((16,), 'residual')
      assert (m.num_scales, cfg.eval.batch_size) == (100, 16)
      assert cfg.sampling.method == 'pc' and cfg.training.sde == 'vesde'
      assert sys.modules['ml_collections'] is None
      print('ok')
      """), blocked=JAX_NAMES + ("ml_collections",))
  assert out.strip().endswith("ok")


def test_overrides_follow_the_current_types():
  cfg = configs.load_config(FLAGSHIP, [
      "model.ch_mult=(1,2)", "model.sigma_max=20", "training.continuous=False",
      "sampling.predictor=none", "data.image_size=16"])
  assert tuple(cfg.model.ch_mult) == (1, 2)
  assert cfg.model.sigma_max == 20.0 and isinstance(cfg.model.sigma_max, float)
  assert cfg.training.continuous is False
  assert cfg.sampling.predictor == "none" and cfg.data.image_size == 16


@pytest.mark.parametrize("override,error", [
    ("model.nff=8", KeyError), ("modle.nf=8", KeyError),
    ("model.nf", ValueError), ("training.continuous=maybe", ValueError)])
def test_bad_overrides_raise(override, error):
  with pytest.raises(error):
    configs.load_config(FLAGSHIP, [override])


@pytest.mark.parametrize("override", ["model.remat=True",
                                      "model.dtype=float16"])
def test_unsupported_settings_raise(override):
  """model.dtype other than float32 or bfloat16 raises (bfloat16 raised
  until it was ported: tests/test_torch_bf16.py). model.remat raised until
  remat was ported: it now loads, with model.remat_min_res, and NCSN++
  takes both up (its gradients: tests/test_torch_hires.py)."""
  if override != "model.remat=True":
    with pytest.raises(NotImplementedError):
      configs.load_config(FLAGSHIP, [override])
    return
  from score_sde_pytorch_tpu_torch.models import utils as mutils
  cfg = configs.load_config(FLAGSHIP, [
      override, "model.remat_min_res=16", "model.nf=16",
      "model.ch_mult=(1,2)", "model.num_res_blocks=1",
      "model.attn_resolutions=(8,)", "data.image_size=16"])
  model = mutils.create_model(cfg, "cpu", torch.Generator().manual_seed(0))
  assert (model.remat, model.remat_min_res) == (True, 16)


@pytest.mark.parametrize("mode", ["eval"])
def test_train_and_eval_modes_raise_naming_roadmap(mode, tmp_path):
  """--mode eval, every sampler and every model of the JAX package are
  ported (NCSNv2, which raised here naming ROADMAP.md, too); a model name
  that no package registers raises, naming the registered ones, before
  any checkpoint is read."""
  with pytest.raises(NotImplementedError, match="no model named.*ncsnv2_64"):
    main.main(["--config", FLAGSHIP, "--workdir", str(tmp_path),
               "--mode", mode, "--device", "cpu",
               "--config.model.name=ncsnv3", "--config.model.nf=16",
               "--config.model.ch_mult=(1,2)",
               "--config.model.num_res_blocks=1",
               "--config.model.attn_resolutions=(8,)",
               "--config.data.image_size=16"])


def test_cuda_device_without_a_card_raises(tmp_path, monkeypatch):
  """No silent CPU path: --device cuda on a machine without a card fails."""
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="--device cpu"):
    main.main(["--config", FLAGSHIP, "--workdir", str(tmp_path),
               "--mode", "sample"])
