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
    "score_sde_pytorch_tpu_torch.models.utils",
    "score_sde_pytorch_tpu_torch.models.ema",
    "score_sde_pytorch_tpu_torch.losses",
    "score_sde_pytorch_tpu_torch.interop",
    "score_sde_pytorch_tpu_torch.sampling",
    "score_sde_pytorch_tpu_torch.checkpoint",
    "score_sde_pytorch_tpu_torch.run_lib",
    "score_sde_pytorch_tpu_torch.main",
]
BLOCK = "import sys\nfor _m in {!r}: sys.modules[_m] = None\n"
JAX_NAMES = ("jax", "jaxlib", "flax", "optax", "orbax", "score_sde_pytorch_tpu")


def run_child(code: str, blocked=JAX_NAMES):
  proc = subprocess.run(
      [sys.executable, "-c", BLOCK.format(tuple(blocked)) + code],
      capture_output=True, text=True, timeout=300, env=cpu_child_env())
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
      """))
  assert out.strip().endswith("ok")
  assert "Starting training loop at step 2" in (
      tmp_path / "stdout.txt").read_text()
  for sub in ("checkpoints/checkpoint_2.pth", "samples/iter_4/sample.png",
              "generated/samples_0.npz"):
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
                                      "model.dtype=bfloat16"])
def test_unsupported_settings_raise(override):
  with pytest.raises(NotImplementedError):
    configs.load_config(FLAGSHIP, [override])


@pytest.mark.parametrize("mode", ["eval"])
def test_train_and_eval_modes_raise_naming_roadmap(mode, tmp_path):
  with pytest.raises(NotImplementedError, match="ROADMAP"):
    main.main(["--config", FLAGSHIP, "--workdir", str(tmp_path),
               "--mode", mode])


def test_cuda_device_without_a_card_raises(tmp_path, monkeypatch):
  """No silent CPU path: --device cuda on a machine without a card fails."""
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="--device cpu"):
    main.main(["--config", FLAGSHIP, "--workdir", str(tmp_path),
               "--mode", "sample"])
