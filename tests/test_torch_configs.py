"""Every config file the port runs, built at full width on the CPU.

Each of the 31 runnable leaf configs builds its model; its state_dict keys
and shapes equal the JAX package's parameter map of the flax model's
(abstract) parameters, so ``flax_params_to_torch_state_dict`` loads the
JAX package's weights with ``strict=True``; and a batch-1 forward on the
``meta`` device (shapes only) records every attention call it makes, each
held to the kernel's contract (``ops.attention.check_inputs``). The other
13 leaves (NCSN, NCSNv2 and the two bf16 files) raise naming ROADMAP.md.
One real full-width forward runs the 256² DDPM, whose attention is 512
channels wide.
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from score_sde_pytorch_tpu import interop as jax_interop
from score_sde_pytorch_tpu.models import utils as jax_mutils
import score_sde_pytorch_tpu.models  # noqa: F401  (registers the JAX models)
from score_sde_pytorch_tpu_torch import configs
from score_sde_pytorch_tpu_torch.models import layers
from score_sde_pytorch_tpu_torch.models import utils as mutils
from score_sde_pytorch_tpu_torch.ops import attention
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

NOT_LEAVES = {"__init__.py", "builder.py", "default_cifar10_configs.py",
              "default_celeba_configs.py", "default_lsun_configs.py"}
LEAVES = sorted(str(p.relative_to(configs.CONFIG_DIR))
                for p in configs.CONFIG_DIR.rglob("*.py")
                if p.name not in NOT_LEAVES)
UNPORTED = [rel for rel in LEAVES if rel.startswith(("ve/ncsn/", "ve/ncsnv2/"))
            ] + ["tpu/celebahq_1024_ncsnpp_tpu.py", "tpu/church_256_ncsnpp_tpu.py"]
RUNNABLE = [rel for rel in LEAVES if rel not in UNPORTED]
# The attention calls of one forward, as [N, C], of the configs that
# chip_smoke.py drives at 256² and 1024².
ATTENTION = {
    "ve/church_ncsnpp_continuous.py": [(256, 256)] * 2 + [(16, 256),
                                                          (256, 256)],
    "tpu/church_ncsnpp_continuous_multiattn.py":
        [(1024, 256)] * 2 + [(256, 256)] * 2 + [(16, 256), (256, 256),
                                                (1024, 256)],
    "vp/ddpm/church.py": [(256, 512)] * 2 + [(64, 512), (256, 512)],
    "ve/celebahq_ncsnpp_continuous.py": [(256, 512), (64, 512), (256, 512)],
}


def test_the_runnable_configs_are_the_readmes_31():
  assert len(LEAVES) == 44 and len(RUNNABLE) == 31 and len(UNPORTED) == 13


@pytest.mark.parametrize("rel", UNPORTED)
def test_unported_configs_raise_naming_roadmap(rel):
  with pytest.raises(NotImplementedError, match="ROADMAP|not ported"):
    cfg = configs.load_config(str(configs.CONFIG_DIR / rel))
    mutils.get_model(cfg.model.name)


_JAX_SHAPES = {}


def jax_state_shapes(cfg):
  """The port-layout shapes of the flax model's parameters (no JAX init
  runs: ``jax.eval_shape``), cached per architecture."""
  m = cfg.model
  key = repr(sorted((k, repr(v)) for k, v in (
      m.to_dict() if hasattr(m, "to_dict") else m._fields).items()
      if k not in ("sigma_min", "sigma_max", "num_scales", "beta_min",
                   "beta_max", "ema_rate", "dropout", "remat",
                   "remat_min_res"))) + repr((cfg.data.image_size,
                                              cfg.data.num_channels,
                                              cfg.training.continuous))
  if key not in _JAX_SHAPES:
    model_def = jax_mutils.get_model(m.name)(cfg)
    size = cfg.data.image_size
    abstract = jax.eval_shape(
        lambda: model_def.init({"params": jax.random.PRNGKey(0),
                                "dropout": jax.random.PRNGKey(1)},
                               jnp.zeros((1, size, size, 3)), jnp.ones((1,)),
                               train=False))["params"]
    zeros = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), abstract)
    _JAX_SHAPES[key] = [
        (k, tuple(v.shape)) for k, v in
        jax_interop.flax_params_to_torch_state_dict(zeros, cfg).items()]
  return _JAX_SHAPES[key]


def attention_calls(model, cfg):
  """The [B, N, C] shapes of the attention calls of one batch-1 forward on
  the meta device, each checked against the kernel's contract."""
  calls = []

  def record(q, k, v):
    attention.check_inputs(q, k, v)
    calls.append(tuple(q.shape))
    return torch.empty_like(q)

  size = cfg.data.image_size
  x = torch.empty(1, cfg.data.num_channels, size, size, device="meta")
  labels = torch.empty(1, device="meta")
  with mock.patch.object(attention, "attention", record), torch.no_grad():
    out = model.to("meta")(x, labels)
  assert out.shape == x.shape
  return calls


@pytest.mark.parametrize("rel", RUNNABLE)
def test_config_builds_at_full_width(rel):
  cfg = configs.load_config(str(configs.CONFIG_DIR / rel))
  model = mutils.create_model(cfg, "cpu", torch.Generator().manual_seed(0))
  got = [(k, tuple(v.shape)) for k, v in model.state_dict().items()]
  assert got == jax_state_shapes(cfg)
  calls = attention_calls(model, cfg)
  blocks = sum(isinstance(m, layers.AttnBlock) for m in model.modules())
  assert len(calls) == blocks > 0
  if rel in ATTENTION:
    assert [(n, c) for _, n, c in calls] == ATTENTION[rel]


def test_full_width_256_ddpm_forward_on_cpu():
  """vp/ddpm/church.py (ch_mult (1,1,2,2,4,4), 111.6 M parameters): one
  batch-1 forward, its attention at [1, 256, 512] and [1, 64, 512] through
  the plain version. Finite, of the input's shape."""
  cfg = configs.load_config(str(configs.CONFIG_DIR / "vp/ddpm/church.py"))
  model = mutils.create_model(cfg, "cpu", torch.Generator().manual_seed(0))
  assert sum(p.numel() for p in model.parameters()) == 111_569_923
  x = torch.rand(1, 3, 256, 256, generator=torch.Generator().manual_seed(1))
  seen = []
  dense = attention.dense_attention

  def plain(q, k, v):
    seen.append(tuple(q.shape))
    return dense(q, k, v)

  with mock.patch.object(attention, "dense_attention", plain), \
      torch.no_grad():
    out = model(x, torch.tensor([500]))
  assert seen == [(1, 256, 512)] * 2 + [(1, 64, 512), (1, 256, 512)]
  assert out.shape == x.shape and torch.isfinite(out).all()
