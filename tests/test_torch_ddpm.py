"""Parity of the port's DDPM and DDPM++ networks with the JAX package (CPU,
fp32).

The same numpy inputs and weights (the JAX params at unit gain, mapped to
the torch layout) go through the flax module and its port, NHWC on the JAX
side and NCHW in the port: the legacy DDPM layers, the DDPM U-Net
(conditional, unconditional, and with ``scale_by_sigma`` at integer VE
labels) and NCSN++ in its DDPM++ form (positional embedding, fir off, no
input pyramid).

Tolerance: 1e-4 absolute and 1e-3 relative in fp32, for CPU convolutions
and reductions that sum in different orders in XLA and PyTorch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from score_sde_pytorch_tpu import interop as jax_interop
from score_sde_pytorch_tpu.models import layers as jax_layers
from score_sde_pytorch_tpu.models import utils as jax_mutils
import score_sde_pytorch_tpu.models  # noqa: F401  (registers the JAX models)
from score_sde_pytorch_tpu_torch import configs, interop
from score_sde_pytorch_tpu_torch.models import layers, layerspp
from score_sde_pytorch_tpu_torch.models import utils as mutils
from tests.test_torch_ncsnpp import (TINY, gen, init_params, nchw, nhwc,
                                     to_torch_state)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

ATOL, RTOL = 1e-4, 1e-3
CONFIGS = "score_sde_pytorch_tpu_torch/configs/"
DDPMPP = CONFIGS + "vp/cifar10_ddpmpp_continuous.py"
DDPM = CONFIGS + "vp/ddpm/cifar10.py"
DDPM_UNCOND = CONFIGS + "vp/ddpm/cifar10_unconditional.py"
VE_DDPM = CONFIGS + "ve/cifar10_ddpm.py"
VE_NCSNPP = CONFIGS + "ve/cifar10_ncsnpp.py"


def tiny_pair(path, *extra):
  """(config, flax module, unit-gain params, port model with them)."""
  cfg = configs.load_config(path, TINY + extra)
  model_def = jax_mutils.get_model(cfg.model.name)(cfg)
  params = init_params(model_def, jnp.zeros((1, 16, 16, 3)), jnp.ones((1,)))
  model = mutils.create_model(cfg, "cpu", gen())
  interop.load_jax_params(model, params, cfg)
  return cfg, model_def, params, model


def _forward_pair(model_def, params, model, x, labels):
  want = np.asarray(model_def.apply({"params": params}, x, labels,
                                    train=False))
  with torch.no_grad():
    got = model(nchw(x), torch.from_numpy(np.asarray(labels)))
  assert got.dtype == torch.float32
  return nhwc(got), want


@pytest.mark.parametrize("dim", [16, 15])
@pytest.mark.parametrize("labels", [np.array([0.0, 1.5, 999.0], np.float32),
                                    np.array([0, 7, 999], np.int32)])
def test_timestep_embedding_matches_jax(dim, labels):
  want = np.asarray(jax_layers.get_timestep_embedding(jnp.asarray(labels),
                                                      dim))
  got = layers.get_timestep_embedding(torch.from_numpy(labels), dim).numpy()
  assert got.shape == want.shape == (3, dim)
  np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("channels", [32, 48])
def test_legacy_groups_match_jax(channels):
  assert layers.legacy_groups(channels) == jax_layers._legacy_groups(channels)


@pytest.mark.parametrize("size", [4, 8])
def test_legacy_attn_block_matches_jax(size):
  """The legacy block (dense einsum in JAX) through ops.attention here."""
  x = np.random.default_rng(2).normal(size=(2, size, size, 32)).astype(
      np.float32)
  blk = jax_layers.AttnBlock()
  params = init_params(blk, x)
  want = np.asarray(blk.apply({"params": params}, x))
  port = layers.AttnBlock(32, generator=gen())
  port.load_state_dict(to_torch_state(params), strict=True)
  got = nhwc(port(nchw(x)))
  np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
  assert np.abs(got - x).max() > 1e-2  # the attention branch contributes


@pytest.mark.parametrize("kind", ["Upsample", "Downsample"])
@pytest.mark.parametrize("with_conv", [True, False])
def test_legacy_resampling_matches_jax(kind, with_conv):
  """Nearest 2x (F.interpolate vs jax.image.resize) and the stride-2 conv
  padded bottom/right only, or the 2x2 average pool."""
  x = np.random.default_rng(3).normal(size=(2, 8, 8, 16)).astype(np.float32)
  blk = getattr(jax_layers, kind)(with_conv=with_conv)
  params = init_params(blk, x) if with_conv else {}
  want = np.asarray(blk.apply({"params": params}, x))
  port = getattr(layers, kind)(16, with_conv=with_conv, generator=gen())
  port.load_state_dict(to_torch_state(params), strict=True)
  got = nhwc(port(nchw(x)))
  assert got.shape == want.shape
  np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("in_ch,out_ch,temb,conv_shortcut",
                         [(16, 32, True, False), (16, 16, True, False),
                          (32, 16, False, False), (16, 32, True, True)])
def test_resblock_ddpm_matches_jax(in_ch, out_ch, temb, conv_shortcut):
  rng = np.random.default_rng(4)
  x = rng.normal(size=(2, 8, 8, in_ch)).astype(np.float32)
  t = rng.normal(size=(2, 64)).astype(np.float32) if temb else None
  blk = jax_layers.ResnetBlockDDPM(act=jax.nn.silu, out_ch=out_ch,
                                   conv_shortcut=conv_shortcut)
  params = init_params(blk, x, t)
  want = np.asarray(blk.apply({"params": params}, x, t))
  port = layers.ResnetBlockDDPM(F.silu, in_ch, out_ch,
                                temb_dim=64 if temb else None,
                                conv_shortcut=conv_shortcut, generator=gen())
  port.load_state_dict(to_torch_state(params), strict=True)
  got = nhwc(port.eval()(nchw(x), None if t is None else torch.from_numpy(t)))
  np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("path", [DDPM, DDPM_UNCOND])
def test_tiny_ddpm_matches_jax(path):
  """Labels t·999 as the continuous VP score function gives them, and the
  integer labels of the discrete one."""
  _, model_def, params, model = tiny_pair(path)
  x = np.random.default_rng(5).normal(size=(2, 16, 16, 3)).astype(np.float32)
  for labels in (np.array([0.999, 600.5], np.float32),
                 np.array([3, 870], np.int32)):
    got, want = _forward_pair(model_def, params, model, x, labels)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_tiny_ve_ddpm_divides_by_fp32_sigmas():
  """ve/cifar10_ddpm.py sets scale_by_sigma: the output is divided by the
  fp32 sigma at each integer label, as the JAX package reads the ladder."""
  _, model_def, params, model = tiny_pair(VE_DDPM, "model.num_scales=10")
  x = np.random.default_rng(6).uniform(size=(2, 16, 16, 3)).astype(np.float32)
  got, want = _forward_pair(model_def, params, model, x,
                            np.array([0, 9], np.int32))
  np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("path", [DDPM, DDPM_UNCOND])
def test_tiny_ddpm_state_dict_order_matches_reference(path):
  """The reference's registration order (the EMA shadow list follows it);
  an unconditional model's resblocks keep their unused Dense_0, as zeros."""
  cfg, _, params, model = tiny_pair(path)
  want = jax_interop.flax_params_to_torch_state_dict(params, cfg)
  assert list(model.state_dict()) == list(want)
  dense = [k for k in want if k.endswith("Dense_0.weight")]
  assert dense and all(np.array_equal(model.state_dict()[k].numpy(), want[k])
                       for k in dense)
  if not cfg.model.conditional:
    assert all(not want[k].any() for k in dense)


@pytest.mark.parametrize("extra", [
    (), ("model.fir=True",),
    ("model.fir=True", "model.progressive_input=residual")])
def test_tiny_ddpmpp_matches_jax(extra):
  """NCSN++ as DDPM++ (positional embedding, fir off, no input pyramid),
  with fir on, and as the VP NCSN++ (fir on, residual input pyramid); VP
  labels t·999 and integer labels."""
  _, model_def, params, model = tiny_pair(DDPMPP, *extra)
  x = np.random.default_rng(7).normal(size=(2, 16, 16, 3)).astype(np.float32)
  for labels in (np.array([0.999, 600.5], np.float32),
                 np.array([3, 870], np.int32)):
    got, want = _forward_pair(model_def, params, model, x, labels)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_positional_scale_by_sigma_clamps_and_stays_fp32():
  """ve/cifar10_ncsnpp.py: positional embedding with scale_by_sigma. A label
  past the ladder (here 7 on 5 scales, as VP labels t·999 run past a cut
  ladder) reads the last sigma, as JAX's clamped gather does; the output
  stays fp32 though the port's sigmas buffer is float64."""
  _, model_def, params, model = tiny_pair(VE_NCSNPP, "model.num_scales=5")
  assert model.sigmas.dtype == torch.float64
  x = np.random.default_rng(8).uniform(size=(2, 16, 16, 3)).astype(np.float32)
  for labels in (np.array([7.0, 2.0], np.float32), np.array([0, 4], np.int32)):
    got, want = _forward_pair(model_def, params, model, x, labels)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_gather_clamped_follows_jax_indexing():
  table = np.arange(5.0, dtype=np.float32)
  index = np.array([0, 3.7, 4, 7, 100], np.float32)
  want = np.asarray(jnp.asarray(table)[jnp.asarray(index).astype(jnp.int32)])
  got = mutils.gather_clamped(torch.from_numpy(table), torch.from_numpy(index))
  np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("path,n_attn", [
    (DDPMPP, 6), (CONFIGS + "vp/cifar10_ddpmpp_deep_continuous.py", 10),
    (DDPM, 4), (DDPM_UNCOND, 4)])
def test_full_width_state_dict_matches_jax_shapes(path, n_attn):
  """Full width, no forward: the port model's state_dict keys and shapes
  equal the interop map of the JAX model's (abstract) params, and the
  attention blocks per forward are those the chip smoke counts."""
  cfg = configs.load_config(path)
  model_def = jax_mutils.get_model(cfg.model.name)(cfg)
  abstract = jax.eval_shape(
      lambda: model_def.init({"params": jax.random.PRNGKey(0),
                              "dropout": jax.random.PRNGKey(1)},
                             jnp.zeros((1, 32, 32, 3)), jnp.ones((1,)),
                             train=False))["params"]
  zeros = jax.tree_util.tree_map(
      lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), abstract)
  want = {k: tuple(v.shape) for k, v in
          jax_interop.flax_params_to_torch_state_dict(zeros, cfg).items()}
  model = mutils.create_model(cfg, "cpu", gen())
  got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
  assert list(got) == list(want)
  assert got == want
  attn = sum(isinstance(m, (layers.AttnBlock, layerspp.AttnBlockpp))
             for m in model.modules())
  assert attn == n_attn
