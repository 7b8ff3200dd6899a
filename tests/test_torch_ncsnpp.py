"""Parity of the PyTorch port's NCSN++ modules with the JAX package (CPU, fp32).

The same numpy inputs and the same weights (JAX params mapped to the torch
layout) go through the flax module and its port; activations are NHWC on
the JAX side and NCHW in the port. Weights are drawn at unit gain for every
parameter, including those the real init zeroes (NIN_3, Conv_1, conv_out),
so that every branch contributes to the output.

Tolerance: 1e-4 absolute and 1e-3 relative in fp32, for CPU convolutions
and reductions that sum in different orders in XLA and PyTorch.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from score_sde_pytorch_tpu import interop as jax_interop
from score_sde_pytorch_tpu.models import layers as jax_layers
from score_sde_pytorch_tpu.models import layerspp as jax_layerspp
from score_sde_pytorch_tpu.models import utils as jax_mutils
import score_sde_pytorch_tpu.models  # noqa: F401  (registers the JAX models)
from score_sde_pytorch_tpu_torch import configs
from score_sde_pytorch_tpu_torch import interop
from score_sde_pytorch_tpu_torch.models import layers, layerspp
from score_sde_pytorch_tpu_torch.models import utils as mutils
from score_sde_pytorch_tpu_torch.ops import upfirdn2d

jax_fir = importlib.import_module("score_sde_pytorch_tpu.ops.upfirdn2d")

ATOL, RTOL = 1e-4, 1e-3
FLAGSHIP = "score_sde_pytorch_tpu_torch/configs/ve/cifar10_ncsnpp_continuous.py"
TINY = ("model.nf=16", "model.ch_mult=(1,2)", "model.num_res_blocks=1",
        "model.attn_resolutions=(8,)", "data.image_size=16")


def tiny_flagship_config():
  """The flagship config cut to nf=16, two levels, one resblock, 16² images
  and attention at 8²."""
  return configs.load_config(FLAGSHIP, TINY)


def init_params(module, *args):
  """Unit-gain params for a flax module, drawn from the shapes of its params
  (``jax.eval_shape``: no JAX init runs)."""
  key = jax.random.PRNGKey(0)
  shapes = jax.eval_shape(
      lambda: module.init({"params": key, "dropout": key}, *args))["params"]
  return unit_gain(shapes)


def unit_gain(params, seed=0, fourier_scale=16.0):
  """A draw at unit gain for every leaf (fan-in scaled weights, GroupNorm
  scales near 1, small biases); the Fourier W is normal x fourier_scale, as
  its init draws it."""
  rng = np.random.default_rng(seed)

  def draw(path, leaf):
    name = path[-1].key
    shape = tuple(leaf.shape)
    if name == "W" and len(shape) == 1:
      return (rng.normal(size=shape) * fourier_scale).astype(np.float32)
    if name in ("kernel", "weight", "W"):
      fan_in = int(np.prod(shape[:-1]))
      return (rng.normal(size=shape) / np.sqrt(fan_in)).astype(np.float32)
    if name == "scale":
      return (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)
    return (0.1 * rng.normal(size=shape)).astype(np.float32)

  return jax.tree_util.tree_map_with_path(draw, params)


def to_torch_state(params):
  """flax param tree of one module -> the port's state_dict."""
  out = {}
  for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
    names = [p.key for p in path]
    arr = np.asarray(leaf)
    if names[-1] == "scale":
      names[-1] = "weight"
    elif names[-1] == "kernel":
      names[-1] = "weight"
      arr = arr.T if arr.ndim == 2 else arr.transpose(3, 2, 0, 1)
    elif names[-1] == "weight" and arr.ndim == 4:
      arr = arr.transpose(3, 2, 0, 1)
    out[".".join(names)] = torch.from_numpy(np.ascontiguousarray(arr))
  return out


def nchw(x):
  return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t):
  return t.detach().numpy().transpose(0, 2, 3, 1)


def gen():
  return torch.Generator().manual_seed(0)


FIR = (1, 3, 3, 1)
FIR_2D = np.outer(FIR, FIR)


@pytest.mark.parametrize("name,jax_fn,port_fn", [
    ("upsample_fir", lambda x: jax_fir.upsample_2d(x, FIR),
     lambda x: upfirdn2d.upsample_2d(x, FIR)),
    ("downsample_fir", lambda x: jax_fir.downsample_2d(x, FIR),
     lambda x: upfirdn2d.downsample_2d(x, FIR)),
    ("upsample_fir_2d", lambda x: jax_fir.upsample_2d(x, FIR_2D),
     lambda x: upfirdn2d.upsample_2d(x, FIR_2D)),
    ("downsample_fir_2d", lambda x: jax_fir.downsample_2d(x, FIR_2D, gain=2.0),
     lambda x: upfirdn2d.downsample_2d(x, FIR_2D, gain=2.0)),
    ("upfirdn_negative_pad",
     lambda x: jax_fir.upfirdn2d(x, np.ones(3, np.float32), up=2, pad=(-1, 2)),
     lambda x: upfirdn2d.upfirdn2d(x, np.ones(3, np.float32), up=2,
                                   pad=(-1, 2))),
    ("naive_upsample", jax_fir.naive_upsample_2d,
     upfirdn2d.naive_upsample_2d),
    ("naive_downsample", jax_fir.naive_downsample_2d,
     upfirdn2d.naive_downsample_2d),
])
def test_fir_ops_match_jax(name, jax_fn, port_fn):
  """FIR resampling (XLA convs in JAX, depthwise F.conv2d here), NHWC vs
  NCHW; fp32 sums of 4-16 taps."""
  x = np.random.default_rng(6).normal(size=(2, 8, 8, 5)).astype(np.float32)
  want = np.asarray(jax_fn(jnp.asarray(x)))
  got = nhwc(port_fn(nchw(x)))
  assert got.shape == want.shape, name
  np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_conv_downsample_matches_jax():
  rng = np.random.default_rng(7)
  x = rng.normal(size=(2, 8, 8, 5)).astype(np.float32)
  w = (rng.normal(size=(3, 3, 5, 7)) / np.sqrt(45)).astype(np.float32)
  want = np.asarray(jax_fir.conv_downsample_2d(jnp.asarray(x),
                                               jnp.asarray(w), FIR))
  got = nhwc(upfirdn2d.conv_downsample_2d(
      nchw(x), torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))),
      FIR))
  np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_upsample_conv_matches_jax():
  """The transposed conv + FIR of progressive='residual''s output pyramid
  (JAX upfirdn2d.py:152-181)."""
  rng = np.random.default_rng(8)
  x = rng.normal(size=(2, 8, 8, 5)).astype(np.float32)
  w = (rng.normal(size=(3, 3, 5, 7)) / np.sqrt(45)).astype(np.float32)
  want = np.asarray(jax_fir.upsample_conv_2d(jnp.asarray(x), jnp.asarray(w),
                                             FIR))
  got = nhwc(upfirdn2d.upsample_conv_2d(
      nchw(x), torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))),
      FIR))
  assert got.shape == want.shape == (2, 16, 16, 7)
  np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("up,down", [(True, False), (False, False)])
def test_fused_conv_matches_jax(up, down):
  """Conv2dFused up (the residual output pyramid's) and plain."""
  rng = np.random.default_rng(9)
  x = rng.normal(size=(2, 8, 8, 5)).astype(np.float32)
  blk = jax_layerspp.Conv2dFused(7, up=up, down=down,
                                 kernel_init=jax_layers.default_init())
  params = init_params(blk, x)
  want = np.asarray(blk.apply({"params": params}, x))
  port = layerspp.Conv2dFused(5, 7, 3, generator=gen(), up=up, down=down)
  port.load_state_dict(to_torch_state(params), strict=True)
  np.testing.assert_allclose(nhwc(port(nchw(x))), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", ["elu", "relu", "lrelu", "swish", "Swish"])
def test_activations_match_jax(name):
  x = np.linspace(-4, 4, 101, dtype=np.float32)
  want = np.asarray(jax_layers.get_act(name)(jnp.asarray(x)))
  got = layers.get_act(name)(torch.from_numpy(x)).numpy()
  np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("channels,groups", [(16, 4), (64, 16), (256, 32)])
def test_groupnorm_matches_jax(channels, groups):
  rng = np.random.default_rng(1)
  # large common offset: exercises the E[x²]−E[x]² path and its clamp
  x = (rng.normal(size=(2, 8, 8, channels)) * 3 + 40).astype(np.float32)
  jax_gn = jax_layers.GroupNorm(num_groups=groups, epsilon=1e-6)
  params = init_params(jax_gn, x)
  want = np.asarray(jax_gn.apply({"params": params}, x))
  gn = layers.GroupNorm(groups, channels, eps=1e-6)
  gn.load_state_dict(to_torch_state(params), strict=True)
  np.testing.assert_allclose(nhwc(gn(nchw(x))), want, atol=ATOL, rtol=RTOL)


def test_groupnorm_constant_input_is_finite():
  """The variance clamp keeps a constant, large-mean group finite: at this
  value E[x²] − E[x]² comes out at −16 in fp32."""
  gn = layers.GroupNorm(4, 16)
  out = gn(torch.full((1, 16, 4, 4), 12345.678))
  assert torch.isfinite(out).all()


@pytest.mark.parametrize("size", [4, 8])
def test_attn_block_matches_jax(size):
  rng = np.random.default_rng(2)
  x = rng.normal(size=(2, size, size, 32)).astype(np.float32)
  blk = jax_layerspp.AttnBlockpp(skip_rescale=True, init_scale=0.0)
  params = init_params(blk, x)
  want = np.asarray(blk.apply({"params": params}, x))
  port = layerspp.AttnBlockpp(32, generator=gen(), skip_rescale=True)
  port.load_state_dict(to_torch_state(params), strict=True)
  got = nhwc(port(nchw(x)))
  np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
  assert np.abs(got - x).max() > 1e-2  # the attention branch contributes


@pytest.mark.parametrize("up,down,in_ch,out_ch,fir",
                         [(False, True, 16, 16, True),
                          (True, False, 32, 16, True),
                          (False, False, 16, 32, True),
                          (True, False, 16, 16, False),
                          (False, True, 16, 16, False)])
def test_resblock_biggan_matches_jax(up, down, in_ch, out_ch, fir):
  rng = np.random.default_rng(3)
  x = rng.normal(size=(2, 8, 8, in_ch)).astype(np.float32)
  temb = rng.normal(size=(2, 64)).astype(np.float32)
  blk = jax_layerspp.ResnetBlockBigGANpp(
      act=jax.nn.silu, out_ch=out_ch, up=up, down=down, fir=fir,
      fir_kernel=(1, 3, 3, 1), skip_rescale=True, init_scale=0.0,
      temb_dim=64)
  params = init_params(blk, x, temb)
  want = np.asarray(blk.apply({"params": params}, x, temb))
  port = layerspp.ResnetBlockBigGANpp(
      F.silu, in_ch, out_ch, 64, generator=gen(), up=up, down=down,
      fir=fir, fir_kernel=(1, 3, 3, 1), skip_rescale=True, init_scale=0.0)
  port.load_state_dict(to_torch_state(params), strict=True)
  got = nhwc(port.eval()(nchw(x), torch.from_numpy(temb)))
  assert got.shape == want.shape
  np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_pyramid_downsample_matches_jax():
  """Downsample(with_conv, fir) = the fused FIR + strided conv of the
  flagship's residual input pyramid."""
  rng = np.random.default_rng(4)
  x = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
  blk = jax_layerspp.Downsample(out_ch=16, with_conv=True, fir=True)
  params = init_params(blk, x)
  want = np.asarray(blk.apply({"params": params}, x))
  port = layerspp.Downsample(3, 16, generator=gen(), with_conv=True, fir=True)
  port.load_state_dict(to_torch_state(params), strict=True)
  np.testing.assert_allclose(nhwc(port(nchw(x))), want, atol=ATOL, rtol=RTOL)


def test_fourier_projection_matches_jax():
  sigmas = np.array([0.01, 0.5, 25.0, 50.0], np.float32)
  proj = jax_layerspp.GaussianFourierProjection(embedding_size=16, scale=16)
  params = init_params(proj, jnp.log(sigmas))
  want = np.asarray(proj.apply({"params": params}, jnp.log(sigmas)))
  port = layerspp.GaussianFourierProjection(16, 16, generator=gen())
  port.load_state_dict(to_torch_state(params), strict=True)
  got = port(torch.log(torch.from_numpy(sigmas))).numpy()
  np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
  assert not port.W.requires_grad


def build_pair(cfg):
  """(config, flax module, unit-gain params, port model with them)."""
  model_def = jax_mutils.get_model(cfg.model.name)(cfg)
  params = init_params(model_def, jnp.zeros((1, 16, 16, 3)), jnp.ones((1,)))
  model = mutils.create_model(cfg, "cpu", gen())
  interop.load_jax_params(model, params, cfg)
  return cfg, model_def, params, model


@pytest.fixture(scope="module")
def tiny_pair():
  return build_pair(tiny_flagship_config())


def assert_forward_matches_jax(pair):
  """One batch holds both labels, sigma = 0.5 and sigma = 25."""
  cfg, model_def, params, model = pair
  rng = np.random.default_rng(5)
  x = rng.uniform(size=(2, 16, 16, 3)).astype(np.float32)
  t = np.array([0.5, 25.0], np.float32)
  want = np.asarray(model_def.apply({"params": params}, x, t, train=False))
  with torch.no_grad():
    got = nhwc(model(nchw(x), torch.from_numpy(t)))
  np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_tiny_ncsnpp_matches_jax(tiny_pair):
  assert_forward_matches_jax(tiny_pair)


def test_tiny_ncsnpp_state_dict_order_matches_reference(tiny_pair):
  """Parameter order is the torch reference's, which the EMA shadow list
  of its checkpoints follows; only the Fourier W is not trainable."""
  cfg, _, params, model = tiny_pair
  want = list(jax_interop.flax_params_to_torch_state_dict(params, cfg))
  assert list(model.state_dict()) == want
  frozen = [n for n, p in model.named_parameters() if not p.requires_grad]
  assert frozen == ["all_modules.0.W"]


def test_flagship_state_dict_matches_jax_shapes():
  """Full width, no forward: the flagship port model's state_dict keys and
  shapes equal the interop map of the JAX model's (abstract) params."""
  cfg = configs.load_config(FLAGSHIP)
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
  n_attn = sum(isinstance(m, layerspp.AttnBlockpp) for m in model.modules())
  assert n_attn == 6  # 4 resblocks at 16² + 1 up-path block + the bottleneck


@pytest.mark.parametrize("key,value", [
    ("conditional", False), ("progressive", "output_skip"),
    ("progressive_input", "input_skip"), ("progressive", "residual"),
    ("resblock_type", "ddpm")])
def test_unported_branches_raise(key, value):
  """The values no shipped config uses, which raised until they were
  ported: each now builds alone on the tiny flagship, loads the JAX weights
  with ``strict=True`` and matches JAX (both pyramids together:
  tests/test_torch_hires.py). An unconditional model keeps the reference's
  unused ``Dense_0`` in each resblock, zeros from the map; a DDPM-resblock
  model resamples with separate FIR Up/Downsample modules."""
  cfg = tiny_flagship_config()
  cfg.model[key] = value
  pair = build_pair(cfg)
  assert_forward_matches_jax(pair)
  model = pair[3]
  if key == "conditional":
    # conv_in right after FourierProj: no Dense_t0, Dense_t1
    assert isinstance(model.all_modules[1], layers.Conv2d)
  if key == "resblock_type":
    assert any(isinstance(m, layerspp.ResnetBlockDDPMpp)
               for m in model.modules())
  cfg.model[key] = "unknown" if isinstance(value, str) else value
  if isinstance(value, str):
    with pytest.raises(ValueError, match="unknown"):
      mutils.create_model(cfg, "cpu", gen())
