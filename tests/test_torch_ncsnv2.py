"""The port's NCSN and NCSNv2 (RefineNet) networks against the JAX package
(CPU, fp32).

Each RefineNet block, then ``ncsnv2_64``, ``ncsnv2_128``, ``ncsnv2_256``
and NCSN v1 (``ncsn``) at nf = 8 and 16² (28² for the ``adjust_padding``
files' size, 32² for the 256² network's six levels): forward and gradient
with the JAX weights loaded through ``interop.flax_params_to_torch_state_dict``
under ``strict=True``; the SMLD loss; the ALD sampler with injected noise;
``model.remat``; a reference-schema ``.pth`` from the JAX package's export.
Weights are drawn at unit gain (norm scales and embeddings near 1), so every
branch contributes.

Tolerance: 1e-4 absolute and 1e-3 relative, as tests/test_torch_ncsnpp.py;
the models' outputs 1e-4 of each sample's largest entry absolute (a v2
output is divided by its sigma, here 0.01 to 50) and 1e-3 relative;
gradients 2e-4 of their largest entry, as tests/test_torch_vp.py.
"""
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from score_sde_pytorch_tpu import interop as jax_interop
from score_sde_pytorch_tpu import losses as jax_losses
from score_sde_pytorch_tpu import sde as jax_sde
from score_sde_pytorch_tpu.models import layers as jax_layers
from score_sde_pytorch_tpu.models import normalization as jax_norm
from score_sde_pytorch_tpu.models import utils as jax_mutils
import score_sde_pytorch_tpu.models  # noqa: F401  (registers the JAX models)
from score_sde_pytorch_tpu_torch import checkpoint, configs, interop, losses
from score_sde_pytorch_tpu_torch import sampling
from score_sde_pytorch_tpu_torch import sde as sde_lib
from score_sde_pytorch_tpu_torch.models import layers, normalization
from score_sde_pytorch_tpu_torch.models import utils as mutils
from tests.test_torch_ncsnpp import nchw, nhwc
from tests.test_torch_vp import jax_labels_z
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

jax_sampling = importlib.import_module("score_sde_pytorch_tpu.sampling")

ATOL, RTOL = 1e-4, 1e-3
CONFIGS = "score_sde_pytorch_tpu_torch/configs/"
NCSN = CONFIGS + "ve/ncsn/cifar10.py"
NCSNV2 = CONFIGS + "ve/ncsnv2/cifar10.py"
BEDROOM = CONFIGS + "ve/ncsnv2/bedroom.py"
MODELS = {
    "ncsn": (NCSN, 16, ()),
    "ncsn_28": (NCSN, 28, ()),
    "ncsnv2_64": (NCSNV2, 16, ()),
    "ncsnv2_64_28": (NCSNV2, 28, ()),
    "ncsnv2_128": (BEDROOM, 16, ()),
    "ncsnv2_256": (BEDROOM, 32, ("model.name=ncsnv2_256",)),
}


def unit_gain(params, seed=0):
  """Conv kernels at fan-in scale, norm scales and embeddings near 1,
  shifts and biases near 0."""
  rng = np.random.default_rng(seed)

  def draw(path, leaf):
    name, shape = path[-1].key, tuple(leaf.shape)
    if name == "kernel":
      fan_in = int(np.prod(shape[:-1]))
      return (rng.normal(size=shape) / np.sqrt(fan_in)).astype(np.float32)
    if name in ("alpha", "gamma", "embed"):
      return (1 + 0.1 * rng.normal(size=shape)).astype(np.float32)
    return (0.1 * rng.normal(size=shape)).astype(np.float32)

  return jax.tree_util.tree_map_with_path(
      lambda path, leaf: jnp.asarray(draw(path, leaf)), params)


# ---------------------------------------------------------------------------
# Blocks. The port's block sits in a wrapper as ``blk`` and the flax params
# under "blk", so interop's row builders name both sides.
# ---------------------------------------------------------------------------


class _Wrap(nn.Module):

  def __init__(self, blk):
    super().__init__()
    self.blk = blk


def load_block(port, jax_params, rows):
  wrap = _Wrap(port)
  tree = {"blk": jax_params}
  state = {k: torch.from_numpy(np.ascontiguousarray(
      interop._to_torch_layout(interop._lookup(tree, f), kind)))
      for k, f, kind in rows}
  wrap.load_state_dict(state, strict=True)
  return port


C, K = 8, 6
G = torch.Generator


def _crp(maxpool):
  rows = []
  for i in range(2):
    interop._conv_nobias(f"blk.convs.{i}", f"blk/Conv_{i}", rows)
  return (jax_layers.CRPBlock(C, 2, jax.nn.elu, maxpool=maxpool),
          layers.CRPBlock(C, 2, F.elu, maxpool=maxpool, generator=G()),
          rows, False)


def _cond_crp():
  rows = []
  for i in range(2):
    interop._conv_nobias(f"blk.convs.{i}", f"blk/Conv_{i}", rows)
  for i in range(2):
    interop._cond_norm(f"blk.norms.{i}", f"blk/Norm_{i}", rows)
  return (jax_layers.CondCRPBlock(C, 2, K, jax_norm.ConditionalInstanceNorm2dPlus,
                                  jax.nn.elu),
          layers.CondCRPBlock(C, 2, K, normalization.ConditionalInstanceNorm2dPlus,
                              F.elu, generator=G()), rows, True)


def _rcu(n_blocks):
  rows = []
  interop._rcu_rows("blk", "blk", rows, n_blocks)
  return (jax_layers.RCUBlock(C, n_blocks, 2, jax.nn.elu),
          layers.RCUBlock(C, n_blocks, 2, F.elu, generator=G()), rows, False)


def _cond_rcu():
  rows = []
  interop._cond_rcu_rows("blk", "blk", rows, 2)
  return (jax_layers.CondRCUBlock(C, 2, 2, K,
                                  jax_norm.ConditionalInstanceNorm2dPlus,
                                  jax.nn.elu),
          layers.CondRCUBlock(C, 2, 2, K,
                              normalization.ConditionalInstanceNorm2dPlus,
                              F.elu, generator=G()), rows, True)


def _conv_mean_pool(kernel, adjust):
  rows = []
  interop._conv(f"blk.conv{'.1' if adjust else ''}", "blk/Conv_0", rows)
  return (jax_layers.ConvMeanPool(C, kernel, adjust_padding=adjust),
          layers.ConvMeanPool(C, C, kernel, adjust_padding=adjust,
                              generator=G()), rows, False)


def _resample_conv(name):
  rows = []
  interop._conv("blk.conv", "blk/Conv_0", rows)
  return (getattr(jax_layers, name)(C), getattr(layers, name)(
      C, C, generator=G()), rows, False)


def _residual(resample, dilation, out, conditional=False):
  rows = []
  if conditional:
    interop._v1_resblock("blk", "blk", rows, resample=resample,
                         dilation=dilation, has_shortcut=out != C)
    return (jax_layers.ConditionalResidualBlock(
        out, K, jax_norm.ConditionalInstanceNorm2dPlus, resample=resample,
        act=jax.nn.elu, dilation=dilation),
            layers.ConditionalResidualBlock(
                C, out, K, normalization.ConditionalInstanceNorm2dPlus,
                resample=resample, dilation=dilation, generator=G()),
            rows, True)
  interop._v2_resblock("blk", "blk", rows, resample=resample,
                       dilation=dilation, has_shortcut=out != C)
  return (jax_layers.ResidualBlock(out, jax_norm.InstanceNorm2dPlus,
                                   resample=resample, act=jax.nn.elu,
                                   dilation=dilation),
          layers.ResidualBlock(C, out, normalization.InstanceNorm2dPlus,
                               resample=resample, dilation=dilation,
                               generator=G()), rows, False)


BLOCKS = {
    "crp_maxpool": lambda: _crp(True),
    "crp_avgpool": lambda: _crp(False),
    "cond_crp": _cond_crp,
    "rcu": lambda: _rcu(1),
    "rcu_3": lambda: _rcu(3),
    "cond_rcu": _cond_rcu,
    "conv_mean_pool_3": lambda: _conv_mean_pool(3, False),
    "conv_mean_pool_1": lambda: _conv_mean_pool(1, False),
    "conv_mean_pool_adjust": lambda: _conv_mean_pool(3, True),
    "mean_pool_conv": lambda: _resample_conv("MeanPoolConv"),
    "upsample_conv": lambda: _resample_conv("UpsampleConv"),
    "residual_down": lambda: _residual("down", 1, 2 * C),
    "residual_down_dilated": lambda: _residual("down", 2, 2 * C),
    "residual_wider": lambda: _residual(None, 1, 2 * C),
    "residual_dilated": lambda: _residual(None, 4, C),
    "residual_dilated_wider": lambda: _residual(None, 2, 2 * C),
    "cond_residual_down": lambda: _residual("down", 1, 2 * C, True),
    "cond_residual_dilated": lambda: _residual("down", 4, C, True),
    "cond_residual_wider": lambda: _residual(None, 1, 2 * C, True),
}


@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_matches_jax(name):
  """One block on an 8x8 input (7x7 into the adjust_padding pool, which
  pads it to 8x8): the pools, dilations and paddings meet the borders."""
  jax_blk, port, rows, conditional = BLOCKS[name]()
  size = 7 if name == "conv_mean_pool_adjust" else 8
  rng = np.random.default_rng(len(name))
  x = (rng.normal(size=(2, size, size, C)) + 0.5).astype(np.float32)
  y = np.array([1, K - 1], np.int32)
  args = (x, y) if conditional else (x,)
  params = unit_gain(jax.eval_shape(
      lambda: jax_blk.init(jax.random.PRNGKey(0), *args))["params"])
  want = np.asarray(jax.jit(jax_blk.apply)({"params": params}, *args))
  load_block(port, params, rows)
  port_args = (nchw(x), torch.from_numpy(y)) if conditional else (nchw(x),)
  with torch.no_grad():
    got = nhwc(port(*port_args))
  assert got.shape == want.shape
  np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("conditional", [False, True])
@pytest.mark.parametrize("kind", ["start", "middle", "end"])
def test_refine_block_matches_jax(kind, conditional):
  """RefineBlock / CondRefineBlock: one input at the start, else an 8x8
  and a 4x4 input fused by MSF's bilinear resize (align_corners=True)."""
  start, end = kind == "start", kind == "end"
  rng = np.random.default_rng(9)
  xs = [rng.normal(size=(2, 8, 8, C)).astype(np.float32)]
  if not start:
    xs.append(rng.normal(size=(2, 4, 4, 2 * C)).astype(np.float32))
  planes = [x.shape[-1] for x in xs]
  y = np.array([0, K - 1], np.int32)
  rows = []
  if conditional:
    norm_j = jax_norm.ConditionalInstanceNorm2dPlus
    jax_blk = jax_layers.CondRefineBlock(C, K, norm_j, jax.nn.elu,
                                         start=start, end=end)
    port = layers.CondRefineBlock(
        planes, C, K, normalization.ConditionalInstanceNorm2dPlus, F.elu,
        start=start, end=end, generator=G())
    interop._cond_refine_rows("blk", "blk", rows, n_inputs=len(xs),
                              start=start, end=end)
    args = (xs, y, (8, 8))
    port_args = ([nchw(x) for x in xs], torch.from_numpy(y), (8, 8))
  else:
    jax_blk = jax_layers.RefineBlock(C, jax.nn.elu, start=start, end=end)
    port = layers.RefineBlock(planes, C, F.elu, start=start, end=end,
                              generator=G())
    interop._refine_rows("blk", "blk", rows, n_inputs=len(xs), start=start,
                         end=end)
    args = (xs, (8, 8))
    port_args = ([nchw(x) for x in xs], (8, 8))
  params = unit_gain(jax.eval_shape(
      lambda: jax_blk.init(jax.random.PRNGKey(0), *args))["params"])
  want = np.asarray(jax_blk.apply({"params": params}, *args))
  load_block(port, params, rows)
  with torch.no_grad():
    got = nhwc(port(*port_args))
  np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("shape", [(8, 8), (4, 4)])
def test_msf_resize_matches_jax(shape):
  """MSF's resize: bilinear with align_corners=True up to 8x8 from 3x3 and
  5x5, and the identity at the input's own size."""
  rng = np.random.default_rng(10)
  xs = [rng.normal(size=(2, s, s, C)).astype(np.float32) for s in (3, 5)]
  xs.append(rng.normal(size=(2,) + shape + (C,)).astype(np.float32))
  jax_blk = jax_layers.MSFBlock(C)
  rows = []
  for i in range(len(xs)):
    interop._conv(f"blk.msf.convs.{i}", f"blk/Conv_{i}", rows)
  rows = [(k.replace("msf.", ""), f, kind) for k, f, kind in rows]
  port = layers.MSFBlock([C] * len(xs), C, generator=G())
  params = unit_gain(jax.eval_shape(
      lambda: jax_blk.init(jax.random.PRNGKey(0), xs, shape))["params"])
  want = np.asarray(jax_blk.apply({"params": params}, xs, shape))
  load_block(port, params, rows)
  with torch.no_grad():
    got = nhwc(port([nchw(x) for x in xs], shape))
  np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


# ---------------------------------------------------------------------------
# Models.
# ---------------------------------------------------------------------------


def model_pair(name, *extra):
  """(config, flax module, unit-gain params, port model with them)."""
  path, size, overrides = MODELS[name]
  cfg = configs.load_config(path, ("model.nf=8", f"data.image_size={size}")
                            + overrides + extra)
  model_def = jax_mutils.get_model(cfg.model.name)(cfg)
  x = jnp.zeros((1, size, size, 3))
  params = unit_gain(jax.eval_shape(lambda: model_def.init(
      jax.random.PRNGKey(0), x, jnp.zeros((1,), jnp.int32)))["params"])
  model = mutils.create_model(cfg, "cpu", G().manual_seed(0))
  interop.load_jax_params(model, params, cfg)
  return cfg, model_def, params, model


@pytest.fixture(scope="module", params=list(MODELS))
def pair(request):
  return (request.param,) + model_pair(request.param)


def _data(cfg, b=2, seed=5):
  size = cfg.data.image_size
  rng = np.random.default_rng(seed)
  x = rng.uniform(size=(b, size, size, 3)).astype(np.float32)
  y = np.array([0, cfg.model.num_scales - 1][:b] + [3] * (b - 2), np.int32)
  return x, y


def test_model_forward_matches_jax(pair):
  name, cfg, model_def, params, model = pair
  x, y = _data(cfg)
  want = np.asarray(jax.jit(model_def.apply)({"params": params}, x, y))
  with torch.no_grad():
    got = model(nchw(x), torch.from_numpy(y))
  assert got.dtype == torch.float32
  for got_i, want_i in zip(nhwc(got), want):
    np.testing.assert_allclose(got_i, want_i,
                               atol=ATOL * np.abs(want_i).max(), rtol=RTOL)
  assert np.abs(want).max() > 1e-2
  if name.startswith("ncsnv2"):  # the v2 output is divided by sigma[y]
    assert np.abs(want[1]).max() > 10 * np.abs(want[0]).max()


def test_state_dict_follows_the_maps(pair):
  """The port's state_dict, key for key and in order, is the port's map of
  the flax params, and, for the v2 models, the JAX package's."""
  name, cfg, _, params, model = pair
  got = [(k, tuple(v.shape)) for k, v in model.state_dict().items()]
  want = [(k, tuple(v.shape)) for k, v in
          interop.flax_params_to_torch_state_dict(params, cfg).items()]
  assert got == want
  assert (got[0][0] == "sigmas") == name.startswith("ncsnv2")
  if name.startswith("ncsnv2"):
    jax_sd = jax_interop.flax_params_to_torch_state_dict(params, cfg)
    assert [(k, tuple(v.shape)) for k, v in jax_sd.items()] == want


@pytest.mark.parametrize("name", [n for n in MODELS if "_28" not in n])
def test_model_gradient_matches_jax(name):
  """Gradient of a fixed projection of the output, every parameter.

  Not at 28²: there a CRP block's stride-1 max pool spreads a peak over a
  plateau that the next conv maps to equal values, so a later window's max
  appears twice, and JAX and PyTorch send its gradient to different copies
  (PyTorch's choice changes with its thread count); either is a valid
  gradient. The 28² forward is held above."""
  cfg, model_def, params, model = model_pair(name)
  x, y = _data(cfg)
  w = np.random.default_rng(6).normal(size=x.shape).astype(np.float32)

  def loss_j(p):
    return jnp.sum(model_def.apply({"params": p}, x, y) * w)

  want = interop.flax_params_to_torch_state_dict(
      jax.jit(jax.grad(loss_j))(params), cfg)
  model.zero_grad(set_to_none=True)
  (model(nchw(x), torch.from_numpy(y)) * nchw(w)).sum().backward()
  scale = max(np.abs(g).max() for k, g in want.items() if k != "sigmas")
  for name, p in model.named_parameters():
    np.testing.assert_allclose(p.grad.numpy(), want[name], atol=2e-4 * scale,
                               rtol=0, err_msg=name)


@pytest.mark.parametrize("name", ["ncsn", "ncsnv2_64"])
def test_smld_loss_and_gradients_match_jax(name):
  """The SMLD loss of the NCSN files (continuous=False on the VE SDE) with
  the JAX key's labels and noise injected."""
  cfg, model_def, params, model = model_pair(name, "model.num_scales=10")
  ref = jax_sde.VESDE(sigma_min=cfg.model.sigma_min,
                      sigma_max=cfg.model.sigma_max, N=cfg.model.num_scales)
  loss_j = jax_losses.get_smld_loss_fn(ref, model_def, train=True,
                                       reduce_mean=False)
  core = losses.get_smld_loss_core(sde_lib.build_sde(cfg), train=True)
  batch = np.random.default_rng(4).uniform(size=(3, 16, 16, 3)).astype(
      np.float32)
  rng = jax.random.PRNGKey(6)
  want, want_grads = jax.jit(jax.value_and_grad(loss_j))(
      params, jnp.asarray(batch), rng)
  labels, z = jax_labels_z(rng, batch.shape, ref.N)
  model.zero_grad(set_to_none=True)
  got = core(model, nchw(batch), torch.from_numpy(labels).long(), nchw(z))
  np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
  got.backward()
  want_grads = interop.flax_params_to_torch_state_dict(want_grads, cfg)
  scale = max(np.abs(g).max() for k, g in want_grads.items()
              if k != "sigmas")
  for key, p in model.named_parameters():
    np.testing.assert_allclose(p.grad.numpy(), want_grads[key],
                               atol=2e-4 * scale, rtol=0, err_msg=key)


def test_ald_sampler_on_ncsn_matches_jax(monkeypatch):
  """ve/ncsn/cifar10.py's sampler (no predictor, annealed Langevin) for 3
  scales x 2 Langevin steps from the same prior and noise. The JAX
  corrector scans its steps, so a patched normal is traced once per
  update: both of a scale's steps see the same array, and the port is fed
  it twice."""
  cfg, model_def, params, model = model_pair("ncsn", "model.num_scales=3")
  n, n_steps, b = 3, 2, 2
  shape = (b, 16, 16, 3)
  rng = np.random.default_rng(12)
  prior = rng.normal(size=shape).astype(np.float32)
  noises = rng.normal(size=(n, 2) + shape).astype(np.float32)
  eps = sde_lib.sampling_eps(cfg)
  sde_j = jax_sde.VESDE(sigma_min=cfg.model.sigma_min,
                        sigma_max=cfg.model.sigma_max, N=n)
  score_j = jax.jit(jax_mutils.get_score_fn(sde_j, model_def, params,
                                            continuous=False))
  corrector_j = jax_sampling.get_corrector("ald")(sde_j, score_j,
                                                  cfg.sampling.snr, n_steps)
  x = jnp.asarray(prior) * sde_j.sigma_max
  for i, t_i in enumerate(jnp.linspace(sde_j.T, eps, n)):
    z = jnp.asarray(noises[i, 0])
    monkeypatch.setattr(jax.random, "normal",
                        lambda k, s, dtype=jnp.float32, z=z: z)
    x, _ = corrector_j(jax.random.PRNGKey(0), x, jnp.full((b,), t_i))
  want = np.asarray(x)  # the "none" predictor's x_mean is its input

  # Per scale: the corrector's two draws, then the "none" predictor's.
  queue = [nchw(noises[i, kind]) for i in range(n) for kind in (0, 0, 1)]
  monkeypatch.setattr(sampling, "normal",
                      lambda shape_, generator, device: queue.pop(0))
  monkeypatch.setattr(sde_lib.VESDE, "prior_sampling",
                      lambda self, s, g, d: nchw(prior) * self.sigma_max)
  sampler = sampling.get_pc_sampler(
      sde_lib.build_sde(cfg), model, shape, sampling.get_predictor("none"),
      sampling.get_corrector("ald"), lambda v: v, snr=cfg.sampling.snr,
      n_steps=n_steps, continuous=False, denoise=True, eps=eps, device="cpu")
  got, nfe = sampler(G())
  assert not queue and nfe == n * (n_steps + 1)
  np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                             atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("name", ["ncsn", "ncsnv2_64"])
def test_remat_gradients_equal_plain(name):
  """model.remat recomputes the residual and refine blocks in the
  backward (their forwards run again) and leaves the gradient as it was."""
  cfg, _, _, model = model_pair(name)
  remat_cfg = configs.load_config(MODELS[name][0], (
      "model.nf=8", "data.image_size=16", "model.remat=True"))
  remat = mutils.create_model(remat_cfg, "cpu", G())
  remat.load_state_dict(model.state_dict(), strict=True)
  x, y = _data(cfg)
  grads, calls = [], []
  for net in (model, remat):
    hooks = [m.register_forward_pre_hook(lambda m, a: calls.append(net))
             for m in net.modules()
             if isinstance(m, (layers.ResidualBlock, layers.RefineBlock,
                               layers.ConditionalResidualBlock,
                               layers.CondRefineBlock))]
    net.zero_grad(set_to_none=True)
    out = net(nchw(x), torch.from_numpy(y))
    out.square().sum().backward()
    grads.append({k: p.grad.clone() for k, p in net.named_parameters()})
    for h in hooks:
      h.remove()
  assert sum(c is remat for c in calls) == 2 * sum(c is model for c in calls)
  for key in grads[0]:
    torch.testing.assert_close(grads[1][key], grads[0][key], atol=1e-6,
                               rtol=1e-5, msg=key)


def test_reference_checkpoint_loads_strict(tmp_path):
  """A .pth of the reference's schema, written by the JAX package's export
  (DataParallel ``module.`` keys, the ``sigmas`` buffer, EMA shadow params
  in parameter order), restores into the port and gives the JAX forward;
  its model entry also loads into a bare model with ``strict=True``."""
  cfg, model_def, params, _ = model_pair("ncsnv2_64")
  path = str(tmp_path / "checkpoint_2.pth")
  jax_interop.export_torch_checkpoint(params, cfg, path, step=2)
  model = mutils.create_model(cfg, "cpu", G().manual_seed(3))
  assert checkpoint.restore_ema(path, model) == 2
  x, y = _data(cfg)
  want = np.asarray(jax.jit(model_def.apply)({"params": params}, x, y))
  with torch.no_grad():
    got = nhwc(model(nchw(x), torch.from_numpy(y)))
  np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
  state = torch.load(path, weights_only=True)["model"]
  bare = mutils.create_model(cfg, "cpu", G())
  bare.load_state_dict({k[len("module."):]: v for k, v in state.items()},
                       strict=True)
  # NCSN v1 has no map in the JAX package: the port's own checkpoint of it
  # round-trips under strict=True, with no sigmas buffer.
  cfg, _, _, ncsn = model_pair("ncsn")
  ncsn_path = str(tmp_path / "ncsn.pth")
  checkpoint.save_checkpoint(ncsn_path, ncsn, cfg, step=1)
  fresh = mutils.create_model(cfg, "cpu", G().manual_seed(4))
  assert checkpoint.restore_ema(ncsn_path, fresh) == 1
  state = torch.load(ncsn_path, weights_only=True)["model"]
  assert not any(k.endswith("sigmas") for k in state)
  with torch.no_grad():
    torch.testing.assert_close(fresh(nchw(x), torch.from_numpy(y)),
                               ncsn(nchw(x), torch.from_numpy(y)))
  assert os.path.getsize(ncsn_path) > 0
