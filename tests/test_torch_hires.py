"""High-resolution NCSN++ against the JAX package (CPU, fp32): the output
pyramid (``progressive='output_skip'``), the input pyramid
(``progressive_input='input_skip'``, combined by ``'sum'`` or ``'cat'``),
their resamplers and ``model.remat``.

The same numpy inputs and unit-gain weights go through the flax module and
its port, the weights carried across by
``interop.flax_params_to_torch_state_dict`` (``strict=True``); NHWC on the
JAX side, NCHW in the port. Tolerance: 1e-4 absolute and 1e-3 relative in
fp32 (tests/test_torch_ncsnpp.py), for convolutions and reductions summed in
other orders by XLA and PyTorch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from score_sde_pytorch_tpu import interop as jax_interop
from score_sde_pytorch_tpu.models import layerspp as jax_layerspp
from score_sde_pytorch_tpu.models import utils as jax_mutils
import score_sde_pytorch_tpu.models  # noqa: F401  (registers the JAX models)
from score_sde_pytorch_tpu_torch import configs, interop
from score_sde_pytorch_tpu_torch.models import layerspp
from score_sde_pytorch_tpu_torch.models import utils as mutils
from tests.test_torch_ncsnpp import (gen, init_params, nchw, nhwc,
                                     to_torch_state)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

ATOL, RTOL = 1e-4, 1e-3
CHURCH = "score_sde_pytorch_tpu_torch/configs/ve/church_ncsnpp_continuous.py"
# ve/church_ncsnpp_continuous.py cut to nf=16, three levels (16², 8², 4²),
# one resblock a level and attention at 8²; its pyramids, FIR and remat
# stay as they are.
TINY = ("model.nf=16", "model.ch_mult=(1,2,2)", "model.num_res_blocks=1",
        "model.attn_resolutions=(8,)", "data.image_size=16")


@pytest.mark.parametrize("kind,fir,with_conv", [
    ("up", True, False), ("up", False, False), ("up", False, True),
    ("down", True, False), ("down", False, False), ("down", False, True)])
def test_pyramid_resamplers_match_jax(kind, fir, with_conv):
  """Upsample and Downsample in the forms NCSN++ builds: FIR without a conv
  (the pyramids'), nearest or average pool, and their plain convs."""
  x = np.random.default_rng(1).normal(size=(2, 8, 8, 6)).astype(np.float32)
  jax_cls, cls = ((jax_layerspp.Upsample, layerspp.Upsample) if kind == "up"
                  else (jax_layerspp.Downsample, layerspp.Downsample))
  blk = jax_cls(out_ch=6, with_conv=with_conv, fir=fir)
  params = init_params(blk, x) if with_conv else {}  # no conv, no params
  want = np.asarray(blk.apply({"params": params}, x))
  port = cls(6, 6, generator=gen(), with_conv=with_conv, fir=fir)
  port.load_state_dict(to_torch_state(params), strict=True)
  got = nhwc(port(nchw(x)))
  assert got.shape == want.shape
  np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("method", ["sum", "cat"])
def test_combine_matches_jax(method):
  rng = np.random.default_rng(2)
  x = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
  y = rng.normal(size=(2, 8, 8, 16)).astype(np.float32)
  blk = jax_layerspp.Combine(dim2=16, method=method)
  params = init_params(blk, x, y)
  want = np.asarray(blk.apply({"params": params}, x, y))
  port = layerspp.Combine(3, 16, method, generator=gen())
  port.load_state_dict(to_torch_state(params), strict=True)
  np.testing.assert_allclose(nhwc(port(nchw(x), nchw(y))), want, atol=ATOL,
                             rtol=RTOL)


def tiny_pair(*extra):
  """(config, flax module, unit-gain params, port model with them)."""
  cfg = configs.load_config(CHURCH, TINY + extra)
  model_def = jax_mutils.get_model(cfg.model.name)(cfg)
  size = cfg.data.image_size
  params = init_params(model_def, jnp.zeros((1, size, size, 3)),
                       jnp.ones((1,)))
  model = mutils.create_model(cfg, "cpu", gen())
  interop.load_jax_params(model, params, cfg)
  return cfg, model_def, params, model


@pytest.mark.parametrize("combine", ["sum", "cat"])
def test_tiny_skip_pyramids_match_jax(combine):
  """The forward through both pyramids at sigma = 0.5 and 25, with the JAX
  weights loaded through flax_params_to_torch_state_dict; the state_dict is
  the JAX package's map, key for key and in order."""
  cfg, model_def, params, model = tiny_pair(
      f"model.progressive_combine={combine}")
  assert (cfg.model.progressive, cfg.model.progressive_input) == (
      "output_skip", "input_skip")
  assert list(model.state_dict()) == list(
      jax_interop.flax_params_to_torch_state_dict(params, cfg))
  rng = np.random.default_rng(5)
  x = rng.uniform(size=(2, 16, 16, 3)).astype(np.float32)
  t = np.array([0.5, 25.0], np.float32)
  want = np.asarray(model_def.apply({"params": params}, x, t, train=False))
  with torch.no_grad():
    got = nhwc(model(nchw(x), torch.from_numpy(t)))
  np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def _count_calls(model, cls):
  calls = [0]

  def hook(module, args):
    calls[0] += 1

  handles = [m.register_forward_pre_hook(hook) for m in model.modules()
             if isinstance(m, cls)]
  return calls, handles


def _port_grads(model, x, t, w, seed):
  model.zero_grad(set_to_none=True)
  torch.manual_seed(seed)  # dropout draws from the global generator
  (model(x, t) * w).sum().backward()
  return {n: p.grad.clone() for n, p in model.named_parameters()
          if p.requires_grad}


@pytest.mark.parametrize("remat_min_res", [0, 16])
def test_remat_gradients_equal_plain_with_dropout(remat_min_res):
  """Gradients with remat equal those without, bit for bit, with dropout at
  0.3 in train mode: the recomputed resblocks replay the RNG state and draw
  the same masks. Remat recomputes the resblocks at or above
  ``remat_min_res`` and never the attention blocks."""
  _, _, _, model = tiny_pair("model.dropout=0.3",
                             f"model.remat_min_res={remat_min_res}")
  model.train()
  rng = np.random.default_rng(6)
  x = nchw(rng.uniform(size=(2, 16, 16, 3)).astype(np.float32))
  t = torch.tensor([0.5, 25.0])
  w = nchw(rng.normal(size=(2, 16, 16, 3)).astype(np.float32))
  blocks, block_hooks = _count_calls(model, layerspp.ResnetBlockBigGANpp)
  attns, attn_hooks = _count_calls(model, layerspp.AttnBlockpp)
  with_remat = _port_grads(model, x, t, w, seed=3)
  counts = (blocks[0], attns[0])
  model.remat = False
  blocks[0] = attns[0] = 0
  plain = _port_grads(model, x, t, w, seed=3)
  for h in block_hooks + attn_hooks:
    h.remove()
  n_blocks, n_attn = (sum(isinstance(m, cls) for m in model.modules())
                      for cls in (layerspp.ResnetBlockBigGANpp,
                                  layerspp.AttnBlockpp))
  # Resblocks whose input is 16² (remat_min_res 16): down_0_block_0,
  # down_0_downsample, up_0_block_0 and up_0_block_1; at 0, all of them.
  recomputed = n_blocks if remat_min_res == 0 else 4
  assert (blocks[0], attns[0]) == (n_blocks, n_attn)
  assert counts == (n_blocks + recomputed, n_attn)
  assert list(with_remat) == list(plain)
  for name in plain:
    assert torch.equal(with_remat[name], plain[name]), name
  # Another seed draws other masks: dropout is live in these gradients.
  model.remat = True
  key = "all_modules.4.Conv_1.weight"  # down_0_block_0, after its dropout
  assert not torch.equal(_port_grads(model, x, t, w, seed=4)[key],
                         plain[key])


def test_remat_gradients_match_jax_remat():
  """The port's gradients under remat against jax.grad of the JAX package's
  remat forward (dropout off), weights and gradients mapped through
  flax_params_to_torch_state_dict. Tolerance 1e-4 of the largest gradient,
  absolute, for fp32 sums over the pixels in other orders. Two levels at
  8² and 4² keep XLA's compile of the remat gradient short."""
  cfg, model_def, params, model = tiny_pair(
      "model.ch_mult=(1,2)", "data.image_size=8", "model.attn_resolutions=(4,)")
  assert cfg.model.remat
  rng = np.random.default_rng(7)
  x = rng.uniform(size=(2, 8, 8, 3)).astype(np.float32)
  t = np.array([0.5, 25.0], np.float32)
  w = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)

  def loss(p):
    return jnp.sum(model_def.apply({"params": p}, x, t, train=False) * w)

  grads = jax.jit(jax.grad(loss))(params)
  want = jax_interop.flax_params_to_torch_state_dict(
      jax.tree_util.tree_map(np.asarray, grads), cfg)
  model.eval()  # dropout off, as train=False in JAX; remat stays on
  calls, hooks = _count_calls(model, layerspp.ResnetBlockBigGANpp)
  got = _port_grads(model, nchw(x), torch.from_numpy(t), nchw(w), seed=0)
  for h in hooks:
    h.remove()
  n_blocks = sum(isinstance(m, layerspp.ResnetBlockBigGANpp)
                 for m in model.modules())
  assert calls[0] == 2 * n_blocks  # every resblock ran again in backward
  scale = max(float(np.abs(g).max()) for g in want.values())
  for name, g in got.items():
    np.testing.assert_allclose(g.numpy(), want[name], atol=1e-4 * scale,
                               rtol=0, err_msg=name)


def test_remat_is_off_without_a_gradient():
  """Under no_grad (sampling, evaluation) no resblock is wrapped: each runs
  once per forward."""
  _, _, _, model = tiny_pair()
  calls, hooks = _count_calls(model, layerspp.ResnetBlockBigGANpp)
  with torch.no_grad():
    model(torch.rand(1, 3, 16, 16), torch.tensor([1.0]))
  for h in hooks:
    h.remove()
  assert calls[0] == sum(isinstance(m, layerspp.ResnetBlockBigGANpp)
                         for m in model.modules())
