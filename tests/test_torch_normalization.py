"""The port's normalization layers (models/normalization.py) against the
JAX package's (CPU, fp32).

The same numpy inputs and parameters go through each flax module and its
port; activations are NHWC on the JAX side and NCHW in the port. Parameters
are drawn away from their init (the conditional embeddings' beta columns
start at zero), so every term contributes. Two inputs per class: a normal
one with a common offset, and a near-constant one whose even channels are
exactly constant (variance 0, the clamp's edge) and whose odd channels vary
by 20% of their mean (at 5%, the fp32 cancellation in E[x²] − E[x]², which
XLA and PyTorch sum in different orders, moves InstanceNorm++'s output by
up to 4e-4, past the tolerance).

Tolerance: 1e-4 absolute and 1e-3 relative, as tests/test_torch_ncsnpp.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from score_sde_pytorch_tpu.models import normalization as jax_norm
from score_sde_pytorch_tpu_torch import configs
from score_sde_pytorch_tpu_torch.models import layers, normalization
from tests.test_torch_ncsnpp import nchw, nhwc

ATOL, RTOL = 1e-4, 1e-3
C, K = 8, 5
CLASSES = {
    "InstanceNorm2d": (False, {}),
    "VarianceNorm2d": (False, {}),
    "NoneNorm2d": (False, {}),
    "InstanceNorm2dPlus": (False, {}),
    "InstanceNorm2dPlus_nobias": (False, {"bias": False}),
    "ConditionalInstanceNorm2dPlus": (True, {}),
    "ConditionalInstanceNorm2dPlus_nobias": (True, {"bias": False}),
    "ConditionalBatchNorm2d": (True, {}),
    "ConditionalInstanceNorm2d": (True, {}),
    "ConditionalInstanceNorm2d_nobias": (True, {"bias": False}),
    "ConditionalVarianceNorm2d": (True, {}),
    "ConditionalNoneNorm2d": (True, {}),
}


def inputs(kind):
  rng = np.random.default_rng(3)
  if kind == "normal":
    return (rng.normal(size=(3, 6, 6, C)) * 2 + 3).astype(np.float32)
  base = 0.5 * np.arange(1, C + 1, dtype=np.float32)
  x = np.broadcast_to(base, (3, 6, 6, C)).copy()
  x[..., 1::2] *= 1 + 0.2 * rng.normal(size=(3, 6, 6, C // 2))
  return x.astype(np.float32)


def modules(name):
  conditional, kwargs = CLASSES[name]
  cls_name = name.split("_")[0]
  jax_cls = getattr(jax_norm, cls_name)
  port_cls = getattr(normalization, cls_name)
  g = torch.Generator().manual_seed(0)
  if conditional:
    return (jax_cls(num_features=C, num_classes=K, **kwargs),
            port_cls(C, K, generator=g, **kwargs))
  return jax_cls(**kwargs), port_cls(C, generator=g, **kwargs)


def draw(variables):
  """Parameters away from their init: scales near 1, shifts near 0."""
  rng = np.random.default_rng(4)

  def one(path, leaf):
    shape = tuple(leaf.shape)
    name = path[-1].key
    if name in ("beta", "mean"):
      return (0.5 * rng.normal(size=shape)).astype(np.float32)
    if name == "var":
      return (1 + 0.5 * rng.random(size=shape)).astype(np.float32)
    return (1 + 0.3 * rng.normal(size=shape)).astype(np.float32)

  return jax.tree_util.tree_map_with_path(one, variables)


def to_port(variables):
  state = {}
  for path, leaf in jax.tree_util.tree_flatten_with_path(variables)[0]:
    collection, name = path[0].key, path[-1].key
    if collection == "batch_stats":
      name = {"mean": "bn.running_mean", "var": "bn.running_var"}[name]
    elif name == "embed":
      name = "embed.weight"
    state[name] = torch.from_numpy(np.asarray(leaf))
  return state


@pytest.mark.parametrize("kind", ["normal", "near_constant"])
@pytest.mark.parametrize("name", list(CLASSES))
def test_norm_matches_jax(name, kind):
  conditional, _ = CLASSES[name]
  jax_mod, port = modules(name)
  x = inputs(kind)
  y = np.array([0, 4, 2], np.int32)
  args = (x, y) if conditional else (x,)
  variables = draw(jax.eval_shape(
      lambda: jax_mod.init(jax.random.PRNGKey(0), *args)))
  batch_norm = name == "ConditionalBatchNorm2d"
  state = to_port(variables)
  if batch_norm:
    state["bn.num_batches_tracked"] = torch.tensor(0)
  port.load_state_dict(state, strict=True)
  port_args = ((nchw(x), torch.from_numpy(y)) if conditional
               else (nchw(x),))
  for train in ((True, False) if batch_norm else (False,)):
    if batch_norm:
      want, updates = jax_mod.apply(variables, *args, train=train,
                                    mutable=["batch_stats"])
    else:
      want = jax_mod.apply(variables, *args)
    got = port.train(train)(*port_args)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    if batch_norm and train:
      for key, jax_key in (("bn.running_mean", "mean"),
                           ("bn.running_var", "var")):
        np.testing.assert_allclose(
            port.state_dict()[key].numpy(),
            np.asarray(updates["batch_stats"]["BatchNorm_0"][jax_key]),
            atol=1e-6, rtol=1e-6)
      port.load_state_dict(state, strict=True)  # eval from the same stats
  if kind == "normal" and name != "NoneNorm2d":
    assert np.abs(nhwc(got) - x).max() > 1e-2  # the norm does something


@pytest.mark.parametrize("name", [n for n in CLASSES if "Batch" not in n])
def test_norm_keeps_bf16_and_computes_stats_in_fp32(name):
  """A bf16 input comes out bf16 (ConditionalNoneNorm2d's fp32 affine
  promotes it, as JAX's does), and equals the fp32 norm of the same
  values, rounded once to bf16."""
  conditional, _ = CLASSES[name]
  _, port = modules(name)
  x = torch.from_numpy(inputs("normal")).permute(0, 3, 1, 2)
  xb = x.bfloat16()
  y = torch.tensor([0, 4, 2])
  args = (xb, y) if conditional else (xb,)
  wide = port(*((xb.float(), y) if conditional else (xb.float(),)))
  got = port(*args)
  if name == "ConditionalNoneNorm2d":
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, wide)
    return
  assert got.dtype == torch.bfloat16
  torch.testing.assert_close(got, wide.bfloat16(), atol=0, rtol=0)


def test_conditional_norm_clamps_the_noise_level():
  """Labels past the table pick its last row, as JAX's gather clamps."""
  _, port = modules("ConditionalInstanceNorm2dPlus")
  x = nchw(inputs("normal"))
  got = port(x, torch.tensor([K + 3, K, K - 1]))
  torch.testing.assert_close(got, port(x, torch.tensor([K - 1] * 3)))


@pytest.mark.parametrize("setting,want", [
    ("InstanceNorm", normalization.InstanceNorm2d),
    ("InstanceNorm++", normalization.InstanceNorm2dPlus),
    ("VarianceNorm", normalization.VarianceNorm2d),
    ("GroupNorm", layers.GroupNorm)])
def test_get_normalization(setting, want):
  cfg = configs.load_config(
      "score_sde_pytorch_tpu_torch/configs/ve/ncsnv2/cifar10.py",
      [f"model.normalization={setting}"])
  norm = normalization.get_normalization(cfg)(64, generator=torch.Generator())
  assert isinstance(norm, want)
  if setting == "InstanceNorm++":
    assert isinstance(normalization.get_normalization(cfg, True)(
        64, 10, generator=torch.Generator()),
        normalization.ConditionalInstanceNorm2dPlus)
  else:
    with pytest.raises(NotImplementedError, match="not implemented"):
      normalization.get_normalization(cfg, conditional=True)
  if setting == "GroupNorm":
    x = torch.randn(2, 64, 4, 4, generator=torch.Generator().manual_seed(0))
    gn = jax_norm.get_normalization(cfg)(name="gn")
    params = gn.init(jax.random.PRNGKey(0), jnp.asarray(nhwc(x)))
    np.testing.assert_allclose(nhwc(norm(x)), np.asarray(gn.apply(
        params, jnp.asarray(nhwc(x)))), atol=ATOL, rtol=RTOL)
  cfg.model.normalization = "LayerNorm"
  with pytest.raises(ValueError, match="Unknown normalization"):
    normalization.get_normalization(cfg)
