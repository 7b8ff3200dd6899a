"""``model.dtype='bfloat16'``: the port's bf16 computation against the JAX
package's (CPU).

The port rounds to bf16 where the JAX package does, cast for cast. The
JAX side runs op by op (not jitted): each operation's result is rounded to
its dtype, which is what the JAX package's code says. Jitted on the CPU,
XLA keeps fp32 inside fused elementwise chains (its default
``--xla_allow_excess_precision``), so the jitted bf16 result depends on
XLA's fusion choices rather than on the code's casts. Each
NCSN++ block (GroupNorm, conv, NIN, attention, the BigGAN and DDPM
resblocks, the combiner and the pyramids' fused convs) is held to JAX in
bf16 on the same bf16 input: at least 99% of its outputs bit for bit, and
1e-3 relative L2 (‖a − b‖ / ‖b‖) in all.

Whole networks, with the same unit-gain weights in both: a tiny NCSN++ (the
flagship at nf = 16, two levels, attention at 8²) and a tiny ``ncsnv2_64``
(nf = 8, 16²), the two the test plan names, and the church file's
output/input-skip pyramids at three levels.

- For the first two, the port's bf16 output is no further from JAX's bf16
  output than JAX's bf16 output is from JAX's fp32 output, and at most
  5e-2. For the pyramids network the port's bf16 output is within 1.1x of
  that distance of JAX's, and its own distance from JAX's fp32 output is
  within 1.1x of JAX's bf16 distance: its bf16 error is JAX's in size.
  Over depth the two bf16 computations decorrelate, because a GroupNorm's
  fp32 statistics, summed in another order by XLA than by PyTorch, now and
  then round a value to the other neighbouring bf16 number, and that
  difference grows through the network as bf16 rounding error does. At
  three levels the ratio is 1.01.
- The port's bf16 and fp32 outputs differ by more than 1e-4 (bf16 is
  really computed); the fp32 pair agrees within 1e-4.
- Parameters and the output are fp32, the convs' outputs bf16 except the
  two the JAX package leaves at fp32, and the attention takes bf16 q, k, v.
- A bf16 gradient is finite and within 5e-2 (relative L2 over all
  parameters) of JAX's bf16 gradient.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from score_sde_pytorch_tpu.models import layers as jax_layers
from score_sde_pytorch_tpu.models import layerspp as jax_layerspp
from score_sde_pytorch_tpu.models import utils as jax_mutils
import score_sde_pytorch_tpu.models  # noqa: F401  (registers the JAX models)
from score_sde_pytorch_tpu_torch import configs, interop
from score_sde_pytorch_tpu_torch.models import layers, layerspp
from score_sde_pytorch_tpu_torch.models import utils as mutils
from score_sde_pytorch_tpu_torch.ops import attention
from tests.test_torch_ncsnpp import (TINY, init_params, nchw, nhwc,
                                     to_torch_state)
from tests.test_torch_ncsnv2 import unit_gain
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

CONFIGS = "score_sde_pytorch_tpu_torch/configs/"
NETS = {
    "ncsnpp": (CONFIGS + "ve/cifar10_ncsnpp_continuous.py", TINY),
    "ncsnpp_pyramids": (CONFIGS + "tpu/church_256_ncsnpp_tpu.py",
                        TINY + ("model.ch_mult=(1,2,2)",)),
    "ncsnv2_64": (CONFIGS + "ve/ncsnv2/cifar10.py",
                  ("model.nf=8", "data.image_size=16")),
}
LIMIT = 5e-2


def rel_l2(a, b) -> float:
  a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
  return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def build(name, dtype):
  path, tiny = NETS[name]
  overrides = tuple(o for o in tiny) + (f"model.dtype={dtype}",)
  return configs.load_config(path, overrides)


@functools.lru_cache(maxsize=None)
def build_nets(name):
  """(name, fp32 and bf16 configs, flax modules, params, port models)."""
  cfg32, cfg16 = build(name, "float32"), build(name, "bfloat16")
  def32 = jax_mutils.get_model(cfg32.model.name)(cfg32)
  def16 = jax_mutils.get_model(cfg16.model.name)(cfg16)
  x = jnp.zeros((1, 16, 16, 3))
  if name.startswith("ncsnpp"):
    params = init_params(def32, x, jnp.ones((1,)))
  else:
    params = unit_gain(jax.eval_shape(lambda: def32.init(
        jax.random.PRNGKey(0), x, jnp.zeros((1,), jnp.int32)))["params"])
  ports = []
  for cfg in (cfg32, cfg16):
    model = mutils.create_model(cfg, "cpu", torch.Generator().manual_seed(0))
    interop.load_jax_params(model, params, cfg)
    ports.append(model)
  return name, (cfg32, cfg16), (def32, def16), params, ports


@pytest.fixture(params=list(NETS))
def nets(request):
  return build_nets(request.param)


def inputs(name):
  rng = np.random.default_rng(7)
  x = rng.uniform(size=(2, 16, 16, 3)).astype(np.float32)
  labels = (np.array([0.5, 20.0], np.float32) if name.startswith("ncsnpp")
            else np.array([0, 200], np.int32))
  return x, labels


def test_bf16_forward_is_as_close_to_jax_as_jax_to_fp32(nets):
  name, _, (def32, def16), params, (port32, port16) = nets
  x, labels = inputs(name)
  want16 = np.asarray(def16.apply({"params": params}, x, labels))
  want32 = np.asarray(jax.jit(def32.apply)({"params": params}, x, labels))
  with torch.no_grad():
    got16 = port16(nchw(x), torch.from_numpy(labels))
    got32 = port32(nchw(x), torch.from_numpy(labels))
  assert got16.dtype == got32.dtype == torch.float32
  jax_gap = rel_l2(want16, want32)
  port_gap = rel_l2(nhwc(got16), want16)
  assert port_gap <= LIMIT
  if name == "ncsnpp_pyramids":
    assert port_gap <= 1.1 * jax_gap, (port_gap, jax_gap)
    assert rel_l2(nhwc(got16), want32) <= 1.1 * jax_gap
  else:
    assert port_gap <= jax_gap, (port_gap, jax_gap)
  assert rel_l2(nhwc(got16), nhwc(got32)) > 1e-4
  assert rel_l2(nhwc(got32), want32) < 1e-4  # the fp32 pair agrees


def test_bf16_params_stay_fp32_and_convs_compute_bf16(nets):
  """Every parameter is fp32 and every conv returns bf16, except those the
  JAX package leaves at fp32 (NCSN++'s pyramid_conv and conv_out, whose
  bf16 input meets fp32 weights), and the attention takes bf16 q, k, v."""
  name, _, _, _, (_, port16) = nets
  assert all(p.dtype == torch.float32 for p in port16.parameters())
  x, labels = inputs(name)
  conv_dtypes, attn_dtypes = [], []
  hooks = [m.register_forward_hook(
      lambda m, a, out: conv_dtypes.append((m.compute_dtype, out.dtype)))
           for m in port16.modules() if isinstance(m, layers.Conv2d)]
  dense = attention.dense_attention

  def record(q, k, v):
    attn_dtypes.append(q.dtype)
    return dense(q, k, v)

  attention.dense_attention = record
  try:
    with torch.no_grad():
      port16(nchw(x), torch.from_numpy(labels))
  finally:
    attention.dense_attention = dense
    for h in hooks:
      h.remove()
  assert len(conv_dtypes) > 10
  for compute_dtype, out_dtype in conv_dtypes:
    assert out_dtype == (torch.bfloat16 if compute_dtype == torch.bfloat16
                         else torch.float32)
  fp32_convs = sum(out == torch.float32 for _, out in conv_dtypes)
  # conv_out; or the three levels' pyramid_conv; none in ncsnv2_64.
  assert fp32_convs == {"ncsnpp": 1, "ncsnpp_pyramids": 3,
                        "ncsnv2_64": 0}[name]
  assert set(attn_dtypes) == (set() if name == "ncsnv2_64"
                              else {torch.bfloat16})


@pytest.mark.parametrize("name", ["ncsnpp", "ncsnv2_64"])
def test_bf16_gradient_matches_jax(name):
  name, (_, cfg16), (_, def16), params, (_, port16) = build_nets(name)
  x, labels = inputs(name)
  w = np.random.default_rng(8).normal(size=x.shape).astype(np.float32)

  def loss_j(p):
    return jnp.sum(def16.apply({"params": p}, x, labels) * w)

  want = interop.flax_params_to_torch_state_dict(jax.grad(loss_j)(params),
                                                 cfg16)
  port16.zero_grad(set_to_none=True)
  (port16(nchw(x), torch.from_numpy(labels)) * nchw(w)).sum().backward()
  names = [k for k, p in port16.named_parameters() if p.requires_grad]
  got = np.concatenate([port16.get_parameter(k).grad.numpy().ravel()
                        for k in names])
  assert np.isfinite(got).all()
  want = np.concatenate([np.asarray(want[k]).ravel() for k in names])
  assert rel_l2(got, want) <= LIMIT, rel_l2(got, want)


def test_only_float32_and_bfloat16_are_accepted():
  with pytest.raises(NotImplementedError, match="float16"):
    configs.load_config(NETS["ncsnpp"][0], TINY + ("model.dtype=float16",))
  assert mutils.compute_dtype(build("ncsnpp", "bfloat16")) == torch.bfloat16
  assert mutils.compute_dtype(build("ncsnpp", "float32")) is None


BF = jnp.bfloat16
G = torch.Generator
SWISH = layers.get_act("swish")


def _block_cases():
  return {
      "groupnorm": (lambda: jax_layers.GroupNorm(num_groups=8, epsilon=1e-6),
                    lambda: layers.GroupNorm(8, 32), False),
      "conv3x3": (lambda: jax_layers.ddpm_conv3x3(32, dtype=BF),
                  lambda: layers.ddpm_conv3x3(32, 32, generator=G(),
                                              dtype=torch.bfloat16), False),
      "attention": (lambda: jax_layerspp.AttnBlockpp(skip_rescale=True,
                                                     dtype=BF),
                    lambda: layerspp.AttnBlockpp(32, generator=G(),
                                                 skip_rescale=True,
                                                 dtype=torch.bfloat16), False),
      "biggan": (lambda: jax_layerspp.ResnetBlockBigGANpp(
          act=jax.nn.silu, out_ch=32, temb_dim=64, fir=True, dtype=BF),
                 lambda: layerspp.ResnetBlockBigGANpp(
                     SWISH, 32, 32, 64, generator=G(), fir=True,
                     dtype=torch.bfloat16), True),
      "biggan_up": (lambda: jax_layerspp.ResnetBlockBigGANpp(
          act=jax.nn.silu, out_ch=16, temb_dim=64, up=True, fir=True,
          dtype=BF),
                    lambda: layerspp.ResnetBlockBigGANpp(
                        SWISH, 32, 16, 64, generator=G(), up=True, fir=True,
                        dtype=torch.bfloat16), True),
      "biggan_down": (lambda: jax_layerspp.ResnetBlockBigGANpp(
          act=jax.nn.silu, out_ch=32, temb_dim=64, down=True, fir=True,
          dtype=BF),
                      lambda: layerspp.ResnetBlockBigGANpp(
                          SWISH, 32, 32, 64, generator=G(), down=True,
                          fir=True, dtype=torch.bfloat16), True),
      "ddpm_block": (lambda: jax_layerspp.ResnetBlockDDPMpp(
          act=jax.nn.silu, out_ch=16, temb_dim=64, skip_rescale=True,
          dtype=BF),
                     lambda: layerspp.ResnetBlockDDPMpp(
                         SWISH, 32, 16, 64, generator=G(), skip_rescale=True,
                         dtype=torch.bfloat16), True),
      "pyramid_upsample": (lambda: jax_layerspp.Upsample(
          out_ch=16, with_conv=True, fir=True, dtype=BF),
                           lambda: layerspp.Upsample(
                               32, 16, generator=G(), with_conv=True,
                               fir=True, dtype=torch.bfloat16), False),
      "pyramid_downsample": (lambda: jax_layerspp.Downsample(
          out_ch=16, with_conv=True, fir=True, dtype=BF),
                             lambda: layerspp.Downsample(
                                 32, 16, generator=G(), with_conv=True,
                                 fir=True, dtype=torch.bfloat16), False),
  }


@pytest.mark.parametrize("name", list(_block_cases()))
def test_bf16_block_rounds_where_jax_does(name):
  make_jax, make_port, with_temb = _block_cases()[name]
  rng = np.random.default_rng(len(name))
  x = np.asarray(jnp.asarray(rng.normal(size=(2, 8, 8, 32)), BF).astype(
      jnp.float32))
  temb = rng.normal(size=(2, 64)).astype(np.float32)
  jax_blk, port = make_jax(), make_port()
  args = (jnp.asarray(x, BF),) + ((temb,) if with_temb else ())
  params = init_params(jax_blk, *args)
  want = np.asarray(jax_blk.apply({"params": params}, *args).astype(
      jnp.float32))
  port.load_state_dict(to_torch_state(params), strict=True)
  port_args = (nchw(x).bfloat16(),) + ((torch.from_numpy(temb),)
                                       if with_temb else ())
  with torch.no_grad():
    got = nhwc(port.eval()(*port_args).float())
  assert got.shape == want.shape
  assert np.mean(got == want) >= 0.99, np.mean(got == want)
  assert rel_l2(got, want) <= 1e-3
