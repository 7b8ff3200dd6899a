"""The port's fused bias + leaky ReLU against the JAX package, its gradient,
the wrapper's contract, and (on a CUDA card only) the Hopper kernels.

The JAX op is NHWC with the bias over the last dim; the port is NCHW with
the bias over dim 1, so inputs are transposed between the two. Tolerance:
1e-6 relative in fp32 (one add and two multiplies per element, in the same
order on both sides).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from score_sde_pytorch_tpu.ops import fused_act as jax_fused_act
from score_sde_pytorch_tpu_torch.ops import build, fused_act

TOL = 1e-6


def nchw(x):
  return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t):
  return t.detach().numpy().transpose(0, 2, 3, 1)


def inputs(shape=(2, 4, 4, 8), seed=0):
  rng = np.random.default_rng(seed)
  x = rng.normal(size=shape).astype(np.float32)
  b = rng.normal(size=shape[-1:]).astype(np.float32)
  return x, b


@pytest.mark.parametrize("with_bias", [True, False])
def test_plain_matches_jax_and_pallas_interpret(with_bias):
  x, b = inputs()
  jb = jnp.asarray(b) if with_bias else None
  want = np.asarray(jax_fused_act.fused_leaky_relu(jnp.asarray(x), jb))
  pallas = np.asarray(jax_fused_act.fused_leaky_relu_pallas(
      jnp.asarray(x), jb, interpret=True))
  got = nhwc(fused_act.fused_leaky_relu(
      nchw(x), torch.from_numpy(b) if with_bias else None))
  np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
  np.testing.assert_allclose(got, pallas, rtol=TOL, atol=TOL)


def test_gradients_match_jax_and_the_plain_backward():
  """Autograd of the wrapper on the CPU (the plain version), the plain
  backward of the kernel, and jax.grad of the JAX op agree."""
  x, b = inputs(seed=1)
  g = np.random.default_rng(2).normal(size=x.shape).astype(np.float32)

  def f(xj, bj):
    return jnp.sum(jax_fused_act.fused_leaky_relu(xj, bj) * jnp.asarray(g))

  want_x, want_b = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(b))
  tx = nchw(x).requires_grad_()
  tb = torch.from_numpy(b).requires_grad_()
  out = fused_act.fused_bias_act(tx, tb)
  out.backward(nchw(g))
  np.testing.assert_allclose(nhwc(tx.grad), want_x, rtol=TOL, atol=TOL)
  np.testing.assert_allclose(tb.grad.numpy(), want_b, rtol=1e-5, atol=1e-5)
  plain = fused_act.fused_leaky_relu_backward(nchw(x), torch.from_numpy(b),
                                              nchw(g))
  torch.testing.assert_close(plain, tx.grad, atol=0, rtol=0)


def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing():
  x, b = inputs()
  before = (fused_act.fused_leaky_relu_launches,
            fused_act.fused_leaky_relu_backward_launches)
  got = fused_act.fused_bias_act(nchw(x), torch.from_numpy(b), 0.1, 2.0)
  torch.testing.assert_close(
      got, fused_act.fused_leaky_relu(nchw(x), torch.from_numpy(b), 0.1, 2.0),
      atol=0, rtol=0)
  assert (fused_act.fused_leaky_relu_launches,
          fused_act.fused_leaky_relu_backward_launches) == before


@pytest.mark.parametrize("x,bias,error", [
    (torch.zeros(2, 3, dtype=torch.float64), None, TypeError),
    (torch.zeros(4), None, ValueError),
    (torch.zeros(2, 3, 4)[..., ::2], None, ValueError),
    (torch.zeros(2, 3, 4), torch.zeros(4), ValueError),
    (torch.zeros(2, 3, 4), torch.zeros(3, dtype=torch.bfloat16), ValueError),
])
def test_wrapper_rejects_bad_inputs(x, bias, error):
  with pytest.raises(error):
    fused_act.fused_bias_act(x, bias)


def test_kernel_is_built_for_hopper_from_the_repo_source():
  cmd = build.nvcc_command("nvcc", build.source_path("fused_act"),
                           build.library_path("fused_act"))
  assert "arch=compute_90a,code=sm_90a" in cmd
  assert cmd[-1].endswith("csrc/fused_act.cu")


@pytest.fixture
def cuda_device():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: the kernel runs only on the card")
  return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(128, 256, 16, 16), (3, 5, 7, 9), (4, 6)])
@pytest.mark.parametrize("with_bias", [True, False])
def test_kernels_match_plain_version_fp32(cuda_device, shape, with_bias):
  gen = torch.Generator(device=cuda_device).manual_seed(0)
  x, g = (torch.randn(shape, device=cuda_device, generator=gen)
          for _ in range(2))
  b = (torch.randn(shape[1], device=cuda_device, generator=gen)
       if with_bias else None)
  xr = x.clone().requires_grad_()
  br = b.clone().requires_grad_() if with_bias else None
  before = fused_act.fused_leaky_relu_backward_launches
  out = fused_act.fused_bias_act(xr, br)
  out.backward(g)
  torch.cuda.synchronize()
  assert fused_act.fused_leaky_relu_backward_launches == before + 1
  torch.testing.assert_close(out, fused_act.fused_leaky_relu(x, b),
                             atol=TOL, rtol=TOL)
  torch.testing.assert_close(xr.grad,
                             fused_act.fused_leaky_relu_backward(x, b, g),
                             atol=TOL, rtol=TOL)
  if with_bias:
    dims = [0] + list(range(2, x.dim()))
    torch.testing.assert_close(
        br.grad, fused_act.fused_leaky_relu_backward(x, b, g).sum(dims),
        atol=1e-4, rtol=1e-5)


@pytest.mark.cuda
def test_kernel_bf16_no_worse_than_plain(cuda_device):
  gen = torch.Generator(device=cuda_device).manual_seed(1)
  x = torch.randn(8, 64, 8, 8, device=cuda_device, generator=gen)
  b = torch.randn(64, device=cuda_device, generator=gen)
  exact = fused_act.fused_leaky_relu(x.bfloat16().double(),
                                     b.bfloat16().double())
  got = fused_act.fused_bias_act(x.bfloat16(), b.bfloat16())
  plain = fused_act.fused_leaky_relu(x.bfloat16(), b.bfloat16())
  err = (got.double() - exact).abs().max()
  assert err <= 1.5 * (plain.double() - exact).abs().max() + 1e-6
