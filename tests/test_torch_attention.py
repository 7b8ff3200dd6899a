"""The port's attention: plain version against the JAX package, the
wrapper's contract, and (on a CUDA card only) the Hopper kernel.

Tolerance for fp32 agreement: 2e-5 absolute and relative, the JAX package's
own flash-vs-dense bound (tests/test_attention.py), for sums of C products
taken in different orders.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from score_sde_pytorch_tpu_torch.ops import attention
from score_sde_pytorch_tpu_torch.ops import build

jax_attention = importlib.import_module("score_sde_pytorch_tpu.ops.attention")

TOL = 2e-5


def qkv(b, n, c, seed=0, scale=2.0):
  rng = np.random.default_rng(seed)
  return tuple((rng.normal(size=(b, n, c)) * scale).astype(np.float32)
               for _ in range(3))


@pytest.mark.parametrize("b,n,c", [(2, 16, 32), (2, 64, 16), (2, 256, 32),
                                   (2, 64, 512), (1, 64, 384)])
def test_dense_matches_jax_flash_and_dense(b, n, c):
  q, k, v = qkv(b, n, c)
  got = attention.dense_attention(*map(torch.from_numpy, (q, k, v))).numpy()
  jq, jk, jv = map(jnp.asarray, (q, k, v))
  flash = np.asarray(jax_attention.flash_attention(jq, jk, jv, interpret=True))
  dense = np.asarray(jax_attention.dense_attention(jq, jk, jv))
  np.testing.assert_allclose(got, flash, atol=TOL, rtol=TOL)
  np.testing.assert_allclose(got, dense, atol=TOL, rtol=TOL)


def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing():
  q, k, v = map(torch.from_numpy, qkv(2, 64, 16))
  before = attention.flash_attention_launches
  torch.testing.assert_close(attention.attention(q, k, v),
                             attention.dense_attention(q, k, v),
                             atol=0, rtol=0)
  assert attention.flash_attention_launches == before


def test_dense_bf16_casts_probabilities_to_v_dtype():
  q, k, v = (torch.from_numpy(a).bfloat16() for a in qkv(1, 16, 16))
  out = attention.dense_attention(q, k, v)
  assert out.dtype == torch.bfloat16
  want = torch.einsum("bnm,bmc->bnc",
                      torch.softmax((torch.einsum("bnc,bmc->bnm", q, k)
                                     * 0.25).float(), -1).bfloat16(), v)
  torch.testing.assert_close(out, want, atol=0, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int32])
def test_wrapper_rejects_dtypes(dtype):
  q = torch.zeros(1, 16, 16, dtype=dtype)
  with pytest.raises(TypeError):
    attention.attention(q, q, q)


@pytest.mark.parametrize("shape", [(1, 16, 12), (1, 16, 520), (1, 16, 0),
                                   (16, 16), (1, 1, 16, 16)])
def test_wrapper_rejects_shapes(shape):
  q = torch.zeros(shape)
  with pytest.raises(ValueError):
    attention.attention(q, q, q)


def test_wrapper_rejects_mismatch_and_noncontiguous():
  q = torch.zeros(1, 16, 16)
  with pytest.raises(ValueError):
    attention.attention(q, torch.zeros(1, 8, 16), q)
  with pytest.raises(TypeError):
    attention.attention(q, q.bfloat16(), q)
  strided = torch.zeros(1, 16, 32)[..., ::2]
  with pytest.raises(ValueError):
    attention.attention(strided, strided, strided)


@pytest.mark.parametrize("b,n,c", [(2, 16, 32), (2, 64, 16), (1, 256, 32),
                                   (2, 64, 512), (1, 64, 384)])
def test_dense_backward_matches_jax_flash_bwd_and_autograd(b, n, c):
  """The plain backward against JAX ``_flash_bwd_impl`` (what the JAX
  package's custom_vjp runs) and against autograd through the plain
  forward. Tolerance 5e-4 absolute and relative, the JAX package's own
  gradient bound (tests/test_attention.py)."""
  q, k, v = qkv(b, n, c, seed=1)
  dout = np.random.default_rng(2).normal(size=(b, n, c)).astype(np.float32)
  tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
  out = attention.dense_attention(tq, tk, tv)
  got = attention.dense_attention_backward(tq.detach(), tk.detach(),
                                           tv.detach(), out.detach(),
                                           torch.from_numpy(dout))
  jq, jk, jv, jdout = map(jnp.asarray, (q, k, v, dout))
  jout = jax_attention.dense_attention(jq, jk, jv)
  want = jax_attention._flash_bwd_impl(jq, jk, jv, jout, jdout, c ** -0.5,
                                       min(512, n))
  out.backward(torch.from_numpy(dout))
  for name, g, w, auto in zip("qkv", got, want, (tq.grad, tk.grad, tv.grad)):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-4,
                               rtol=5e-4, err_msg=name)
    np.testing.assert_allclose(g.numpy(), auto.numpy(), atol=5e-4, rtol=5e-4,
                               err_msg=name)


def test_wrapper_gradient_on_cpu_is_autograd_and_launches_nothing():
  q, k, v = (torch.from_numpy(a).requires_grad_() for a in qkv(2, 16, 16))
  before = (attention.flash_attention_launches,
            attention.flash_attention_backward_launches)
  attention.attention(q, k, v).sum().backward()
  assert q.grad is not None and torch.isfinite(q.grad).all()
  assert (attention.flash_attention_launches,
          attention.flash_attention_backward_launches) == before


def test_kernel_is_built_for_hopper_from_the_repo_source():
  cmd = build.nvcc_command("nvcc", build.source_path("flash_attention"),
                           build.library_path("flash_attention"))
  assert "arch=compute_90a,code=sm_90a" in cmd
  assert cmd[-1].endswith("csrc/flash_attention.cu")
  assert build.library_path("flash_attention").parent == build.BUILD_DIR


@pytest.fixture
def cuda_device():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: the kernel runs only on the card")
  return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,c", [(64, 256, 256), (64, 16, 256),
                                   (2, 1024, 256), (3, 200, 64), (2, 64, 8),
                                   (8, 256, 512), (8, 64, 512),
                                   (4, 200, 512), (1, 1024, 384),
                                   (2, 40, 264)])
def test_kernel_matches_plain_version(cuda_device, b, n, c):
  torch.backends.cuda.matmul.allow_tf32 = False
  q, k, v = (torch.from_numpy(a).to(cuda_device)
             for a in qkv(b, n, c, scale=1.0))
  before = attention.flash_attention_launches
  out = attention.attention(q, k, v)
  torch.cuda.synchronize()
  assert attention.flash_attention_launches == before + 1
  torch.testing.assert_close(out, attention.dense_attention(q, k, v),
                             atol=TOL, rtol=TOL)


def _err(a, b):
  return (a.double() - b).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("c", [256, 512])
def test_kernel_bf16_no_worse_than_dense(cuda_device, c):
  torch.backends.cuda.matmul.allow_tf32 = False
  q, k, v = (torch.from_numpy(a).to(cuda_device) for a in qkv(8, 256, c))
  exact = attention.dense_attention(q.double(), k.double(), v.double())
  qb, kb, vb = (t.bfloat16() for t in (q, k, v))
  err_kernel = _err(attention.attention(qb, kb, vb), exact)
  err_dense = _err(attention.dense_attention(qb, kb, vb), exact)
  assert err_kernel <= err_dense * 1.5 + 1e-3, (err_kernel, err_dense)


@pytest.mark.cuda
@pytest.mark.parametrize("n,c", [(16, 256), (256, 256), (256, 512)])
def test_kernel_stable_at_large_logits(cuda_device, n, c):
  """Logits x30: finite, and no further from the fp64 result than the
  plain fp32 path (x1.5 + 2e-5); at this scale the plain path is itself
  ~1e-4 from the fp64 result, so the bound is against fp64."""
  torch.backends.cuda.matmul.allow_tf32 = False
  q, k, v = (torch.from_numpy(a).to(cuda_device)
             for a in qkv(16, n, c, scale=1.0))
  q = q * 30
  exact = attention.dense_attention(q.double(), k.double(), v.double())
  out = attention.attention(q, k, v)
  assert torch.isfinite(out).all()
  err_dense = _err(attention.dense_attention(q, k, v), exact)
  assert _err(out, exact) <= 1.5 * err_dense + TOL


BWD_TOL = 5e-4  # the JAX package's gradient bound (tests/test_attention.py)


def _grads_through_kernel(q, k, v, dout):
  leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
  attention.attention(*leaves).backward(dout)
  return [t.grad for t in leaves]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,c", [(128, 256, 256), (128, 16, 256),
                                   (2, 1024, 256), (1, 1024, 128),
                                   (4, 200, 256), (3, 40, 8),
                                   (8, 256, 512), (8, 64, 512),
                                   (4, 200, 512), (1, 1024, 384),
                                   (3, 40, 504)])
def test_kernel_backward_matches_plain_version(cuda_device, b, n, c):
  torch.backends.cuda.matmul.allow_tf32 = False
  gen = torch.Generator(device=cuda_device).manual_seed(b + n + c)
  q, k, v, dout = (torch.randn(b, n, c, device=cuda_device, generator=gen)
                   for _ in range(4))
  before = attention.flash_attention_backward_launches
  got = _grads_through_kernel(q, k, v, dout)
  torch.cuda.synchronize()
  assert attention.flash_attention_backward_launches == before + 1
  want = attention.dense_attention_backward(
      q, k, v, attention.dense_attention(q, k, v), dout)
  for g, w in zip(got, want):
    torch.testing.assert_close(g, w, atol=BWD_TOL, rtol=BWD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [256, 512])
def test_kernel_backward_bf16_and_large_logits(cuda_device, c):
  """bf16: no further from the fp64 gradients than the plain bf16 path
  (x1.5 + 1e-3); logits x30: finite, and no further from fp64 than the
  plain fp32 path (x1.5 + 5e-4)."""
  torch.backends.cuda.matmul.allow_tf32 = False
  gen = torch.Generator(device=cuda_device).manual_seed(3)
  q, k, v, dout = (torch.randn(8, 256, c, device=cuda_device, generator=gen)
                   for _ in range(4))
  for scale, dtype, slack in ((1.0, torch.bfloat16, 1e-3),
                              (30.0, torch.float32, BWD_TOL)):
    args = [(q * scale).to(dtype), k.to(dtype), v.to(dtype), dout.to(dtype)]
    exact = attention.dense_attention_backward(
        *[a.double() for a in args[:3]],
        attention.dense_attention(*[a.double() for a in args[:3]]),
        args[3].double())
    got = _grads_through_kernel(*args)
    plain = attention.dense_attention_backward(
        *args[:3], attention.dense_attention(*args[:3]), args[3])
    for g, p, e in zip(got, plain, exact):
      assert torch.isfinite(g).all()
      assert _err(g, e) <= 1.5 * _err(p, e) + slack, (scale, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [256, 512])
def test_kernel_backward_is_bitwise_deterministic(cuda_device, c):
  """The backward has one writer per output row and sums in a fixed order
  (dS goes through a scratch, not atomics): two runs give the same bits."""
  gen = torch.Generator(device=cuda_device).manual_seed(7)
  q, k, v, dout = (torch.randn(16, 256, c, device=cuda_device,
                               generator=gen) for _ in range(4))
  first = _grads_through_kernel(q, k, v, dout)
  second = _grads_through_kernel(q, k, v, dout)
  for a, b in zip(first, second):
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [8, 24])
def test_kernel_bf16_narrow_channels(cuda_device, c):
  """bf16 at C = 8 and 24 (not multiples of 16): forward and gradients no
  further from fp64 than the plain bf16 path (x1.5 + 1e-3)."""
  torch.backends.cuda.matmul.allow_tf32 = False
  gen = torch.Generator(device=cuda_device).manual_seed(c)
  q, k, v, dout = (torch.randn(4, 100, c, device=cuda_device,
                               generator=gen).bfloat16() for _ in range(4))
  wide = [t.double() for t in (q, k, v)]
  exact = attention.dense_attention(*wide)
  assert _err(attention.attention(q, k, v), exact) <= (
      1.5 * _err(attention.dense_attention(q, k, v), exact) + 1e-3)
  exact_grads = attention.dense_attention_backward(*wide, exact,
                                                   dout.double())
  plain_grads = attention.dense_attention_backward(
      q, k, v, attention.dense_attention(q, k, v), dout)
  for g, p, e in zip(_grads_through_kernel(q, k, v, dout), plain_grads,
                     exact_grads):
    assert _err(g, e) <= 1.5 * _err(p, e) + 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,c", [(3, 1, 64), (2, 200, 256), (3, 1, 512),
                                   (2, 200, 384)])
def test_kernel_ragged_lengths(cuda_device, b, n, c):
  """N = 1 (one valid row and column in every tile) and N = 200 (ragged
  last tiles): forward within 2e-5, gradients within 5e-4 of plain."""
  torch.backends.cuda.matmul.allow_tf32 = False
  gen = torch.Generator(device=cuda_device).manual_seed(n)
  q, k, v, dout = (torch.randn(b, n, c, device=cuda_device, generator=gen)
                   for _ in range(4))
  torch.testing.assert_close(attention.attention(q, k, v),
                             attention.dense_attention(q, k, v),
                             atol=TOL, rtol=TOL)
  want = attention.dense_attention_backward(
      q, k, v, attention.dense_attention(q, k, v), dout)
  for g, w in zip(_grads_through_kernel(q, k, v, dout), want):
    torch.testing.assert_close(g, w, atol=BWD_TOL, rtol=BWD_TOL)


@pytest.mark.cuda
def test_attn_block_gradients_through_kernel(cuda_device):
  """AttnBlockpp hands the kernel a permuted (non-contiguous) gradient;
  parameter gradients through the kernel equal those through the plain
  attention."""
  from unittest import mock
  from score_sde_pytorch_tpu_torch.models import layerspp
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  block = layerspp.AttnBlockpp(64, generator=torch.Generator().manual_seed(0),
                               skip_rescale=True, init_scale=1.0).to(
                                   cuda_device)
  x = torch.randn(4, 64, 16, 16, device=cuda_device)

  def grads():
    block.zero_grad()
    (block(x) ** 2).sum().backward()
    return [p.grad.clone() for p in block.parameters()]

  through_kernel = grads()
  with mock.patch.object(attention, "attention", attention.dense_attention):
    through_plain = grads()
  scale = max(g.abs().max() for g in through_plain)
  for g, w in zip(through_kernel, through_plain):
    assert (g - w).abs().max() <= 1e-4 * scale
