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


@pytest.mark.parametrize("b,n,c", [(2, 16, 32), (2, 64, 16), (2, 256, 32)])
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


@pytest.mark.parametrize("shape", [(1, 16, 12), (1, 16, 264), (1, 16, 0),
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


def test_backward_raises_naming_the_training_slice():
  with pytest.raises(NotImplementedError, match="ROADMAP"):
    attention.FlashAttention.backward(None, torch.zeros(1))


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
                                   (2, 1024, 256), (3, 200, 64), (2, 64, 8)])
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
def test_kernel_bf16_no_worse_than_dense(cuda_device):
  torch.backends.cuda.matmul.allow_tf32 = False
  q, k, v = (torch.from_numpy(a).to(cuda_device) for a in qkv(8, 256, 256))
  exact = attention.dense_attention(q.double(), k.double(), v.double())
  qb, kb, vb = (t.bfloat16() for t in (q, k, v))
  err_kernel = _err(attention.attention(qb, kb, vb), exact)
  err_dense = _err(attention.dense_attention(qb, kb, vb), exact)
  assert err_kernel <= err_dense * 1.5 + 1e-3, (err_kernel, err_dense)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16, 256])
def test_kernel_stable_at_large_logits(cuda_device, n):
  """Logits x30: finite, and no further from the fp64 result than the
  plain fp32 path (x1.5 + 2e-5); at this scale the plain path is itself
  ~1e-4 from the fp64 result, so the bound is against fp64."""
  torch.backends.cuda.matmul.allow_tf32 = False
  q, k, v = (torch.from_numpy(a).to(cuda_device)
             for a in qkv(16, n, 256, scale=1.0))
  q = q * 30
  exact = attention.dense_attention(q.double(), k.double(), v.double())
  out = attention.attention(q, k, v)
  assert torch.isfinite(out).all()
  err_dense = _err(attention.dense_attention(q, k, v), exact)
  assert _err(out, exact) <= 1.5 * err_dense + TOL
