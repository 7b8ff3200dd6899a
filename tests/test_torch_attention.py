"""The port's attention: plain version against the JAX package, the
wrapper's contract, and (on a CUDA card only) the Hopper kernels: their
build (no register spill, tensor-core instructions), and forward and
backward against the plain versions at the main path's and every shipped
config's shapes, N_q != N_kv included.

Tolerance for fp32 agreement: 2e-5 absolute and relative, the JAX package's
own flash-vs-dense bound (tests/test_attention.py), for sums of C products
taken in different orders.
"""
import importlib
import os
import re
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from score_sde_pytorch_tpu_torch.ops import attention
from score_sde_pytorch_tpu_torch.ops import build
from score_sde_pytorch_tpu_torch.utils import tracing

jax_attention = importlib.import_module("score_sde_pytorch_tpu.ops.attention")

TOL = 2e-5


def qkv(b, n, c, seed=0, scale=2.0, n_kv=None):
  """q [B, N, C] and k, v [B, n_kv or N, C], normal draws times ``scale``."""
  rng = np.random.default_rng(seed)
  return tuple((rng.normal(size=(b, m, c)) * scale).astype(np.float32)
               for m in (n, n_kv or n, n_kv or n))


def launches():
  """The attention kernels' counts: forward launches, backward calls."""
  return (tracing.count_of("kernel.attention.fwd"),
          tracing.count_of("kernel.attention.bwd"))


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
  before = launches()
  torch.testing.assert_close(attention.attention(q, k, v),
                             attention.dense_attention(q, k, v),
                             atol=0, rtol=0)
  assert launches() == before


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
  before = launches()
  attention.attention(q, k, v).sum().backward()
  assert q.grad is not None and torch.isfinite(q.grad).all()
  assert launches() == before


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
def test_the_kernels_spill_no_registers_and_run_on_tensor_cores(cuda_device,
                                                                tmp_path):
  """A fresh build of the source: ptxas reports no spill in any attention
  kernel, and cuobjdump finds tensor-core (HMMA, ``mma.sync``)
  instructions in the forward, dK/dV and dQ kernels."""
  nvcc = build.find_nvcc()
  lib = tmp_path / "libflash_attention.so"
  proc = subprocess.run(
      build.nvcc_command(nvcc, build.source_path("flash_attention"), lib),
      capture_output=True, text=True, check=True)
  kernel, spills = None, {}
  for line in (proc.stdout + proc.stderr).splitlines():
    if "Compiling entry function" in line:
      kernel = line.split("'")[1]
    found = re.search(r"(\d+) bytes spill stores", line)
    if found and kernel and "flash_attention" in kernel:
      spills[kernel] = int(found.group(1))
  assert spills and not any(spills.values()), spills
  sass = subprocess.run(
      [os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass", str(lib)],
      capture_output=True, text=True, check=True).stdout
  hmma, name = {}, None
  for line in sass.splitlines():
    if "Function :" in line:
      name = line.split(":", 1)[1].strip()
      hmma[name] = 0
    elif name is not None and re.search(r"\bHMMA\b", line):
      hmma[name] += 1
  for part in ("fwd", "bwd_dkdv", "bwd_dq"):
    counts = [n for k, n in hmma.items() if f"flash_attention_{part}" in k]
    assert counts and all(counts), (part, hmma)


# (B, N_q, N_kv, C) of the main path and of every shipped config's
# attention: sampling (64), training (128) and the eval batch (1024) at 16²
# and the 4² bottleneck, ragged N, one long N; C = 512 (the 256² DDPM and
# the 1024² NCSN++) and 384; the bf16 files' batches (church 32, 1024² 8);
# and the space axis's slabs, N / 2 queries against the N keys of both
# ranks (church 256² at global batch 4 and 8 and in bf16 at 32; 1024² at
# 2 and in bf16 at 8).
FWD_PATH_SHAPES = [
    (64, 256, 256, 256), (128, 256, 256, 256), (1024, 256, 256, 256),
    (64, 16, 16, 256), (2, 1024, 1024, 256), (4, 200, 200, 256),
    (1, 4096, 4096, 256), (4, 128, 256, 256), (4, 8, 16, 256),
    (8, 128, 256, 256), (64, 256, 256, 512), (8, 256, 256, 512),
    (8, 64, 64, 512), (2, 256, 256, 512), (4, 200, 200, 512),
    (1, 1024, 1024, 384), (2, 128, 256, 512), (2, 32, 64, 512),
    (32, 256, 256, 256), (32, 16, 16, 256), (32, 128, 256, 256),
    (32, 8, 16, 256), (8, 128, 256, 512)]
# The train path's (and the bits/dim drift's) shapes: training at 128,
# ragged N, N = 1024 at C = 128 and 256, C = 384 and 512, the bf16 files'
# and the space axis's.
BWD_PATH_SHAPES = [
    (128, 256, 256, 256), (128, 16, 16, 256), (2, 1024, 1024, 256),
    (1, 1024, 1024, 128), (4, 200, 200, 256), (4, 128, 256, 256),
    (4, 8, 16, 256), (8, 128, 256, 256), (64, 256, 256, 512),
    (8, 256, 256, 512), (8, 64, 64, 512), (2, 256, 256, 512),
    (4, 200, 200, 512), (1, 1024, 1024, 384), (2, 128, 256, 512),
    (2, 32, 64, 512), (32, 256, 256, 256), (32, 16, 16, 256),
    (32, 128, 256, 256), (32, 8, 16, 256), (8, 128, 256, 512)]


def _with(cases, shapes, *extra):
  """``cases`` and then every shape of ``shapes`` not among them, each
  with ``extra`` appended."""
  return cases + [s + extra for s in shapes if s + extra not in cases]


def _err(a, b):
  return (a.double() - b).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("b,n_q,n_kv,c", _with(
    [(64, 256, 256, 256), (64, 16, 16, 256), (2, 1024, 1024, 256),
     (3, 200, 200, 64), (2, 64, 64, 8), (8, 256, 256, 512), (8, 64, 64, 512),
     (4, 200, 200, 512), (1, 1024, 1024, 384), (2, 40, 40, 264)],
    FWD_PATH_SHAPES))
def test_kernel_matches_plain_version(cuda_device, b, n_q, n_kv, c):
  """fp32 (TF32 off): the largest |kernel - plain| within 2e-5."""
  torch.backends.cuda.matmul.allow_tf32 = False
  q, k, v = (torch.from_numpy(a).to(cuda_device)
             for a in qkv(b, n_q, c, scale=1.0, n_kv=n_kv))
  before = launches()
  out = attention.attention(q, k, v)
  torch.cuda.synchronize()
  assert launches() == (before[0] + 1, before[1])
  assert _err(out, attention.dense_attention(q, k, v).double()) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("b,n_q,n_kv,c,scale", _with(
    [(8, 256, 256, 256, 2.0), (8, 256, 256, 512, 2.0)], FWD_PATH_SHAPES,
    1.0))
def test_kernel_bf16_no_worse_than_dense(cuda_device, b, n_q, n_kv, c,
                                         scale):
  torch.backends.cuda.matmul.allow_tf32 = False
  q, k, v = (torch.from_numpy(a).to(cuda_device)
             for a in qkv(b, n_q, c, scale=scale, n_kv=n_kv))
  qb, kb, vb = (t.bfloat16() for t in (q, k, v))
  out, dense = attention.attention(qb, kb, vb), attention.dense_attention(
      qb, kb, vb)
  # Against the fp64 result of the fp32 inputs and of their bf16 roundings.
  for inputs in ((q, k, v), (qb, kb, vb)):
    exact = attention.dense_attention(*(t.double() for t in inputs))
    err_kernel, err_dense = _err(out, exact), _err(dense, exact)
    assert err_kernel <= err_dense * 1.5 + 1e-3, (err_kernel, err_dense)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n_q,n_kv,c", _with(
    [(16, 16, 16, 256), (16, 256, 256, 256), (16, 256, 256, 512)],
    FWD_PATH_SHAPES))
def test_kernel_stable_at_large_logits(cuda_device, b, n_q, n_kv, c):
  """Logits x30: finite, and no further from the fp64 result than the
  plain fp32 path (x1.5 + 2e-5); at this scale the plain path is itself
  ~1e-4 from the fp64 result, so the bound is against fp64."""
  torch.backends.cuda.matmul.allow_tf32 = False
  q, k, v = (torch.from_numpy(a).to(cuda_device)
             for a in qkv(b, n_q, c, scale=1.0, n_kv=n_kv))
  q = q * 30
  exact = attention.dense_attention(q.double(), k.double(), v.double())
  out = attention.attention(q, k, v)
  assert torch.isfinite(out).all()
  err_dense = _err(attention.dense_attention(q, k, v), exact)
  assert _err(out, exact) <= 1.5 * err_dense + TOL


BWD_TOL = 5e-4  # the JAX package's gradient bound (tests/test_attention.py)


def _randn(device, b, n_q, n_kv, c, seed):
  """Standard-normal q, k, v, dO ([B, N_q, C], [B, N_kv, C] twice, then
  [B, N_q, C]) on ``device``."""
  gen = torch.Generator(device=device).manual_seed(seed)
  return [torch.randn(b, n, c, device=device, generator=gen)
          for n in (n_q, n_kv, n_kv, n_q)]


def _grads_through_kernel(q, k, v, dout):
  leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
  attention.attention(*leaves).backward(dout)
  return [t.grad for t in leaves]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n_q,n_kv,c", _with(
    [(128, 256, 256, 256), (128, 16, 16, 256), (2, 1024, 1024, 256),
     (1, 1024, 1024, 128), (4, 200, 200, 256), (3, 40, 40, 8),
     (8, 256, 256, 512), (8, 64, 64, 512), (4, 200, 200, 512),
     (1, 1024, 1024, 384), (3, 40, 40, 504)], BWD_PATH_SHAPES))
def test_kernel_backward_matches_plain_version(cuda_device, b, n_q, n_kv, c):
  """fp32 (TF32 off): dq, dk, dv within 5e-4 (absolute and relative) of
  the plain backward and of autograd through the plain forward."""
  torch.backends.cuda.matmul.allow_tf32 = False
  q, k, v, dout = _randn(cuda_device, b, n_q, n_kv, c, seed=b + n_q + c)
  before = launches()
  got = _grads_through_kernel(q, k, v, dout)
  torch.cuda.synchronize()
  assert launches() == (before[0] + 1, before[1] + 1)
  want = attention.dense_attention_backward(
      q, k, v, attention.dense_attention(q, k, v), dout)
  leaves = [t.clone().requires_grad_() for t in (q, k, v)]
  attention.dense_attention(*leaves).backward(dout)
  for g, w, auto in zip(got, want, leaves):
    torch.testing.assert_close(g, w, atol=BWD_TOL, rtol=BWD_TOL)
    torch.testing.assert_close(g, auto.grad, atol=BWD_TOL, rtol=BWD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n_q,n_kv,c", _with(
    [(8, 256, 256, 256), (8, 256, 256, 512)], BWD_PATH_SHAPES))
def test_kernel_backward_bf16_and_large_logits(cuda_device, b, n_q, n_kv, c):
  """bf16: no further from the fp64 gradients than the plain bf16 path
  (x1.5 + 1e-3); logits x30: finite, and no further from fp64 than the
  plain fp32 path (x1.5 + 5e-4)."""
  torch.backends.cuda.matmul.allow_tf32 = False
  q, k, v, dout = _randn(cuda_device, b, n_q, n_kv, c, seed=3)
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
@pytest.mark.parametrize("b,n_q,n_kv,c", _with(
    [(16, 256, 256, 256), (16, 256, 256, 512)], BWD_PATH_SHAPES))
def test_kernel_backward_is_bitwise_deterministic(cuda_device, b, n_q, n_kv,
                                                  c):
  """The backward has one writer per output row and sums in a fixed order
  (dS goes through a scratch, not atomics): two runs give the same bits."""
  q, k, v, dout = _randn(cuda_device, b, n_q, n_kv, c, seed=7)
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
