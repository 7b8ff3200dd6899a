"""GroupNorm + swish (``ops/group_norm.py``): the plain backward against
autograd, the wrapper's contract and paths, and (on a CUDA card only) the
Hopper kernels against the plain versions.

On the CPU the plain backward, the formula the kernels implement, is held
to autograd of the plain forward (the CPU's path, which the JAX package's
GroupNorm holds bit for bit in ``test_torch_bf16.py``). In fp32 both sum
in another order, and autograd forms dweight as ``rstd·Σ dy·x −
mean·rstd·Σ dy``, which cancels where the formula takes ``Σ dy·x̂``: 1e-4
of each tensor's largest entry. In bf16 autograd rounds every step of the
chain to bf16 and the formula keeps fp32 to the last cast: 2 bf16 ulps
(2**-7) of the largest entry.

On the card: fp32 within 1e-5 of the plain versions, relative to the
largest entry of each group of y and dx (of each tensor at the benchmark
cells' own shapes) and of each of dweight and dbias;
bf16 within 1 bf16 ulp of it (also dweight and dbias, which stay fp32:
where the two sides' statistics differ in the last bit, an element of u
can round to the neighbouring bf16 value, which moves act'(u) there by
about an ulp); both paths, act None and swish, the three benchmark cells'
shapes at a smaller batch and at their own, cell 2's largest bf16 call
no further from the fp64 result of its inputs than the plain bf16 path
(per group), a group of zero variance,
groups whose variance the kernels read below 0 (the clamp's gradient
gate, held to the plain backward given the kernels' own statistics),
copies of inputs the kernels cannot read in place, a CUDA graph of a
resblock replayed against its eager forward and backward, dweight bit
for bit across runs, and every GroupNorm call of a full-width flagship
and church 256² forward and backward through the kernels.
"""
import os

import pytest
import torch
import torch.nn.functional as F

from score_sde_pytorch_tpu_torch import configs
from score_sde_pytorch_tpu_torch.models import layers, layerspp
from score_sde_pytorch_tpu_torch.models import utils as mutils
from score_sde_pytorch_tpu_torch.ops import build, group_norm
from score_sde_pytorch_tpu_torch.utils import tracing
# Imported from this directory, which pytest puts on the path: an installed
# package named `tests` can shadow the repository's.
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

EPS = 1e-6
BF16_ULP = 2.0 ** -7
PATH_COUNTS = ("onchip_fwd", "onchip_bwd", "split_fwd", "split_bwd")


def _launches() -> dict:
  """Calls of each kernel path so far (``kernel.group_norm.*`` counters)."""
  return {k: tracing.count_of(f"kernel.group_norm.{k}") for k in PATH_COUNTS}


def _inputs(shape, dtype=torch.float32, seed=0, device="cpu"):
  gen = torch.Generator().manual_seed(seed)
  c = shape[1]
  x = torch.randn(shape, generator=gen) * 1.5 + 0.5
  dy = torch.randn(shape, generator=gen)
  w = 1 + 0.3 * torch.randn(c, generator=gen)
  b = 0.3 * torch.randn(c, generator=gen)
  return (x.to(device, dtype), w.to(device), b.to(device),
          dy.to(device, dtype))


def _constant_group(x: torch.Tensor, groups: int, value: float):
  """``x`` with batch 0's group 1 set to ``value``: zero variance, or a
  slightly negative one after rounding, which the clamp takes to 0."""
  out = x.clone().reshape(x.shape[0], groups, -1)
  out[0, 1] = value
  return out.reshape(x.shape)


def _close(got, want, tol, groups=None):
  """``got`` within ``tol`` of ``want``'s largest entry, taken in each
  (batch, group) of a [B, C, ...] tensor where ``groups`` is given: a
  group of zero variance has a dx of ~1/sqrt(eps) times the others', which
  would set their scale too."""
  got, want = got.detach().double(), want.detach().double()
  if groups is not None:
    got, want = (t.reshape(t.shape[0], groups, -1) for t in (got, want))
  scale = want.abs().amax(dim=-1 if groups is not None else None,
                          keepdim=True)
  scale = torch.where(scale > 0, scale, torch.ones_like(scale))
  share = (got - want).abs() / scale
  worst = int(share.argmax())
  assert float(share.max()) <= tol, (
      f"{float(share.max()):.3g} > {tol:.1e} of the largest entry "
      f"{float(scale.expand_as(share).flatten()[worst]):.3g}, at flat "
      f"index {worst}")


def _autograd(x, w, b, groups, act, dy):
  xr, wr, br = (t.clone().requires_grad_() for t in (x, w, b))
  group_norm.group_norm_act_forward(xr, wr, br, groups, EPS, act).backward(dy)
  return xr.grad, wr.grad, br.grad


# (shape, groups): the flagship's 32² and 16² levels (cells 1 and 3),
# a 12-channel group (the 384-channel concatenation at 16²), the 4²
# level, church's 256² and 64² levels at a smaller size (cell 2), odd
# sizes, and [B, C].
CPU_CASES = [((2, 128, 32, 32), 32), ((2, 384, 16, 16), 32),
             ((3, 256, 4, 4), 32), ((1, 128, 64, 64), 32),
             ((2, 12, 7, 9), 4), ((3, 8), 2)]


@pytest.mark.parametrize("act", group_norm.ACTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups", CPU_CASES + [("zero-var", 4)])
def test_plain_backward_matches_autograd(shape, groups, dtype, act):
  if shape == "zero-var":
    x, w, b, dy = _inputs((2, 16, 8, 8), dtype, seed=3)
    x = _constant_group(_constant_group(x, groups, 0.5), groups, 0.1)
  else:
    x, w, b, dy = _inputs(shape, dtype, seed=1)
  want = _autograd(x, w, b, groups, act, dy)
  mean, var = group_norm.group_norm_stats(x, groups)
  got = group_norm.group_norm_act_backward(x, w, b, groups, EPS, act, mean,
                                           var, dy)
  tol = 1e-4 if dtype == torch.float32 else 2 * BF16_ULP
  # With constant groups, dx is held per group, so theirs (~1/sqrt(eps)
  # times the others') sets no other group's scale. Elsewhere the tensor's
  # largest entry: autograd's bf16 chain rounds intermediates larger than
  # the dx of a small group.
  per_group = groups if shape == "zero-var" else None
  for g, e, by in zip(got, want, (per_group, None, None)):
    assert g.dtype == e.dtype and g.shape == e.shape
    _close(g, e, tol, by)


def test_the_clamp_gates_the_variance_term():
  """Where E[x²] − mean² rounds below 0 the clamp holds rstd, and dx loses
  its x̂ term, as autograd of the clamp gives."""
  x = torch.full((1, 4, 1, 3), 0.1)
  mean, var = group_norm.group_norm_stats(x, 1)
  w, b = torch.ones(4), torch.zeros(4)
  dy = torch.arange(12.0).reshape(x.shape)
  got = group_norm.group_norm_act_backward(x, w, b, 1, EPS, None, mean, var,
                                           dy)
  want = _autograd(x, w, b, 1, None, dy)
  _close(got[0], want[0], 1e-4)
  assert float(var) != 0.0  # the rounding this test is about


def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing():
  x, w, b, _ = _inputs((2, 16, 4, 4))
  before = _launches()
  for act in group_norm.ACTS:
    got = group_norm.group_norm_act(x, w, b, 4, EPS, act)
    torch.testing.assert_close(
        got, group_norm.group_norm_act_forward(x, w, b, 4, EPS, act),
        atol=0, rtol=0)
  meta = [t.to("meta") for t in (x, w, b)]
  assert group_norm.group_norm_act(*meta, 4, EPS, "swish").shape == x.shape
  assert _launches() == before


def test_norm_act_fuses_swish_and_applies_other_acts_after():
  """``layers.norm_act`` hands swish to the GroupNorm and applies any
  other activation after it; the module is the plain version on the CPU."""
  norm = layers.GroupNorm(4, 16)
  with torch.no_grad():
    norm.weight.normal_(generator=torch.Generator().manual_seed(4))
  x = _inputs((2, 16, 4, 4))[0]
  plain = group_norm.group_norm_act_forward(x, norm.weight, norm.bias, 4,
                                            1e-6)
  torch.testing.assert_close(layers.norm_act(norm, x), plain, atol=0,
                             rtol=0)
  torch.testing.assert_close(layers.norm_act(norm, x, layers.get_act("swish")),
                             layers._swish(plain), atol=0, rtol=0)
  torch.testing.assert_close(layers.norm_act(norm, x, F.relu), F.relu(plain),
                             atol=0, rtol=0)


@pytest.mark.parametrize("case,error", [
    ("act", ValueError), ("float64", TypeError), ("channels", ValueError),
    ("weight_dtype", ValueError),
    ("weight_shape", ValueError), ("pixels", ValueError)])
def test_wrapper_rejects_what_the_kernels_do_not_take(case, error):
  """Another act raises on every device; the rest is what the CUDA path
  checks before any launch (:func:`group_norm.check_inputs`)."""
  x, w, b, _ = _inputs((2, 8, 4, 4))
  if case == "act":
    with pytest.raises(error):
      group_norm.group_norm_act(x, w, b, 2, EPS, "relu")
    return
  if case == "float64":
    x = x.double()
  elif case == "channels":
    x = x[:, :6].contiguous()
  elif case == "weight_dtype":
    w = w.bfloat16()
  elif case == "pixels":  # 3·3 pixels: no whole 4-element vectors
    x = x[..., :3, :3].contiguous()
  else:
    b = b[:4]
  with pytest.raises(error):
    group_norm.check_inputs(x, w, b, 2)


# (shape, groups, space group set, on-chip): every group of cells 1 and 3
# and church's 32² and below on chip; church's 64², 128² and 256² split,
# as is any call under a space group; on chip up to 4096 vectors of 4.
PATHS = [((1024, 128, 32, 32), 32, False, True),
         ((128, 256, 32, 32), 32, False, True),
         ((1024, 512, 16, 16), 32, False, True),
         ((24, 512, 32, 32), 32, False, True),
         ((24, 256, 64, 64), 32, False, False),
         ((24, 128, 128, 128), 32, False, False),
         ((24, 256, 256, 256), 32, False, False),
         ((2, 256, 4, 4), 32, True, False),
         ((2, 32, 128, 128), 32, False, True),
         ((2, 64, 128, 128), 32, False, False)]


@pytest.mark.parametrize("shape,groups,space,onchip", PATHS)
def test_the_path_follows_the_group_size(shape, groups, space, onchip):
  x = torch.empty(shape, device="meta")
  assert group_norm._onchip(x, groups, object() if space else None) \
      == onchip


def test_kernel_is_built_for_hopper_from_the_repo_source():
  cmd = build.nvcc_command("nvcc", build.source_path("group_norm"),
                           build.library_path("group_norm"))
  assert "arch=compute_90a,code=sm_90a" in cmd
  assert cmd[-1].endswith("csrc/group_norm.cu")


@pytest.fixture
def cuda_device():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: the kernels run only on the card")
  return torch.device("cuda")


def _paths_run(before: dict) -> dict:
  return {k: v - before[k] for k, v in _launches().items() if v != before[k]}


# (shape, groups, path, scale): cell 3's 32² and 16² levels and 384
# channels (12 a group), the 4² level, cell 1's 8² level, cell 2's 256²,
# 128² and 64² levels, at a smaller batch, y and dx held per group; then
# the largest calls of each benchmark cell at its own batch, each tensor
# held to its own largest entry with no constant group: cell 3 (PC at
# 1024, 32² and 16²), cell 1 (train at 128) and cell 2 (church 256² train
# at 24: split at 256², 128² and 64², on chip at 32²).
CARD_CASES = [((16, 128, 32, 32), 32, "onchip", "group"),
              ((8, 384, 16, 16), 32, "onchip", "group"),
              ((8, 512, 4, 4), 32, "onchip", "group"),
              ((8, 256, 8, 8), 32, "onchip", "group"),
              ((2, 128, 256, 256), 32, "split", "group"),
              ((2, 128, 128, 128), 32, "split", "group"),
              ((2, 256, 64, 64), 32, "split", "group"),
              ((1024, 128, 32, 32), 32, "onchip", "tensor"),
              ((1024, 256, 16, 16), 32, "onchip", "tensor"),
              ((128, 256, 32, 32), 32, "onchip", "tensor"),
              ((128, 256, 8, 8), 32, "onchip", "tensor"),
              ((24, 256, 256, 256), 32, "split", "tensor"),
              ((24, 128, 128, 128), 32, "split", "tensor"),
              ((24, 256, 64, 64), 32, "split", "tensor"),
              ((24, 512, 32, 32), 32, "onchip", "tensor")]


@pytest.mark.cuda
@pytest.mark.parametrize("act", group_norm.ACTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups,path,scale", CARD_CASES)
def test_kernels_match_the_plain_versions(cuda_device, shape, groups, path,
                                          scale, dtype, act):
  x, w, b, dy = _inputs(shape, dtype, seed=5, device=cuda_device)
  if path == "onchip" and scale == "group":
    # Zero variance, exactly on both sides: for a constant c ≠ 0 the plain
    # path's mean (a sum times 1/N) can miss c by an ulp, and E[x²] − mean²
    # then reads ~1e-8, which against eps = 1e-6 moves rstd by ~1%.
    x = _constant_group(x, groups, 0.0)
  xr, wr, br = (t.clone().requires_grad_() for t in (x, w, b))
  before = _launches()
  y = group_norm.group_norm_act(xr, wr, br, groups, EPS, act)
  y.backward(dy)
  torch.cuda.synchronize()
  assert _paths_run(before) == {f"{path}_fwd": 1, f"{path}_bwd": 1}
  want_y = group_norm.group_norm_act_forward(x, w, b, groups, EPS, act)
  mean, var = group_norm.group_norm_stats(x, groups)
  want = group_norm.group_norm_act_backward(x, w, b, groups, EPS, act, mean,
                                            var, dy)
  tol = 1e-5 if dtype == torch.float32 else BF16_ULP
  per_group = groups if scale == "group" else None
  for got, exp, by in zip((y, xr.grad, wr.grad, br.grad), (want_y,) + want,
                          (per_group, per_group, None, None)):
    _close(got, exp, tol, by)


def _distance(got, exact, groups=None):
  """max |got - exact| over ``exact``'s largest |entry|, in each (batch,
  group) where ``groups`` is given, else over the tensor."""
  got = got.detach().double()
  if groups is None:
    return ((got - exact).abs().max() / exact.abs().max()).reshape(1)
  got, exact = (t.reshape(t.shape[0], groups, -1) for t in (got, exact))
  return ((got - exact).abs().amax(-1) / exact.abs().amax(-1)).flatten()


@pytest.mark.cuda
@pytest.mark.parametrize("act", group_norm.ACTS)
def test_bf16_kernels_no_further_from_fp64_than_the_plain_path(cuda_device,
                                                               act):
  """Cell 2's largest call, split, in bf16: in each (batch, group) of y and
  dx, and over dweight and dbias, the kernels are no further from the fp64
  result of the same bf16 inputs than the plain bf16 path is (x1.5 + a
  quarter of a bf16 ulp of the largest entry), the rule the attention
  tests hold bf16 to. Against the plain path itself the kernels reach 1.14
  ulps of a group's largest entry here."""
  shape, groups = (24, 256, 256, 256), 32
  x, w, b, dy = _inputs(shape, torch.bfloat16, seed=5, device=cuda_device)
  xr, wr, br = (t.clone().requires_grad_() for t in (x, w, b))
  y = group_norm.group_norm_act(xr, wr, br, groups, EPS, act)
  y.backward(dy)
  got = [y.detach(), xr.grad, wr.grad, br.grad]
  del y, xr, wr, br
  mean, var = group_norm.group_norm_stats(x, groups)
  plain = [group_norm.group_norm_act_forward(x, w, b, groups, EPS, act)]
  plain += group_norm.group_norm_act_backward(x, w, b, groups, EPS, act, mean,
                                              var, dy)
  xd, wd, bd = (t.double().requires_grad_() for t in (x, w, b))
  exact = F.group_norm(xd, groups, wd, bd, EPS)
  if act == "swish":
    exact = F.silu(exact)
  exact.backward(dy.double())
  exact = [exact.detach(), xd.grad, wd.grad, bd.grad]
  del xd, wd, bd
  for name, k, p, e, by in zip(("y", "dx", "dweight", "dbias"), got, plain,
                               exact, (groups, groups, None, None)):
    kernel, reference = _distance(k, e, by), _distance(p, e, by)
    worst = int((kernel - 1.5 * reference).argmax())
    assert bool((kernel <= 1.5 * reference + BF16_ULP / 4).all()), (
        f"{name}: kernel {float(kernel[worst]):.3g} vs plain "
        f"{float(reference[worst]):.3g} of the largest entry, group {worst}")


@pytest.mark.cuda
@pytest.mark.parametrize("act", group_norm.ACTS)
@pytest.mark.parametrize("shape,path", [((4, 64, 32, 32), "onchip"),
                                        ((2, 64, 128, 128), "split")])
def test_a_variance_read_below_zero_drops_the_xhat_term(cuda_device, shape,
                                                        path, act):
  """Groups of mean ~10 and spread ~1e-4: E[x²] − mean² reads the
  cancellation's error (some 1e-5 either way) against a variance of 2e-8,
  so the kernels' own statistics hold groups of var < 0 and of var ≥ 0.
  Given those statistics, dx is the plain backward's, which drops the x̂
  term where var < 0; dy follows x̂, so that term is a visible share of dx
  there."""
  groups = 32
  x, w, b, dy = _inputs(shape, seed=11, device=cuda_device)
  x = 10 + 1e-4 * x
  centred = x.reshape(shape[0], groups, -1)
  centred = centred - centred.mean(dim=-1, keepdim=True)
  dy = dy + 1e4 * centred.reshape(shape)
  before = _launches()
  _, stats = group_norm._launch_forward(x, w, b, groups, EPS, act, None)
  got = group_norm._launch_backward(x, w, b, groups, EPS, act, None, stats,
                                    dy)
  torch.cuda.synchronize()
  assert _paths_run(before) == {f"{path}_fwd": 1, f"{path}_bwd": 1}
  mean, var = stats.unbind(-1)
  below = var < 0
  assert bool(below.any()) and bool((~below).any()), var
  want = group_norm.group_norm_act_backward(x, w, b, groups, EPS, act, mean,
                                            var, dy)
  for g, e, per_group in zip(got, want, (groups, None, None)):
    _close(g, e, 1e-5, per_group)
  # Without the gate (var 0 keeps rstd and takes the term) dx moves by far
  # more than the tolerance in every group read below 0.
  ungated = group_norm.group_norm_act_backward(
      x, w, b, groups, EPS, act, mean, var.clamp_min(0.0), dy)[0]
  moved = (ungated - want[0]).reshape(shape[0], groups, -1).abs().amax(-1)
  scale = want[0].reshape(shape[0], groups, -1).abs().amax(-1)
  assert bool((moved[below] > 1e-3 * scale[below]).all())


@pytest.mark.cuda
def test_a_channels_last_input_runs_as_its_contiguous_copy(cuda_device):
  """A convolution of a permuted input returns ``channels_last``, as the
  colorizer's first layer does; the kernels read its NCHW copy."""
  x, w, b, dy = _inputs((4, 64, 16, 16), seed=9, device=cuda_device)
  grads = []
  for t in (x, x.to(memory_format=torch.channels_last)):
    xr = t.clone().requires_grad_()
    y = group_norm.group_norm_act(xr, w, b, 32, EPS, "swish")
    y.backward(dy)
    grads.append((y, xr.grad))
  for got, want in zip(*grads):
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.cuda
def test_a_view_inside_a_vector_runs_as_its_aligned_copy(cuda_device):
  """The kernels move 4 elements at a time; an x or dy that starts 1
  element into a buffer is read from an aligned copy, with the same
  results."""
  x, w, b, dy = _inputs((4, 64, 16, 16), seed=10, device=cuda_device)

  def inside(t):
    buf = torch.empty(t.numel() + 1, device=t.device, dtype=t.dtype)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view

  grads = []
  for xt, dyt in ((x, dy), (inside(x), inside(dy))):
    xr = xt.detach().requires_grad_()
    y = group_norm.group_norm_act(xr, w, b, 32, EPS, "swish")
    y.backward(dyt)
    grads.append((y, xr.grad))
  assert grads[1][0].data_ptr() % 16 == 0
  for got, want in zip(*grads):
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,groups", [((16, 128, 32, 32), 32),
                                          ((2, 128, 256, 256), 32)])
def test_dweight_is_bit_for_bit_across_runs(cuda_device, shape, groups):
  x, w, b, dy = _inputs(shape, seed=6, device=cuda_device)
  grads = []
  for _ in range(2):
    wr = w.clone().requires_grad_()
    group_norm.group_norm_act(x, wr, b, groups, EPS, "swish").backward(dy)
    grads.append(wr.grad)
  torch.testing.assert_close(grads[0], grads[1], atol=0, rtol=0)


@pytest.mark.cuda
def test_a_graphed_resblock_replays_its_eager_forward_and_backward(
    cuda_device):
  """A BigGAN resblock of the flagship's 32² level (dropout off) captured
  with the kernels inside: its replays give the eager outputs and
  gradients bit for bit."""
  saved = torch.backends.cudnn.deterministic
  torch.backends.cudnn.deterministic = True
  try:
    block = layerspp.ResnetBlockBigGANpp(
        layers.get_act("swish"), 128, 128, 512, dropout=0.0, fir=True,
        init_scale=1.0, generator=torch.Generator().manual_seed(7)).to(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    x = torch.randn(16, 128, 32, 32, device=cuda_device, generator=gen)
    temb = torch.randn(16, 512, device=cuda_device, generator=gen)
    dy = torch.randn(16, 128, 32, 32, device=cuda_device, generator=gen)
    params = list(block.parameters())

    def run(fn):
      xr, tr = x.clone().requires_grad_(), temb.clone().requires_grad_()
      for p in params:
        p.grad = None
      y = fn(xr, tr)
      y.backward(dy)
      return [y.detach().clone(), xr.grad, tr.grad] + [
          p.grad.clone() for p in params]

    eager = run(block)
    graphed = torch.cuda.make_graphed_callables(
        block, (x.clone().requires_grad_(), temb.clone().requires_grad_()))
    for _ in range(2):
      for got, want in zip(run(graphed), eager):
        torch.testing.assert_close(got, want, atol=0, rtol=0)
  finally:
    torch.backends.cudnn.deterministic = saved


CONFIGS = os.path.dirname(configs.__file__)


@pytest.mark.cuda
@pytest.mark.parametrize("config_path,batch", [
    ("ve/cifar10_ncsnpp_continuous.py", 16),
    ("h100/church_256_ncsnpp_h100.py", 2)])
def test_every_groupnorm_call_of_a_model_runs_the_kernels(cuda_device,
                                                          config_path, batch):
  """The flagship and the church 256² model at full width: every
  GroupNorm call of a forward launches a kernel (church's larger levels
  on the split path), and a forward with a backward runs each call's
  backward on its forward's path."""
  config = configs.load_config(os.path.join(CONFIGS, config_path))
  model = mutils.create_model(config, "cuda",
                              torch.Generator().manual_seed(0)).eval()
  gen = torch.Generator(device=cuda_device).manual_seed(9)
  size = config.data.image_size
  x = torch.rand(batch, 3, size, size, device=cuda_device, generator=gen)
  labels = config.model.sigma_max * torch.rand(batch, device=cuda_device,
                                               generator=gen)
  calls = [0]
  for m in model.modules():
    if isinstance(m, layers.GroupNorm):
      m.register_forward_pre_hook(
          lambda *_: calls.__setitem__(0, calls[0] + 1))

  def counted(run):
    calls[0], before = 0, _launches()
    run()
    torch.cuda.synchronize()
    return calls[0], {k: v - before[k] for k, v in _launches().items()}

  with torch.no_grad():
    n, ran = counted(lambda: model(x, labels))
  assert ran["onchip_fwd"] + ran["split_fwd"] == n > 0, (n, ran)
  assert ran["onchip_bwd"] + ran["split_bwd"] == 0, ran
  xr = x.clone().requires_grad_()
  n_grad, ran_grad = counted(
      lambda: model(xr, labels).square().mean().backward())
  assert n_grad == n
  assert ran_grad == dict(ran, onchip_bwd=ran["onchip_fwd"],
                          split_bwd=ran["split_fwd"]), ran_grad
