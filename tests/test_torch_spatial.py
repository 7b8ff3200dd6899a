"""The port's space axis (``parallel/spatial.py``, ``parallel.init_grid``,
the slab forms of the layers and of ``ops/upfirdn2d.py``, attention with
N_q != N_kv) on gloo ranks of the CPU: against the same ops unsplit, and
against the JAX package's spatial sharding on a (data, space) mesh.

The ranks are fresh processes (``tests/torch_dist_workers.py``), each on
one torch thread, each run with a timeout, so a collective that one rank
never enters fails the test instead of hanging it. One launch per world
size serves every slab op.

Tolerances, fp32:
- each slab op on 2 and 4 ranks against the op on the whole image:
  outputs, input gradients and the ranks' summed parameter gradients
  within 1e-6 of the largest magnitude of each (the same arithmetic on
  fewer rows; the halos' and the all-reduced statistics' sums run in
  another order);
- the plain attention with N_q != N_kv against JAX's ``dense_attention``
  on the whole sequence and its vjp: 1e-6 of the largest magnitude;
- the tiny NCSN++ on a (1, 2) grid against JAX's forward on a (1, 2) mesh
  with ``spatial_sharding`` on: rtol 1e-4, atol 1e-5, as
  tests/test_parallel.py:201 holds JAX against itself; its gradient
  against the port's unsplit one within 1e-5 of the largest entry;
- two train steps and an eval-loss step on a (2, 2) grid of 4 ranks
  against JAX's step on a (2, 2) mesh with the batch placed
  ``P('data', 'space')``: losses 1e-5 relative, weights and EMA 1e-6
  absolute, as tests/test_torch_parallel.py holds DDP; every rank's
  weights bit-equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding, PartitionSpec as P

from score_sde_pytorch_tpu import losses as jax_losses
from score_sde_pytorch_tpu import parallel as jax_parallel
from score_sde_pytorch_tpu import sde as jax_sde
from score_sde_pytorch_tpu.models import ema as jax_ema
from score_sde_pytorch_tpu.models import utils as jax_mutils
from score_sde_pytorch_tpu.ops import attention as jax_attention
from score_sde_pytorch_tpu_torch import configs, parallel
from score_sde_pytorch_tpu_torch.models import utils as mutils
from score_sde_pytorch_tpu_torch.ops import attention
from score_sde_pytorch_tpu_torch.parallel import spatial
from score_sde_pytorch_tpu_torch.utils import tracing
from tests.test_torch_ncsnpp import init_params, nchw
from tests.test_torch_training import grads_by_name, jax_t_z, port_model
from tests.torch_dist_workers import (SLAB_OPS, run_ranks, run_slab_op,
                                      slab_op_inputs)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

CHURCH = "score_sde_pytorch_tpu_torch/configs/tpu/church_256_ncsnpp_tpu.py"
# The church file (FIR, output_skip and input_skip pyramids, remat,
# spatial_sharding) cut to 16², three levels and attention at 8².
OVERRIDES = ["model.nf=16", "model.ch_mult=(1,2,2)",
             "model.num_res_blocks=1", "model.attn_resolutions=(8,)",
             "data.image_size=16", "model.dtype=float32", "model.dropout=0.0",
             "optim.warmup=2", "optim.grad_clip=1.0"]
B = 4  # the global batch of the train steps: 2 rows a data rank


def _close(got, want, rel=1e-6):
  scale = float(want.abs().max())
  err = float((got - want).abs().max())
  assert err <= rel * scale, f"{err:.3e} > {rel:g} x {scale:.3e}"


def _fake_group(monkeypatch, rank, world):
  """A stand-in process group of ``world`` ranks, seen from ``rank``."""
  monkeypatch.setattr(dist, "get_world_size", lambda group=None: world)
  monkeypatch.setattr(dist, "get_rank", lambda group=None: rank)
  return object()


@pytest.fixture(scope="module")
def slab_runs(tmp_path_factory):
  """Each world size's ranks of the ``slab_ops`` job, run once."""
  runs = {}

  def get(world):
    if world not in runs:
      runs[world] = run_ranks("slab_ops",
                              str(tmp_path_factory.mktemp(f"slab{world}")),
                              {}, world=world, timeout=120)
    return runs[world]

  return get


@pytest.mark.multiprocess
@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(SLAB_OPS))
def test_slab_op_matches_the_op_unsplit(slab_runs, name, world):
  """The op on each rank's slab (the world one space group), its output
  slabs and input-gradient slabs put together, and its parameter
  gradients summed over the ranks, against the op on the whole image.
  Only the ``replicated_*`` ops need more rows than a neighbour holds."""
  ranks = slab_runs(world)
  op, x, g = slab_op_inputs(name, world)
  want = run_slab_op(op, x, g, None)
  _close(torch.cat([r[name]["out"] for r in ranks], 2), want["out"])
  _close(torch.cat([r[name]["dx"] for r in ranks], 2), want["dx"])
  if want["dparams"]:
    scale = max(float(v.abs().max()) for v in want["dparams"].values())
    for key, grad in want["dparams"].items():
      total = sum(r[name]["dparams"][key] for r in ranks)
      assert float((total - grad).abs().max()) <= 1e-6 * scale, key
  replicated = 1 if name.startswith("replicated") else 0
  for r in ranks:
    assert r[name]["counts"]["replicated_ops"] == replicated
    assert sum(v for k, v in r[name]["counts"].items()
               if k.endswith("_bytes")) > 0


@pytest.mark.parametrize("b,n_q,n_kv,c,rank", [(2, 8, 16, 8, 1),
                                               (1, 64, 256, 32, 3),
                                               (2, 32, 64, 512, 0)])
def test_dense_attention_of_a_slab_matches_jax_on_the_whole(b, n_q, n_kv, c,
                                                            rank):
  """The plain attention and its backward with the slab's queries against
  every rank's keys and values, against JAX's ``dense_attention`` on the
  whole sequence (and its vjp, with the cotangent on the slab's rows)."""
  rng = np.random.default_rng(n_q + c)
  q, k, v = (rng.normal(size=(b, n_kv, c)).astype(np.float32)
             for _ in range(3))
  rows = slice(rank * n_q, (rank + 1) * n_q)
  dout = np.zeros_like(q)
  dout[:, rows] = rng.normal(size=(b, n_q, c))
  want, vjp = jax.vjp(jax_attention.dense_attention, *map(jnp.asarray,
                                                          (q, k, v)))
  want_dq, want_dk, want_dv = vjp(jnp.asarray(dout))
  tq, tk, tv = (torch.from_numpy(a) for a in (q[:, rows], k, v))
  out = attention.attention(tq.contiguous(), tk, tv)
  assert out.shape == (b, n_q, c)
  dq, dk, dv = attention.dense_attention_backward(
      tq, tk, tv, out, torch.from_numpy(dout[:, rows]))
  for got, expected in ((out, np.asarray(want)[:, rows]),
                        (dq, np.asarray(want_dq)[:, rows]),
                        (dk, np.asarray(want_dk)), (dv, np.asarray(want_dv))):
    _close(got, torch.tensor(np.asarray(expected)))


@pytest.mark.parametrize("q_shape,kv_shapes,error", [
    ((2, 8, 16), [(2, 16, 16), (2, 8, 16)], ValueError),   # k, v differ
    ((2, 8, 16), [(1, 16, 16)] * 2, ValueError),           # batch
    ((2, 8, 16), [(2, 16, 24)] * 2, ValueError),           # channels
    ((2, 8, 16), [(2, 0, 16)] * 2, ValueError),            # no keys
    ((2, 8, 16), [(16, 16)] * 2, ValueError),              # rank 2
])
def test_attention_inputs_of_two_lengths_are_checked(q_shape, kv_shapes,
                                                     error):
  q = torch.zeros(q_shape)
  k, v = (torch.zeros(s) for s in kv_shapes)
  with pytest.raises(error):
    attention.attention(q, k, v)


def test_keys_of_another_dtype_or_device_are_refused():
  q = torch.zeros(2, 8, 16)
  with pytest.raises(TypeError):
    attention.check_inputs(q, torch.zeros(2, 16, 16, dtype=torch.bfloat16),
                           torch.zeros(2, 16, 16, dtype=torch.bfloat16))
  with pytest.raises(ValueError, match="different devices"):
    attention.check_inputs(q, torch.zeros(2, 16, 16, device="meta"),
                           torch.zeros(2, 16, 16, device="meta"))


def _church_model(spatial_sharding: bool, overrides=()):
  cfg = configs.load_config(
      CHURCH, OVERRIDES + [f"model.spatial_sharding={spatial_sharding}"]
      + list(overrides))
  return cfg, mutils.create_model(cfg, "cpu",
                                  torch.Generator().manual_seed(0))


def test_the_flag_without_a_space_group_changes_nothing():
  """``model.spatial_sharding`` with no space group, or with a group of
  one rank, gives the flag-off forward and gradient bit for bit."""
  _, off = _church_model(False)
  _, on = _church_model(True)
  on.load_state_dict(off.state_dict())
  x = torch.rand(2, 3, 16, 16, generator=torch.Generator().manual_seed(1))
  t = torch.tensor([0.5, 20.0])

  def run(model):
    model.zero_grad()
    out = model(x, t)
    out.square().sum().backward()
    return out.detach(), [p.grad.clone() for p in model.parameters()
                          if p.grad is not None]

  want, want_grads = run(off)
  for got, grads in (run(on), run_in(spatial.sharded(None), run, on)):
    assert torch.equal(got, want)
    assert len(grads) == len(want_grads)
    assert all(torch.equal(a, b) for a, b in zip(grads, want_grads))


def run_in(context, fn, *args):
  with context:
    return fn(*args)


def test_a_group_of_one_rank_splits_nothing(monkeypatch):
  _, off = _church_model(False)
  _, on = _church_model(True)
  on.load_state_dict(off.state_dict())
  x = torch.rand(1, 3, 16, 16, generator=torch.Generator().manual_seed(2))
  t = torch.tensor([3.0])
  group = _fake_group(monkeypatch, 0, 1)
  with torch.no_grad(), spatial.sharded(group):
    assert spatial.ambient() is None
    assert torch.equal(on(x, t), off(x, t))


@pytest.mark.parametrize("height,world", [(16, 3), (6, 4), (10, 4)])
def test_a_height_that_does_not_divide_raises(monkeypatch, height, world):
  group = _fake_group(monkeypatch, 0, world)
  with pytest.raises(ValueError, match=f"height of {height} does not divide "
                                       f"over {world}"):
    spatial.split_rows(torch.zeros(1, 3, height, 4), group)


@pytest.mark.parametrize("world", [3, 8])
def test_a_model_whose_levels_do_not_divide_raises(monkeypatch, world):
  """16² over 3 ranks (no level divides), or over 8 (the 8² level holds
  one row a rank and is downsampled): refused before any collective."""
  _, model = _church_model(True)
  group = _fake_group(monkeypatch, 0, world)
  with pytest.raises(ValueError, match="does not split over"):
    with spatial.sharded(group):
      model(torch.zeros(1, 3, 16 // world or 1, 16), torch.ones(1))


def test_one_rank_is_the_data_parallel_layout():
  assert parallel.init_grid(1) == (None, None)
  with pytest.raises(ValueError, match="does not divide the 1 ranks"):
    parallel.init_grid(2)


def _jax_model(cfg):
  model_def = jax_mutils.get_model(cfg.model.name)(cfg)
  return model_def, init_params(model_def, jnp.zeros((1, 16, 16, 3)),
                                jnp.ones((1,)))


@pytest.mark.multiprocess
def test_forward_on_a_one_by_two_grid_matches_the_jax_mesh(tmp_path):
  """The tiny NCSN++ split over 2 ranks (a (1, 2) grid), its output slabs
  gathered, against JAX's forward on a (1, 2) mesh with the input placed
  ``P('data', 'space')``; and its gradient (remat recomputing the
  resblocks' collectives) against the port's unsplit gradient."""
  cfg, _ = _church_model(True)
  model_def, params = _jax_model(cfg)
  rng = np.random.default_rng(3)
  x = rng.uniform(size=(2, 16, 16, 3)).astype(np.float32)
  t = np.array([0.5, 20.0], np.float32)
  g = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
  mesh = jax_parallel.create_mesh(n_data=1, n_space=2,
                                  devices=jax.devices()[:2])
  split = NamedSharding(mesh, P("data", "space"))
  fwd = jax.jit(lambda p, x, t: model_def.apply({"params": p}, x, t,
                                                train=False),
                in_shardings=(jax_parallel.replicated(mesh), split,
                              jax_parallel.replicated(mesh)),
                out_shardings=split)
  with jax.set_mesh(mesh):
    want = np.asarray(fwd(params, jax.device_put(x, split), jnp.asarray(t)))

  model = port_model(cfg, params)
  ranks = run_ranks("spatial_forward", str(tmp_path), {
      "config": CHURCH, "overrides": OVERRIDES, "x": x, "t": t, "g": g,
      "state_dict": model.state_dict()})
  for r in ranks:
    np.testing.assert_allclose(r["out"].numpy().transpose(0, 2, 3, 1), want,
                               rtol=1e-4, atol=1e-5)
  out = model.train()(nchw(x), torch.from_numpy(t))
  (out * nchw(g)).sum().backward()
  grads = {n: p.grad for n, p in model.named_parameters()
           if p.grad is not None}
  scale = max(float(v.abs().max()) for v in grads.values())
  for key, grad in grads.items():
    total = sum(r["grads"][key] for r in ranks)
    assert float((total - grad).abs().max()) <= 1e-5 * scale, key


def _jax_grid_steps(cfg, batches):
  """JAX's train step on a (2, 2) mesh, the batch placed
  ``P('data', 'space')`` under the ambient mesh (the
  __graft_entry__.py:109-131 pattern), then its eval-loss step; and the
  t and z each step draws."""
  model_def, params = _jax_model(cfg)
  sde_j = jax_sde.VESDE(sigma_min=cfg.model.sigma_min,
                        sigma_max=cfg.model.sigma_max, N=cfg.model.num_scales)
  optimizer = jax_losses.get_optimizer(cfg)
  state = jax_losses.TrainState(
      step=jnp.zeros((), jnp.int32), params=params,
      opt_state=optimizer.init(params),
      ema=jax_ema.init(params, decay=cfg.model.ema_rate),
      rng=jax.random.PRNGKey(11))
  mesh = jax_parallel.create_mesh(n_data=2, n_space=2,
                                  devices=jax.devices()[:4])
  split = NamedSharding(mesh, P("data", "space"))
  kwargs = dict(reduce_mean=False, likelihood_weighting=False,
                prng_impl="threefry2x32")
  shardings = dict(in_shardings=(jax_parallel.replicated(mesh), split),
                   out_shardings=(jax_parallel.replicated(mesh),
                                  jax_parallel.replicated(mesh)))
  train = jax.jit(jax_losses.get_step_fn(sde_j, model_def, train=True,
                                         optimizer=optimizer, **kwargs),
                  **shardings)
  evaluate = jax.jit(jax_losses.get_step_fn(sde_j, model_def, train=False,
                                            **kwargs), **shardings)
  step_losses = []
  with jax.set_mesh(mesh):
    for b in batches:
      state, loss = train(state, jax.device_put(b, split))
      step_losses.append(float(loss))
    _, eval_loss = evaluate(state, jax.device_put(batches[0], split))
  draws, rng = [], jax.random.PRNGKey(11)
  for b in batches + batches[:1]:
    rng, step_rng = jax.random.split(rng)
    draws.append(jax_t_z(step_rng, b.shape))
  return params, state, np.asarray(step_losses), float(eval_loss), draws


@pytest.mark.multiprocess
def test_train_steps_on_a_two_by_two_grid_match_the_jax_mesh(tmp_path):
  """Two train steps (warmup 2, clipping, EMA) and an eval-loss step on 4
  gloo ranks laid out (2, 2): each rank on its rows' slab, DDP over the
  world, JAX's global t and z injected, against JAX's steps on a (2, 2)
  mesh on the same weights."""
  cfg, _ = _church_model(True)
  batches = [np.random.default_rng(s).uniform(size=(B, 16, 16, 3)).astype(
      np.float32) for s in (4, 5)]
  params, want, want_losses, want_eval, draws = _jax_grid_steps(cfg, batches)
  ranks = run_ranks("spatial_train_steps", str(tmp_path), {
      "config": CHURCH, "overrides": OVERRIDES, "n_space": 2,
      "batches": batches, "draws": draws,
      "state_dict": port_model(cfg, params).state_dict()}, world=4,
      timeout=240)

  want_params = grads_by_name(want.params, cfg)
  want_ema = grads_by_name(want.ema.params, cfg)
  for r in ranks:
    assert r["step"] == 2
    np.testing.assert_allclose(r["losses"], want_losses, rtol=1e-5)
    np.testing.assert_allclose(r["eval_loss"], want_eval, rtol=1e-5)
  assert [r["layout"] for r in ranks] == [
      ([0, 2], [0, 1]), ([1, 3], [0, 1]), ([0, 2], [2, 3]),
      ([1, 3], [2, 3])]
  trainable = [(n, p) for n, p in ranks[0]["params"].items()
               if n in want_params]
  assert len(trainable) == len(ranks[0]["ema"])
  for (name, p), shadow in zip(trainable, ranks[0]["ema"]):
    for r in ranks[1:]:
      assert torch.equal(p, r["params"][name]), name
    if name.endswith("NIN_1.b"):
      continue  # zero gradient up to rounding: Adam's step is noise
    np.testing.assert_allclose(p.numpy(), want_params[name], atol=1e-6,
                               rtol=0, err_msg=name)
    np.testing.assert_allclose(shadow.numpy(), want_ema[name], atol=1e-6,
                               rtol=0, err_msg=name)
  for r in ranks[1:]:
    assert all(torch.equal(a, b) for a, b in zip(ranks[0]["ema"], r["ema"]))


@pytest.fixture
def cuda_device():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: the kernels run only on the card")
  return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,n_q,n_kv,c,dtype", [
    (4, 128, 256, 256, torch.float32), (4, 8, 16, 256, torch.float32),
    (2, 128, 256, 512, torch.float32), (2, 32, 64, 512, torch.float32),
    (3, 40, 200, 136, torch.float32), (3, 200, 40, 64, torch.float32),
    (4, 128, 256, 256, torch.bfloat16), (2, 32, 64, 512, torch.bfloat16)])
def test_kernels_of_two_lengths_match_the_plain_versions(cuda_device, b, n_q,
                                                         n_kv, c, dtype):
  """The forward and backward kernels with N_q != N_kv (and more queries
  than keys) against the plain versions on the card: fp32 (TF32 off) at
  2e-5 forward and 5e-4 backward; bf16 no further from fp64 than the plain
  bf16 version (x1.5 + 1e-3), as tests/test_torch_attention.py holds them
  at one length."""
  torch.backends.cuda.matmul.allow_tf32 = False
  gen = torch.Generator(device=cuda_device).manual_seed(n_q + n_kv + c)
  q, dout = (torch.randn(b, n_q, c, device=cuda_device, generator=gen)
             .to(dtype) for _ in range(2))
  k, v = (torch.randn(b, n_kv, c, device=cuda_device, generator=gen)
          .to(dtype) for _ in range(2))
  leaves = [t.clone().requires_grad_() for t in (q, k, v)]
  names = ("kernel.attention.fwd", "kernel.attention.bwd")
  before = [tracing.count_of(n) for n in names]
  out = attention.attention(*leaves)
  out.backward(dout)
  torch.cuda.synchronize()
  assert [tracing.count_of(n) for n in names] == [before[0] + 1,
                                                  before[1] + 1]
  plain = attention.dense_attention(q, k, v)
  grads = attention.dense_attention_backward(q, k, v, plain, dout)
  if dtype == torch.float32:
    torch.testing.assert_close(out, plain, atol=2e-5, rtol=2e-5)
    for t, g in zip(leaves, grads):
      torch.testing.assert_close(t.grad, g, atol=5e-4, rtol=5e-4)
    return
  wide = [t.double() for t in (q, k, v, dout)]
  exact = attention.dense_attention(*wide[:3])
  exact_grads = attention.dense_attention_backward(*wide[:3], exact, wide[3])
  for got, want, ref in [(out, plain, exact)] + list(
      zip((t.grad for t in leaves), grads, exact_grads)):
    err = (got.double() - ref).abs().max().item()
    assert err <= 1.5 * (want.double() - ref).abs().max().item() + 1e-3
