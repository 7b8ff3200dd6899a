"""The port's training slice against the JAX package (CPU, fp32): the loss,
its gradients, the optimizer with its warmup and clipping, the EMA, and the
train CLI with resume.

Weights are the JAX model's unit-gain draw mapped into the port
(tests/test_torch_ncsnpp.py); t and z are re-derived from the JAX key
exactly as JAX losses.py:99-102 splits it and handed to the port. Dropout is
0, so both sides compute the same function.

Tolerances, fp32:
- losses: 1e-5 relative, for sums of ~1e3 squared model outputs whose
  elements agree to ~1e-6 relative;
- gradients: 2e-4 of the largest gradient entry, for sums over the batch
  and pixels taken in different orders in XLA and PyTorch;
- weights and EMA after Adam steps: 1e-6 absolute on updates of ~1e-4
  (Adam's steps are ±lr wherever the gradient is not near 0).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from score_sde_pytorch_tpu import interop as jax_interop
from score_sde_pytorch_tpu import losses as jax_losses
from score_sde_pytorch_tpu import sde as jax_sde
from score_sde_pytorch_tpu.models import ema as jax_ema
from score_sde_pytorch_tpu.models import utils as jax_mutils
from score_sde_pytorch_tpu_torch import checkpoint, interop, losses, main
from score_sde_pytorch_tpu_torch import sde as sde_lib
from score_sde_pytorch_tpu_torch.models import utils as mutils
from tests.test_torch_ncsnpp import (FLAGSHIP, TINY, init_params, nchw,
                                     tiny_flagship_config)

EPS = 1e-5
B = 2


def tiny_config(**optim):
  cfg = tiny_flagship_config()
  cfg.model.dropout = 0.0
  for key, value in optim.items():
    cfg.optim[key] = value
  return cfg


@pytest.fixture(scope="module")
def pair():
  cfg = tiny_config()
  model_def = jax_mutils.get_model(cfg.model.name)(cfg)
  params = init_params(model_def, jnp.zeros((1, 16, 16, 3)), jnp.ones((1,)))
  return cfg, model_def, params


def port_model(cfg, params):
  model = mutils.create_model(cfg, "cpu", torch.Generator().manual_seed(0))
  interop.load_jax_params(model, params, cfg)
  return model


def batch_nhwc(seed=3):
  return np.random.default_rng(seed).uniform(
      size=(B, 16, 16, 3)).astype(np.float32)


def jax_t_z(step_rng, shape):
  """t and z as JAX get_sde_loss_fn draws them from a step's key."""
  t_rng, z_rng, _ = jax.random.split(step_rng, 3)
  t = jax.random.uniform(t_rng, (shape[0],), minval=EPS, maxval=1.0)
  z = jax.random.normal(z_rng, shape)
  return np.asarray(t), np.asarray(z)


def grads_by_name(tree, cfg):
  """A flax gradient tree in the port's state_dict names and layout."""
  return {k: np.asarray(v) for k, v in
          jax_interop.flax_params_to_torch_state_dict(tree, cfg).items()}


@pytest.mark.parametrize("reduce_mean,likelihood_weighting",
                         [(False, False), (True, False), (False, True),
                          (True, True)])
def test_loss_and_gradients_match_jax(pair, reduce_mean, likelihood_weighting):
  cfg, model_def, params = pair
  sde_j = jax_sde.VESDE(sigma_min=cfg.model.sigma_min,
                        sigma_max=cfg.model.sigma_max, N=cfg.model.num_scales)
  loss_j = jax_losses.get_sde_loss_fn(
      sde_j, model_def, train=True, reduce_mean=reduce_mean,
      likelihood_weighting=likelihood_weighting, eps=EPS)
  batch = batch_nhwc()
  rng = jax.random.PRNGKey(7)
  want, want_grads = jax.jit(jax.value_and_grad(loss_j))(
      params, jnp.asarray(batch), rng)
  t, z = jax_t_z(rng, batch.shape)

  model = port_model(cfg, params)
  core = losses.get_sde_loss_core(sde_lib.build_sde(cfg), train=True,
                                  reduce_mean=reduce_mean,
                                  likelihood_weighting=likelihood_weighting)
  got = core(model, nchw(batch), torch.from_numpy(t), nchw(z))
  np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)

  got.backward()
  want_grads = grads_by_name(want_grads, cfg)
  scale = max(np.abs(g).max() for g in want_grads.values())
  for name, p in model.named_parameters():
    if not p.requires_grad:
      continue  # the Fourier W: stop_gradient in JAX, frozen here
    np.testing.assert_allclose(p.grad.numpy(), want_grads[name],
                               atol=2e-4 * scale, rtol=0, err_msg=name)


def run_jax_steps(cfg, model_def, params, batches, n_steps):
  sde_j = jax_sde.VESDE(sigma_min=cfg.model.sigma_min,
                        sigma_max=cfg.model.sigma_max, N=cfg.model.num_scales)
  optimizer = jax_losses.get_optimizer(cfg)
  state = jax_losses.TrainState(
      step=jnp.zeros((), jnp.int32), params=params,
      opt_state=optimizer.init(params),
      ema=jax_ema.init(params, decay=cfg.model.ema_rate),
      rng=jax.random.PRNGKey(11))
  step_fn = jax.jit(jax_losses.get_step_fn(
      sde_j, model_def, train=True, optimizer=optimizer, reduce_mean=False,
      likelihood_weighting=False, prng_impl="threefry2x32"))
  draws = []
  for i in range(n_steps):
    step_rng = jax.random.split(state.rng)[1]
    draws.append(jax_t_z(step_rng, batches[i].shape))
    state, _ = step_fn(state, jnp.asarray(batches[i]))
  return state, draws


@pytest.mark.parametrize("grad_clip", [1.0, 1e-3])
def test_three_train_steps_match_jax(pair, grad_clip, monkeypatch):
  """Adam with warmup 2 (learning rates 0, lr/2, lr), global-norm clipping
  (1e-3 clips every step: the gradient norms here are ~1e2), and the EMA
  with its warmup decay, three steps against JAX get_step_fn."""
  _, model_def, params = pair
  cfg = tiny_config(warmup=2, grad_clip=grad_clip)
  batches = [batch_nhwc(seed) for seed in (4, 5, 6)]
  want, draws = run_jax_steps(cfg, model_def, params, batches, 3)

  model = port_model(cfg, params)
  state = losses.init_train_state(cfg, model, "cpu")
  queue = [(torch.from_numpy(t), nchw(z)) for t, z in draws]
  monkeypatch.setattr(losses, "draw_t_z", lambda *a: queue.pop(0))
  step_fn = losses.get_step_fn(
      sde_lib.build_sde(cfg), train=True,
      optimize_fn=losses.optimization_manager(cfg), reduce_mean=False,
      likelihood_weighting=False)
  initial = [p.detach().clone() for p in model.parameters()
             if p.requires_grad]
  for b in batches:
    step_fn(state, nchw(b), state["generator"])
  assert not queue and state["step"] == 3 and state["ema"].num_updates == 3

  want_params = grads_by_name(want.params, cfg)
  want_ema = grads_by_name(want.ema.params, cfg)
  named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
  moved = 0.0
  assert len(named) == len(initial) == len(state["ema"].shadow_params)
  for (name, p), shadow, p0 in zip(named, state["ema"].shadow_params,
                                   initial):
    if name.endswith("NIN_1.b"):
      # The attention key bias adds q·b to every logit of a row, which the
      # softmax cancels: its gradient is 0 up to rounding, and Adam's step
      # on rounding noise is noise in both frameworks. It must stay put.
      assert (p.detach() - p0).abs().max() < 2e-5, name
      continue
    np.testing.assert_allclose(p.detach().numpy(), want_params[name],
                               atol=1e-6, rtol=0, err_msg=name)
    np.testing.assert_allclose(shadow.numpy(), want_ema[name], atol=1e-6,
                               rtol=0, err_msg=name)
    moved = max(moved, (p.detach() - p0).abs().max().item())
  assert moved > 1e-4  # the steps did move the weights


@pytest.mark.parametrize("branch", ["amsgrad", "weight_decay"])
def test_optimizer_branches_match_optax(branch):
  """Four steps of each optimizer branch on the same gradients, including a
  step of zero gradient, where torch's own AMSGrad would differ from
  optax's by a factor 1 + b2 in the second moment."""
  cfg = tiny_config(warmup=0, grad_clip=-1.0, lr=1e-2)
  if branch == "amsgrad":
    cfg.optim.amsgrad = True
  else:
    cfg.optim.weight_decay = 1  # the config's field is typed int
  rng = np.random.default_rng(9)
  w0 = rng.normal(size=(5, 3)).astype(np.float32)
  grads = [rng.normal(size=w0.shape).astype(np.float32) * s
           for s in (1.0, 0.0, 3.0, 0.5)]

  optimizer = jax_losses.get_optimizer(cfg)
  w_j = jnp.asarray(w0)
  opt_state = optimizer.init(w_j)
  for g in grads:
    updates, opt_state = optimizer.update(jnp.asarray(g), opt_state, w_j)
    w_j = optax.apply_updates(w_j, updates)

  w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
  opt = losses.get_optimizer(cfg, [w])
  expected = {"amsgrad": losses.AMSGrad, "weight_decay": torch.optim.AdamW}
  assert type(opt) is expected[branch]
  optimize_fn = losses.optimization_manager(cfg)
  for step, g in enumerate(grads):
    w.grad = torch.from_numpy(g.copy())
    optimize_fn(opt, [w], step)
  np.testing.assert_allclose(w.detach().numpy(), np.asarray(w_j), atol=1e-6,
                             rtol=1e-6)


def test_torch_amsgrad_is_not_optax_amsgrad():
  """Why the port carries its own AMSGrad: after a zero gradient torch's
  built-in variant takes a different step."""
  w0 = torch.ones(4)
  steps = []
  for opt_cls in (lambda p: torch.optim.Adam(p, lr=1e-2, amsgrad=True),
                  lambda p: losses.AMSGrad(p, lr=1e-2)):
    w = torch.nn.Parameter(w0.clone())
    opt = opt_cls([w])
    for g in (torch.ones(4), torch.zeros(4)):
      w.grad = g
      opt.step()
    steps.append(w.detach().clone())
  assert (steps[0] - steps[1]).abs().max() > 1e-4


def test_clip_uses_optax_rule():
  g = [torch.full((4,), 3.0), torch.full((4,), 4.0)]  # global norm 10
  norm = losses.clip_by_global_norm_(g, 2.0)
  assert norm.item() == pytest.approx(10.0)
  torch.testing.assert_close(g[0], torch.full((4,), 0.6), atol=0, rtol=1e-7)
  kept = [torch.full((4,), 0.1)]
  losses.clip_by_global_norm_(kept, 2.0)
  assert torch.equal(kept[0], torch.full((4,), 0.1))


def test_eval_step_uses_ema_weights_and_leaves_state(pair):
  cfg, _, params = pair
  model = port_model(cfg, params)
  state = losses.init_train_state(cfg, model, "cpu")
  with torch.no_grad():
    for shadow in state["ema"].shadow_params:
      shadow.mul_(0.5)
  before = [p.detach().clone() for p in model.parameters()]
  batch = nchw(batch_nhwc())
  eval_fn = losses.get_step_fn(sde_lib.build_sde(cfg), train=False,
                               reduce_mean=False, likelihood_weighting=False)
  got = eval_fn(state, batch, torch.Generator().manual_seed(1))
  assert state["step"] == 0 and state["ema"].num_updates == 0
  for p, q in zip(model.parameters(), before):
    assert torch.equal(p, q)
  state["ema"].copy_to(model.parameters())
  want = losses.get_sde_loss_fn(sde_lib.build_sde(cfg), train=False,
                                reduce_mean=False, likelihood_weighting=False)(
                                    model, batch,
                                    torch.Generator().manual_seed(1))
  assert got.item() == want.item()


def test_discrete_loss_raises_naming_roadmap(monkeypatch):
  """training.continuous=False on the VE SDE is the SMLD loss, which no
  longer raises: the eval step (EMA weights) of ve/cifar10_ncsnpp.py's
  tiny model, labels and z re-derived from the JAX step's key, gives the
  JAX eval step's loss (1e-5 relative)."""
  from tests.test_torch_ddpm import VE_NCSNPP, tiny_pair
  from tests.test_torch_vp import jax_labels_z
  cfg, model_def, params, model = tiny_pair(
      VE_NCSNPP, "model.dropout=0.0", "model.num_scales=10")
  sde_j = jax_sde.VESDE(sigma_min=cfg.model.sigma_min,
                        sigma_max=cfg.model.sigma_max, N=cfg.model.num_scales)
  state = jax_losses.TrainState(
      step=jnp.zeros((), jnp.int32), params=params, opt_state=None,
      ema=jax_ema.init(params, decay=cfg.model.ema_rate),
      rng=jax.random.PRNGKey(13))
  eval_j = jax_losses.get_step_fn(sde_j, model_def, train=False,
                                  reduce_mean=False, continuous=False,
                                  prng_impl="threefry2x32")
  batch = batch_nhwc()
  _, want = jax.jit(eval_j)(state, jnp.asarray(batch))
  labels, z = jax_labels_z(jax.random.split(state.rng)[1], batch.shape,
                           sde_j.N)
  draws = [(torch.from_numpy(labels).long(), nchw(z))]
  monkeypatch.setattr(losses, "draw_labels_z", lambda *a: draws.pop(0))
  step = losses.get_step_fn(sde_lib.build_sde(cfg), train=False,
                            reduce_mean=False, continuous=False)
  got = step(losses.init_train_state(cfg, model, "cpu"), nchw(batch),
             torch.Generator())
  assert not draws
  np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


TRAIN_FLAGS = ["--config.training.batch_size=4",
               "--config.training.n_jitted_steps=1",
               "--config.training.log_freq=1", "--config.training.eval_freq=2",
               "--config.training.snapshot_freq=2",
               "--config.training.snapshot_freq_for_preemption=2",
               "--config.model.num_scales=2"] + ["--config." + o for o in TINY]


def train_cli(workdir, n_iters, *extra):
  return main.main(["--config", FLAGSHIP, "--workdir", str(workdir),
                    "--mode", "train", "--device", "cpu",
                    f"--config.training.n_iters={n_iters}", *TRAIN_FLAGS,
                    *extra])


def test_train_cli_resumes_exactly_and_samples(tmp_path):
  """A tiny `main --mode train` on the CPU (dropout 0.1 on): 4 steps in one
  run equal 2 steps, a resume, and 2 more, in the weights, the Adam and EMA
  states and the logged losses; the checkpoints are in the reference
  schema; `--mode sample` runs from the result."""
  whole = train_cli(tmp_path / "whole", 4)
  first = train_cli(tmp_path / "split", 2)
  second = train_cli(tmp_path / "split", 4)
  assert (first["initial_step"], second["initial_step"]) == (0, 2)
  assert "Starting training loop at step 2" in (
      tmp_path / "split" / "stdout.txt").read_text()
  assert first["train_losses"] + second["train_losses"] == whole[
      "train_losses"]
  assert first["eval_losses"] + second["eval_losses"] == whole["eval_losses"]
  assert all(np.isfinite(v) for _, v in whole["train_losses"])

  a = torch.load(tmp_path / "whole" / "checkpoints" / "checkpoint_2.pth",
                 weights_only=True)
  b = torch.load(tmp_path / "split" / "checkpoints" / "checkpoint_2.pth",
                 weights_only=True)
  assert {"model", "ema", "optimizer", "step"} <= set(a)
  assert a["step"] == 4 and a["ema"]["num_updates"] == 4
  assert all(k.startswith("module.") for k in a["model"])
  assert len(a["optimizer"]["state"]) == len(a["ema"]["shadow_params"])
  for k, v in a["model"].items():
    assert torch.equal(v, b["model"][k]), k
  for x, y in zip(a["ema"]["shadow_params"], b["ema"]["shadow_params"]):
    assert torch.equal(x, y)
  for i, s in a["optimizer"]["state"].items():
    for key in ("exp_avg", "exp_avg_sq"):
      assert torch.equal(s[key], b["optimizer"]["state"][i][key])
  trainable = [v for k, v in a["model"].items()
               if not k.endswith(("sigmas", "all_modules.0.W"))]
  assert any(not torch.equal(w, e)
             for w, e in zip(trainable, a["ema"]["shadow_params"]))

  workdir = tmp_path / "split"
  for sub in ("samples/iter_2/sample.np", "samples/iter_4/sample.png",
              "checkpoints-meta/checkpoint.pth"):
    assert (workdir / sub).is_file(), sub
  samples = np.load(workdir / "samples" / "iter_4" / "sample.np")
  assert samples.shape == (4, 16, 16, 3) and np.isfinite(samples).all()
  rounds = main.main(["--config", FLAGSHIP, "--workdir", str(workdir),
                      "--mode", "sample", "--device", "cpu",
                      "--config.eval.batch_size=2",
                      "--config.model.num_scales=2"]
                     + ["--config." + o for o in TINY])
  assert [r["nfe"] for r in rounds] == [4]
  assert os.path.isfile(workdir / "generated" / "samples_0.npz")


def test_restore_train_state_needs_generator_states(tmp_path):
  cfg = tiny_config()
  model = mutils.create_model(cfg, "cpu", torch.Generator().manual_seed(0))
  path = str(tmp_path / "ref.pth")
  checkpoint.save_checkpoint(path, model, cfg, step=3)
  state = losses.init_train_state(cfg, model, "cpu")
  with pytest.raises(KeyError, match="rng"):
    checkpoint.restore_train_state(path, state)
