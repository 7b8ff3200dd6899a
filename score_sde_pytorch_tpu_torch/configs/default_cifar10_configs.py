"""Default CIFAR-10 config (reference configs/default_cifar10_configs.py)."""
import ml_collections


def get_default_configs():
  config = ml_collections.ConfigDict()
  # training
  config.training = training = ml_collections.ConfigDict()
  config.training.batch_size = 128
  training.n_iters = 1300001
  training.snapshot_freq = 50000
  training.log_freq = 50
  training.eval_freq = 100
  training.snapshot_freq_for_preemption = 10000
  training.snapshot_sampling = True
  training.likelihood_weighting = False
  training.continuous = True
  training.reduce_mean = False
  # Optimizer steps per call of the step function (the JAX original's
  # n_jitted_steps, one jitted scan there; a host loop in the port).
  training.n_jitted_steps = 5
  # The JAX package's PRNG impl for per-step random bits; the port ignores
  # it.
  training.prng_impl = 'rbg'

  # sampling
  config.sampling = sampling = ml_collections.ConfigDict()
  sampling.n_steps_each = 1
  sampling.noise_removal = True
  sampling.probability_flow = False
  sampling.snr = 0.16
  # Per-config solver knobs (the reference hard-codes
  # rtol=atol=1e-5 in sampling.py:418 and heun has no reference analogue).
  sampling.rtol = 1e-5
  sampling.atol = 1e-5
  sampling.heun_steps = 50
  sampling.dpmpp_steps = 20
  # SDE-DPM-Solver++(2M): per-step noise injection restores the stochastic
  # mode mixing deterministic prob-flow solvers lack (PARITY.md mixture
  # proof) at the same 1 NFE/step.
  sampling.dpmpp_stochastic = False
  # Integration endpoint; <=0 → per-SDE default (1e-3 VP/subVP, 1e-5 VE —
  # reference run_lib.py:90-100 sampling_eps).
  sampling.eps = -1.0

  # evaluation
  config.eval = evaluate = ml_collections.ConfigDict()
  evaluate.begin_ckpt = 9
  evaluate.end_ckpt = 26
  evaluate.batch_size = 1024
  evaluate.enable_sampling = False
  evaluate.num_samples = 50000
  evaluate.enable_loss = True
  evaluate.enable_bpd = False
  evaluate.bpd_dataset = 'test'

  # data
  config.data = data = ml_collections.ConfigDict()
  data.dataset = 'CIFAR10'
  data.image_size = 32
  data.random_flip = True
  data.centered = False
  data.uniform_dequantization = False
  data.num_channels = 3
  # Where to find raw data; empty → synthetic data (zero-egress environments).
  data.data_dir = ''

  # model
  config.model = model = ml_collections.ConfigDict()
  model.sigma_min = 0.01
  model.sigma_max = 50.0
  model.num_scales = 1000
  model.beta_min = 0.1
  model.beta_max = 20.
  model.dropout = 0.1
  model.embedding_type = 'fourier'
  # Model options (every model family): compute dtype, backward
  # rematerialization, spatial activation sharding.
  model.dtype = 'float32'
  model.remat = False
  # Selective remat: with remat on, only blocks at spatial size >= this are
  # rematerialized (0 = all blocks). High-res levels dominate activation
  # HBM; low-res levels are cheap to store (models/ncsnpp.py).
  model.remat_min_res = 0
  model.spatial_sharding = False

  # optimization
  config.optim = optim = ml_collections.ConfigDict()
  optim.weight_decay = 0
  optim.optimizer = 'Adam'
  optim.lr = 2e-4
  optim.beta1 = 0.9
  optim.eps = 1e-8
  optim.warmup = 5000
  optim.grad_clip = 1.

  config.seed = 42
  # device mesh: data-parallel axis size -1 → all devices.
  config.mesh = mesh = ml_collections.ConfigDict()
  mesh.data_axis = -1

  return config
