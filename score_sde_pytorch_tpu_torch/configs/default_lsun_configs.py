"""Default LSUN-256 config (reference configs/default_lsun_configs.py)."""
from score_sde_pytorch_tpu_torch.configs.default_cifar10_configs import (
    get_default_configs as _cifar10_defaults)


def get_default_configs():
  config = _cifar10_defaults()
  config.training.batch_size = 64
  config.training.n_iters = 2400001
  config.training.snapshot_freq_for_preemption = 5000
  config.sampling.snr = 0.075
  config.eval.begin_ckpt = 50
  config.eval.end_ckpt = 96
  config.eval.batch_size = 512
  config.eval.enable_sampling = True
  config.data.dataset = 'LSUN'
  config.data.image_size = 256
  config.model.sigma_max = 378.0
  config.model.num_scales = 2000
  config.model.dropout = 0.0
  return config
