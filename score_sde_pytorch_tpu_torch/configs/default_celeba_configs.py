"""Default CelebA-64 config (reference configs/default_celeba_configs.py)."""
from score_sde_pytorch_tpu_torch.configs.default_cifar10_configs import (
    get_default_configs as _cifar10_defaults)


def get_default_configs():
  config = _cifar10_defaults()
  config.sampling.snr = 0.17
  config.eval.begin_ckpt = 1
  config.eval.enable_sampling = True
  config.data.dataset = 'CELEBA'
  config.data.image_size = 64
  config.model.sigma_max = 90.0
  return config
