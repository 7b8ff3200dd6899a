"""Hyperparameters of reference configs/ve/cifar10_ddpm.py (declarative form)."""
from score_sde_pytorch_tpu_torch.configs.builder import declare

get_config = declare(
    'cifar10',
    training=dict(sde='vesde', continuous=False),
    sampling=dict(method='pc', predictor='reverse_diffusion', corrector='langevin'),
    model=dict(name='ddpm', normalization='GroupNorm', nonlinearity='swish', nf=128, attn_resolutions=(16,), resamp_with_conv=True, conditional=True, scale_by_sigma=True, ema_rate=0.999, ch_mult=(1, 2, 2, 2), num_res_blocks=2, conv_size=3),
)
