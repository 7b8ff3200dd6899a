"""Hyperparameters of reference configs/ve/cifar10_ncsnpp_deep_continuous.py (declarative form)."""
from score_sde_pytorch_tpu_torch.configs.builder import declare

get_config = declare(
    'cifar10',
    training=dict(sde='vesde', continuous=True, n_iters=950001),
    sampling=dict(method='pc', predictor='reverse_diffusion', corrector='langevin'),
    model=dict(name='ncsnpp', normalization='GroupNorm', nonlinearity='swish', nf=128, attn_resolutions=(16,), resamp_with_conv=True, conditional=True, fir_kernel=[1, 3, 3, 1], skip_rescale=True, resblock_type='biggan', progressive_combine='sum', attention_type='ddpm', conv_size=3, scale_by_sigma=True, ema_rate=0.999, ch_mult=(1, 2, 2, 2), num_res_blocks=8, fir=True, progressive='none', progressive_input='residual', init_scale=0.0, fourier_scale=16),
)
