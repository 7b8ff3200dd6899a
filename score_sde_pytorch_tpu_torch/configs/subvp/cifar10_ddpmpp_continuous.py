"""Hyperparameters of reference configs/subvp/cifar10_ddpmpp_continuous.py (declarative form)."""
from score_sde_pytorch_tpu_torch.configs.builder import declare

get_config = declare(
    'cifar10',
    training=dict(sde='subvpsde', continuous=True, reduce_mean=True),
    sampling=dict(method='pc', predictor='euler_maruyama', corrector='none'),
    data=dict(centered=True),
    model=dict(name='ncsnpp', normalization='GroupNorm', nonlinearity='swish', nf=128, attn_resolutions=(16,), resamp_with_conv=True, conditional=True, fir_kernel=[1, 3, 3, 1], skip_rescale=True, resblock_type='biggan', progressive_combine='sum', attention_type='ddpm', conv_size=3, scale_by_sigma=False, ema_rate=0.9999, ch_mult=(1, 2, 2, 2), num_res_blocks=4, fir=False, progressive='none', progressive_input='none', init_scale=0., embedding_type='positional', fourier_scale=16),
)
