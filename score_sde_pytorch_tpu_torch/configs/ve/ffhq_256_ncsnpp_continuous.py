"""Hyperparameters of reference configs/ve/ffhq_256_ncsnpp_continuous.py (declarative form)."""
from score_sde_pytorch_tpu_torch.configs.builder import declare

get_config = declare(
    'lsun',
    training=dict(sde='vesde', continuous=True),
    sampling=dict(method='pc', predictor='reverse_diffusion', corrector='langevin'),
    data=dict(dataset='FFHQ', image_size=256, tfrecords_path=''),
    model=dict(name='ncsnpp', normalization='GroupNorm', nonlinearity='swish', nf=128, attn_resolutions=(16,), resamp_with_conv=True, conditional=True, fir_kernel=[1, 3, 3, 1], skip_rescale=True, resblock_type='biggan', progressive_combine='sum', attention_type='ddpm', conv_size=3, scale_by_sigma=True, ema_rate=0.999, ch_mult=(1, 1, 2, 2, 2, 2, 2), num_res_blocks=2, fir=True, progressive='output_skip', progressive_input='input_skip', init_scale=0., fourier_scale=16, remat=True, sigma_max=348),
)
