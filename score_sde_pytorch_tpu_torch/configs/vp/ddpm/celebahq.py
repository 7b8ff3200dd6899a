"""Hyperparameters of reference configs/vp/ddpm/celebahq.py (declarative form)."""
from score_sde_pytorch_tpu_torch.configs.builder import declare

get_config = declare(
    'lsun',
    training=dict(sde='vpsde', continuous=False, reduce_mean=True),
    sampling=dict(method='pc', predictor='ancestral_sampling', corrector='none'),
    data=dict(dataset='CelebAHQ', centered=True, image_size=256, tfrecords_path=''),
    model=dict(name='ddpm', normalization='GroupNorm', nonlinearity='swish', nf=128, attn_resolutions=(16,), resamp_with_conv=True, conditional=True, scale_by_sigma=False, num_scales=1000, ema_rate=0.9999, ch_mult=(1, 1, 2, 2, 4, 4), num_res_blocks=2),
    optim=dict(lr=2e-5),
)
