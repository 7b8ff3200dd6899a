"""Hyperparameters of reference configs/ve/ncsnv2/bedroom.py (declarative form)."""
from score_sde_pytorch_tpu_torch.configs.builder import declare

get_config = declare(
    'lsun',
    training=dict(sde='vesde', continuous=False, continuouse=False, batch_size=128),
    sampling=dict(method='pc', predictor='none', corrector='ald', n_steps_each=3, snr=0.095),
    data=dict(category='bedroom', image_size=128),
    model=dict(name='ncsnv2_128', scale_by_sigma=True, sigma_max=190, num_scales=1086, ema_rate=0.9999, sigma_min=0.01, normalization='InstanceNorm++', nonlinearity='elu', nf=128, interpolation='bilinear'),
    optim=dict(weight_decay=0, optimizer='Adam', lr=1e-4, beta1=0.9, amsgrad=False, eps=1e-8, warmup=0, grad_clip=-1.),
)
