"""Hyperparameters of reference configs/ve/ncsnv2/celeba.py (declarative form)."""
from score_sde_pytorch_tpu_torch.configs.builder import declare

get_config = declare(
    'celeba',
    training=dict(sde='vesde', continuous=False),
    sampling=dict(method='pc', predictor='none', corrector='ald', n_steps_each=5, snr=0.128),
    model=dict(name='ncsnv2_64', scale_by_sigma=True, num_scales=500, ema_rate=0.999, normalization='InstanceNorm++', nonlinearity='elu', nf=128, interpolation='bilinear'),
    optim=dict(weight_decay=0, optimizer='Adam', lr=1e-4, beta1=0.9, amsgrad=False, eps=1e-8, warmup=0, grad_clip=-1.),
)
