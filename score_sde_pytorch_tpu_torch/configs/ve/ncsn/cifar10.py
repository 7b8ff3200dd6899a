"""Hyperparameters of reference configs/ve/ncsn/cifar10.py (declarative form)."""
from score_sde_pytorch_tpu_torch.configs.builder import declare

get_config = declare(
    'cifar10',
    training=dict(sde='vesde', continuous=False),
    sampling=dict(method='pc', predictor='none', corrector='ald', n_steps_each=100, snr=0.316),
    model=dict(name='ncsn', scale_by_sigma=False, normalization='InstanceNorm++', nonlinearity='elu', nf=128, interpolation='bilinear', sigma_max=1, num_scales=10, ema_rate=0.),
    optim=dict(weight_decay=0, optimizer='Adam', lr=1e-3, beta1=0.9, amsgrad=False, eps=1e-8, warmup=0, grad_clip=-1.),
)
