"""Hyperparameters of score_sde_pytorch_tpu/configs/tpu/cifar10_ncsnpp_continuous_sde_dpmpp.py, the JAX
package's variant for its own hardware (declarative form; the port
reads the same values).
"""
from score_sde_pytorch_tpu_torch.configs.builder import declare

get_config = declare(
    'cifar10',
    training=dict(sde='vesde', continuous=True),
    sampling=dict(method='dpmpp', dpmpp_steps=20, dpmpp_stochastic=True, predictor='reverse_diffusion', corrector='langevin'),
    model=dict(name='ncsnpp', normalization='GroupNorm', nonlinearity='swish', nf=128, attn_resolutions=(16,), resamp_with_conv=True, conditional=True, fir_kernel=[1, 3, 3, 1], skip_rescale=True, resblock_type='biggan', progressive_combine='sum', attention_type='ddpm', conv_size=3, scale_by_sigma=True, ema_rate=0.999, ch_mult=(1, 2, 2, 2), num_res_blocks=4, fir=True, progressive='none', progressive_input='residual', init_scale=0., fourier_scale=16),
)
