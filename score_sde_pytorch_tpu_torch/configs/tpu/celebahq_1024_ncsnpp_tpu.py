"""Hyperparameters of score_sde_pytorch_tpu/configs/tpu/celebahq_1024_ncsnpp_tpu.py, the JAX
package's variant for its own hardware (declarative form; the port
reads the same values).
"""
from score_sde_pytorch_tpu_torch.configs.builder import declare

get_config = declare(
    'lsun',
    training=dict(sde='vesde', continuous=True, batch_size=8,
                  reduce_mean=False),
    sampling=dict(method='pc', predictor='reverse_diffusion',
                  corrector='langevin', snr=0.15),
    eval=dict(batch_size=8, begin_ckpt=1, end_ckpt=96),
    data=dict(dataset='CelebAHQ', image_size=1024, tfrecords_path=''),
    model=dict(name='ncsnpp', normalization='GroupNorm',
               nonlinearity='swish', nf=16, attn_resolutions=(16,),
               resamp_with_conv=True, conditional=True,
               fir_kernel=[1, 3, 3, 1], skip_rescale=True,
               resblock_type='biggan', progressive_combine='sum',
               attention_type='ddpm', conv_size=3, scale_by_sigma=True,
               sigma_max=1348, num_scales=2000, ema_rate=0.9999,
               sigma_min=0.01, ch_mult=(1, 2, 4, 8, 16, 32, 32, 32),
               num_res_blocks=1, dropout=0., fir=True,
               progressive='output_skip', progressive_input='input_skip',
               init_scale=0., fourier_scale=16, embedding_type='fourier',
               dtype='bfloat16', remat=True, spatial_sharding=True),
)
