"""CelebA-HQ 1024² NCSN++ (continuous VE) for one H100: the architecture and
SDE of ``tpu/celebahq_1024_ncsnpp_tpu.py``, with the batch,
``model.remat`` and ``model.dtype`` chosen on the card.

Train-step grid (``python -m
score_sde_pytorch_tpu_torch.tools.train_step_grid``: full width, seeded
weights, one warm-up then 3 timed steps, one run a point), on NVIDIA H100
80GB HBM3, 700.00 W (79.18 GiB), torch 2.11.0+cu128; images/s and peak
``max_memory_allocated`` GiB:

  dtype     remat  batch 4       8             12            16
  float32   off    11.54 27.88   13.39 54.10   out of memory out of memory
  bfloat16  off    11.40 36.62   14.05 71.33   out of memory out of memory
                   batch 8       16            24            32
  float32   on     10.74 22.16   11.73 42.67   11.62 62.38   out of memory
  bfloat16  on      9.89 18.58   11.32 35.52   11.63 52.44   out of memory

The points near the choice, re-timed in one later call on NVIDIA H100 80GB
HBM3, 700.00 W (``--steps 6 --repeats 5``, the points in turn): median
images/s (min-max of the 5 runs), peak GiB; the SM clock 1980 MHz and the
draw 505-572 W in every run:

  float32 off 8    13.50 (13.32-13.62)   54.11
  float32 on  16   11.71 (11.60-11.75)   42.67
  float32 on  24   12.04 (12.03-12.09)   63.18

The highest images/s that leaves at least 10% of the card's memory free
(peak <= 71.26 GiB): float32 without remat at batch 8 (bfloat16 at 8 peaks
at 71.33 GiB). The choice holds beyond the noise: the slowest run at 8
beats the fastest remat run by 10%. The eval batch stays 8.
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
               dtype='float32', remat=False),
)
