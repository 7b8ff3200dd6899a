"""LSUN church 256² NCSN++ (continuous VE) for one H100: the architecture and
SDE of ``tpu/church_256_ncsnpp_tpu.py``, with the batch, ``model.remat``
and ``model.dtype`` chosen on the card.

Train-step grid (``python -m
score_sde_pytorch_tpu_torch.tools.train_step_grid``: full width, seeded
weights, one warm-up then 3 timed steps, one run a point), on NVIDIA H100
80GB HBM3, 700.00 W (79.18 GiB), torch 2.11.0+cu128; images/s and peak
``max_memory_allocated`` GiB:

  dtype     remat  batch 8       16            24            32
  float32   off    29.61 22.63   34.32 44.18   36.06 65.75   out of memory
  bfloat16  off    20.76 31.59   30.38 62.00   out of memory out of memory
                   batch 32      48            64            80
  float32   on     28.15 28.47   29.60 42.15   30.07 55.84   30.34 69.54
  bfloat16  on     25.22 26.49   27.19 39.19   28.11 51.91   28.57 64.61

The points near the choice, re-timed in one later call on NVIDIA H100 80GB
HBM3, 700.00 W (``--steps 6 --repeats 5``, the points in turn): median
images/s (min-max of the 5 runs), peak GiB; the SM clock 1965-1980 MHz and
the draw 522-613 W in every run:

  float32 off 16   34.12 (32.53-34.58)   44.19
  float32 off 24   36.37 (35.74-36.68)   65.77
  float32 on  64   29.88 (29.78-30.14)   55.86
  float32 on  80   24.89 (24.82-24.99)   69.55

The highest images/s that leaves at least 10% of the card's memory free
(peak <= 71.26 GiB): float32 without remat at batch 24. The choice holds
beyond the noise: the slowest run at 24 beats the fastest at 16 and every
remat run.
"""
from score_sde_pytorch_tpu_torch.configs.builder import declare

get_config = declare(
    'lsun',
    training=dict(sde='vesde', continuous=True, batch_size=24),
    sampling=dict(method='pc', predictor='reverse_diffusion',
                  corrector='langevin'),
    data=dict(category='church_outdoor'),
    model=dict(name='ncsnpp', normalization='GroupNorm',
               nonlinearity='swish', nf=128, attn_resolutions=(16,),
               resamp_with_conv=True, conditional=True,
               fir_kernel=[1, 3, 3, 1], skip_rescale=True,
               resblock_type='biggan', progressive_combine='sum',
               attention_type='ddpm', conv_size=3, scale_by_sigma=True,
               ema_rate=0.999, ch_mult=(1, 1, 2, 2, 2, 2, 2),
               num_res_blocks=2, fir=True, progressive='output_skip',
               progressive_input='input_skip', init_scale=0.,
               fourier_scale=16, sigma_max=380,
               dtype='float32', remat=False),
)
