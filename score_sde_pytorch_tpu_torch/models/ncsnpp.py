"""NCSN++ score network (NCHW), flagship branches.

Counterpart of score_sde_pytorch_tpu/models/ncsnpp.py:40-272. Modules live
in one flat ``all_modules`` list in the torch reference's construction order
(yang-song/score_sde_pytorch models/ncsnpp.py), after a ``sigmas`` buffer,
so that ``score_sde_pytorch_tpu.interop.flax_params_to_torch_state_dict``
and the reference's ``.pth`` files load with ``strict=True``. Comments name
each module's flax counterpart.

Ported branches: Fourier noise embedding, BigGAN resblocks with FIR
resampling, ``progressive='none'``, ``progressive_input='residual'``,
``scale_by_sigma`` and the ``2x - 1`` input scaling of uncentered data.
Everything else raises NotImplementedError.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from score_sde_pytorch_tpu_torch.models import layers, layerspp, utils

_SQRT2 = math.sqrt(2.0)

# The flagship's settings; any other value of these keys is not ported yet.
_PORTED = {
    "embedding_type": "fourier",
    "resblock_type": "biggan",
    "progressive": "none",
    "progressive_input": "residual",
    "attention_type": "ddpm",
}


def _check_ported(config) -> None:
  m = config.model
  for key, want in _PORTED.items():
    got = str(m[key]).lower()
    if got != want:
      raise NotImplementedError(
          f"NCSNpp model.{key}={got!r} is not ported yet (only {want!r}); "
          "see ROADMAP.md queue 1 item 11")
  if not m.conditional:
    raise NotImplementedError("NCSNpp with conditional=False is not ported "
                              "yet; see ROADMAP.md queue 1 item 11")
  if not m.fir:
    raise NotImplementedError("NCSNpp with fir=False is not ported yet; see "
                              "ROADMAP.md queue 1 item 11")
  if not config.training.continuous:
    raise ValueError("Fourier features are only used for continuous training.")


@utils.register_model(name="ncsnpp")
class NCSNpp(nn.Module):
  """NCSN++ model; architecture read from ``config.model``."""

  def __init__(self, config, *, generator: torch.Generator):
    super().__init__()
    _check_ported(config)
    m = config.model
    self.act = act = layers.get_act(m.nonlinearity)
    # Registered first, as in the reference: `sigmas` is the first state_dict
    # entry of its checkpoints (float64, as torch.tensor of numpy float64).
    self.register_buffer("sigmas", torch.tensor(utils.get_sigmas(config)))

    nf = m.nf
    ch_mult = tuple(m.ch_mult)
    self.num_res_blocks = num_res_blocks = m.num_res_blocks
    self.attn_resolutions = attn_resolutions = tuple(m.attn_resolutions)
    self.num_resolutions = num_resolutions = len(ch_mult)
    all_resolutions = [config.data.image_size // (2 ** i)
                       for i in range(num_resolutions)]
    self.skip_rescale = skip_rescale = m.skip_rescale
    self.centered = config.data.centered
    self.scale_by_sigma = m.scale_by_sigma
    fir_kernel = tuple(m.fir_kernel)
    init_scale = m.init_scale
    channels = config.data.num_channels
    g = generator

    def resblock(in_ch, out_ch=None, up=False, down=False):
      return layerspp.ResnetBlockBigGANpp(
          act, in_ch, out_ch, nf * 4, generator=g, up=up, down=down,
          dropout=m.dropout, fir=True, fir_kernel=fir_kernel,
          skip_rescale=skip_rescale, init_scale=init_scale)

    def attn(ch):
      return layerspp.AttnBlockpp(ch, generator=g, skip_rescale=skip_rescale,
                                  init_scale=init_scale)

    modules = [
        layerspp.GaussianFourierProjection(nf, m.fourier_scale, generator=g),
        layers.dense(nf * 2, nf * 4, generator=g),          # Dense_t0
        layers.dense(nf * 4, nf * 4, generator=g),          # Dense_t1
        layers.ddpm_conv3x3(channels, nf, generator=g),     # conv_in
    ]
    hs_c = [nf]
    in_ch = nf
    input_pyramid_ch = channels
    for i_level in range(num_resolutions):
      for _ in range(num_res_blocks):
        out_ch = nf * ch_mult[i_level]
        modules.append(resblock(in_ch, out_ch))      # down_{i}_block_{j}
        in_ch = out_ch
        if all_resolutions[i_level] in attn_resolutions:
          modules.append(attn(in_ch))                # down_{i}_attn_{j}
        hs_c.append(in_ch)
      if i_level != num_resolutions - 1:
        modules.append(resblock(in_ch, down=True))   # down_{i}_downsample
        modules.append(layerspp.Downsample(          # pyramid_downsample_{i}
            input_pyramid_ch, in_ch, generator=g, with_conv=True, fir=True,
            fir_kernel=fir_kernel))
        input_pyramid_ch = in_ch
        hs_c.append(in_ch)

    modules.append(resblock(in_ch))                  # mid_block_0
    modules.append(attn(in_ch))                      # mid_attn
    modules.append(resblock(in_ch))                  # mid_block_1

    for i_level in reversed(range(num_resolutions)):
      for _ in range(num_res_blocks + 1):
        out_ch = nf * ch_mult[i_level]
        modules.append(resblock(in_ch + hs_c.pop(), out_ch))  # up_{i}_block_{j}
        in_ch = out_ch
      if all_resolutions[i_level] in attn_resolutions:
        modules.append(attn(in_ch))                  # up_{i}_attn
      if i_level != 0:
        modules.append(resblock(in_ch, up=True))     # up_{i}_upsample
    assert not hs_c

    modules.append(layers.GroupNorm(min(in_ch // 4, 32), in_ch,
                                    eps=1e-6))       # norm_out
    modules.append(layers.ddpm_conv3x3(in_ch, channels, generator=g,
                                       init_scale=init_scale))  # conv_out
    self.all_modules = nn.ModuleList(modules)

  def forward(self, x: torch.Tensor, time_cond: torch.Tensor) -> torch.Tensor:
    """Score-network output for NCHW ``x`` at noise levels ``time_cond``
    (sigmas, shape [B])."""
    modules = iter(self.all_modules)
    act = self.act

    used_sigmas = time_cond
    temb = next(modules)(torch.log(used_sigmas))     # FourierProj
    temb = next(modules)(temb)                       # Dense_t0
    temb = next(modules)(act(temb))                  # Dense_t1

    if not self.centered:
      x = 2 * x - 1.0                                # [0, 1] -> [-1, 1]

    input_pyramid = x
    hs = [next(modules)(x)]                          # conv_in
    for i_level in range(self.num_resolutions):
      for _ in range(self.num_res_blocks):
        h = next(modules)(hs[-1], temb)              # down_{i}_block_{j}
        if h.shape[-1] in self.attn_resolutions:
          h = next(modules)(h)                       # down_{i}_attn_{j}
        hs.append(h)
      if i_level != self.num_resolutions - 1:
        h = next(modules)(hs[-1], temb)              # down_{i}_downsample
        input_pyramid = next(modules)(input_pyramid)  # pyramid_downsample_{i}
        if self.skip_rescale:
          input_pyramid = (input_pyramid + h) / _SQRT2
        else:
          input_pyramid = input_pyramid + h
        h = input_pyramid
        hs.append(h)

    h = hs[-1]
    h = next(modules)(h, temb)                       # mid_block_0
    h = next(modules)(h)                             # mid_attn
    h = next(modules)(h, temb)                       # mid_block_1

    for i_level in reversed(range(self.num_resolutions)):
      for _ in range(self.num_res_blocks + 1):
        h = next(modules)(torch.cat([h, hs.pop()], dim=1), temb)  # up_{i}_block_{j}
      if h.shape[-1] in self.attn_resolutions:
        h = next(modules)(h)                         # up_{i}_attn
      if i_level != 0:
        h = next(modules)(h, temb)                   # up_{i}_upsample
    assert not hs

    h = act(next(modules)(h))                        # norm_out
    h = next(modules)(h)                             # conv_out
    assert next(modules, None) is None

    h = h.float()
    if self.scale_by_sigma:
      h = h / used_sigmas.reshape((x.shape[0],) + (1,) * (x.dim() - 1))
    return h
