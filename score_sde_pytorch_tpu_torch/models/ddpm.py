"""DDPM U-Net score network (Ho et al. 2020), NCHW.

Counterpart of score_sde_pytorch_tpu/models/ddpm.py. As in the torch
reference (yang-song/score_sde_pytorch models/ddpm.py), modules live in one
flat ``all_modules`` list in construction order after a float64 ``sigmas``
buffer, so the reference's ``.pth`` files and the JAX package's weights
(through ``interop.flax_params_to_torch_state_dict``) load with
``strict=True``. Every resblock has a ``Dense_0``, conditional or not, as
the reference's do. Comments name each module's flax counterpart.
"""
from __future__ import annotations

import torch
from torch import nn

from score_sde_pytorch_tpu_torch.models import layers, utils


@utils.register_model(name="ddpm")
class DDPM(nn.Module):
  """DDPM model; architecture read from ``config.model``."""

  def __init__(self, config, *, generator: torch.Generator):
    super().__init__()
    m = config.model
    self.act = act = layers.get_act(m.nonlinearity)
    self.register_buffer("sigmas", torch.tensor(utils.get_sigmas(config)))
    self.nf = nf = m.nf
    ch_mult = tuple(m.ch_mult)
    self.num_res_blocks = num_res_blocks = m.num_res_blocks
    self.attn_resolutions = attn_resolutions = tuple(m.attn_resolutions)
    self.num_resolutions = num_resolutions = len(ch_mult)
    all_resolutions = [config.data.image_size // (2 ** i)
                       for i in range(num_resolutions)]
    self.conditional = m.conditional
    self.centered = config.data.centered
    self.scale_by_sigma = m.scale_by_sigma
    resamp_with_conv = m.resamp_with_conv
    channels = config.data.num_channels
    g = generator

    def resblock(in_ch, out_ch=None):
      return layers.ResnetBlockDDPM(act, in_ch, out_ch, temb_dim=nf * 4,
                                    dropout=m.dropout, generator=g)

    modules = []
    if self.conditional:
      modules.append(layers.dense(nf, nf * 4, generator=g))      # Dense_t0
      modules.append(layers.dense(nf * 4, nf * 4, generator=g))  # Dense_t1
    modules.append(layers.ddpm_conv3x3(channels, nf, generator=g))  # conv_in
    hs_c = [nf]
    in_ch = nf
    for i_level in range(num_resolutions):
      for _ in range(num_res_blocks):
        out_ch = nf * ch_mult[i_level]
        modules.append(resblock(in_ch, out_ch))      # down_{i}_block_{j}
        in_ch = out_ch
        if all_resolutions[i_level] in attn_resolutions:
          modules.append(layers.AttnBlock(in_ch, generator=g))  # down_{i}_attn_{j}
        hs_c.append(in_ch)
      if i_level != num_resolutions - 1:
        modules.append(layers.Downsample(            # down_{i}_downsample
            in_ch, with_conv=resamp_with_conv, generator=g))
        hs_c.append(in_ch)

    modules.append(resblock(in_ch))                  # mid_block_0
    modules.append(layers.AttnBlock(in_ch, generator=g))  # mid_attn
    modules.append(resblock(in_ch))                  # mid_block_1

    for i_level in reversed(range(num_resolutions)):
      for _ in range(num_res_blocks + 1):
        out_ch = nf * ch_mult[i_level]
        modules.append(resblock(in_ch + hs_c.pop(), out_ch))  # up_{i}_block_{j}
        in_ch = out_ch
      if all_resolutions[i_level] in attn_resolutions:
        modules.append(layers.AttnBlock(in_ch, generator=g))  # up_{i}_attn
      if i_level != 0:
        modules.append(layers.Upsample(              # up_{i}_upsample
            in_ch, with_conv=resamp_with_conv, generator=g))
    assert not hs_c

    modules.append(layers.GroupNorm(layers.legacy_groups(in_ch), in_ch,
                                    eps=1e-6))       # norm_out
    modules.append(layers.ddpm_conv3x3(in_ch, channels, generator=g,
                                       init_scale=0.0))  # conv_out
    self.all_modules = nn.ModuleList(modules)

  def forward(self, x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Output for NCHW ``x`` at timestep ``labels`` ([B], float or int)."""
    modules = iter(self.all_modules)
    act = self.act
    if self.conditional:
      temb = layers.get_timestep_embedding(labels, self.nf)
      temb = next(modules)(temb)                     # Dense_t0
      temb = next(modules)(act(temb))                # Dense_t1
    else:
      temb = None

    h = x if self.centered else 2 * x - 1.0
    hs = [next(modules)(h)]                          # conv_in
    for i_level in range(self.num_resolutions):
      for _ in range(self.num_res_blocks):
        h = next(modules)(hs[-1], temb)              # down_{i}_block_{j}
        if h.shape[-1] in self.attn_resolutions:
          h = next(modules)(h)                       # down_{i}_attn_{j}
        hs.append(h)
      if i_level != self.num_resolutions - 1:
        hs.append(next(modules)(hs[-1]))             # down_{i}_downsample

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
        h = next(modules)(h)                         # up_{i}_upsample
    assert not hs

    h = act(next(modules)(h))                        # norm_out
    h = next(modules)(h)                             # conv_out
    assert next(modules, None) is None

    if self.scale_by_sigma:
      # fp32 ladder, index clamped: as the JAX package reads it.
      used_sigmas = utils.gather_clamped(self.sigmas.float(), labels)
      h = h / used_sigmas.reshape((x.shape[0],) + (1,) * (x.dim() - 1))
    return h
