"""NCSN++ / DDPM++ score network (NCHW).

Counterpart of score_sde_pytorch_tpu/models/ncsnpp.py:40-272. Modules live
in one flat ``all_modules`` list in the torch reference's construction order
(yang-song/score_sde_pytorch models/ncsnpp.py), after a ``sigmas`` buffer,
so that ``score_sde_pytorch_tpu.interop.flax_params_to_torch_state_dict``
and the reference's ``.pth`` files load with ``strict=True``. Comments name
each module's flax counterpart.

Ported branches: Fourier and positional noise embeddings, BigGAN resblocks
with FIR or naive resampling (``fir``), ``progressive`` 'none' or
'output_skip' (the output pyramid), ``progressive_input`` 'none',
'input_skip' (with ``progressive_combine`` 'sum' or 'cat') or 'residual',
``scale_by_sigma``, the ``2x - 1`` input scaling of uncentered data, and
``model.remat``: every shipped NCSN++ and DDPM++ config. The rest
(``progressive='residual'``, ``resblock_type='ddpm'``, ``conditional=False``)
raises NotImplementedError.

``model.remat`` recomputes the resblocks whose input is at least
``model.remat_min_res`` pixels high (0: every resblock) in the backward
instead of storing their activations, as the JAX package's ``nn.remat`` of
``block_call`` does (JAX ncsnpp.py:80-99): through
``torch.utils.checkpoint`` with the RNG state kept, so dropout draws the
same masks again, and only while a gradient is being taken. The attention
blocks are called directly, so their kernel runs once per forward with or
without remat.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils import checkpoint

from score_sde_pytorch_tpu_torch.models import layers, layerspp, utils

_SQRT2 = math.sqrt(2.0)

# The values of these settings that are ported; any other raises.
_PORTED = {
    "embedding_type": ("fourier", "positional"),
    "resblock_type": ("biggan",),
    "progressive": ("none", "output_skip"),
    "progressive_input": ("none", "input_skip", "residual"),
}


def _check_ported(config) -> None:
  m = config.model
  for key, ported in _PORTED.items():
    got = str(m[key]).lower()
    if got not in ported:
      raise NotImplementedError(
          f"NCSNpp model.{key}={got!r} is not ported yet (only "
          f"{', '.join(map(repr, ported))}); see ROADMAP.md queue 1 item 2")
  if not m.conditional:
    raise NotImplementedError("NCSNpp with conditional=False is not ported "
                              "yet; see ROADMAP.md queue 1 item 2")
  if m.embedding_type.lower() == "fourier" and not config.training.continuous:
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
    self.embedding_type = m.embedding_type.lower()
    self.nf = nf
    self.progressive = m.progressive.lower()
    self.progressive_input = m.progressive_input.lower()
    self.remat = bool(m.get("remat", False))
    self.remat_min_res = int(m.get("remat_min_res", 0))
    fir, fir_kernel = m.fir, tuple(m.fir_kernel)
    init_scale = m.init_scale
    channels = config.data.num_channels
    g = generator

    def resblock(in_ch, out_ch=None, up=False, down=False):
      return layerspp.ResnetBlockBigGANpp(
          act, in_ch, out_ch, nf * 4, generator=g, up=up, down=down,
          dropout=m.dropout, fir=fir, fir_kernel=fir_kernel,
          skip_rescale=skip_rescale, init_scale=init_scale)

    def attn(ch):
      return layerspp.AttnBlockpp(ch, generator=g, skip_rescale=skip_rescale,
                                  init_scale=init_scale)

    modules = []
    if self.embedding_type == "fourier":
      modules.append(layerspp.GaussianFourierProjection(  # FourierProj
          nf, m.fourier_scale, generator=g))
    embed_dim = nf * 2 if self.embedding_type == "fourier" else nf
    modules += [
        layers.dense(embed_dim, nf * 4, generator=g),       # Dense_t0
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
        if self.progressive_input == "input_skip":
          modules.append(layerspp.Combine(           # combine_{i}
              input_pyramid_ch, in_ch, m.progressive_combine.lower(),
              generator=g))
          if m.progressive_combine.lower() == "cat":
            in_ch *= 2
        elif self.progressive_input == "residual":
          modules.append(layerspp.Downsample(        # pyramid_downsample_{i}
              input_pyramid_ch, in_ch, generator=g, with_conv=True, fir=fir,
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
      if self.progressive == "output_skip":
        modules.append(layers.GroupNorm(min(in_ch // 4, 32), in_ch,
                                        eps=1e-6))   # pyramid_norm_{i}
        modules.append(layers.ddpm_conv3x3(          # pyramid_conv_{i}
            in_ch, channels, generator=g, init_scale=init_scale))
      if i_level != 0:
        modules.append(resblock(in_ch, up=True))     # up_{i}_upsample
    assert not hs_c

    if self.progressive != "output_skip":
      modules.append(layers.GroupNorm(min(in_ch // 4, 32), in_ch,
                                      eps=1e-6))     # norm_out
      modules.append(layers.ddpm_conv3x3(in_ch, channels, generator=g,
                                         init_scale=init_scale))  # conv_out
    self.all_modules = nn.ModuleList(modules)
    # The pyramids' resamplers hold no parameters (JAX pyramid_upsample_{i},
    # pyramid_downsample_{i}), so they stay out of all_modules, as in the
    # reference.
    self.pyramid_upsample = layerspp.Upsample(
        channels, generator=g, fir=fir, fir_kernel=fir_kernel)
    self.pyramid_downsample = layerspp.Downsample(
        channels, generator=g, fir=fir, fir_kernel=fir_kernel)

  def _resblock(self, block: nn.Module, x: torch.Tensor,
                temb: torch.Tensor) -> torch.Tensor:
    """``block(x, temb)``, recomputed in the backward under ``model.remat``
    (JAX ``block_call``, ncsnpp.py:96-99)."""
    if (self.remat and torch.is_grad_enabled()
        and x.shape[2] >= self.remat_min_res):
      return checkpoint.checkpoint(block, x, temb, use_reentrant=False,
                                   preserve_rng_state=True)
    return block(x, temb)

  def forward(self, x: torch.Tensor, time_cond: torch.Tensor) -> torch.Tensor:
    """Score-network output for NCHW ``x`` at ``time_cond`` ([B]): the
    noise levels sigma for the Fourier embedding, timestep labels (float or
    integer) for the positional one."""
    modules = iter(self.all_modules)
    act = self.act

    if self.embedding_type == "fourier":
      temb = next(modules)(torch.log(time_cond))     # FourierProj
    else:
      temb = layers.get_timestep_embedding(time_cond, self.nf)
    temb = next(modules)(temb)                       # Dense_t0
    temb = next(modules)(act(temb))                  # Dense_t1

    if not self.centered:
      x = 2 * x - 1.0                                # [0, 1] -> [-1, 1]

    block = self._resblock
    input_pyramid = x
    hs = [next(modules)(x)]                          # conv_in
    for i_level in range(self.num_resolutions):
      for _ in range(self.num_res_blocks):
        h = block(next(modules), hs[-1], temb)       # down_{i}_block_{j}
        if h.shape[-1] in self.attn_resolutions:
          h = next(modules)(h)                       # down_{i}_attn_{j}
        hs.append(h)
      if i_level != self.num_resolutions - 1:
        h = block(next(modules), hs[-1], temb)       # down_{i}_downsample
        if self.progressive_input == "input_skip":
          input_pyramid = self.pyramid_downsample(input_pyramid)
          h = next(modules)(input_pyramid, h)        # combine_{i}
        elif self.progressive_input == "residual":
          input_pyramid = next(modules)(input_pyramid)  # pyramid_downsample_{i}
          if self.skip_rescale:
            input_pyramid = (input_pyramid + h) / _SQRT2
          else:
            input_pyramid = input_pyramid + h
          h = input_pyramid
        hs.append(h)

    h = hs[-1]
    h = block(next(modules), h, temb)                # mid_block_0
    h = next(modules)(h)                             # mid_attn
    h = block(next(modules), h, temb)                # mid_block_1

    pyramid = None
    for i_level in reversed(range(self.num_resolutions)):
      for _ in range(self.num_res_blocks + 1):
        h = block(next(modules), torch.cat([h, hs.pop()], dim=1),
                  temb)                              # up_{i}_block_{j}
      if h.shape[-1] in self.attn_resolutions:
        h = next(modules)(h)                         # up_{i}_attn
      if self.progressive == "output_skip":
        pyramid_h = act(next(modules)(h))            # pyramid_norm_{i}
        pyramid_h = next(modules)(pyramid_h)         # pyramid_conv_{i}
        if pyramid is None:
          pyramid = pyramid_h
        else:
          pyramid = self.pyramid_upsample(pyramid) + pyramid_h
      if i_level != 0:
        h = block(next(modules), h, temb)            # up_{i}_upsample
    assert not hs

    if self.progressive == "output_skip":
      h = pyramid
    else:
      h = act(next(modules)(h))                      # norm_out
      h = next(modules)(h)                           # conv_out
    assert next(modules, None) is None

    h = h.float()
    if self.scale_by_sigma:
      if self.embedding_type == "fourier":
        used_sigmas = time_cond
      else:
        # The JAX package reads the ladder as fp32 and clamps the index;
        # dividing by the float64 buffer would promote the output.
        used_sigmas = utils.gather_clamped(self.sigmas.float(), time_cond)
      h = h / used_sigmas.reshape((x.shape[0],) + (1,) * (x.dim() - 1))
    return h
