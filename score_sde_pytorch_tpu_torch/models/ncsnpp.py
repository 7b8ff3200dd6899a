"""NCSN++ / DDPM++ score network (NCHW).

Counterpart of score_sde_pytorch_tpu/models/ncsnpp.py:40-272. Modules live
in one flat ``all_modules`` list in the torch reference's construction order
(yang-song/score_sde_pytorch models/ncsnpp.py), after a ``sigmas`` buffer,
so that ``score_sde_pytorch_tpu.interop.flax_params_to_torch_state_dict``
and the reference's ``.pth`` files load with ``strict=True``. Comments name
each module's flax counterpart.

Every branch of the JAX model: Fourier and positional noise embeddings,
``conditional`` or not (an unconditional model has no ``Dense_t0``/``t1``
and adds no time embedding; its resblocks keep their unused ``Dense_0``, as
in the reference), BigGAN resblocks with FIR or naive resampling (``fir``)
or DDPM resblocks with separate Up/Downsample modules, ``progressive``
'none', 'output_skip' or 'residual' (the output pyramid),
``progressive_input`` 'none', 'input_skip' (with ``progressive_combine``
'sum' or 'cat') or 'residual', ``scale_by_sigma``, the ``2x - 1`` input
scaling of uncentered data, ``model.dtype`` and ``model.remat``.

``model.dtype='bfloat16'`` computes the trunk in bf16, cast for cast as
the JAX package does (JAX ncsnpp.py:61-64): ``conv_in``, the resblocks, the
attention blocks (whose bf16 q, k and v go to the kernel's bf16 path on
the card), the combiners and the pyramids' fused convs compute in bf16;
the time embedding, ``pyramid_conv``, ``conv_out`` and every norm's
statistics stay fp32, and the output is cast to fp32 before the division
by sigma. Parameters stay fp32.

``model.remat`` recomputes the resblocks whose input is at least
``model.remat_min_res`` pixels high (0: every resblock) in the backward
instead of storing their activations, as the JAX package's ``nn.remat`` of
``block_call`` does (JAX ncsnpp.py:80-99): through
``torch.utils.checkpoint`` with the RNG state kept, so dropout draws the
same masks again, and only while a gradient is being taken. The attention
blocks are called directly, so their kernel runs once per forward with or
without remat.

``model.spatial_sharding`` splits the image height over the space group of
``parallel.spatial.sharded``, as the JAX package's flag does under an
ambient mesh with a space axis (JAX ncsnpp.py:65-74, the constraints at
``:153, :161, :190, :193, :255``). Inside that context the forward takes
the rank's slab of rows of ``x`` ([B, C, H/S, W]) and returns the slab of
the output; every level stays split (its layers exchange halo rows,
all-reduce the GroupNorm statistics and gather attention's keys and
values: ``models/layers.py``), and the caller gathers the output. Every
level's height must divide over S, and every level that is downsampled
must hold an even number of rows a rank. A resblock under remat recomputes
its collectives in the backward: the recompute re-enters the split, and
every rank's backward meets them in one order. Without the flag, or
without a space group, the forward is unchanged, bit for bit.

In a train step on one card, each resblock call replays CUDA graphs of the
block's forward and backward, captured at the first such step
(``models/graphs.py``, which says when a call qualifies); every other call
runs the block eagerly.

Spans (``utils/tracing.py``, only while a profiler records): the forward
sits in ``ncsnpp.forward``; each U-Net level's work in
``ncsnpp.res{R}``, named by the level's whole-image resolution R, opened
on the way down and again on the way up (``conv_in`` and the output head
in the first level's, the middle blocks in the last level's); each
pyramid step in ``ncsnpp.pyramid`` inside it: the input pyramid's
downsample and its combine or sum with ``h``, the output pyramid's
norm, conv, upsample and sum.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils import checkpoint

from score_sde_pytorch_tpu_torch.models import graphs, layers, layerspp, utils
from score_sde_pytorch_tpu_torch.parallel import distributed, spatial
from score_sde_pytorch_tpu_torch.utils import tracing

_SQRT2 = math.sqrt(2.0)

# The values these settings take (JAX ncsnpp.py:74-76,101-115).
_CHOICES = {
    "embedding_type": ("fourier", "positional"),
    "resblock_type": ("ddpm", "biggan"),
    "progressive": ("none", "output_skip", "residual"),
    "progressive_input": ("none", "input_skip", "residual"),
}


def _check_config(config) -> None:
  m = config.model
  for key, choices in _CHOICES.items():
    got = str(m[key]).lower()
    if got not in choices:
      raise ValueError(f"NCSNpp model.{key}={got!r} unknown (one of "
                       f"{', '.join(map(repr, choices))})")
  if m.embedding_type.lower() == "fourier" and not config.training.continuous:
    raise ValueError("Fourier features are only used for continuous training.")


@utils.register_model(name="ncsnpp")
class NCSNpp(nn.Module):
  """NCSN++ model; architecture read from ``config.model``."""

  def __init__(self, config, *, generator: torch.Generator):
    super().__init__()
    _check_config(config)
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
    self.resblock_type = m.resblock_type.lower()
    self.conditional = m.conditional
    self.remat = bool(m.get("remat", False))
    self.remat_min_res = int(m.get("remat_min_res", 0))
    self.spatial_sharding = bool(m.get("spatial_sharding", False))
    self.all_resolutions = all_resolutions
    self._res_spans = [f"ncsnpp.res{r}" for r in all_resolutions]
    fir, fir_kernel = m.fir, tuple(m.fir_kernel)
    init_scale = m.init_scale
    channels = config.data.num_channels
    dtype = utils.compute_dtype(config)
    g = generator

    def resblock(in_ch, out_ch=None, up=False, down=False):
      if self.resblock_type == "ddpm":
        return layerspp.ResnetBlockDDPMpp(
            act, in_ch, out_ch, nf * 4, generator=g, dropout=m.dropout,
            skip_rescale=skip_rescale, init_scale=init_scale, dtype=dtype)
      return layerspp.ResnetBlockBigGANpp(
          act, in_ch, out_ch, nf * 4, generator=g, up=up, down=down,
          dropout=m.dropout, fir=fir, fir_kernel=fir_kernel,
          skip_rescale=skip_rescale, init_scale=init_scale, dtype=dtype)

    def attn(ch):
      return layerspp.AttnBlockpp(ch, generator=g, skip_rescale=skip_rescale,
                                  init_scale=init_scale, dtype=dtype)

    def resample(cls, ch):
      return cls(ch, generator=g, with_conv=m.resamp_with_conv, fir=fir,
                 fir_kernel=fir_kernel, dtype=dtype)

    modules = []
    if self.embedding_type == "fourier":
      modules.append(layerspp.GaussianFourierProjection(  # FourierProj
          nf, m.fourier_scale, generator=g))
    embed_dim = nf * 2 if self.embedding_type == "fourier" else nf
    if self.conditional:
      modules += [
          layers.dense(embed_dim, nf * 4, generator=g),     # Dense_t0
          layers.dense(nf * 4, nf * 4, generator=g),        # Dense_t1
      ]
    modules.append(layers.ddpm_conv3x3(channels, nf, generator=g,
                                       dtype=dtype))       # conv_in
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
        if self.resblock_type == "ddpm":             # down_{i}_downsample
          modules.append(resample(layerspp.Downsample, in_ch))
        else:
          modules.append(resblock(in_ch, down=True))
        if self.progressive_input == "input_skip":
          modules.append(layerspp.Combine(           # combine_{i}
              input_pyramid_ch, in_ch, m.progressive_combine.lower(),
              generator=g, dtype=dtype))
          if m.progressive_combine.lower() == "cat":
            in_ch *= 2
        elif self.progressive_input == "residual":
          modules.append(layerspp.Downsample(        # pyramid_downsample_{i}
              input_pyramid_ch, in_ch, generator=g, with_conv=True, fir=fir,
              fir_kernel=fir_kernel, dtype=dtype))
          input_pyramid_ch = in_ch
        hs_c.append(in_ch)

    modules.append(resblock(in_ch))                  # mid_block_0
    modules.append(attn(in_ch))                      # mid_attn
    modules.append(resblock(in_ch))                  # mid_block_1

    pyramid_ch = None
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
      elif self.progressive == "residual":
        if pyramid_ch is None:
          modules.append(layers.GroupNorm(min(in_ch // 4, 32), in_ch,
                                          eps=1e-6))  # pyramid_norm_{i}
          modules.append(layers.ddpm_conv3x3(        # pyramid_conv_{i}
              in_ch, in_ch, generator=g))
        else:
          modules.append(layerspp.Upsample(          # pyramid_upsample_{i}
              pyramid_ch, in_ch, generator=g, with_conv=True, fir=fir,
              fir_kernel=fir_kernel, dtype=dtype))
        pyramid_ch = in_ch
      if i_level != 0:
        if self.resblock_type == "ddpm":             # up_{i}_upsample
          modules.append(resample(layerspp.Upsample, in_ch))
        else:
          modules.append(resblock(in_ch, up=True))
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
    self._graphs = graphs.BlockGraphs()

  def _resblock(self, block: nn.Module, x: torch.Tensor,
                temb: torch.Tensor) -> torch.Tensor:
    """``block(x, temb)``: its graphs replayed in a train step on one card
    (``models/graphs.py``), else eagerly, recomputed in the backward under
    ``model.remat`` (JAX ``block_call``, ncsnpp.py:96-99), on a slab inside
    the split it ran in. The rule reads the whole image's height, as JAX's
    does."""
    out = self._graphs.replay(block, x, temb)
    if out is not None:
      return out
    group = spatial.group()
    height = x.shape[2] * distributed.group_size(group)
    if (self.remat and torch.is_grad_enabled()
        and height >= self.remat_min_res):
      return checkpoint.checkpoint(_split_call, group, block, x, temb,
                                   use_reentrant=False,
                                   preserve_rng_state=True)
    return block(x, temb)

  def forward(self, x: torch.Tensor, time_cond: torch.Tensor) -> torch.Tensor:
    """Score-network output for NCHW ``x`` at ``time_cond`` ([B]): the
    noise levels sigma for the Fourier embedding, timestep labels (float or
    integer) for the positional one. Split over a space group (module
    docstring), ``x`` and the output are the rank's slabs."""
    group = spatial.ambient() if self.spatial_sharding else None
    if group is None:
      return self._forward(x, time_cond)
    n = distributed.group_size(group)
    for i, res in enumerate(self.all_resolutions):
      last = i == self.num_resolutions - 1
      if res % n or (not last and (res // n) % 2):
        raise ValueError(f"NCSN++ at {res}² does not split over {n} space "
                         "ranks: every level's height must divide, and every "
                         "downsampled level hold an even number of rows a "
                         "rank")
    if x.shape[2] * n != self.all_resolutions[0]:
      raise ValueError(f"a slab of {x.shape[2]} rows is not 1/{n} of the "
                       f"{self.all_resolutions[0]}² image")
    with spatial.slabs(group):
      return self._forward(x, time_cond)

  def _forward(self, x: torch.Tensor, time_cond: torch.Tensor) -> torch.Tensor:
    self._graphs.prepare(self, x, time_cond)
    with tracing.span("ncsnpp.forward"):
      return self._layers(x, time_cond)

  def _layers(self, x: torch.Tensor, time_cond: torch.Tensor) -> torch.Tensor:
    modules = iter(self.all_modules)
    act = self.act

    if self.embedding_type == "fourier":
      temb = next(modules)(torch.log(time_cond))     # FourierProj
    else:
      temb = layers.get_timestep_embedding(time_cond, self.nf)
    if self.conditional:
      temb = next(modules)(temb)                     # Dense_t0
      temb = next(modules)(act(temb))                # Dense_t1
    else:
      temb = None

    if not self.centered:
      x = 2 * x - 1.0                                # [0, 1] -> [-1, 1]

    block = self._resblock
    span, pyramid_span = tracing.span, "ncsnpp.pyramid"
    res_spans = self._res_spans
    input_pyramid = x
    with span(res_spans[0]):
      hs = [next(modules)(x)]                        # conv_in
    for i_level in range(self.num_resolutions):
      with span(res_spans[i_level]):
        for _ in range(self.num_res_blocks):
          h = block(next(modules), hs[-1], temb)     # down_{i}_block_{j}
          if h.shape[-1] in self.attn_resolutions:
            h = next(modules)(h)                     # down_{i}_attn_{j}
          hs.append(h)
        if i_level != self.num_resolutions - 1:
          if self.resblock_type == "ddpm":
            h = next(modules)(hs[-1])                # down_{i}_downsample
          else:
            h = block(next(modules), hs[-1], temb)   # down_{i}_downsample
          if self.progressive_input == "input_skip":
            with span(pyramid_span):
              input_pyramid = self.pyramid_downsample(input_pyramid)
              h = next(modules)(input_pyramid, h)    # combine_{i}
          elif self.progressive_input == "residual":
            with span(pyramid_span):
              input_pyramid = next(modules)(         # pyramid_downsample_{i}
                  input_pyramid).to(h.dtype)
              if self.skip_rescale:  # np.sqrt(2.0) in JAX: an fp32 result
                input_pyramid = (input_pyramid + h).float() / _SQRT2
              else:
                input_pyramid = input_pyramid + h
            h = input_pyramid
          hs.append(h)

    with span(res_spans[-1]):
      h = hs[-1]
      h = block(next(modules), h, temb)              # mid_block_0
      h = next(modules)(h)                           # mid_attn
      h = block(next(modules), h, temb)              # mid_block_1

    pyramid = None
    for i_level in reversed(range(self.num_resolutions)):
      with span(res_spans[i_level]):
        for _ in range(self.num_res_blocks + 1):
          h = block(next(modules), torch.cat([h, hs.pop()], dim=1),
                    temb)                            # up_{i}_block_{j}
        if h.shape[-1] in self.attn_resolutions:
          h = next(modules)(h)                       # up_{i}_attn
        if self.progressive == "output_skip":
          with span(pyramid_span):
            pyramid_h = layers.norm_act(next(modules), h,
                                        act)         # pyramid_norm_{i}
            pyramid_h = next(modules)(pyramid_h)     # pyramid_conv_{i}
            if pyramid is None:
              pyramid = pyramid_h
            else:
              pyramid = self.pyramid_upsample(pyramid) + pyramid_h
        elif self.progressive == "residual":
          with span(pyramid_span):
            if pyramid is None:
              pyramid = layers.norm_act(next(modules), h,
                                        act)         # pyramid_norm_{i}
              pyramid = next(modules)(pyramid)       # pyramid_conv_{i}
            else:
              pyramid = next(modules)(pyramid).to(
                  h.dtype)                           # pyramid_upsample_{i}
              if self.skip_rescale:  # np.sqrt(2.0) in JAX: an fp32 result
                pyramid = (pyramid + h).float() / _SQRT2
              else:
                pyramid = pyramid + h
              h = pyramid
        if i_level != 0:
          if self.resblock_type == "ddpm":
            h = next(modules)(h)                     # up_{i}_upsample
          else:
            h = block(next(modules), h, temb)        # up_{i}_upsample
    assert not hs

    if self.progressive == "output_skip":
      h = pyramid
    else:
      with span(res_spans[0]):
        h = layers.norm_act(next(modules), h, act)   # norm_out
        h = next(modules)(h)                         # conv_out
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


def _split_call(group, block: nn.Module, x: torch.Tensor,
                temb: torch.Tensor) -> torch.Tensor:
  """``block(x, temb)`` with the layers split over ``group`` (None: whole),
  in the forward and in remat's recompute, which runs after the model's
  forward has left its split."""
  with spatial.slabs(group):
    return block(x, temb)
