"""NCSN and NCSNv2 RefineNet score networks (NCHW).

Counterpart of score_sde_pytorch_tpu/models/ncsnv2.py: ``ncsnv2_64``
(under 96²), ``ncsnv2_128`` (96² to 128²), ``ncsnv2_256`` (to 256²) and the
noise-conditional NCSN v1, ``ncsn``. Attribute names and registration order
are the torch reference's (yang-song/score_sde_pytorch models/ncsnv2.py:
``begin_conv``, ``normalizer``, ``end_conv``, ``res{k}`` pairs and
``refine{k}`` blocks), after a float64 ``sigmas`` buffer in the v2 models,
so reference checkpoints and ``interop.flax_params_to_torch_state_dict``
load with ``strict=True``.

- The v2 models normalize unconditionally (``config.model.normalization``)
  and divide their fp32 output by ``sigmas[y]``: they predict score·sigma.
- NCSN v1 uses the conditional norm throughout, indexed by the noise level
  ``y``, and returns its output undivided. Like the JAX package (JAX
  ncsnv2.py:6-10) it builds its conditional blocks with the conditional
  norm, which is what the reference's architecture means.
- ``model.dtype='bfloat16'`` makes every conv compute in bf16 (parameters
  and norm statistics stay fp32) and ``model.remat`` recomputes the
  residual and refine blocks in the backward instead of storing their
  activations, through ``torch.utils.checkpoint`` and only while a
  gradient is taken (JAX ncsnv2.py:46-57).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch import nn
from torch.utils import checkpoint

from score_sde_pytorch_tpu_torch.models import layers, normalization, utils

# (name, in, out, resample of the first block, dilation), widths in units
# of nf: each pair is block 0 (in -> out, resampling) and block 1
# (out -> out). Then (name, input widths, width, start, end) of the refine
# blocks, in the reference's registration order; refine block k fuses the
# k-th residual level from the bottom with the block before it.
_RES_64 = [("res1", 1, 1, None, 1), ("res2", 1, 2, "down", 1),
           ("res3", 2, 2, "down", 2), ("res4", 2, 2, "down", 4)]
_REFINE_64 = [("refine1", (2,), 2), ("refine2", (2, 2), 2),
              ("refine3", (2, 2), 1), ("refine4", (1, 1), 1)]
_RES_128 = [("res1", 1, 1, None, 1), ("res2", 1, 2, "down", 1),
            ("res3", 2, 2, "down", 1), ("res4", 2, 4, "down", 2),
            ("res5", 4, 4, "down", 4)]
_REFINE_128 = [("refine1", (4,), 4), ("refine2", (4, 4), 2),
               ("refine3", (2, 2), 2), ("refine4", (2, 2), 1),
               ("refine5", (1, 1), 1)]
_RES_256 = _RES_128[:3] + [("res31", 2, 2, "down", 1)] + _RES_128[3:]
_REFINE_256 = (_REFINE_128[:2] + [("refine31", (2, 2), 2)]
               + _REFINE_128[2:])


class _RefineNet(nn.Module):
  """The RefineNet trunk shared by the four models: ``begin_conv``, the
  residual pairs, the refine chain back up, ``normalizer``, act and
  ``end_conv``."""

  conditional = False
  divide_by_sigma = True

  def __init__(self, config, res_spec: Sequence[Tuple], refine_spec:
               Sequence[Tuple], *, generator: torch.Generator):
    super().__init__()
    m = config.model
    g = generator
    nf = m.nf
    channels = config.data.num_channels
    dtype = utils.compute_dtype(config)
    act = layers.get_act(m.nonlinearity)
    num_classes = m.num_scales
    norm = normalization.get_normalization(config,
                                           conditional=self.conditional)
    if self.divide_by_sigma:
      self.register_buffer("sigmas", torch.tensor(utils.get_sigmas(config)))
    self.centered = config.data.centered
    self.act = act
    self.remat = bool(m.get("remat", False))
    adjust = config.data.image_size == 28

    self.begin_conv = layers.ncsn_conv3x3(channels, nf, generator=g,
                                          dtype=dtype)
    self.normalizer = (norm(nf, num_classes, generator=g) if self.conditional
                       else norm(nf, generator=g))
    self.end_conv = layers.ncsn_conv3x3(nf, channels, generator=g,
                                        dtype=dtype)

    def res_block(cin, cout, resample, dilation, adjust_padding=False):
      if self.conditional:
        return layers.ConditionalResidualBlock(
            cin, cout, num_classes, norm, resample=resample, act=act,
            adjust_padding=adjust_padding, dilation=dilation, generator=g,
            dtype=dtype)
      return layers.ResidualBlock(
          cin, cout, norm, resample=resample, act=act,
          adjust_padding=adjust_padding, dilation=dilation, generator=g,
          dtype=dtype)

    self.res_names: List[str] = []
    last = res_spec[-1][0]
    for name, cin, cout, resample, dilation in res_spec:
      setattr(self, name, nn.ModuleList([
          res_block(cin * nf, cout * nf, resample, dilation,
                    adjust_padding=adjust and name == last),
          res_block(cout * nf, cout * nf, None, dilation)]))
      self.res_names.append(name)

    self.refine_names: List[str] = []
    for k, (name, widths, width) in enumerate(refine_spec):
      in_planes = [w * nf for w in widths]
      start, end = k == 0, k == len(refine_spec) - 1
      if self.conditional:
        block = layers.CondRefineBlock(in_planes, width * nf, num_classes,
                                       norm, act, start=start, end=end,
                                       generator=g, dtype=dtype)
      else:
        block = layers.RefineBlock(in_planes, width * nf, act, start=start,
                                   end=end, generator=g, dtype=dtype)
      setattr(self, name, block)
      self.refine_names.append(name)

  def _call(self, block: nn.Module, *args):
    """``block(*args)``, recomputed in the backward under ``model.remat``."""
    if self.remat and torch.is_grad_enabled():
      return checkpoint.checkpoint(block, *args, use_reentrant=False,
                                   preserve_rng_state=False)
    return block(*args)

  def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The network's output for NCHW ``x`` at integer noise levels ``y``
    ([B], an index into the descending sigma ladder)."""
    cond = (y,) if self.conditional else ()
    h = x if self.centered else 2 * x - 1.0
    h = self.begin_conv(h)
    levels = []
    for name in self.res_names:
      first, second = getattr(self, name)
      h = self._call(first, h, *cond)
      h = self._call(second, h, *cond)
      levels.append(h)
    ref = None
    for name, level in zip(self.refine_names, reversed(levels)):
      xs = [level] if ref is None else [level, ref]
      if self.conditional:
        ref = self._call(getattr(self, name), xs, y, level.shape[2:])
      else:
        ref = self._call(getattr(self, name), xs, level.shape[2:])
    h = self.normalizer(ref, *cond)
    h = self.end_conv(self.act(h)).float()
    if self.divide_by_sigma:
      used_sigmas = utils.gather_clamped(self.sigmas.float(), y)
      h = h / used_sigmas.reshape((x.shape[0],) + (1,) * (x.dim() - 1))
    return h


@utils.register_model(name="ncsnv2_64")
class NCSNv2(_RefineNet):
  """NCSNv2 for images under 96² (JAX ncsnv2.py:70-113)."""

  def __init__(self, config, *, generator: torch.Generator):
    super().__init__(config, _RES_64, _REFINE_64, generator=generator)


@utils.register_model(name="ncsn")
class NCSN(_RefineNet):
  """The noise-conditional NCSN v1 (JAX ncsnv2.py:116-174): ncsnv2_64's
  trunk with conditional norms and no division by sigma."""

  conditional = True
  divide_by_sigma = False

  def __init__(self, config, *, generator: torch.Generator):
    super().__init__(config, _RES_64, _REFINE_64, generator=generator)


@utils.register_model(name="ncsnv2_128")
class NCSNv2_128(_RefineNet):
  """NCSNv2 for 96² to 128² (JAX ncsnv2.py:177-222)."""

  def __init__(self, config, *, generator: torch.Generator):
    super().__init__(config, _RES_128, _REFINE_128, generator=generator)


@utils.register_model(name="ncsnv2_256")
class NCSNv2_256(_RefineNet):
  """NCSNv2 for 128² to 256² (JAX ncsnv2.py:225-276)."""

  def __init__(self, config, *, generator: torch.Generator):
    super().__init__(config, _RES_256, _REFINE_256, generator=generator)
