"""Load the JAX package's parameters into the port's modules.

The map from a flax params tree of any of the port's models to its
state_dict, numpy only: a copy of score_sde_pytorch_tpu/interop.py's row
builders (:37-97, :308-358), ``ncsnpp_param_map`` (:99-218),
``ddpm_param_map`` (:221-305), ``ncsnv2_param_map`` (:361-417), the HWIO →
OIHW transform and ``flax_params_to_torch_state_dict`` (:481-531), so that
the port imports nothing of the JAX package. The port's modules use the
torch reference's layout, so loading is that map plus
``load_state_dict(strict=True)``. ``tests/test_torch_copies.py`` holds the
copied maps equal to the JAX package's, row for row.

NCSN v1 (``ncsn``) has no map in the JAX package; :func:`ncsn_param_map`
is written in the same row form from its flax names (JAX ncsnv2.py:116-174
and the conditional blocks of JAX layers.py), and
``tests/test_torch_ncsnv2.py`` holds it by the forward parity of the port
and the JAX model under ``strict=True``.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch


def _conv(prefix_t, prefix_f, out):
  out.append((f"{prefix_t}.weight", f"{prefix_f}/kernel", "conv"))
  out.append((f"{prefix_t}.bias", f"{prefix_f}/bias", "copy"))


def _conv_nobias(prefix_t, prefix_f, out):
  out.append((f"{prefix_t}.weight", f"{prefix_f}/kernel", "conv"))


def _dense(prefix_t, prefix_f, out):
  out.append((f"{prefix_t}.weight", f"{prefix_f}/kernel", "dense"))
  out.append((f"{prefix_t}.bias", f"{prefix_f}/bias", "copy"))


def _groupnorm(prefix_t, prefix_f, out):
  out.append((f"{prefix_t}.weight", f"{prefix_f}/scale", "copy"))
  out.append((f"{prefix_t}.bias", f"{prefix_f}/bias", "copy"))


def _nin(prefix_t, prefix_f, out):
  out.append((f"{prefix_t}.W", f"{prefix_f}/W", "copy"))
  out.append((f"{prefix_t}.b", f"{prefix_f}/b", "copy"))


def _attn(idx, name, out):
  base = f"all_modules.{idx}"
  _groupnorm(f"{base}.GroupNorm_0", f"{name}/GroupNorm_0", out)
  for i in range(4):
    _nin(f"{base}.NIN_{i}", f"{name}/NIN_{i}", out)


def _resblock(idx, name, out, *, resblock_type, in_ch, out_ch, up=False,
              down=False, temb=True, temb_dim=None):
  """ResnetBlockDDPMpp / ResnetBlockBigGANpp parameter rows. An
  unconditional model's resblocks (``temb`` False) keep the reference's
  unused ``Dense_0`` of input width ``temb_dim``: rows with no flax path
  that carry the torch shape, as DDPM's (the JAX package's map has no
  unconditional NCSN++)."""
  base = f"all_modules.{idx}"
  _groupnorm(f"{base}.GroupNorm_0", f"{name}/GroupNorm_0", out)
  _conv(f"{base}.Conv_0", f"{name}/Conv_0", out)
  if temb:
    _dense(f"{base}.Dense_0", f"{name}/Dense_0", out)
  elif temb_dim:
    out.append((f"{base}.Dense_0.weight", None, (out_ch, temb_dim)))
    out.append((f"{base}.Dense_0.bias", None, (out_ch,)))
  _groupnorm(f"{base}.GroupNorm_1", f"{name}/GroupNorm_1", out)
  _conv(f"{base}.Conv_1", f"{name}/Conv_1", out)
  if resblock_type == "biggan":
    if in_ch != out_ch or up or down:
      _conv(f"{base}.Conv_2", f"{name}/Conv_2", out)
  else:
    if in_ch != out_ch:
      _nin(f"{base}.NIN_0", f"{name}/NIN_0", out)


def _updown_sample(idx, name, out, *, with_conv, fir):
  base = f"all_modules.{idx}"
  if not with_conv:
    return
  if fir:
    out.append((f"{base}.Conv2d_0.weight", f"{name}/Conv2d_0/weight",
                "conv"))
    out.append((f"{base}.Conv2d_0.bias", f"{name}/Conv2d_0/bias", "copy"))
  else:
    _conv(f"{base}.Conv_0", f"{name}/Conv_0", out)


def ncsnpp_param_map(config) -> List[Tuple[str, str, str]]:
  """Replay the NCSN++ construction order to produce
  ``(torch_key, flax_path, transform)`` rows."""
  rows: List[Tuple[str, str, str]] = []
  m = config.model
  nf = m.nf
  ch_mult = tuple(m.ch_mult)
  num_res_blocks = m.num_res_blocks
  num_resolutions = len(ch_mult)
  attn_resolutions = tuple(m.attn_resolutions)
  all_resolutions = [config.data.image_size // (2 ** i)
                     for i in range(num_resolutions)]
  fir = m.fir
  resamp_with_conv = m.resamp_with_conv
  resblock_type = m.resblock_type.lower()
  progressive = m.progressive.lower()
  progressive_input = m.progressive_input.lower()
  embedding_type = m.embedding_type.lower()
  combine_method = m.progressive_combine.lower()

  temb = dict(temb=m.conditional, temb_dim=nf * 4)
  idx = 0
  if embedding_type == "fourier":
    rows.append((f"all_modules.{idx}.W", "FourierProj/W", "copy"))
    idx += 1
  if m.conditional:
    _dense(f"all_modules.{idx}", "Dense_t0", rows); idx += 1
    _dense(f"all_modules.{idx}", "Dense_t1", rows); idx += 1

  _conv(f"all_modules.{idx}", "conv_in", rows); idx += 1

  hs_c = [nf]
  in_ch = nf
  for i_level in range(num_resolutions):
    for i_block in range(num_res_blocks):
      out_ch = nf * ch_mult[i_level]
      _resblock(idx, f"down_{i_level}_block_{i_block}", rows,
                **temb, resblock_type=resblock_type,
                in_ch=in_ch, out_ch=out_ch)
      idx += 1
      in_ch = out_ch
      if all_resolutions[i_level] in attn_resolutions:
        _attn(idx, f"down_{i_level}_attn_{i_block}", rows); idx += 1
      hs_c.append(in_ch)
    if i_level != num_resolutions - 1:
      if resblock_type == "ddpm":
        _updown_sample(idx, f"down_{i_level}_downsample", rows,
                       with_conv=resamp_with_conv, fir=fir)
      else:
        _resblock(idx, f"down_{i_level}_downsample", rows,
                  **temb, resblock_type=resblock_type,
                  in_ch=in_ch, out_ch=in_ch, down=True)
      idx += 1
      if progressive_input == "input_skip":
        _conv(f"all_modules.{idx}.Conv_0", f"combine_{i_level}/Conv_0", rows)
        idx += 1
        if combine_method == "cat":
          in_ch *= 2
      elif progressive_input == "residual":
        # pyramid_downsample with conv (Conv2dFused)
        rows.append((f"all_modules.{idx}.Conv2d_0.weight",
                     f"pyramid_downsample_{i_level}/Conv2d_0/weight", "conv"))
        rows.append((f"all_modules.{idx}.Conv2d_0.bias",
                     f"pyramid_downsample_{i_level}/Conv2d_0/bias", "copy"))
        idx += 1
      hs_c.append(in_ch)

  _resblock(idx, "mid_block_0", rows, resblock_type=resblock_type,
            **temb, in_ch=in_ch, out_ch=in_ch); idx += 1
  _attn(idx, "mid_attn", rows); idx += 1
  _resblock(idx, "mid_block_1", rows, resblock_type=resblock_type,
            **temb, in_ch=in_ch, out_ch=in_ch); idx += 1

  for i_level in reversed(range(num_resolutions)):
    for i_block in range(num_res_blocks + 1):
      out_ch = nf * ch_mult[i_level]
      _resblock(idx, f"up_{i_level}_block_{i_block}", rows,
                **temb, resblock_type=resblock_type,
                in_ch=in_ch + hs_c.pop(),
                out_ch=out_ch)
      idx += 1
      in_ch = out_ch
    if all_resolutions[i_level] in attn_resolutions:
      _attn(idx, f"up_{i_level}_attn", rows); idx += 1
    if progressive != "none":
      if i_level == num_resolutions - 1:
        _groupnorm(f"all_modules.{idx}", f"pyramid_norm_{i_level}", rows)
        idx += 1
        _conv(f"all_modules.{idx}", f"pyramid_conv_{i_level}", rows)
        idx += 1
      else:
        if progressive == "output_skip":
          _groupnorm(f"all_modules.{idx}", f"pyramid_norm_{i_level}", rows)
          idx += 1
          _conv(f"all_modules.{idx}", f"pyramid_conv_{i_level}", rows)
          idx += 1
        elif progressive == "residual":
          rows.append((f"all_modules.{idx}.Conv2d_0.weight",
                       f"pyramid_upsample_{i_level}/Conv2d_0/weight", "conv"))
          rows.append((f"all_modules.{idx}.Conv2d_0.bias",
                       f"pyramid_upsample_{i_level}/Conv2d_0/bias", "copy"))
          idx += 1
    if i_level != 0:
      if resblock_type == "ddpm":
        _updown_sample(idx, f"up_{i_level}_upsample", rows,
                       with_conv=resamp_with_conv, fir=fir)
      else:
        _resblock(idx, f"up_{i_level}_upsample", rows,
                  **temb, resblock_type=resblock_type,
                  in_ch=in_ch, out_ch=in_ch, up=True)
      idx += 1

  if progressive != "output_skip":
    _groupnorm(f"all_modules.{idx}", "norm_out", rows); idx += 1
    _conv(f"all_modules.{idx}", "conv_out", rows); idx += 1
  return rows


def ddpm_param_map(config) -> List[Tuple[str, str, str]]:
  """Replay the DDPM construction order. A reference resblock owns a
  ``Dense_0`` even when the model is unconditional; the flax module has none
  then, so those rows have no flax path and carry the torch shape in their
  third slot."""
  rows: List[Tuple[str, str, str]] = []
  m = config.model
  nf = m.nf
  ch_mult = tuple(m.ch_mult)
  num_res_blocks = m.num_res_blocks
  num_resolutions = len(ch_mult)
  attn_resolutions = tuple(m.attn_resolutions)
  all_resolutions = [config.data.image_size // (2 ** i)
                     for i in range(num_resolutions)]
  resamp_with_conv = m.resamp_with_conv

  def legacy_resblock(idx, name, in_ch, out_ch):
    base = f"all_modules.{idx}"
    _groupnorm(f"{base}.GroupNorm_0", f"{name}/GroupNorm_0", rows)
    _conv(f"{base}.Conv_0", f"{name}/Conv_0", rows)
    if m.conditional:
      _dense(f"{base}.Dense_0", f"{name}/Dense_0", rows)
    else:
      rows.append((f"{base}.Dense_0.weight", None, (out_ch, nf * 4)))
      rows.append((f"{base}.Dense_0.bias", None, (out_ch,)))
    _groupnorm(f"{base}.GroupNorm_1", f"{name}/GroupNorm_1", rows)
    _conv(f"{base}.Conv_1", f"{name}/Conv_1", rows)
    if in_ch != out_ch:
      _nin(f"{base}.NIN_0", f"{name}/NIN_0", rows)

  def legacy_attn(idx, name):
    base = f"all_modules.{idx}"
    _groupnorm(f"{base}.GroupNorm_0", f"{name}/GroupNorm_0", rows)
    for i in range(4):
      _nin(f"{base}.NIN_{i}", f"{name}/NIN_{i}", rows)

  idx = 0
  if m.conditional:
    _dense(f"all_modules.{idx}", "Dense_t0", rows); idx += 1
    _dense(f"all_modules.{idx}", "Dense_t1", rows); idx += 1
  _conv(f"all_modules.{idx}", "conv_in", rows); idx += 1

  hs_c = [nf]
  in_ch = nf
  for i_level in range(num_resolutions):
    for i_block in range(num_res_blocks):
      out_ch = nf * ch_mult[i_level]
      legacy_resblock(idx, f"down_{i_level}_block_{i_block}", in_ch, out_ch)
      idx += 1
      in_ch = out_ch
      if all_resolutions[i_level] in attn_resolutions:
        legacy_attn(idx, f"down_{i_level}_attn_{i_block}"); idx += 1
      hs_c.append(in_ch)
    if i_level != num_resolutions - 1:
      if resamp_with_conv:
        _conv(f"all_modules.{idx}.Conv_0",
              f"down_{i_level}_downsample/Conv_0", rows)
      idx += 1
      hs_c.append(in_ch)

  legacy_resblock(idx, "mid_block_0", in_ch, in_ch); idx += 1
  legacy_attn(idx, "mid_attn"); idx += 1
  legacy_resblock(idx, "mid_block_1", in_ch, in_ch); idx += 1

  for i_level in reversed(range(num_resolutions)):
    for i_block in range(num_res_blocks + 1):
      out_ch = nf * ch_mult[i_level]
      legacy_resblock(idx, f"up_{i_level}_block_{i_block}",
                      in_ch + hs_c.pop(), out_ch)
      idx += 1
      in_ch = out_ch
    if all_resolutions[i_level] in attn_resolutions:
      legacy_attn(idx, f"up_{i_level}_attn"); idx += 1
    if i_level != 0:
      if resamp_with_conv:
        _conv(f"all_modules.{idx}.Conv_0",
              f"up_{i_level}_upsample/Conv_0", rows)
      idx += 1

  _groupnorm(f"all_modules.{idx}", "norm_out", rows); idx += 1
  _conv(f"all_modules.{idx}", "conv_out", rows); idx += 1
  return rows


def _in2plus(prefix_t, prefix_f, out, bias=True):
  """InstanceNorm2dPlus params (reference normalization.py:157-178):
  alpha/gamma/beta vectors pass through unchanged."""
  out.append((f"{prefix_t}.alpha", f"{prefix_f}/alpha", "copy"))
  out.append((f"{prefix_t}.gamma", f"{prefix_f}/gamma", "copy"))
  if bias:
    out.append((f"{prefix_t}.beta", f"{prefix_f}/beta", "copy"))


def _v2_resblock(t, f, out, *, resample, dilation, has_shortcut,
                 adjust_padding=False):
  """NCSNv2 ResidualBlock rows (reference layers.py:453-507). Torch names
  are attributes (normalize1/conv1/...); ConvMeanPool nests its conv as
  ``.conv`` (``.conv.1`` behind the ZeroPad2d Sequential when
  adjust_padding, reference layers.py:355-363). Row order follows the
  reference's REGISTRATION order — conv1, normalize2, conv2, shortcut,
  normalize1 last (layers.py:462-492) — which the export direction's
  parameters()-order EMA contract depends on."""
  _conv(f"{t}.conv1", f"{f}/Conv_0", out)
  _in2plus(f"{t}.normalize2", f"{f}/Norm_1", out)
  if resample == "down" and dilation == 1:
    seq = ".1" if adjust_padding else ""
    _conv(f"{t}.conv2.conv{seq}", f"{f}/Conv_1/Conv_0", out)
    _conv(f"{t}.shortcut.conv{seq}", f"{f}/Shortcut/Conv_0", out)
  else:
    _conv(f"{t}.conv2", f"{f}/Conv_1", out)
    if resample == "down" or has_shortcut:
      _conv(f"{t}.shortcut", f"{f}/Shortcut", out)
  _in2plus(f"{t}.normalize1", f"{f}/Norm_0", out)


def _rcu_rows(t, f, out, n_blocks, n_stages=2):
  """RCUBlock convs: torch ``{b}_{s}_conv`` attrs, bias-free
  (reference layers.py:184-206)."""
  for b in range(1, n_blocks + 1):
    for s in range(1, n_stages + 1):
      _conv_nobias(f"{t}.{b}_{s}_conv", f"{f}/Conv_{b}_{s}", out)


def _refine_rows(t, f, out, *, n_inputs, start=False, end=False):
  """RefineBlock rows (reference layers.py:277-310): per-input adapt RCUs,
  MSF fusion convs (absent when start), CRP convs, output RCU (3 blocks
  when end)."""
  for i in range(n_inputs):
    _rcu_rows(f"{t}.adapt_convs.{i}", f"{f}/RCU_{i}", out, 2)
  _rcu_rows(f"{t}.output_convs", f"{f}/RCU_out", out, 3 if end else 1)
  if not start:
    for i in range(n_inputs):
      _conv(f"{t}.msf.convs.{i}", f"{f}/MSF/Conv_{i}", out)
  for i in range(2):
    _conv_nobias(f"{t}.crp.convs.{i}", f"{f}/CRP/Conv_{i}", out)


def ncsnv2_param_map(config) -> List[Tuple[str, str, str]]:
  """NCSNv2 64/128/256 map (reference ncsnv2.py:43-130,222-313,316-415):
  a walk of the named attributes. Only the shipped ``InstanceNorm++``
  normalization is supported. The dilated residual blocks pad by their
  dilation (upstream ermongroup/ncsnv2's semantics, which the JAX
  package's models implement)."""
  if config.model.normalization != "InstanceNorm++":
    raise NotImplementedError(
        f"ncsnv2 interop supports InstanceNorm++ only, "
        f"got {config.model.normalization}")
  name = config.model.name
  nf = config.model.nf
  adjust = config.data.image_size == 28
  # (torch attr, resample of block 0, dilation, adjust_padding);
  # every pair's second block is (out→out, resample=None) — no shortcut.
  if name == "ncsnv2_64":
    res = [("res1", None, 1, False), ("res2", "down", 1, False),
           ("res3", "down", 2, False), ("res4", "down", 4, adjust)]
    refines = ["refine1", "refine2", "refine3", "refine4"]
  elif name == "ncsnv2_128":
    res = [("res1", None, 1, False), ("res2", "down", 1, False),
           ("res3", "down", 1, False), ("res4", "down", 2, False),
           ("res5", "down", 4, False)]
    refines = ["refine1", "refine2", "refine3", "refine4", "refine5"]
  elif name == "ncsnv2_256":
    res = [("res1", None, 1, False), ("res2", "down", 1, False),
           ("res3", "down", 1, False), ("res31", "down", 1, False),
           ("res4", "down", 2, False), ("res5", "down", 4, False)]
    refines = ["refine1", "refine2", "refine31", "refine3", "refine4",
               "refine5"]
  else:
    raise NotImplementedError(f"unknown ncsnv2 variant {name}")
  del nf  # channel counts do not affect the row structure

  rows: List[Tuple[str, str, str]] = []
  _conv("begin_conv", "begin_conv", rows)
  _in2plus("normalizer", "normalizer", rows)
  _conv("end_conv", "end_conv", rows)
  for attr, resample, dilation, adj in res:
    _v2_resblock(f"{attr}.0", f"{attr}_0", rows, resample=resample,
                 dilation=dilation, has_shortcut=False, adjust_padding=adj)
    _v2_resblock(f"{attr}.1", f"{attr}_1", rows, resample=None,
                 dilation=dilation, has_shortcut=False)
  for k, attr in enumerate(refines):
    _refine_rows(attr, attr, rows, n_inputs=1 if k == 0 else 2,
                 start=k == 0, end=k == len(refines) - 1)
  return rows


def _cond_norm(prefix_t, prefix_f, out):
  """ConditionalInstanceNorm2dPlus: ``embed.weight`` [K, 3C] is the flax
  ``embed`` unchanged."""
  out.append((f"{prefix_t}.embed.weight", f"{prefix_f}/embed", "copy"))


def _v1_resblock(t, f, out, *, resample, dilation, has_shortcut=False,
                 adjust_padding=False):
  """ConditionalResidualBlock rows (JAX layers.py:594-650), in the
  registration order of :func:`_v2_resblock` with conditional norms."""
  _conv(f"{t}.conv1", f"{f}/Conv_0", out)
  _cond_norm(f"{t}.normalize2", f"{f}/Norm_1", out)
  if resample == "down" and dilation == 1:
    seq = ".1" if adjust_padding else ""
    _conv(f"{t}.conv2.conv{seq}", f"{f}/Conv_1/Conv_0", out)
    _conv(f"{t}.shortcut.conv{seq}", f"{f}/Shortcut/Conv_0", out)
  else:
    _conv(f"{t}.conv2", f"{f}/Conv_1", out)
    if resample == "down" or has_shortcut:
      _conv(f"{t}.shortcut", f"{f}/Shortcut", out)
  _cond_norm(f"{t}.normalize1", f"{f}/Norm_0", out)


def _cond_rcu_rows(t, f, out, n_blocks, n_stages=2):
  """CondRCUBlock: ``{b}_{s}_norm`` then ``{b}_{s}_conv`` (bias-free) per
  unit and stage (JAX layers.py:360-380)."""
  for b in range(1, n_blocks + 1):
    for s in range(1, n_stages + 1):
      _cond_norm(f"{t}.{b}_{s}_norm", f"{f}/Norm_{b}_{s}", out)
      _conv_nobias(f"{t}.{b}_{s}_conv", f"{f}/Conv_{b}_{s}", out)


def _cond_refine_rows(t, f, out, *, n_inputs, start=False, end=False):
  """CondRefineBlock rows (JAX layers.py:459-486): adapt RCUs, the output
  RCU, the MSF's convs then its norms (absent when start), the CRP's convs
  then its norms."""
  for i in range(n_inputs):
    _cond_rcu_rows(f"{t}.adapt_convs.{i}", f"{f}/RCU_{i}", out, 2)
  _cond_rcu_rows(f"{t}.output_convs", f"{f}/RCU_out", out, 3 if end else 1)
  if not start:
    for i in range(n_inputs):
      _conv(f"{t}.msf.convs.{i}", f"{f}/MSF/Conv_{i}", out)
    for i in range(n_inputs):
      _cond_norm(f"{t}.msf.norms.{i}", f"{f}/MSF/Norm_{i}", out)
  for i in range(2):
    _conv_nobias(f"{t}.crp.convs.{i}", f"{f}/CRP/Conv_{i}", out)
  for i in range(2):
    _cond_norm(f"{t}.crp.norms.{i}", f"{f}/CRP/Norm_{i}", out)


def ncsn_param_map(config) -> List[Tuple[str, str, str]]:
  """NCSN v1 map (JAX ncsnv2.py:116-174): ncsnv2_64's walk with
  conditional norms and no ``sigmas`` buffer."""
  if config.model.normalization != "InstanceNorm++":
    raise NotImplementedError(
        f"ncsn interop supports InstanceNorm++ only, "
        f"got {config.model.normalization}")
  adjust = config.data.image_size == 28
  res = [("res1", None, 1, False), ("res2", "down", 1, False),
         ("res3", "down", 2, False), ("res4", "down", 4, adjust)]
  refines = ["refine1", "refine2", "refine3", "refine4"]
  rows: List[Tuple[str, str, str]] = []
  _conv("begin_conv", "begin_conv", rows)
  _cond_norm("normalizer", "normalizer", rows)
  _conv("end_conv", "end_conv", rows)
  for attr, resample, dilation, adj in res:
    _v1_resblock(f"{attr}.0", f"{attr}_0", rows, resample=resample,
                 dilation=dilation, adjust_padding=adj)
    _v1_resblock(f"{attr}.1", f"{attr}_1", rows, resample=None,
                 dilation=dilation)
  for k, attr in enumerate(refines):
    _cond_refine_rows(attr, attr, rows, n_inputs=1 if k == 0 else 2,
                      start=k == 0, end=k == len(refines) - 1)
  return rows


_PARAM_MAPS = {"ncsnpp": ncsnpp_param_map, "ddpm": ddpm_param_map,
               "ncsnv2_64": ncsnv2_param_map, "ncsnv2_128": ncsnv2_param_map,
               "ncsnv2_256": ncsnv2_param_map, "ncsn": ncsn_param_map}
# The models that register a ``sigmas`` buffer before their parameters.
_NO_SIGMAS = frozenset({"ncsn"})


def _to_torch_layout(arr: np.ndarray, kind: str) -> np.ndarray:
  if kind == "conv":
    assert arr.ndim == 4, arr.shape
    return np.transpose(arr, (3, 2, 0, 1))  # HWIO → OIHW
  if kind == "dense":
    assert arr.ndim == 2
    return arr.T
  return arr


def _lookup(tree: Dict, path: str) -> np.ndarray:
  node = tree
  for p in path.split("/"):
    node = node[p]
  return np.asarray(node)


def flax_params_to_torch_state_dict(params: Dict,
                                    config) -> Dict[str, np.ndarray]:
  """A flax params tree (leaves convertible to numpy) as a
  reference-layout state_dict of numpy arrays, in parameter-registration
  order, led by the ``sigmas`` buffer (float64, from the config) in every
  model but NCSN v1. Rows with no flax path (an unconditional DDPM's
  ``Dense_0``) come out as zeros of the torch shape their row carries."""
  param_map = _PARAM_MAPS.get(config.model.name)
  if param_map is None:
    raise NotImplementedError(
        f"no parameter map for model {config.model.name!r} (mapped: "
        f"{sorted(_PARAM_MAPS)})")
  out: Dict[str, np.ndarray] = {}
  if config.model.name not in _NO_SIGMAS:
    out["sigmas"] = np.exp(np.linspace(
        np.log(config.model.sigma_max), np.log(config.model.sigma_min),
        config.model.num_scales))
  for torch_key, flax_path, kind in param_map(config):
    if flax_path is None:
      out[torch_key] = np.zeros(kind, np.float32)
      continue
    out[torch_key] = _to_torch_layout(_lookup(params, flax_path), kind)
  return out


def load_jax_params(model: torch.nn.Module, params, config) -> None:
  """Copy a JAX params tree (leaves convertible to numpy) into ``model``.

  Every parameter and buffer must be covered and nothing left over."""
  state = flax_params_to_torch_state_dict(params, config)
  tensors = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in state.items()}
  model.load_state_dict(tensors, strict=True)
