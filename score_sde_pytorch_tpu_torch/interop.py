"""Load the JAX package's parameters into the port's modules.

The map from a flax params tree of NCSN++ or DDPM to the port's state_dict,
numpy only: a copy of the NCSN++ and DDPM parts of
score_sde_pytorch_tpu/interop.py (the row builders :37-97,
``ncsnpp_param_map`` :99-218, ``ddpm_param_map`` :221-305, the HWIO → OIHW
transform and ``flax_params_to_torch_state_dict`` :481-531), so that the port
imports nothing of the JAX package. The port's modules use the torch
reference's layout, so loading is that map plus
``load_state_dict(strict=True)``. ``tests/test_torch_copies.py`` holds the
maps equal to the JAX package's, row for row.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch


def _conv(prefix_t, prefix_f, out):
  out.append((f"{prefix_t}.weight", f"{prefix_f}/kernel", "conv"))
  out.append((f"{prefix_t}.bias", f"{prefix_f}/bias", "copy"))


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
              down=False, temb=True):
  """ResnetBlockDDPMpp / ResnetBlockBigGANpp parameter rows."""
  base = f"all_modules.{idx}"
  _groupnorm(f"{base}.GroupNorm_0", f"{name}/GroupNorm_0", out)
  _conv(f"{base}.Conv_0", f"{name}/Conv_0", out)
  if temb:
    _dense(f"{base}.Dense_0", f"{name}/Dense_0", out)
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
                resblock_type=resblock_type, in_ch=in_ch, out_ch=out_ch)
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
                  resblock_type=resblock_type, in_ch=in_ch, out_ch=in_ch,
                  down=True)
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
            in_ch=in_ch, out_ch=in_ch); idx += 1
  _attn(idx, "mid_attn", rows); idx += 1
  _resblock(idx, "mid_block_1", rows, resblock_type=resblock_type,
            in_ch=in_ch, out_ch=in_ch); idx += 1

  for i_level in reversed(range(num_resolutions)):
    for i_block in range(num_res_blocks + 1):
      out_ch = nf * ch_mult[i_level]
      _resblock(idx, f"up_{i_level}_block_{i_block}", rows,
                resblock_type=resblock_type, in_ch=in_ch + hs_c.pop(),
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
                  resblock_type=resblock_type, in_ch=in_ch, out_ch=in_ch,
                  up=True)
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


_PARAM_MAPS = {"ncsnpp": ncsnpp_param_map, "ddpm": ddpm_param_map}


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
  """An NCSN++ or DDPM flax params tree (leaves convertible to numpy) as a
  reference-layout state_dict of numpy arrays, in parameter-registration
  order, led by the ``sigmas`` buffer (float64, from the config). Rows with
  no flax path (an unconditional DDPM's ``Dense_0``) come out as zeros of
  the torch shape their row carries."""
  param_map = _PARAM_MAPS.get(config.model.name)
  if param_map is None:
    raise NotImplementedError(
        f"model {config.model.name!r} is not ported yet (ported: "
        f"{sorted(_PARAM_MAPS)}); see ROADMAP.md queue 1 item 11")
  out: Dict[str, np.ndarray] = {"sigmas": np.exp(np.linspace(
      np.log(config.model.sigma_max), np.log(config.model.sigma_min),
      config.model.num_scales))}
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
