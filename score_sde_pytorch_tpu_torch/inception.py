"""InceptionV3 feature extractor for FID/IS/KID (PyTorch, NCHW).

Counterpart of score_sde_pytorch_tpu/inception.py: the FID InceptionV3
(TF "frozen inception v3 2015" as ported by pytorch-fid), 2048-d ``pool_3``
features and, when the weights carry the ``fc`` head, 1008 logits.

Weights load from the same ``.npz`` the JAX package reads: the pytorch-fid
state_dict layout that ``tools/convert_inception_weights.py`` writes
(``<block>.conv.weight`` OIHW and four BatchNorm arrays per convolution),
checked key by key and shape by shape against :func:`weight_spec` before
use. An npz without ``fc.*`` keys (the feature-vector network of the ≥256 px
protocol) gives pool features only.

As in the JAX package:
* BatchNorm (eps = 1e-3) is folded at load into a per-channel scale and
  shift applied after each convolution;
* in-block 3×3 average pools leave padding out of the count;
* ``Mixed_7b`` pools by average in its pool branch, ``Mixed_7c`` by max;
* input: uint8 NHWC → /255 → bilinear resize to 299×299 → ×2 − 1. The JAX
  package resizes with ``jax.image.resize`` (half-pixel centres; a
  downsample is anti-aliased), which is ``F.interpolate(mode="bilinear",
  align_corners=False)``, with ``antialias=True`` when an image is larger
  than 299 on a side.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

INCEPTION_SIZE = 299
BN_EPS = 1e-3
NUM_CLASSES = 1008


def weight_spec():
  """(name, kh, kw, in_ch, out_ch) for every conv; the architecture table
  (JAX inception.py:225-308)."""
  spec = [
      ("Conv2d_1a_3x3", 3, 3, 3, 32),
      ("Conv2d_2a_3x3", 3, 3, 32, 32),
      ("Conv2d_2b_3x3", 3, 3, 32, 64),
      ("Conv2d_3b_1x1", 1, 1, 64, 80),
      ("Conv2d_4a_3x3", 3, 3, 80, 192),
  ]

  def inc_a(name, in_ch, pool_ch):
    spec.extend([
        (f"{name}.branch1x1", 1, 1, in_ch, 64),
        (f"{name}.branch5x5_1", 1, 1, in_ch, 48),
        (f"{name}.branch5x5_2", 5, 5, 48, 64),
        (f"{name}.branch3x3dbl_1", 1, 1, in_ch, 64),
        (f"{name}.branch3x3dbl_2", 3, 3, 64, 96),
        (f"{name}.branch3x3dbl_3", 3, 3, 96, 96),
        (f"{name}.branch_pool", 1, 1, in_ch, pool_ch),
    ])
    return 64 + 64 + 96 + pool_ch

  def inc_b(name, in_ch):
    spec.extend([
        (f"{name}.branch3x3", 3, 3, in_ch, 384),
        (f"{name}.branch3x3dbl_1", 1, 1, in_ch, 64),
        (f"{name}.branch3x3dbl_2", 3, 3, 64, 96),
        (f"{name}.branch3x3dbl_3", 3, 3, 96, 96),
    ])
    return 384 + 96 + in_ch

  def inc_c(name, in_ch, c7):
    spec.extend([
        (f"{name}.branch1x1", 1, 1, in_ch, 192),
        (f"{name}.branch7x7_1", 1, 1, in_ch, c7),
        (f"{name}.branch7x7_2", 1, 7, c7, c7),
        (f"{name}.branch7x7_3", 7, 1, c7, 192),
        (f"{name}.branch7x7dbl_1", 1, 1, in_ch, c7),
        (f"{name}.branch7x7dbl_2", 7, 1, c7, c7),
        (f"{name}.branch7x7dbl_3", 1, 7, c7, c7),
        (f"{name}.branch7x7dbl_4", 7, 1, c7, c7),
        (f"{name}.branch7x7dbl_5", 1, 7, c7, 192),
        (f"{name}.branch_pool", 1, 1, in_ch, 192),
    ])
    return 4 * 192

  def inc_d(name, in_ch):
    spec.extend([
        (f"{name}.branch3x3_1", 1, 1, in_ch, 192),
        (f"{name}.branch3x3_2", 3, 3, 192, 320),
        (f"{name}.branch7x7x3_1", 1, 1, in_ch, 192),
        (f"{name}.branch7x7x3_2", 1, 7, 192, 192),
        (f"{name}.branch7x7x3_3", 7, 1, 192, 192),
        (f"{name}.branch7x7x3_4", 3, 3, 192, 192),
    ])
    return 320 + 192 + in_ch

  def inc_e(name, in_ch):
    spec.extend([
        (f"{name}.branch1x1", 1, 1, in_ch, 320),
        (f"{name}.branch3x3_1", 1, 1, in_ch, 384),
        (f"{name}.branch3x3_2a", 1, 3, 384, 384),
        (f"{name}.branch3x3_2b", 3, 1, 384, 384),
        (f"{name}.branch3x3dbl_1", 1, 1, in_ch, 448),
        (f"{name}.branch3x3dbl_2", 3, 3, 448, 384),
        (f"{name}.branch3x3dbl_3a", 1, 3, 384, 384),
        (f"{name}.branch3x3dbl_3b", 3, 1, 384, 384),
        (f"{name}.branch_pool", 1, 1, in_ch, 192),
    ])
    return 320 + 768 + 768 + 192

  c = inc_a("Mixed_5b", 192, 32)
  c = inc_a("Mixed_5c", c, 64)
  c = inc_a("Mixed_5d", c, 64)
  c = inc_b("Mixed_6a", c)
  c = inc_c("Mixed_6b", c, 128)
  c = inc_c("Mixed_6c", c, 160)
  c = inc_c("Mixed_6d", c, 160)
  c = inc_c("Mixed_6e", c, 192)
  c = inc_d("Mixed_7a", c)
  c = inc_e("Mixed_7b", c)
  c = inc_e("Mixed_7c", c)
  assert c == 2048
  return spec


def validate_raw(raw: Dict[str, np.ndarray]) -> None:
  """Strict key and shape check against :func:`weight_spec` (JAX
  inception.py:43-72): a truncated or mis-exported npz fails here, not as a
  silently wrong FID."""
  problems = []
  for name, kh, kw, cin, cout in weight_spec():
    w_key = f"{name}.conv.weight"
    if w_key not in raw:
      problems.append(f"missing {w_key}")
    elif tuple(raw[w_key].shape) != (cout, cin, kh, kw):
      problems.append(f"{w_key}: shape {tuple(raw[w_key].shape)} != "
                      f"OIHW {(cout, cin, kh, kw)}")
    for bn in ("weight", "bias", "running_mean", "running_var"):
      b_key = f"{name}.bn.{bn}"
      if b_key not in raw:
        problems.append(f"missing {b_key}")
      elif tuple(raw[b_key].shape) != (cout,):
        problems.append(f"{b_key}: shape {tuple(raw[b_key].shape)} != "
                        f"({cout},)")
  if "fc.weight" in raw and tuple(raw["fc.weight"].shape)[1] != 2048:
    problems.append(f"fc.weight: shape {tuple(raw['fc.weight'].shape)} — "
                    "expected (num_classes, 2048)")
  if problems:
    head = "; ".join(problems[:8])
    raise ValueError(
        f"Inception weights npz fails the FID-InceptionV3 schema "
        f"({len(problems)} problems): {head}"
        f"{' ...' if len(problems) > 8 else ''} — re-export with "
        "tools/convert_inception_weights.py")


def fold_bn(raw: Dict[str, np.ndarray], prefix: str):
  """BatchNorm(eps=1e-3) of ``prefix`` as a per-channel (scale, shift)."""
  gamma = raw[f"{prefix}.bn.weight"]
  beta = raw[f"{prefix}.bn.bias"]
  mean = raw[f"{prefix}.bn.running_mean"]
  var = raw[f"{prefix}.bn.running_var"]
  scale = gamma / np.sqrt(var + BN_EPS)
  shift = beta - mean * scale
  return scale.astype(np.float32), shift.astype(np.float32)


def load_params(npz_path: str) -> Dict[str, torch.Tensor]:
  """The npz as :class:`InceptionV3`'s state_dict: validated, BN folded
  into ``<name>.scale``/``<name>.shift``, convolutions OIHW fp32."""
  with np.load(npz_path) as z:
    raw = dict(z)
  validate_raw(raw)
  out = {}
  for name, *_ in weight_spec():
    out[f"{name}.conv.weight"] = torch.from_numpy(
        np.asarray(raw[f"{name}.conv.weight"], np.float32))
    scale, shift = fold_bn(raw, name)
    out[f"{name}.scale"] = torch.from_numpy(scale)
    out[f"{name}.shift"] = torch.from_numpy(shift)
  if "fc.weight" in raw:
    out["fc.weight"] = torch.from_numpy(np.asarray(raw["fc.weight"],
                                                   np.float32))
    out["fc.bias"] = torch.from_numpy(np.asarray(raw["fc.bias"], np.float32))
  return out


def random_raw_params(seed: int = 0, logits: bool = True
                      ) -> Dict[str, np.ndarray]:
  """Random weights in the raw npz layout (OIHW convolutions, four BN
  arrays each, optionally the fc head), drawn like the JAX package's
  tests draw them."""
  rng = np.random.default_rng(seed)
  raw = {}
  for name, kh, kw, cin, cout in weight_spec():
    raw[f"{name}.conv.weight"] = rng.normal(
        0, 1 / np.sqrt(kh * kw * cin), (cout, cin, kh, kw)).astype(np.float32)
    raw[f"{name}.bn.weight"] = np.ones(cout, np.float32)
    raw[f"{name}.bn.bias"] = np.zeros(cout, np.float32)
    raw[f"{name}.bn.running_mean"] = np.zeros(cout, np.float32)
    raw[f"{name}.bn.running_var"] = np.ones(cout, np.float32)
  if logits:
    raw["fc.weight"] = rng.normal(0, 0.02, (NUM_CLASSES, 2048)).astype(
        np.float32)
    raw["fc.bias"] = np.zeros(NUM_CLASSES, np.float32)
  return raw


def write_random_npz(path: str, seed: int = 0, logits: bool = True) -> str:
  """Write :func:`random_raw_params` as an npz that :func:`load_params` and
  the JAX package's loader both read; returns ``path``."""
  np.savez(path, **random_raw_params(seed, logits))
  return path


def random_params(seed: int = 0) -> Dict[str, torch.Tensor]:
  """Random folded weights with the architecture's shapes: the draws of the
  JAX package's ``random_params(seed)`` (HWIO there), as OIHW."""
  rng = np.random.default_rng(seed)
  p = {}
  for name, kh, kw, cin, cout in weight_spec():
    fan_in = kh * kw * cin
    w = rng.normal(0, 1 / np.sqrt(fan_in), (kh, kw, cin, cout))
    p[f"{name}.conv.weight"] = torch.from_numpy(
        np.ascontiguousarray(w.transpose(3, 2, 0, 1), np.float32))
    p[f"{name}.scale"] = torch.ones(cout)
    p[f"{name}.shift"] = torch.zeros(cout)
  fc = rng.normal(0, 0.02, (2048, NUM_CLASSES))
  p["fc.weight"] = torch.from_numpy(np.ascontiguousarray(fc.T, np.float32))
  p["fc.bias"] = torch.zeros(NUM_CLASSES)
  return p


class ConvBN(nn.Module):
  """Convolution, folded BatchNorm, ReLU."""

  def __init__(self, kh: int, kw: int, cin: int, cout: int, stride=1,
               padding=0):
    super().__init__()
    self.conv = nn.Conv2d(cin, cout, (kh, kw), stride=stride,
                          padding=padding, bias=False)
    self.register_buffer("scale", torch.ones(cout))
    self.register_buffer("shift", torch.zeros(cout))

  def forward(self, x):
    y = self.conv(x)
    return F.relu(y * self.scale[:, None, None] + self.shift[:, None, None])


def _avg_pool_3x3(x):
  """3×3 stride-1 average pool, pad 1, padding left out of the count."""
  return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class _Block(nn.Module):
  """An Inception block: its convolutions from :func:`weight_spec` by
  name, with the strides and paddings of JAX inception.py:129-194."""

  LAYOUT: Dict[str, tuple] = {}

  def __init__(self, name: str, spec: dict):
    super().__init__()
    for branch, (stride, padding) in self.LAYOUT.items():
      kh, kw, cin, cout = spec[f"{name}.{branch}"]
      self.add_module(branch, ConvBN(kh, kw, cin, cout, stride, padding))


class InceptionA(_Block):
  LAYOUT = {"branch1x1": (1, 0), "branch5x5_1": (1, 0),
            "branch5x5_2": (1, 2), "branch3x3dbl_1": (1, 0),
            "branch3x3dbl_2": (1, 1), "branch3x3dbl_3": (1, 1),
            "branch_pool": (1, 0)}

  def forward(self, x):
    b1 = self.branch1x1(x)
    b5 = self.branch5x5_2(self.branch5x5_1(x))
    b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
    bp = self.branch_pool(_avg_pool_3x3(x))
    return torch.cat([b1, b5, b3, bp], 1)


class InceptionB(_Block):
  LAYOUT = {"branch3x3": (2, 0), "branch3x3dbl_1": (1, 0),
            "branch3x3dbl_2": (1, 1), "branch3x3dbl_3": (2, 0)}

  def forward(self, x):
    b3 = self.branch3x3(x)
    bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
    return torch.cat([b3, bd, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionC(_Block):
  LAYOUT = {"branch1x1": (1, 0), "branch7x7_1": (1, 0),
            "branch7x7_2": (1, (0, 3)), "branch7x7_3": (1, (3, 0)),
            "branch7x7dbl_1": (1, 0), "branch7x7dbl_2": (1, (3, 0)),
            "branch7x7dbl_3": (1, (0, 3)), "branch7x7dbl_4": (1, (3, 0)),
            "branch7x7dbl_5": (1, (0, 3)), "branch_pool": (1, 0)}

  def forward(self, x):
    b1 = self.branch1x1(x)
    b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
    bd = x
    for i in range(1, 6):
      bd = getattr(self, f"branch7x7dbl_{i}")(bd)
    bp = self.branch_pool(_avg_pool_3x3(x))
    return torch.cat([b1, b7, bd, bp], 1)


class InceptionD(_Block):
  LAYOUT = {"branch3x3_1": (1, 0), "branch3x3_2": (2, 0),
            "branch7x7x3_1": (1, 0), "branch7x7x3_2": (1, (0, 3)),
            "branch7x7x3_3": (1, (3, 0)), "branch7x7x3_4": (2, 0)}

  def forward(self, x):
    b3 = self.branch3x3_2(self.branch3x3_1(x))
    b7 = x
    for i in range(1, 5):
      b7 = getattr(self, f"branch7x7x3_{i}")(b7)
    return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionE(_Block):
  LAYOUT = {"branch1x1": (1, 0), "branch3x3_1": (1, 0),
            "branch3x3_2a": (1, (0, 1)), "branch3x3_2b": (1, (1, 0)),
            "branch3x3dbl_1": (1, 0), "branch3x3dbl_2": (1, 1),
            "branch3x3dbl_3a": (1, (0, 1)), "branch3x3dbl_3b": (1, (1, 0)),
            "branch_pool": (1, 0)}

  def __init__(self, name: str, spec: dict, pool: str):
    super().__init__(name, spec)
    self.pool = pool

  def forward(self, x):
    b1 = self.branch1x1(x)
    b3 = self.branch3x3_1(x)
    b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
    bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
    bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
    if self.pool == "avg":
      bp = _avg_pool_3x3(x)
    else:  # Mixed_7c pools by max in the FID graph
      bp = F.max_pool2d(x, 3, stride=1, padding=1)
    return torch.cat([b1, b3, bd, self.branch_pool(bp)], 1)


_STEM = {"Conv2d_1a_3x3": (2, 0), "Conv2d_2a_3x3": (1, 0),
         "Conv2d_2b_3x3": (1, 1), "Conv2d_3b_1x1": (1, 0),
         "Conv2d_4a_3x3": (1, 0)}
_BLOCKS = [("Mixed_5b", InceptionA), ("Mixed_5c", InceptionA),
           ("Mixed_5d", InceptionA), ("Mixed_6a", InceptionB),
           ("Mixed_6b", InceptionC), ("Mixed_6c", InceptionC),
           ("Mixed_6d", InceptionC), ("Mixed_6e", InceptionC),
           ("Mixed_7a", InceptionD), ("Mixed_7b", InceptionE),
           ("Mixed_7c", InceptionE)]


class InceptionV3(nn.Module):
  """The FID InceptionV3 on NCHW input in [−1, 1] at 299×299; ``forward``
  returns ``(pool_3 [N, 2048], logits [N, 1008] or None)``. Module names
  are the npz's, so :func:`load_params` is its state_dict."""

  def __init__(self, logits: bool = True):
    super().__init__()
    spec = {name: rest for name, *rest in weight_spec()}
    for name, (stride, padding) in _STEM.items():
      self.add_module(name, ConvBN(*spec[name], stride, padding))
    for name, cls in _BLOCKS:
      kwargs = {"pool": "avg" if name == "Mixed_7b" else "max"} if (
          cls is InceptionE) else {}
      self.add_module(name, cls(name, spec, **kwargs))
    self.fc = nn.Linear(2048, NUM_CLASSES) if logits else None

  @classmethod
  def from_params(cls, params: Dict[str, torch.Tensor]) -> "InceptionV3":
    model = cls(logits="fc.weight" in params)
    model.load_state_dict(params, strict=True)
    return model.eval().requires_grad_(False)

  def forward(self, x):
    x = self.Conv2d_1a_3x3(x)
    x = self.Conv2d_2a_3x3(x)
    x = self.Conv2d_2b_3x3(x)
    x = F.max_pool2d(x, 3, stride=2)
    x = self.Conv2d_3b_1x1(x)
    x = self.Conv2d_4a_3x3(x)
    x = F.max_pool2d(x, 3, stride=2)
    for name, _ in _BLOCKS:
      x = getattr(self, name)(x)
    pool = x.mean(dim=(2, 3))  # global average pool → [N, 2048]
    return pool, (self.fc(pool) if self.fc is not None else None)


def preprocess(images_u8: torch.Tensor) -> torch.Tensor:
  """uint8 NHWC → float NCHW in [−1, 1] at 299×299 (bilinear, half-pixel
  centres, anti-aliased where it shrinks an image; grey → three channels)."""
  x = images_u8.permute(0, 3, 1, 2).to(torch.float32) / 255.0
  shrink = x.shape[2] > INCEPTION_SIZE or x.shape[3] > INCEPTION_SIZE
  x = F.interpolate(x, size=(INCEPTION_SIZE, INCEPTION_SIZE), mode="bilinear",
                    align_corners=False, antialias=shrink)
  if x.shape[1] == 1:
    x = x.repeat(1, 3, 1, 1)
  return x * 2.0 - 1.0


class InceptionV3Features:
  """Callable: uint8 NHWC images (numpy) → ``dict(pool_3, logits)`` as
  numpy, run on ``device`` in batches of ``batch`` (JAX
  inception.py:326-379). ``logits`` is absent when the weights have no fc
  head. The last batch is not padded to full size, as the JAX package
  pads it: a new batch size costs PyTorch no compilation."""

  def __init__(self, npz_path: str, batch: int = 64, device="cpu",
               params: Optional[Dict[str, torch.Tensor]] = None):
    self.device = torch.device(device)
    self.model = InceptionV3.from_params(
        params if params is not None else load_params(npz_path)).to(
            self.device)
    self.batch = batch

  @torch.no_grad()
  def __call__(self, images_u8: np.ndarray) -> Dict[str, np.ndarray]:
    pools, logits = [], []
    for start in range(0, images_u8.shape[0], self.batch):
      chunk = torch.from_numpy(np.ascontiguousarray(
          images_u8[start:start + self.batch])).to(self.device)
      pool, lg = self.model(preprocess(chunk))
      pools.append(pool.cpu().numpy())
      if lg is not None:
        logits.append(lg.cpu().numpy())
    out = {"pool_3": np.concatenate(pools)}
    if logits:
      out["logits"] = np.concatenate(logits)
    return out
