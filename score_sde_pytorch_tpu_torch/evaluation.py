"""Sample quality: FID, Inception Score and KID (PyTorch).

Counterpart of score_sde_pytorch_tpu/evaluation.py:
* **FID**: the Fréchet distance in the symmetric ``eigh`` form,
  ``tr((S1^½ S2 S1^½)^½)``, with trace-relative regularisation of both
  covariances, in fp32 as the JAX package computes it, on the device the
  caller names;
* **IS** from logits, ``exp(E[KL(p(y|x) ‖ p(y))])``;
* **KID**, the unbiased polynomial-kernel MMD² with tfgan's block estimator,
  in float64 numpy;
* the Inception pass (:mod:`score_sde_pytorch_tpu_torch.inception`) gated on
  a local weights npz: ``INCEPTION_WEIGHTS_NPZ`` (or
  ``config.eval.inception_weights``) below 256 px, and
  ``INCEPTION_V3_FEATURE_WEIGHTS_NPZ`` (or
  ``config.eval.inception_feature_weights``) for the ≥256 px protocol;
  :func:`run_inception` returns None without one;
* dataset statistics from ``assets/stats/`` relative to the working
  directory, as the reference loads them.
"""
from __future__ import annotations

import logging
import os
from typing import Dict, Optional

import numpy as np
import torch

INCEPTION_DEFAULT_SIZE = 299


def sqrtm_newton_schulz(a: torch.Tensor, num_iters: int = 50) -> torch.Tensor:
  """Matrix square root of a PSD matrix by Newton–Schulz iteration:
  ``Y ← Y(3I − ZY)/2``, ``Z ← (3I − ZY)Z/2`` from ``Y = A/‖A‖_F``,
  ``Z = I``; then ``Y·√‖A‖_F``."""
  norm = torch.linalg.norm(a)
  y = a / norm
  eye = torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
  z = eye
  for _ in range(num_iters):
    t = 0.5 * (3.0 * eye - z @ y)
    y, z = y @ t, t @ z
  return y * torch.sqrt(norm)


def frechet_distance(mu1: torch.Tensor, sigma1: torch.Tensor,
                     mu2: torch.Tensor, sigma2: torch.Tensor) -> torch.Tensor:
  """FID: ``‖mu1−mu2‖² + tr(S1 + S2 − 2(S1 S2)^½)`` (JAX
  evaluation.py:62-88), with ``tr((S1 S2)^½)`` taken as
  ``tr((S1^½ S2 S1^½)^½)`` so only symmetric PSD matrices are decomposed,
  and ``1e-6·max(1, tr(S)/d)`` added to each diagonal."""
  diff = mu1 - mu2
  dim = sigma1.shape[0]
  eps1 = 1e-6 * torch.clamp(torch.trace(sigma1) / dim, min=1.0)
  eps2 = 1e-6 * torch.clamp(torch.trace(sigma2) / dim, min=1.0)
  eye = torch.eye(dim, dtype=sigma1.dtype, device=sigma1.device)
  s1 = sigma1 + eye * eps1
  s2 = sigma2 + eye * eps2
  w1, v1 = torch.linalg.eigh(s1)
  root1 = (v1 * torch.sqrt(torch.clamp(w1, min=0.0))) @ v1.T
  inner = root1 @ s2 @ root1
  inner = 0.5 * (inner + inner.T)  # clean numerical asymmetry
  w = torch.linalg.eigvalsh(inner)
  tr_covmean = torch.sum(torch.sqrt(torch.clamp(w, min=0.0)))
  return (torch.dot(diff, diff) + torch.trace(s1) + torch.trace(s2)
          - 2.0 * tr_covmean)


def _moments(act: torch.Tensor):
  return act.mean(dim=0), torch.cov(act.T)


def fid_from_activations(act1, act2, device="cpu") -> float:
  """FID between two activation sets [N, D], in fp32 on ``device``."""
  a1, a2 = (torch.as_tensor(np.asarray(a), dtype=torch.float32,
                            device=device) for a in (act1, act2))
  return float(frechet_distance(*_moments(a1), *_moments(a2)))


def fid_from_stats(act, mu2, sigma2, device="cpu") -> float:
  """FID of activations [N, D] against a dataset's ``mu`` and ``sigma``."""
  a = torch.as_tensor(np.asarray(act), dtype=torch.float32, device=device)
  mu2, sigma2 = (torch.as_tensor(np.asarray(v), dtype=torch.float32,
                                 device=device) for v in (mu2, sigma2))
  return float(frechet_distance(*_moments(a), mu2, sigma2))


def inception_score_from_logits(logits, device="cpu") -> float:
  """IS from logits [N, classes] (tfgan classifier_score_from_logits)."""
  lg = torch.as_tensor(np.asarray(logits), dtype=torch.float32, device=device)
  log_probs = torch.log_softmax(lg, dim=-1)
  probs = torch.exp(log_probs)
  marginal = probs.mean(dim=0)
  kl = torch.sum(probs * (log_probs - torch.log(marginal)[None, :]), dim=-1)
  return float(torch.exp(kl.mean()))


def kid_from_activations(act1, act2, block_size: int = 1000) -> float:
  """Unbiased KID (kernel MMD², polynomial kernel (x·y/d + 1)³) with tfgan's
  block-averaged estimator, in float64."""
  act1 = np.asarray(act1, np.float64)
  act2 = np.asarray(act2, np.float64)
  n1, d = act1.shape
  n2 = act2.shape[0]
  n_blocks = max(1, min(n1, n2) // block_size)

  def kernel(x, y):
    return (x @ y.T / d + 1.0) ** 3

  scores = []
  for i in range(n_blocks):
    x = act1[i * block_size:(i + 1) * block_size]
    y = act2[i * block_size:(i + 1) * block_size]
    m, n = x.shape[0], y.shape[0]
    k_xx = kernel(x, x)
    k_yy = kernel(y, y)
    k_xy = kernel(x, y)
    term_xx = (k_xx.sum() - np.trace(k_xx)) / (m * (m - 1))
    term_yy = (k_yy.sum() - np.trace(k_yy)) / (n * (n - 1))
    term_xy = k_xy.mean()
    scores.append(term_xx + term_yy - 2 * term_xy)
  return float(np.mean(scores))


_INCEPTION_CACHE: Dict[tuple, object] = {}


def is_inceptionv3(config) -> bool:
  """The ≥256 px protocol (reference run_lib.py:257-258): the feature-vector
  network (pool features only), and no IS."""
  return config is not None and config.data.image_size >= 256


def get_inception_weights_path(config=None,
                               inceptionv3: Optional[bool] = None
                               ) -> Optional[str]:
  """The local weights npz of the protocol's network, or None."""
  if inceptionv3 is None:
    inceptionv3 = is_inceptionv3(config)
  if inceptionv3:
    path = os.environ.get("INCEPTION_V3_FEATURE_WEIGHTS_NPZ", "")
    if not path and config is not None:
      path = config.eval.get("inception_feature_weights", "")
  else:
    path = os.environ.get("INCEPTION_WEIGHTS_NPZ", "")
    if not path and config is not None:
      path = config.eval.get("inception_weights", "")
  return path if path and os.path.exists(path) else None


def get_inception_model(config=None, device="cpu"):
  """The feature extractor for the config's protocol on ``device`` (built
  once per weights file and device), or None without weights."""
  path = get_inception_weights_path(config)
  if path is None:
    return None
  from score_sde_pytorch_tpu_torch.inception import InceptionV3Features
  key = (path, str(torch.device(device)))
  if key not in _INCEPTION_CACHE:
    _INCEPTION_CACHE[key] = InceptionV3Features(path, device=device)
  return _INCEPTION_CACHE[key]


def run_inception(images_u8: np.ndarray, config=None,
                  device="cpu") -> Optional[Dict[str, np.ndarray]]:
  """``dict(pool_3 [N, 2048], logits [N, 1008])`` of uint8 NHWC images, or
  None when no weights are available (the caller skips the statistics)."""
  model = get_inception_model(config, device)
  if model is None:
    logging.warning(
        "No Inception weights available (set INCEPTION_WEIGHTS_NPZ, or "
        "INCEPTION_V3_FEATURE_WEIGHTS_NPZ for the >=256px protocol); "
        "skipping FID/IS statistics.")
    return None
  return model(images_u8)


def load_dataset_stats(config) -> Dict:
  """A dataset's statistics npz from ``assets/stats/`` under the working
  directory (reference evaluation.py:43-56)."""
  data_name = config.data.dataset.lower()
  size = config.data.image_size
  candidates = [
      f"assets/stats/{data_name}_{size}_stats.npz",
      f"assets/stats/{data_name}_stats.npz",
  ]
  for c in candidates:
    if os.path.exists(c):
      with np.load(c) as z:
        return dict(z)
  raise FileNotFoundError(
      f"No dataset stats found for {data_name}@{size} (tried {candidates})")


def compute_scores(pool_acts: np.ndarray, config,
                   logits: Optional[np.ndarray] = None,
                   device="cpu") -> Dict[str, float]:
  """IS, and FID (with KID when the statistics carry ``pool_3``) against
  the dataset's statistics (reference run_lib.py:380-397). IS only below
  256 px; a missing statistics file drops FID and KID with a warning."""
  out: Dict[str, float] = {}
  if logits is not None and not is_inceptionv3(config):
    out["inception_score"] = inception_score_from_logits(logits, device)
  try:
    stats = load_dataset_stats(config)
    if "mu" in stats and "sigma" in stats:
      out["fid"] = fid_from_stats(pool_acts, stats["mu"], stats["sigma"],
                                  device)
    elif "pool_3" in stats:
      out["fid"] = fid_from_activations(pool_acts, stats["pool_3"], device)
      out["kid"] = kid_from_activations(pool_acts, stats["pool_3"])
  except FileNotFoundError as e:
    logging.warning("%s", e)
  return out
