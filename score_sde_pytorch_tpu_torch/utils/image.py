"""Image grids and PNG files of samples (numpy and PIL).

Copy of score_sde_pytorch_tpu/utils/image.py, so that the port imports
nothing of the JAX package; files are written through ``utils.io``, so a
path may be a URI of a registered scheme.
"""
from __future__ import annotations

import numpy as np


def make_grid(images: np.ndarray, nrow: int = 8, padding: int = 2,
              pad_value: float = 0.0) -> np.ndarray:
  """Tile a [N,H,W,C] float batch (values in [0,1]) into one [H',W',C] image."""
  n, h, w, c = images.shape
  ncol = nrow
  nrows = (n + ncol - 1) // ncol
  grid = np.full((nrows * (h + padding) + padding,
                  ncol * (w + padding) + padding, c), pad_value,
                 dtype=images.dtype)
  for idx in range(n):
    r, col = divmod(idx, ncol)
    top = r * (h + padding) + padding
    left = col * (w + padding) + padding
    grid[top:top + h, left:left + w] = images[idx]
  return grid


def save_image(image: np.ndarray, path: str) -> None:
  """Save a [H,W,C] float image in [0,1] as PNG (cloud-URI transparent)."""
  from PIL import Image
  from score_sde_pytorch_tpu_torch.utils import io as io_utils
  arr = np.clip(np.asarray(image) * 255.0, 0, 255).astype(np.uint8)
  if arr.shape[-1] == 1:
    arr = arr[..., 0]
  with io_utils.open_file(path, "wb") as f:
    Image.fromarray(arr).save(f, format="PNG")
