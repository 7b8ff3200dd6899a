"""The plain reference the benchmark holds the program to: plain PyTorch
and NumPy, nothing of the program under test and nothing it made."""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def plain_precision():
  """float32 products in full float32: TF32 off for cuDNN and for matmuls
  while the reference runs, the flags put back after."""
  saved = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  try:
    yield
  finally:
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved
