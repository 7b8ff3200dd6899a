"""Published dense peaks of the cards the benchmark knows, by the name
``torch.cuda.get_device_name()`` gives. A card not listed has no peak,
and the shares of a peak are then not reported.

NVIDIA H100 SXM5 (NVIDIA's data sheet, dense, without sparsity, at its
700 W limit): 989 TFLOP/s bf16, 495 TFLOP/s TF32, 67 TFLOP/s fp32 off the
tensor cores, 3.35 TB/s of HBM3.
"""
from __future__ import annotations

CARDS = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989e12, "tf32": 495e12,
                              "fp32": 67e12, "hbm_bytes_per_s": 3.35e12},
}


def card(name: str) -> dict:
  if name not in CARDS:
    raise KeyError(f"no published peak for {name!r}")
  return CARDS[name]


def known(name: str) -> bool:
  return name in CARDS
