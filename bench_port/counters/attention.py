"""The least time an attention call can take on the card.

softmax(q kᵀ/√C) v with q of [B, N_q, C] and k, v of [B, N_kv, C]: the
larger of its operations at the dense peak of the precision and its bytes
at the memory bandwidth, each input read once and each output written
once. Forward: 4·B·N_q·N_kv·C operations (two products); q and the output
over N_q, k and v over N_kv. Backward: 10·B·N_q·N_kv·C (the scores again,
then four products); q, o, dO, dq over N_q, k, v, dk, dv over N_kv, and
the fp32 row log-sum-exp read.
"""
from __future__ import annotations

from bench_port.counters import peaks

_BYTES = {"float32": 4, "bfloat16": 2}


def bound_seconds(b: int, n_q: int, n_kv: int, c: int, dtype: str,
                  backward: bool, device: str) -> tuple:
  """``(seconds, "ops" or "bytes")`` for one call on ``device``."""
  card = peaks.card(device)
  es = _BYTES[dtype]
  if backward:
    ops = 10 * b * n_q * n_kv * c
    moved = 4 * b * n_q * c * es + 4 * b * n_kv * c * es + 4 * b * n_q
  else:
    ops = 4 * b * n_q * n_kv * c
    moved = 2 * b * n_q * c * es + 2 * b * n_kv * c * es
  peak = card["tf32" if dtype == "float32" else "bf16"]
  t_ops, t_bytes = ops / peak, moved / card["hbm_bytes_per_s"]
  return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")
