"""Device ms per network evaluation of the operations launched inside the
port's ``op.norm_act`` spans (each GroupNorm of NCSN++ with the activation
after it) in the traced segment (``spans.py``)."""
from bench_port import spans


def read(rec: dict, metric: dict):
  return spans.per_nfe_ms(rec, "op.norm_act")
