"""Device ms per network evaluation of the operations launched inside the
port's ``op.fir`` spans (the depthwise FIR filter every FIR path runs) in
the traced segment (``spans.py``)."""
from bench_port import spans


def read(rec: dict, metric: dict):
  return spans.per_nfe_ms(rec, "op.fir")
