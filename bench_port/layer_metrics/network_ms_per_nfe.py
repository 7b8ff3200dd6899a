"""Device ms per network evaluation of the operations launched inside the
port's ``ncsnpp.forward`` span in the traced segment (``spans.py``)."""
from bench_port import spans


def read(rec: dict, metric: dict):
  return spans.per_nfe_ms(rec, "ncsnpp.forward")
