"""Device ms per network evaluation of the operations launched inside the
port's ``pc.step`` spans and outside its ``ncsnpp.forward`` spans (every
evaluation of a PC chain is inside a ``pc.step``): the sampler's own
updates and draws, in the traced segment (``spans.py``)."""
from bench_port import spans


def read(rec: dict, metric: dict):
  return spans.per_nfe_ms(rec, "pc.step", less="ncsnpp.forward")
