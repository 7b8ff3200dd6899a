"""Forward device ms a train step of the operations launched inside the
port's ``ncsnpp.pyramid`` spans (each step of NCSN++'s input and output
pyramids: FIR resampling, combine, norm and conv) in the traced segment
(``level_spans.py``)."""


def read(rec: dict, metric: dict):
  spans = rec.get("spans") or {}
  steps = (rec.get("trace_work") or {}).get("steps")
  if "ncsnpp.pyramid" not in spans or not steps:
    return None
  return 1e3 * spans["ncsnpp.pyramid"]["device_s"] / steps
