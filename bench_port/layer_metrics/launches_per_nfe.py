"""Device operations (kernels, copies, sets) in the traced segment per
network evaluation."""


def read(rec: dict, metric: dict):
  summary, work = rec.get("trace") or {}, rec.get("trace_work") or {}
  if not summary.get("launches") or not work.get("nfe"):
    return None
  return summary["launches"] / work["nfe"]
