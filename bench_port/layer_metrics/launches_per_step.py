"""Device operations (kernels, copies, sets) in the traced segment per
train step: a count, the same on every run of a seed."""


def read(rec: dict, metric: dict):
  summary, work = rec.get("trace") or {}, rec.get("trace_work") or {}
  if not summary.get("launches") or not work.get("steps"):
    return None
  return summary["launches"] / work["steps"]
