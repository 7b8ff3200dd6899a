"""Forward device ms a train step of the operations launched inside the
port's span of NCSN++'s full-resolution level (the largest
``ncsnpp.res<R>``: ``conv_in``, that level's resblocks and pyramid steps,
the output head) in the traced segment (``level_spans.py``)."""


def read(rec: dict, metric: dict):
  spans = rec.get("spans") or {}
  steps = (rec.get("trace_work") or {}).get("steps")
  sizes = [int(name[len("ncsnpp.res"):]) for name in spans
           if name.startswith("ncsnpp.res")]
  if not sizes or not steps:
    return None
  return 1e3 * spans[f"ncsnpp.res{max(sizes)}"]["device_s"] / steps
