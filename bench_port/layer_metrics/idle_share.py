"""Per cent of the traced window in which no kernel, copy or set ran on
the card: 1 - (union of the device intervals / the window), both from the
same trace."""


def read(rec: dict, metric: dict):
  summary = rec.get("trace") or {}
  if not summary.get("window_s") or not summary.get("launches"):
    return None
  return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
