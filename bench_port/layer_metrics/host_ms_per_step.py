"""Host ms a train step spent inside the program's step function over the
untraced window: the port's ``train.step`` counter (seconds by
``time.perf_counter`` around the step's body) over its count."""


def read(rec: dict, metric: dict):
  step = (rec.get("program_counters") or {}).get("train.step")
  if not step or not step["count"]:
    return None
  return 1e3 * step["seconds"] / step["count"]
