"""Host ms a train step spent waiting for the input pipeline over the
untraced window: the port's ``data.wait`` counter (the wait on the
prefetching iterator's queue) over the ``train.step`` counter's count."""


def read(rec: dict, metric: dict):
  counters = rec.get("program_counters") or {}
  step, wait = counters.get("train.step"), counters.get("data.wait")
  if not step or not step["count"] or wait is None:
    return None
  return 1e3 * wait["seconds"] / step["count"]
