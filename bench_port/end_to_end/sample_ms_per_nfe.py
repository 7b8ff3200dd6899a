"""Milliseconds of the window per score-network evaluation the sampler's
chains completed in it (host clock; counted by the benchmark's forward
hook)."""


def read(rec: dict, metric: dict):
  nfe = rec["work"].get("nfe")
  if not nfe or not rec["work"].get("chains"):
    return None
  return 1e3 * rec["window_s"] / nfe
