"""Per cent of its roofline that attention reaches in the traced segment:
the least time of every attention call, forward and backward, from its
shapes (``counters/attention.py``), over the device time of the kernels
launched inside the benchmark's spans around the program's attention
entry and its backward launcher."""
from bench_port.counters import attention, peaks


def read(rec: dict, metric: dict):
  summary, calls = rec.get("trace") or {}, rec.get("attention_calls") or []
  device_s = summary.get("attention_device_s", 0.0)
  if not calls or not device_s or not peaks.known(rec.get("device_name", "")):
    return None
  bound = sum(attention.bound_seconds(b, nq, nkv, c, dtype, bwd,
                                      rec["device_name"])[0]
              for b, nq, nkv, c, dtype, bwd in calls)
  return 100.0 * bound / device_s
