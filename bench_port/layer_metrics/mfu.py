"""Per cent of the card's dense peak that the window's model FLOPs reach:
FLOPs counted from the configuration's shapes (``counters/ncsnpp.py``)
times the work completed in the measured window, over the window's
seconds, over the published peak of the precision the convolutions run in
(the configuration's ``conv_peak``). A card without a published peak
reports nothing."""
from bench_port import registry
from bench_port.counters import peaks


def read(rec: dict, metric: dict):
  if not peaks.known(rec.get("device_name", "")):
    return None
  config = registry.config(rec["config"])
  flops = sum(per * rec["work"].get(unit, 0)
              for unit, per in rec["flops"].items())
  if not flops:
    return None
  peak = peaks.card(rec["device_name"])[config["conv_peak"]]
  return 100.0 * flops / rec["window_s"] / peak
