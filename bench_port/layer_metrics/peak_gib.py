"""The card's peak of allocated memory over set-up, window and traced
segment (``torch.cuda.max_memory_allocated`` after a reset before the
model is built), GiB."""


def read(rec: dict, metric: dict):
  return rec["peak_bytes"] / 2 ** 30 if rec.get("peak_bytes") else None
