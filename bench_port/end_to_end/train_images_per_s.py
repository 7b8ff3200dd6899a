"""Images trained in the window over the window's seconds (host clock; the
window ends when the card has finished its last step)."""


def read(rec: dict, metric: dict):
  images = rec["work"].get("images")
  return images / rec["window_s"] if images else None
