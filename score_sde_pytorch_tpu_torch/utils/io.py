"""File I/O that takes URI workdirs through registered scheme handlers.

Copy of score_sde_pytorch_tpu/utils/io.py, so that the port imports nothing
of the JAX package. Every artifact the pipelines write or read (``main``,
``run_lib``, ``checkpoint``, ``utils.image``) goes through these helpers.
Plain local paths use the standard library. A path with a scheme
(``myfs://bucket/run``) goes through the handler registered for its scheme
with :func:`register_scheme`; :class:`LocalMirrorHandler` maps a scheme onto
a local directory. A handler provides ``makedirs``, ``open``, ``exists``,
``listdir`` and ``localize``.

One departure from the JAX package: it sends a scheme without a handler
(``gs://``) to ``tf.io.gfile``, and the port never imports TensorFlow. Here
such a path raises ``ValueError`` naming :func:`register_scheme`; nothing
is ever written to a local directory named after the scheme.
"""
from __future__ import annotations

import os
from typing import IO, Dict, List, Optional

_SCHEME_HANDLERS: Dict[str, object] = {}


def _scheme(path: str) -> Optional[str]:
  if "://" in path:
    return path.split("://", 1)[0]
  return None


class LocalMirrorHandler:
  """Maps ``<scheme>://<rest>`` onto a local directory tree.

  Useful for local mirrors of remote buckets and for testing the pipelines'
  URI-handling end-to-end (the test registers ``myfs://`` → tmpdir and runs
  train+eval with a ``myfs://`` workdir).
  """

  def __init__(self, scheme: str, root: str):
    self.scheme = scheme
    self.root = root

  def localize(self, path: str) -> str:
    rest = path.split("://", 1)[1].lstrip("/")
    return os.path.join(self.root, rest)

  def makedirs(self, path: str) -> None:
    os.makedirs(self.localize(path), exist_ok=True)

  def open(self, path: str, mode: str) -> IO:
    local = self.localize(path)
    if any(m in mode for m in ("w", "a", "+")):
      os.makedirs(os.path.dirname(local), exist_ok=True)
    return open(local, mode)

  def exists(self, path: str) -> bool:
    return os.path.exists(self.localize(path))

  def listdir(self, path: str) -> List[str]:
    return os.listdir(self.localize(path))


def register_scheme(scheme: str, handler) -> None:
  _SCHEME_HANDLERS[scheme] = handler


def unregister_scheme(scheme: str) -> None:
  _SCHEME_HANDLERS.pop(scheme, None)


def _handler(path: str):
  """Handler for a path, or None when the path is plain-local. A scheme
  with no registered handler raises."""
  scheme = _scheme(path)
  if scheme is None:
    return None
  try:
    return _SCHEME_HANDLERS[scheme]
  except KeyError:
    raise ValueError(
        f"{path}: no handler for the scheme {scheme}://. Register one with "
        "score_sde_pytorch_tpu_torch.utils.io.register_scheme (for example "
        f"register_scheme({scheme!r}, LocalMirrorHandler({scheme!r}, "
        "'/local/mirror'))); the port has no built-in remote filesystem"
    ) from None


def makedirs(path: str) -> None:
  h = _handler(path)
  if h is None:
    os.makedirs(path, exist_ok=True)
  else:
    h.makedirs(path)


def open_file(path: str, mode: str = "rb") -> IO:
  h = _handler(path)
  if h is None:
    return open(path, mode)
  return h.open(path, mode)


def exists(path: str) -> bool:
  h = _handler(path)
  if h is None:
    return os.path.exists(path)
  return h.exists(path)


def listdir(path: str) -> List[str]:
  h = _handler(path)
  if h is None:
    return os.listdir(path)
  return h.listdir(path)


def localize(path: str) -> str:
  """Local filesystem path when the scheme handler can provide one, else
  the path unchanged. For libraries that do their own I/O (TensorBoard's
  writer): mirror-backed schemes translate to their local root."""
  h = _handler(path)
  if h is None:
    return path
  return h.localize(path)


def save_npz(path: str, **arrays) -> None:
  """np.savez_compressed through the scheme handler when needed."""
  import numpy as np
  h = _handler(path)
  if h is None:
    np.savez_compressed(path, **arrays)
    return
  import io as _io
  buf = _io.BytesIO()
  np.savez_compressed(buf, **arrays)
  with open_file(path, "wb") as f:
    f.write(buf.getvalue())


def save_npy(path: str, array) -> None:
  """np.save through the scheme handler (same ``.npy``-appending semantics
  as np.save on a string path)."""
  import numpy as np
  if not path.endswith(".npy"):
    path = path + ".npy"
  h = _handler(path)
  if h is None:
    np.save(path, array)
    return
  import io as _io
  buf = _io.BytesIO()
  np.save(buf, array)
  with open_file(path, "wb") as f:
    f.write(buf.getvalue())


def load_npz(path: str):
  """np.load of an .npz through the scheme handler; returns a dict."""
  import numpy as np
  with open_file(path, "rb") as f:
    with np.load(f) as z:
      return {k: z[k] for k in z.files}
