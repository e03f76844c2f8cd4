"""Checkpoint wire codec — JSON-safe encoding of session snapshots.

A :meth:`~.session.StreamSession.checkpoint` is a host-side dict of
numpy arrays, tuples and id tables. Two forms exist:

- the **in-process** form (the dict itself) — what
  :class:`~.manager.SessionManager` retains for eviction-without-
  replay; zero serialization cost.
- the **wire** form (:func:`to_wire` / :func:`from_wire`) — a pure
  JSON document, so a session can move between processes as text.

The encoding is self-describing and reversible: numpy arrays ship as
base64 ``.npy`` payloads (dtype + shape preserved, ``allow_pickle``
off on both sides), tuples are tagged (EDN ``[k v]`` values parse as
plain tuples and the id tables key on them — a JSON round-trip that
lowered tuples to lists would silently re-intern every keyed value),
and dicts with non-string keys ship as tagged item lists. The codec is
the JAX package's ``stream/checkpoint.py``: the same dict encodes to
the same bytes in both packages. Everything here is host data; no
tensor enters a checkpoint.
"""

from __future__ import annotations

import base64
import io
import json
from typing import Any

import numpy as np

_ND, _TU, _DI = "__nd__", "__tu__", "__di__"
_TAGS = (_ND, _TU, _DI)


def _enc_array(a: np.ndarray) -> dict:
    buf = io.BytesIO()
    np.save(buf, a, allow_pickle=False)
    return {_ND: base64.b64encode(buf.getvalue()).decode("ascii")}


def _dec_array(payload: str) -> np.ndarray:
    buf = io.BytesIO(base64.b64decode(payload.encode("ascii")))
    return np.load(buf, allow_pickle=False)


def to_wire(obj: Any) -> Any:
    """Checkpoint dict -> JSON-safe document (see module docstring)."""
    if isinstance(obj, np.ndarray):
        return _enc_array(obj)
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, tuple):
        return {_TU: [to_wire(x) for x in obj]}
    if isinstance(obj, list):
        return [to_wire(x) for x in obj]
    if isinstance(obj, dict):
        if all(isinstance(k, str) and k not in _TAGS for k in obj):
            return {k: to_wire(v) for k, v in obj.items()}
        return {_DI: [[to_wire(k), to_wire(v)]
                      for k, v in obj.items()]}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    raise TypeError(
        f"checkpoint value of type {type(obj).__name__} is not "
        "wire-encodable")


def from_wire(obj: Any) -> Any:
    """Inverse of :func:`to_wire` (tuples and non-string dict keys
    come back as the hashables the id tables key on)."""
    if isinstance(obj, dict):
        if _ND in obj:
            return _dec_array(obj[_ND])
        if _TU in obj:
            return tuple(from_wire(x) for x in obj[_TU])
        if _DI in obj:
            return {from_wire(k): from_wire(v) for k, v in obj[_DI]}
        return {k: from_wire(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [from_wire(x) for x in obj]
    return obj


def wire_nbytes(wire: Any) -> int:
    """Size of the encoded document — the ``checkpoint_bytes``
    metric's honest number (what actually crosses the socket)."""
    return len(json.dumps(wire, separators=(",", ":")).encode())


__all__ = ["from_wire", "to_wire", "wire_nbytes"]
