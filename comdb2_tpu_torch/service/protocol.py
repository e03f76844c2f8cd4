"""Wire protocol of the verifier service — newline-delimited JSON.

One request per line, one reply per line, same line-framing idiom as
the rest of the control plane (``control/pmux.py``'s pmux
conversation, ``workloads/tcp.py``'s SUT protocol): a reply that does
not end in ``\\n`` is truncated and must be treated as lost, never
parsed. JSON (not EDN) frames the envelope because every field is a
scalar; the history payload itself rides INSIDE the envelope as EDN
text — the exact format ``filetest`` reads and the native test clients
emit, so any persisted ``history.edn`` can be submitted unmodified.

Requests::

    {"op": "check", "id": 7, "history": "<EDN ops>",
     "model": "cas-register", "keyed": false, "deadline_ms": 5000}
    {"op": "status"}        {"op": "ping"}        {"op": "shutdown"}

Replies (``id`` echoed when given)::

    {"ok": true, "valid": true|false|"unknown", "op_index": -1,
     "engine": "keys", "bucket": "n64-s32-k2-p4", "batched": 17, ...}
    {"ok": false, "error": "overload" | "bad-request" | ...}

``valid`` is the checker tri-state: ``"unknown"`` carries a ``cause``
(``"deadline"``, ``"frontier overflow"``, ``"malformed"`` …) — the
reference's low-memory-abort contract, never a hang.
"""

from __future__ import annotations

import json
from typing import Optional, Union

# error codes (replies with {"ok": false, "error": <code>})
OVERLOAD = "overload"          # admission queue full — retry later
BAD_REQUEST = "bad-request"    # unparseable envelope or history
SHUTDOWN = "shutting-down"     # daemon is draining

#: ``valid`` values by engine status code (checker.linear_jax order)
STATUS_VALID = (True, False, "unknown")


def verdict(status: int) -> Union[bool, str]:
    """Engine status code -> the ``valid`` tri-state."""
    return STATUS_VALID[int(status)]


def encode(obj: dict) -> bytes:
    """One framed message. Compact separators: replies ride next to
    latency-sensitive traffic."""
    return (json.dumps(obj, separators=(",", ":")) + "\n").encode()


def decode(line: Union[str, bytes]) -> dict:
    """Parse one request line; raises ``ValueError`` on garbage (the
    daemon answers ``bad-request`` instead of dying)."""
    if isinstance(line, bytes):
        line = line.decode("utf-8", errors="replace")
    try:
        obj = json.loads(line)
    except json.JSONDecodeError as e:
        raise ValueError(f"not JSON: {e}") from None
    if not isinstance(obj, dict):
        raise ValueError("request must be a JSON object")
    return obj


def error_reply(code: str, message: str = "",
                rid: Optional[object] = None) -> dict:
    out: dict = {"ok": False, "error": code}
    if message:
        out["message"] = message
    if rid is not None:
        out["id"] = rid
    return out


__all__ = ["OVERLOAD", "BAD_REQUEST", "SHUTDOWN", "STATUS_VALID",
           "verdict", "encode", "decode", "error_reply"]
