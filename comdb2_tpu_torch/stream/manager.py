"""Session table — ids, caps, checkpoint eviction, carry accounting.

The counterpart of the JAX package's ``stream/manager.py``: one
:class:`SessionManager` resolves session ids for a process that serves
many live histories. Guards:

- ``max_sessions``: a carry is real device memory — the cap answers
  ``open`` with :class:`SessionLimit` instead of silently running the
  card out of memory under a session flood.
- idle eviction is **checkpoint-not-replay**: a session nobody
  appended to for ``idle_s`` snapshots to a host-numpy checkpoint
  (:meth:`~.session.StreamSession.checkpoint`) and releases its device
  carry; the next call naming the id restores it transparently, with
  no client replay and no re-dispatch. Checkpoints are bounded
  (``max_checkpoints``, FIFO).
- migration: :meth:`checkpoint` hands a session's snapshot out and
  :meth:`open_restored` accepts one (from this package, or from the
  JAX package through ``convert.session_checkpoint``) — O(carry), zero
  device replay.

Every session of one manager lives on the manager's ``device``
(``None`` means ``cuda``, which raises on a host without a card).
"""

from __future__ import annotations

import itertools
import os
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from ..obs import trace as _obs
from ..utils import resolve_device
from . import wl as _wl
from .session import StreamSession


def _restore(ck: dict, device):
    """Checkpoint router: wl-family checkpoints carry the
    ``wl_family`` discriminator; everything else is a frontier
    session's."""
    if ck.get("wl_family"):
        return _wl.restore_session(ck, device=device)
    return StreamSession.restore(ck, device=device)


class SessionLimit(Exception):
    """``max_sessions`` reached — the caller sheds the open (a
    server answers it as overload)."""


class SessionManager:
    """See module docstring. All times are ``obs.trace.monotonic``
    floats passed in by the caller (the caller owns the clock)."""

    def __init__(self, max_sessions: int = 64,
                 idle_s: float = 300.0,
                 max_checkpoints: int = 256, device=None):
        self.device = resolve_device(device)
        self.max_sessions = int(max_sessions)
        self.idle_s = float(idle_s)
        self.max_checkpoints = int(max_checkpoints)
        self._sessions: Dict[str, StreamSession] = {}
        self._touched: Dict[str, float] = {}
        #: evicted sessions' host checkpoints, FIFO-bounded
        self._checkpoints: "OrderedDict[str, dict]" = OrderedDict()
        self._seq = itertools.count()
        self.evictions = 0
        self.restores = 0
        self.opened = 0

    def __len__(self) -> int:
        return len(self._sessions)

    def open(self, now: float, model: str = "cas-register",
             engine: str = "auto", max_states: int = 1 << 20,
             wl: Optional[dict] = None) -> Tuple[str, StreamSession]:
        if len(self._sessions) >= self.max_sessions:
            raise SessionLimit(
                f"session table at cap ({self.max_sessions})")
        sid = self._new_sid()
        if model in _wl.WL_MODELS:
            # workload-family session (stream/wl.py): same table,
            # caps, eviction and checkpoint discipline
            s = _wl.make_session(model, wl, device=self.device)
        else:
            s = StreamSession(model=model, engine=engine,
                              max_states=max_states, device=self.device)
        self._sessions[sid] = s
        self._touched[sid] = now
        self.opened += 1
        return sid, s

    def open_restored(self, now: float,
                      ck: dict) -> Tuple[str, StreamSession]:
        """Admit a migrated session from its checkpoint (the
        open-with-checkpoint handoff). Same cap as :meth:`open` — a
        shed migration surfaces as overload and the client falls back
        to retained-delta replay elsewhere."""
        if len(self._sessions) >= self.max_sessions:
            raise SessionLimit(
                f"session table at cap ({self.max_sessions})")
        s = _restore(ck, self.device)
        sid = self._new_sid()
        self._sessions[sid] = s
        self._touched[sid] = now
        self.opened += 1
        return sid, s

    def _new_sid(self) -> str:
        return f"s{next(self._seq)}-{os.urandom(3).hex()}"

    def get(self, sid, now: Optional[float] = None
            ) -> Optional[StreamSession]:
        s = self._sessions.get(sid)
        if s is None and sid in self._checkpoints:
            # checkpoint eviction's other half: restore transparently.
            # Deliberately allowed to run the table transiently past
            # max_sessions — the cap gates NEW carries (opens); a
            # restore re-admits state a client already owns, and
            # bouncing it would only trade a cheap upload for a full
            # client replay.
            ck = self._checkpoints.pop(sid)
            s = _restore(ck, self.device)
            self._sessions[sid] = s
            self.restores += 1
            if now is not None:
                _obs.record("stream.restore", now, now, sid=sid)
        if s is not None and now is not None:
            self._touched[sid] = now
        return s

    def close(self, sid) -> Optional[dict]:
        # a checkpointed session still closes cleanly: restore (via
        # get) settles nothing by itself; close() then runs the final
        # tail settle against the restored carry
        s = self.get(sid)
        self._sessions.pop(sid, None)
        self._touched.pop(sid, None)
        if s is None:
            return None
        return s.close()

    def checkpoint(self, sid) -> Optional[dict]:
        """Snapshot one session (the migration handoff's read half).
        The caller :meth:`drop`s it AFTER the snapshot is safely
        encoded/delivered — a handoff MOVES the session (two
        processes serving it would double-serve its appends), but releasing
        before the checkpoint provably left this process would LOSE
        it on an encode failure."""
        ck = self._checkpoints.get(sid)
        if ck is not None:
            # idle-evicted: the held host snapshot IS the requested
            # artifact. Restoring just to re-snapshot would replay the
            # memo extend log to hand the same snapshot out. The
            # caller's drop() discards this entry on release like any
            # resident session.
            return ck
        s = self.get(sid)
        if s is None:
            return None
        return s.checkpoint()

    def drop(self, sid) -> None:
        """Remove a session and free its carry WITHOUT the final tail
        settle (the handoff's release half; also discards any held
        checkpoint under the same id)."""
        s = self._sessions.pop(sid, None)
        self._touched.pop(sid, None)
        self._checkpoints.pop(sid, None)
        if s is not None:
            s.release()

    def evict_idle(self, now: float) -> List[str]:
        """Checkpoint-and-release every session idle past the TTL
        (device carry freed; the host checkpoint keeps the session
        resumable with zero replay)."""
        out = []
        for sid, t in list(self._touched.items()):
            if now - t >= self.idle_s:
                s = self._sessions.pop(sid, None)
                self._touched.pop(sid, None)
                if s is not None:
                    # the snapshot itself forces any in-flight staged
                    # append through its (idempotent) finalize — a
                    # staged dispatch never reads a released engine
                    self._checkpoints[sid] = s.checkpoint()
                    while len(self._checkpoints) > self.max_checkpoints:
                        self._checkpoints.popitem(last=False)
                    s.release()
                    out.append(sid)
                    self.evictions += 1
                    _obs.record("stream.evict", now, now, sid=sid)
        return out

    def carry_bytes(self) -> int:
        """DEVICE bytes held by resident carries (checkpointed
        sessions hold host memory only — see
        :meth:`checkpoint_count`)."""
        return sum(s.carry_nbytes()
                   for s in self._sessions.values())

    def checkpoint_count(self) -> int:
        return len(self._checkpoints)


__all__ = ["SessionLimit", "SessionManager"]
