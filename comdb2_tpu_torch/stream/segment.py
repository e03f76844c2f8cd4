"""Incremental segmentation + slot renaming — the delta form of
``make_segments`` + ``remap_slots``.

Feeds on newly SETTLED row slices (:class:`~.ingest.StreamIngest`):
each settled ok-op closes one segment carrying the invokes since the
previous ok, with two pieces of state carried across deltas —

- the **tail**: settled invokes after the last settled ok. One-shot
  ``make_segments`` drops invokes after the FINAL ok (a pending call
  only adds orders); mid-stream they are simply the next segment's
  prefix, so the tail re-attaches at the front of the next delta's
  first segment and the concatenated segment stream is bit-identical
  to a one-shot segmentation of the full history.
- the **renamer**: ``remap_slots``' sequential lowest-free-slot
  allocation state (open slot per process, free heap, owner rows).
  The assignment is a pure function of the segment sequence, so
  carrying it across deltas reproduces the one-shot renaming
  bit-for-bit — and P_eff (the engines' slot width) grows only when
  the live history's real concurrency does.

Depth bookkeeping (the exact closure-iteration bound per ok) carries
the running pending count the same way. Everything retained here —
the renamed segment stream and the per-segment owner maps — IS the
session's replay/decode source: engine re-routes (kernel overflow,
MXU re-plan) re-dispatch these arrays, and counterexample decode maps
renamed slots back through the owner rows.

The counterpart of the JAX package's ``stream/segment.py`` (host
numpy only).
"""

from __future__ import annotations

import heapq
from typing import Dict, List

import numpy as np

from ..ops.op import FAIL, INVOKE, OK
from .ingest import StreamIngest, _Grow


class _Grow2:
    """Row-growable, width-widenable 2-D int32 buffer (segments are
    retained for the session's lifetime; K/P widen on demand)."""

    __slots__ = ("_buf", "n", "fill")

    def __init__(self, width: int = 1, fill: int = -1, cap: int = 64):
        self.fill = fill
        self._buf = np.full((cap, max(width, 1)), fill, np.int32)
        self.n = 0

    @property
    def width(self) -> int:
        return self._buf.shape[1]

    def widen(self, width: int) -> None:
        if width > self._buf.shape[1]:
            pad = width - self._buf.shape[1]
            self._buf = np.pad(self._buf, ((0, 0), (0, pad)),
                               constant_values=self.fill)

    def extend(self, rows: np.ndarray) -> None:
        rows = np.asarray(rows, np.int32)
        self.widen(rows.shape[1])
        need = self.n + rows.shape[0]
        if need > self._buf.shape[0]:
            cap = self._buf.shape[0]
            while cap < need:
                cap *= 2
            nb = np.full((cap, self._buf.shape[1]), self.fill,
                         np.int32)
            nb[:self.n] = self._buf[:self.n]
            self._buf = nb
        self._buf[self.n:need, :rows.shape[1]] = rows
        self._buf[self.n:need, rows.shape[1]:] = self.fill
        self.n = need

    @property
    def a(self) -> np.ndarray:
        return self._buf[:self.n]


class StreamSegmenter:
    """See module docstring."""

    def __init__(self) -> None:
        self.pending = 0
        self._tail_proc: List[int] = []
        self._tail_tr: List[int] = []
        # renamer state (remap_slots', carried across deltas)
        self._slot_of: Dict[int, int] = {}
        self._free: List[int] = []
        self._owners: List[int] = []
        self.p_eff = 0
        # retained renamed segment stream
        self.inv_slot = _Grow2(1, fill=-1)
        self.inv_tr = _Grow2(1, fill=0)
        self.ok_slot = _Grow(np.int32)
        self.depth = _Grow(np.int32)
        self.seg_row = _Grow(np.int64)      # segment -> history row
        self.owner_map = _Grow2(1, fill=-1)  # segment -> proc of slot

    @property
    def n_segments(self) -> int:
        return self.ok_slot.n

    @property
    def k_max(self) -> int:
        return max(self.inv_slot.width, 1)

    def feed(self, ing: StreamIngest, lo: int, hi: int):
        """Consume the settled rows ``[lo, hi)``; returns the new
        segment range ``(s_lo, s_hi)``."""
        s_lo = self.n_segments
        if hi <= lo:
            return s_lo, s_lo
        t, proc, trans, fails, pair = ing.settled_slice(lo, hi)
        vinv = (t == INVOKE) & ~fails
        okm = t == OK
        # a completion removes a pending call iff its paired invoke is
        # a NON-FAILING invoke (make_segments' removal flags, resolved
        # through the global pair column — the invoke may sit in an
        # earlier settled batch)
        compm = (okm | (t == FAIL)) & (pair >= 0)
        removal = np.zeros(hi - lo, bool)
        if compm.any():
            prows = pair[compm]
            removal[compm] = ((ing.type.a[prows] == INVOKE)
                              & ~ing.fails.a[prows])
        cv = np.cumsum(vinv)
        cr = np.cumsum(removal)
        ok_idx = np.flatnonzero(okm)
        n_ok = ok_idx.size
        depth = (self.pending + cv[ok_idx]
                 - (cr[ok_idx] - removal[ok_idx])).astype(np.int32)
        self.pending += int(cv[-1] - cr[-1]) if hi > lo else 0
        inv_rows = np.flatnonzero(vinv)
        seg_of = (np.cumsum(okm) - okm)[inv_rows]
        keep = seg_of < n_ok
        if n_ok == 0:
            self._tail_proc.extend(proc[inv_rows].tolist())
            self._tail_tr.extend(trans[inv_rows].tolist())
            return s_lo, s_lo
        # per-segment invoke lists: tail + this slice's invokes, in
        # row order (columnar split; the rename below is the only
        # sequential pass, exactly like remap_slots)
        ip = proc[inv_rows[keep]].tolist()
        it = trans[inv_rows[keep]].tolist()
        bounds = np.searchsorted(seg_of[keep], np.arange(n_ok + 1))
        seg_proc: List[List[int]] = []
        seg_tr: List[List[int]] = []
        for s in range(n_ok):
            a, b = int(bounds[s]), int(bounds[s + 1])
            if s == 0:
                seg_proc.append(self._tail_proc + ip[a:b])
                seg_tr.append(self._tail_tr + it[a:b])
            else:
                seg_proc.append(ip[a:b])
                seg_tr.append(it[a:b])
        # invokes after the slice's last ok become the new tail
        tail_rows = inv_rows[~keep]
        self._tail_proc = proc[tail_rows].tolist()
        self._tail_tr = trans[tail_rows].tolist()
        self._rename(seg_proc, seg_tr, proc[ok_idx].tolist(),
                     depth, (ok_idx + lo).astype(np.int64))
        return s_lo, self.n_segments

    # -- the carried remap_slots loop ----------------------------------

    def _rename(self, seg_proc, seg_tr, ok_procs, depth, rows) -> None:
        """Port of :func:`~..checker.linear_torch.remap_slots`
        with persistent allocation state — identical output to the
        one-shot pass over the concatenated segment stream."""
        n_ok = len(ok_procs)
        K_new = max(max((len(s) for s in seg_proc), default=1), 1)
        out_ip = np.full((n_ok, max(K_new, self.inv_slot.width)),
                         -1, np.int32)
        out_it = np.zeros_like(out_ip)
        out_ok = np.empty(n_ok, np.int32)
        owners_rows = []
        for s in range(n_ok):
            for k, p in enumerate(seg_proc[s]):
                if p in self._slot_of:
                    raise ValueError(
                        f"process {p} invokes in segment "
                        f"{self.n_segments + s} while an earlier "
                        "invocation is still open")
                if self._free:
                    sl = heapq.heappop(self._free)
                else:
                    sl = self.p_eff
                    self.p_eff += 1
                    self._owners.append(-1)
                self._slot_of[p] = sl
                self._owners[sl] = p
                out_ip[s, k] = sl
                out_it[s, k] = seg_tr[s][k]
            o = ok_procs[s]
            sl = self._slot_of.pop(o, None)
            if sl is None:
                # ok without an open invocation: any free slot is IDLE
                # in every config — reference one (fresh if none),
                # leaving it free (remap_slots' unmatched-ok branch)
                if self._free:
                    out_ok[s] = self._free[0]
                else:
                    out_ok[s] = self.p_eff
                    self.p_eff += 1
                    self._owners.append(-1)
                    heapq.heappush(self._free, int(out_ok[s]))
            else:
                out_ok[s] = sl
                self._owners[sl] = -1
                heapq.heappush(self._free, sl)
            owners_rows.append(self._owners[:])
        self.inv_slot.extend(out_ip)
        self.inv_tr.extend(out_it)
        self.ok_slot.extend(out_ok)
        self.depth.extend(depth)
        self.seg_row.extend(rows)
        om = np.full((n_ok, max(self.p_eff, 1)), -1, np.int32)
        for s, row in enumerate(owners_rows):
            if row:
                om[s, :len(row)] = row
        self.owner_map.extend(om)

    # -- checkpoint / restore ------------------------------------------

    def checkpoint(self) -> dict:
        """Host snapshot: the carried renamer/tail state plus the
        retained renamed segment stream (the session's replay/decode
        source — without it a restored session could never re-route)."""
        return {
            "pending": int(self.pending),
            "tail_proc": list(self._tail_proc),
            "tail_tr": list(self._tail_tr),
            "slot_of": {int(k): int(v)
                        for k, v in self._slot_of.items()},
            "free": [int(x) for x in self._free],
            "owners": [int(x) for x in self._owners],
            "p_eff": int(self.p_eff),
            "inv_slot": self.inv_slot.a.copy(),
            "inv_tr": self.inv_tr.a.copy(),
            "ok_slot": self.ok_slot.a.copy(),
            "depth": self.depth.a.copy(),
            "seg_row": self.seg_row.a.copy(),
            "owner_map": self.owner_map.a.copy(),
        }

    @classmethod
    def restore(cls, ck: dict) -> "StreamSegmenter":
        seg = cls()
        seg.pending = int(ck["pending"])
        seg._tail_proc = [int(x) for x in ck["tail_proc"]]
        seg._tail_tr = [int(x) for x in ck["tail_tr"]]
        seg._slot_of = {int(k): int(v)
                        for k, v in ck["slot_of"].items()}
        # a copied heap list keeps the heap invariant — no re-heapify
        seg._free = [int(x) for x in ck["free"]]
        seg._owners = [int(x) for x in ck["owners"]]
        seg.p_eff = int(ck["p_eff"])
        for name in ("inv_slot", "inv_tr", "ok_slot", "depth",
                     "seg_row", "owner_map"):
            buf = getattr(seg, name)
            buf.extend(np.asarray(ck[name]).astype(buf.a.dtype))
        return seg

    # -- dispatch views ------------------------------------------------

    def padded(self, s_lo: int, s_hi: int, s_pad: int, k_pad: int):
        """(inv_slot, inv_tr, ok_slot, depth) of segments
        ``[s_lo, s_hi)`` padded to ``(s_pad, k_pad)`` — the delta
        tensors one dispatch consumes (dead segments are ok=-1
        no-ops, exactly the batch path's padding)."""
        n = s_hi - s_lo
        assert n <= s_pad and self.k_max <= k_pad
        ip = np.full((s_pad, k_pad), -1, np.int32)
        it = np.zeros((s_pad, k_pad), np.int32)
        okp = np.full(s_pad, -1, np.int32)
        dp = np.zeros(s_pad, np.int32)
        w = self.inv_slot.width
        ip[:n, :w] = self.inv_slot.a[s_lo:s_hi]
        it[:n, :w] = self.inv_tr.a[s_lo:s_hi]
        okp[:n] = self.ok_slot.a[s_lo:s_hi]
        dp[:n] = self.depth.a[s_lo:s_hi]
        return ip, it, okp, dp


__all__ = ["StreamSegmenter"]
