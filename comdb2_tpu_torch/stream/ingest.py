"""Incremental columnar ingest — the delta form of the pack path.

A streaming session receives a live history as append-only op deltas;
this module grows the same struct-of-arrays columns the one-shot
packer (:mod:`..ops.columnar`) produces, delta by delta, and
never re-touches a row twice. Two invariants carry the whole design:

- **Settled rows are final.** ``history.complete`` back-fills an
  invocation's value (and ``fails`` bit) from its completion, which
  may arrive in a LATER delta — so a row only *settles* (gets its
  value/transition interned and becomes visible to segmentation) once
  every invoke at or before it is *resolved* (its completion arrived,
  or an ``:info`` row retired its process, pinning the invoked value
  forever). The settled prefix therefore grows monotonically behind a
  watermark (the earliest unresolved invoke), and everything emitted
  for the device is bit-identical to what the one-shot pack of the
  full history would have produced for those rows.
- **Intern order is row order.** process/f ids intern at arrival
  (arrival order == row order), value/transition ids intern at
  settlement in row order — exactly the first-occurrence order of the
  one-shot packer, so id tables are PREFIXES of the one-shot tables
  and every engine key layout agrees with a post-hoc re-check.

The arrival pass touches each Op object once (the API edge, same as
``pack_history_columnar``); pairing, double-pending validation and
back-fill bookkeeping ride the shared per-process chain machinery
(``ops.columnar._per_process_prev``) with the open-call state carried
across deltas. No loop walks ``.ops``.

The counterpart of the JAX package's ``stream/ingest.py``; host numpy
only, so both packages settle the same rows into the same columns.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..ops.columnar import _per_process_prev
from ..ops.op import FAIL, INFO, INVOKE, OK, TYPE_CODES, Op


class _Grow:
    """Capacity-doubling 1-D numpy buffer (amortized O(1) append —
    ``np.append`` per delta would make a long session O(n^2))."""

    __slots__ = ("_buf", "n")

    def __init__(self, dtype, cap: int = 64):
        self._buf = np.zeros(cap, dtype)
        self.n = 0

    def extend(self, arr) -> None:
        arr = np.asarray(arr)
        need = self.n + arr.shape[0]
        if need > self._buf.shape[0]:
            cap = self._buf.shape[0]
            while cap < need:
                cap *= 2
            nb = np.zeros(cap, self._buf.dtype)
            nb[:self.n] = self._buf[:self.n]
            self._buf = nb
        self._buf[self.n:need] = arr
        self.n = need

    @property
    def a(self) -> np.ndarray:
        """The live view (length ``n``)."""
        return self._buf[:self.n]

    def __len__(self) -> int:
        return self.n


class MalformedDelta(ValueError):
    """A delta violates the per-process invoke/complete discipline —
    the session's analog of ``history.complete``'s RuntimeErrors; the
    session latches ``unknown`` with a ``malformed:`` cause."""


class StreamIngest:
    """See module docstring. Drives: ``append(ops)`` ingests one delta
    and returns the newly settled row range ``(lo, hi)``;
    ``finalize()`` force-resolves the remaining open invokes (end of
    stream: their values stay as invoked, exactly like a one-shot pack
    of the full history) and settles the tail."""

    def __init__(self) -> None:
        self._proc_ids: Dict = {}
        self.process_table: List = []
        self._f_ids: Dict = {}
        self.f_table: List = []
        self._val_ids: Dict = {}
        self.value_table: List = []
        self._tr_ids: Dict = {}
        self.transition_table: List[tuple] = []
        # arrival columns (full history)
        self.type = _Grow(np.int8)
        self.proc = _Grow(np.int32)
        self.f = _Grow(np.int32)
        self.raw_values: List = []      # back-filled in place pre-settle
        self.fails = _Grow(np.bool_)
        self.time = _Grow(np.int64)
        self.pair = _Grow(np.int32)
        # settled columns (prefix)
        self.value = _Grow(np.int32)
        self.trans = _Grow(np.int32)
        self.settled = 0
        #: non-failing invokes among settled rows — the memo depth bound
        self.n_invokes_settled = 0
        # per-process open-call state: proc_id -> open invoke row
        self._open_row: Dict[int, int] = {}
        #: open invokes whose completion has NOT arrived (the watermark
        #: blockers); an :info retirement resolves without closing
        self._unresolved: Dict[int, int] = {}
        self.finalized = False

    def __len__(self) -> int:
        return self.type.n

    # -- arrival -------------------------------------------------------

    def _intern(self, ids: dict, table: list, column) -> np.ndarray:
        codes = np.empty(len(column), np.int32)
        get = ids.get
        for i, x in enumerate(column):
            j = get(x)
            if j is None:
                j = len(table)
                ids[x] = j
                table.append(x)
            codes[i] = j
        return codes

    def append(self, ops: List[Op]):
        """Ingest one delta; returns the newly settled ``(lo, hi)`` row
        range (``lo == hi`` when the watermark did not move). Raises
        :class:`MalformedDelta` on discipline violations."""
        if self.finalized:
            raise MalformedDelta("session already finalized")
        n0 = len(self)
        n = len(ops)
        if n == 0:
            return self._settle()
        # the API-edge pass: Op objects -> parallel columns (the only
        # per-op touch, same shape as pack_history_columnar's)
        procs = [op.process for op in ops]
        fs = [op.f for op in ops]
        vals = [op.value for op in ops]
        tcodes = np.fromiter((TYPE_CODES[op.type] for op in ops),
                             np.int8, n)
        fails = np.fromiter((op.fails for op in ops), np.bool_, n)
        times = np.fromiter((-1 if op.time is None else op.time
                             for op in ops), np.int64, n)
        # process/f interning happens before validation (the chain
        # machinery needs the codes) — snapshot so a raise can roll
        # the tables back and keep the leave-unchanged-on-raise
        # contract exact (a phantom entry would shift every later id
        # off the one-shot tables)
        n_proc0, n_f0 = len(self.process_table), len(self.f_table)
        pcodes = self._intern(self._proc_ids, self.process_table, procs)
        fcodes = self._intern(self._f_ids, self.f_table, fs)

        def _reject(msg: str):
            for x in self.process_table[n_proc0:]:
                del self._proc_ids[x]
            del self.process_table[n_proc0:]
            for x in self.f_table[n_f0:]:
                del self._f_ids[x]
            del self.f_table[n_f0:]
            raise MalformedDelta(msg)

        is_inv = tcodes == INVOKE
        is_ok = tcodes == OK
        is_fail = tcodes == FAIL
        sel_idx = np.flatnonzero(is_inv | is_ok | is_fail)
        srt, inv_flag, prev_inv, prev_row = _per_process_prev(
            pcodes, sel_idx, is_inv)
        # chain the delta's per-process event chains onto the carried
        # open-call state: the first selected event of a process in
        # this delta continues whatever the previous deltas left open
        first = prev_row < 0
        open0 = np.fromiter(
            (self._open_row.get(int(p), -1) for p in pcodes[srt]),
            np.int64, srt.size) if srt.size else np.empty(0, np.int64)
        prev_row_g = np.where(first, open0, prev_row + n0)
        prev_inv_g = np.where(first, open0 >= 0, prev_inv)
        dbl = inv_flag & prev_inv_g
        if dbl.any():
            i = int(srt[dbl].min())
            _reject(
                f"process {procs[i]!r} invokes at row {n0 + i} while "
                "an earlier invocation is still pending")
        orphan = ~inv_flag & ~prev_inv_g
        if orphan.any():
            i = int(srt[orphan].min())
            _reject(f"{ops[i].type} without invocation: {ops[i]}")

        # pairing + back-fill (global row ids; completions may pair
        # with invokes from earlier deltas)
        comp = ~inv_flag & prev_inv_g
        crow = srt[comp] + n0
        irow = prev_row_g[comp]
        # validate the fail-pair value reconciliation BEFORE any
        # column mutates (like the dbl/orphan checks above): a raise
        # here must leave the ingest exactly as it was — StreamIngest
        # is public API and a half-applied delta would corrupt every
        # later settled_slice/packed_history
        def _val(row: int):
            return (vals[row - n0] if row >= n0
                    else self.raw_values[row])

        for c, i in zip(crow.tolist(), irow.tolist()):
            if is_fail[c - n0]:
                iv, fv = _val(i), _val(c)
                if iv is not None and fv is not None and iv != fv:
                    _reject(
                        f"invocation value {iv!r} and failure value "
                        f"{fv!r} don't match at row {c}")
        pair = np.full(n, -1, np.int32)
        pair[crow - n0] = irow
        self.raw_values.extend(vals)
        local_inv = irow >= n0
        pair[irow[local_inv] - n0] = crow[local_inv]
        self.type.extend(tcodes)
        self.proc.extend(pcodes)
        self.f.extend(fcodes)
        self.fails.extend(fails)
        self.time.extend(times)
        self.pair.extend(pair)
        for i, c in zip(irow[~local_inv].tolist(),
                        (crow[~local_inv]).tolist()):
            self.pair.a[i] = c
        ok_pairs = is_ok[crow - n0]
        rv = self.raw_values
        for c, i in zip(crow[ok_pairs].tolist(),
                        irow[ok_pairs].tolist()):
            rv[i] = rv[c]                   # the ok's value wins
        fa = self.fails.a
        for c, i in zip(crow[~ok_pairs].tolist(),
                        irow[~ok_pairs].tolist()):
            iv, fv = rv[i], rv[c]       # mismatch pre-validated above
            v = iv if iv is not None else fv
            rv[i] = v
            rv[c] = v
            fa[i] = True
            fa[c] = True

        # open-call / resolution state updates, per process touched:
        # the LAST selected event decides open-ness (group tails of the
        # stable per-process sort)
        if srt.size:
            psort = pcodes[srt]
            tail = np.empty(srt.size, bool)
            tail[:-1] = psort[1:] != psort[:-1]
            tail[-1] = True
            for j in np.flatnonzero(tail).tolist():
                p = int(psort[j])
                row = int(srt[j])
                if inv_flag[j]:
                    self._open_row[p] = n0 + row
                    self._unresolved[p] = n0 + row
                else:
                    self._open_row.pop(p, None)
                    self._unresolved.pop(p, None)
            # a completion mid-delta resolves even when a LATER invoke
            # of the same process re-opens: drop stale unresolved rows
            # (only the tail invoke can be unresolved)
        # :info rows retire their process: the open invoke stays open
        # forever (it pins a slot) but its value is final — resolved.
        # Row order matters: an invoke AFTER the info row (one-shot
        # complete() allows it — info never touches inflight) is NOT
        # retired by it and must keep blocking the watermark until
        # its own completion back-fills its value.
        for i in np.flatnonzero(tcodes == INFO).tolist():
            p = int(pcodes[i])
            r = self._unresolved.get(p)
            if r is not None and r < n0 + i:
                self._unresolved.pop(p)
        return self._settle()

    def finalize(self):
        """End of stream: every open invoke keeps its invoked value
        (one-shot parity — ``complete`` leaves them pending), the tail
        settles, further appends are rejected."""
        self._unresolved.clear()
        self.finalized = True
        return self._settle()

    # -- settlement ----------------------------------------------------

    def _settle(self):
        lo = self.settled
        hi = min(self._unresolved.values(), default=len(self))
        if hi <= lo:
            return lo, lo
        # value interning in row order over the settled slice (the
        # back-filled values are final here — the watermark guarantees
        # every invoke in the slice is resolved)
        vals = self.raw_values[lo:hi]
        vcodes = self._intern(self._val_ids, self.value_table, vals)
        self.value.extend(vcodes)
        t = self.type.a[lo:hi]
        fl = self.fails.a[lo:hi]
        vinv = np.flatnonzero((t == INVOKE) & ~fl)
        trans = np.full(hi - lo, -1, np.int32)
        if vinv.size:
            fc = self.f.a[lo:hi][vinv]
            tr_ids = self._tr_ids
            table = self.transition_table
            codes = np.empty(vinv.size, np.int32)
            for j, key in enumerate(zip(fc.tolist(),
                                        vcodes[vinv].tolist())):
                c = tr_ids.get(key)
                if c is None:
                    c = len(table)
                    tr_ids[key] = c
                    table.append(key)
                codes[j] = c
            trans[vinv] = codes
        self.trans.extend(trans)
        self.n_invokes_settled += int(vinv.size)
        self.settled = hi
        return lo, hi

    # -- checkpoint / restore ------------------------------------------

    #: the _Grow columns a checkpoint snapshots, in restore order
    _COLS = ("type", "proc", "f", "fails", "time", "pair", "value",
             "trans")

    def checkpoint(self) -> dict:
        """Host snapshot of the ingest: id tables, columns, watermark
        and open-call state. The id-lookup dicts are NOT stored — they
        are pure functions of the tables and rebuild on restore."""
        return {
            "process_table": list(self.process_table),
            "f_table": list(self.f_table),
            "value_table": list(self.value_table),
            "transition_table": [tuple(t)
                                 for t in self.transition_table],
            "cols": {c: getattr(self, c).a.copy() for c in self._COLS},
            "raw_values": list(self.raw_values),
            "settled": int(self.settled),
            "n_invokes_settled": int(self.n_invokes_settled),
            "open_row": {int(k): int(v)
                         for k, v in self._open_row.items()},
            "unresolved": {int(k): int(v)
                           for k, v in self._unresolved.items()},
            "finalized": bool(self.finalized),
        }

    @classmethod
    def restore(cls, ck: dict) -> "StreamIngest":
        ing = cls()
        ing.process_table = list(ck["process_table"])
        ing._proc_ids = {x: i for i, x in
                         enumerate(ing.process_table)}
        ing.f_table = list(ck["f_table"])
        ing._f_ids = {x: i for i, x in enumerate(ing.f_table)}
        ing.value_table = list(ck["value_table"])
        ing._val_ids = {x: i for i, x in enumerate(ing.value_table)}
        ing.transition_table = [tuple(t)
                                for t in ck["transition_table"]]
        ing._tr_ids = {t: i for i, t in
                       enumerate(ing.transition_table)}
        for c in cls._COLS:
            col = getattr(ing, c)
            col.extend(np.asarray(ck["cols"][c], col._buf.dtype))
        ing.raw_values = list(ck["raw_values"])
        ing.settled = int(ck["settled"])
        ing.n_invokes_settled = int(ck["n_invokes_settled"])
        ing._open_row = {int(k): int(v)
                         for k, v in ck["open_row"].items()}
        ing._unresolved = {int(k): int(v)
                           for k, v in ck["unresolved"].items()}
        ing.finalized = bool(ck["finalized"])
        return ing

    # -- API edges -----------------------------------------------------

    def settled_slice(self, lo: int, hi: int):
        """(type, proc, trans, fails, pair) columns of a settled row
        range — the segmenter's input."""
        return (self.type.a[lo:hi], self.proc.a[lo:hi],
                self.trans.a[lo:hi], self.fails.a[lo:hi],
                self.pair.a[lo:hi])

    def transitions_of(self, lo: int, hi: int) -> List[tuple]:
        """(f, value) pairs of transition ids ``lo..hi`` (the memo
        extension's input, in interning order)."""
        return [(self.f_table[fi], self.value_table[vi])
                for fi, vi in self.transition_table[lo:hi]]

    def packed_history(self, end: Optional[int] = None):
        """A :class:`~..ops.packed.PackedHistory` view of the
        settled prefix (counterexample decode, failover replay — the
        retained columnar tables). Pairs pointing past the cut are
        open calls there and report -1."""
        from ..ops.packed import PackedHistory

        end = self.settled if end is None else min(end, self.settled)
        pair = self.pair.a[:end].copy()
        pair[pair >= end] = -1
        return PackedHistory(
            process=self.proc.a[:end].copy(),
            type=self.type.a[:end].copy(),
            f=self.f.a[:end].copy(),
            value=self.value.a[:end].copy(),
            trans=self.trans.a[:end].copy(),
            pair=pair,
            fails=self.fails.a[:end].copy(),
            time=self.time.a[:end].copy(),
            process_table=list(self.process_table),
            f_table=list(self.f_table),
            value_table=list(self.value_table),
            transition_table=list(self.transition_table))


__all__ = ["MalformedDelta", "StreamIngest"]
