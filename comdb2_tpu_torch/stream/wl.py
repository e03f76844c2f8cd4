"""Workload-family stream rungs — live bank / sets sessions.

The counterpart of the JAX package's ``stream/wl.py``: the
non-frontier siblings of :class:`~.session.StreamSession`. A wl
session owns a DEVICE-RESIDENT carry — bank: the (A,) running balance;
sets: the three (E,) membership planes — and each append dispatches
ONLY its delta (``wl_bank_delta`` / ``wl_sets_delta``), so per-append
device work is O(delta) regardless of history length. Deltas join a
:class:`~.engine.MegaBatch` under ``("wl-bank", a_pad, device)`` /
``("wl-sets", e_pad, device)`` fuse keys; the fused forms run the SAME
lane-batched body, so a megabatched advance is bit-identical to the
solo one, and a beat reads every lane's verdict flags back at once.

Verdict discipline:

- bank LATCHES INVALID immediately — a wrong-total / wrong-n read
  stays wrong under every extension. The snapshot plane stays
  diagnostic (and is windowed per delta: reads match snapshots
  reachable within their append, counting from the carry).
- sets latches only malformed deltas (UNKNOWN) mid-stream: the final
  read is last-read-wins, so ``lost``/``unexpected`` are PROVISIONAL
  until close. The terminal verdict lands at close and matches a
  one-shot ``check_wl_batch`` of the full history.

Checkpoint/restore is host numpy only; restoring resumes with the
same carry bits and interning table, so eviction and migration cost
zero device replay. Sets escalate the element rung IN PLACE up
``WL_ELEMS`` (host readback + pad, upload on the next dispatch); past
the top rung the session answers terminal UNKNOWN. Sessions live on
``device`` (``None`` means ``cuda``); carries stay host numpy until
the first dispatch uploads them.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..checker.linear_torch import as_tensor
from ..checker.wl import bank as _WLB
from ..checker.wl import sets as _WLS
from ..checker.wl.batch import (WL_ACCOUNTS, WL_DELTA_PADS, WL_ELEMS,
                                bucket_of)
from ..obs import trace as _obs
from ..utils import resolve_device
from . import engine as _ENG
from .engine import _host
from .ingest import MalformedDelta

#: the stream-served wl models. Dirty-reads stays post-hoc only: its
#: verdict joins reads against the FULL failed-write set, so there is
#: no O(delta) carry for it — ``check_wl_batch`` serves it.
WL_MODELS = ("wl-bank", "wl-sets")


class WlLadderOverflow(Exception):
    """A session axis grew past its ladder top — the session answers
    terminal UNKNOWN instead of compiling an open-ended program."""


def make_session(model: str, params: Optional[dict] = None,
                 device=None):
    """Session factory for :class:`~.manager.SessionManager`.
    ``params`` is the bank model (``{"n": .., "total": ..}``)."""
    if model == "wl-bank":
        p = dict(params or {})
        if "n" not in p or "total" not in p:
            raise ValueError("wl-bank needs {'n': .., 'total': ..}")
        return WlBankSession(p, device=device)
    if model == "wl-sets":
        return WlSetsSession(device=device)
    raise ValueError(f"unknown wl model {model!r}")


def restore_session(ck: dict, device=None):
    """Checkpoint router (the ``wl_family`` discriminator)."""
    fam = ck.get("wl_family")
    if fam == "bank":
        return WlBankSession.restore(ck, device=device)
    if fam == "sets":
        return WlSetsSession.restore(ck, device=device)
    raise ValueError(f"unknown wl_family {fam!r}")


class _Flags:
    """A beat's verdict flags, one row per lane, on the device: the
    first lane to absorb reads the whole block back, the rest reuse
    it — one host sync per beat."""

    __slots__ = ("_dev", "_host")

    def __init__(self, block: torch.Tensor):
        self._dev = block
        self._host = None

    def row(self, i: int) -> list:
        if self._host is None:
            self._host = self._dev.tolist()
        return self._host[i]


class _WlLane:
    """One wl session's staged delta inside a forming megabatch (the
    wl analog of ``engine._Lane`` — exposes ``.sess`` so the flush
    failure latch covers wl lanes too). After the launch ``out`` holds
    the lane's device outputs and ``flags`` / ``row`` its verdict
    flags."""

    __slots__ = ("sess", "delta", "out", "flags", "row")

    def __init__(self, sess, delta):
        self.sess = sess
        self.delta = delta
        self.out = None
        self.flags = None
        self.row = 0


class _WlSessionBase:
    """The session protocol the manager (and any caller serving many
    sessions) is generic over — mirrors :class:`~.session.StreamSession`'s
    surface: ``append_stage(ops, collector=)`` returning an
    idempotent finalize, poll/close/checkpoint/restore/release,
    ``dispatches``/``appends`` counters, and the latch."""

    family = "?"
    keyed = False

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.valid = True
        self.cause = None
        self.fail_index = -1
        self.appends = 0
        self.dispatches = 0      # device calls the session's deltas rode
        self.op_count = 0
        self.closed = False
        self._inflight = None

    @property
    def model_name(self) -> str:
        return f"wl-{self.family}"

    def _latched(self) -> bool:
        return self.valid is not True

    def _latch_unknown(self, cause: str) -> None:
        # guarded (unlike StreamSession's): a group flush failure must
        # never downgrade an already-latched INVALID to unknown
        if self.valid is True:
            self.valid = "unknown"
            self.cause = cause

    # -- append / finalize ---------------------------------------------

    def append(self, ops) -> dict:
        fin = self.append_stage(ops)
        return fin()

    def append_stage(self, ops, collector=None):
        """Stage one delta and return a zero-arg idempotent finalize
        producing the verdict map. With ``collector`` the delta parks
        as a megabatch lane (carry advances at flush, device-only);
        the finalize flushes first and then ABSORBS the lane's
        readback flags — all host↔device readback is deferred there.
        Appends to one session serialize (staging forces the previous
        finalize), so a session holds at most one lane per beat. A
        launch error latches the session UNKNOWN and raises."""
        if self._inflight is not None:
            self._inflight()
        if self.closed:
            out = self._verdict_map()
            out["cause"] = "session closed"
            return lambda: out
        self.appends += 1
        if self._latched():
            out = self._verdict_map()
            out["latched"] = True
            return lambda: out
        try:
            deltas = self._encode_delta(list(ops))
        except MalformedDelta as e:
            self._latch_unknown(f"malformed: {e}")
            return lambda: self._verdict_map()
        except WlLadderOverflow as e:
            self._latch_unknown(str(e))
            return lambda: self._verdict_map()
        if not deltas:
            # nothing checkable in the delta — a legitimate
            # 0-dispatch beat, same as a watermark-held append
            return lambda: self._verdict_map()
        lanes = [_WlLane(self, d) for d in deltas]
        key = self._fuse_key()
        if collector is not None and len(lanes) == 1:
            collector.add_wl(key, lanes[0])
        else:
            # oversized appends chunk: each chunk's carry feeds the
            # next, so they launch sequentially solo inside the beat
            # (the same out-of-band rule as oversized frontier deltas)
            try:
                for ln in lanes:
                    launch_wl_group(None, key, [ln])
            except Exception as e:
                self._latch_unknown(f"engine: {type(e).__name__}: {e}")
                raise
        done = {}

        def fin():
            if "out" in done:
                return done["out"]
            if collector is not None \
                    and any(ln.out is None for ln in lanes):
                collector.flush()
            self._inflight = None
            if not self._latched():
                for ln in lanes:
                    if ln.out is None:       # flush died before us
                        self._latch_unknown(
                            "megabatch lane never launched")
                        break
                    self._absorb(ln)
            done["out"] = self._verdict_map()
            return done["out"]

        self._inflight = fin
        return fin

    def poll(self) -> dict:
        if self._inflight is not None:
            self._inflight()
        return self._verdict_map()

    def finalize_input(self) -> dict:
        if self._inflight is not None:
            self._inflight()
        if not self.closed and not self._latched():
            self._settle_final()
        return self._verdict_map()

    def close(self) -> dict:
        """Final verdict + carry release. The release rides
        ``finally``: a settle that raises must still free the carry."""
        try:
            out = self.finalize_input()
        finally:
            self.release()
        return out

    def release(self) -> None:
        if self._inflight is not None:
            self._inflight()
        self._drop_carry()
        self.closed = True

    # -- verdict -------------------------------------------------------

    def _verdict_map(self) -> dict:
        out = {
            "valid": self.valid,
            "op_index": self.fail_index,
            "op_count": self.op_count,
            # wl deltas settle at dispatch — no invoke watermark
            "checked_through": self.op_count,
            "engine": self.model_name,
            "family": self.family,
            "dispatches": self.dispatches,
            "appends": self.appends,
        }
        if self.cause:
            out["cause"] = self.cause
        out.update(self._family_fields())
        return out


class WlBankSession(_WlSessionBase):
    """Live bank: the carry is the (A,) running balance. INVALID
    latches immediately; the snapshot-inconsistency plane stays
    diagnostic (and windowed to each append — see module
    docstring)."""

    family = "bank"

    def __init__(self, model: dict, device=None):
        super().__init__(device)
        self.n = int(model["n"])
        self.total = int(model["total"])
        if self.n < 1:
            raise ValueError("bank model needs n >= 1 accounts")
        if abs(self.total) >= 1 << 30:
            raise ValueError("bank totals must fit int32 (no x64)")
        self.a_pad = bucket_of(self.n, WL_ACCOUNTS)
        if self.a_pad is None:
            raise ValueError(
                f"bank n {self.n} exceeds the WL_ACCOUNTS ladder")
        init = _WLB.default_init({"n": self.n, "total": self.total,
                                  **({"init": model["init"]}
                                     if "init" in model else {})})
        bal = np.zeros(self.a_pad, np.int32)
        bal[:self.n] = init
        self._balance = bal         # numpy until the first dispatch
        self.bad_reads = 0
        self.snap_inconsistent = 0

    @property
    def shape_class(self) -> str:
        return f"wl-bank-a{self.a_pad}"

    def _fuse_key(self):
        return ("wl-bank", self.a_pad, self.device)

    def _encode_delta(self, ops) -> List[dict]:
        """Host encode into (reads, transfers) row lists, chunked at
        the ``WL_DELTA_PADS`` top so no open-ended program compiles;
        arrival order is preserved across chunk cuts."""
        top = WL_DELTA_PADS[-1]
        deltas: List[dict] = []
        r_rows: list = []
        t_rows: list = []

        def cut():
            if r_rows or t_rows:
                deltas.append({"reads": list(r_rows),
                               "transfers": list(t_rows)})
                r_rows.clear()
                t_rows.clear()

        for op in ops:
            idx = self.op_count if op.index is None else op.index
            self.op_count += 1
            if op.type != "ok" or op.value is None:
                continue
            if op.f == "read":
                v = op.value
                if isinstance(v, (str, bytes)) \
                        or not isinstance(v, (list, tuple)):
                    raise MalformedDelta(
                        f"bank read value must be a balance row, "
                        f"got {type(v).__name__} (op {idx})")
                row = [int(x) for x in v]
                if any(abs(x) >= 1 << 30 for x in row):
                    raise MalformedDelta(
                        f"bank balance overflows int32 (op {idx})")
                r_rows.append((row, idx))
                if len(r_rows) >= top:
                    cut()
            elif op.f == "transfer":
                try:
                    frm, to, amt = op.value
                    frm, to, amt = int(frm), int(to), int(amt)
                except (TypeError, ValueError):
                    raise MalformedDelta(
                        f"bank transfer value must be "
                        f"(from, to, amount) (op {idx})")
                if not (0 <= frm < self.n and 0 <= to < self.n):
                    raise MalformedDelta(
                        f"bank transfer names an unknown account "
                        f"(op {idx})")
                d = np.zeros(self.a_pad, np.int32)
                d[frm] -= amt
                d[to] += amt
                t_rows.append(d)
                if len(t_rows) >= top:
                    cut()
        cut()
        return deltas

    def _absorb(self, lane) -> None:
        # the carry already advanced at launch (device-only); here we
        # read back this delta's verdict flags — the one readback
        any_bad, first_bad, n_bad, n_snap = lane.flags.row(lane.row)
        self.snap_inconsistent += int(n_snap)
        if bool(any_bad):
            self.bad_reads += int(n_bad)
            if self.valid is True:
                self.valid = False
                row, idx = lane.delta["reads"][int(first_bad)]
                self.fail_index = idx
                self.cause = ("wrong-n read" if len(row) != self.n
                              else "wrong-total read")

    def _settle_final(self) -> None:
        pass                 # bank verdicts are already settled

    def _family_fields(self) -> dict:
        return {"bad_reads": self.bad_reads,
                "snapshot_inconsistent": self.snap_inconsistent}

    def _drop_carry(self) -> None:
        self._balance = None

    def carry_nbytes(self) -> int:
        b = self._balance
        if not isinstance(b, torch.Tensor):
            return 0         # not (or no longer) device-resident
        return int(b.numel() * b.element_size())

    # -- checkpoint / restore (host numpy ONLY) ------------------------

    def checkpoint(self) -> dict:
        if self._inflight is not None:
            self._inflight()
        return {
            "v": 1,
            "wl_family": "bank",
            "model": {"n": self.n, "total": self.total},
            "a_pad": int(self.a_pad),
            "balance": (None if self._balance is None
                        else _host(self._balance)),
            "appends": int(self.appends),
            "dispatches": int(self.dispatches),
            "op_count": int(self.op_count),
            "bad_reads": int(self.bad_reads),
            "snapshot_inconsistent": int(self.snap_inconsistent),
            "valid": self.valid,
            "cause": self.cause,
            "fail_index": int(self.fail_index),
            "closed": bool(self.closed),
        }

    @classmethod
    def restore(cls, ck: dict, device=None) -> "WlBankSession":
        s = cls(dict(ck["model"]), device=device)
        s.a_pad = int(ck["a_pad"])
        bal = ck["balance"]
        s._balance = (None if bal is None
                      else np.asarray(bal, np.int32))
        s.appends = int(ck["appends"])
        s.dispatches = int(ck["dispatches"])
        s.op_count = int(ck["op_count"])
        s.bad_reads = int(ck["bad_reads"])
        s.snap_inconsistent = int(ck["snapshot_inconsistent"])
        s.valid = ck["valid"]
        s.cause = ck["cause"]
        s.fail_index = int(ck["fail_index"])
        s.closed = bool(ck["closed"])
        return s


class WlSetsSession(_WlSessionBase):
    """Live sets: the carry is the three (E,) membership planes over
    a host first-occurrence interning table (exactly the one-shot
    encoder's id space). Only malformed deltas latch mid-stream;
    ``lost``/``unexpected`` are provisional until close."""

    family = "sets"

    def __init__(self, device=None):
        super().__init__(device)
        self.e_pad = WL_ELEMS[0]
        self._ids: dict = {}
        self._att = np.zeros(self.e_pad, bool)
        self._add = np.zeros(self.e_pad, bool)
        self._fr = np.zeros(self.e_pad, bool)
        self.has_read = False
        self.escalations = 0
        self._prov_valid = None    # last dispatch's valid-now flag
        self.lost = 0              # CURRENT totals vs the last read,
        self.unexpected = 0        # not cumulative

    @property
    def shape_class(self) -> str:
        return f"wl-sets-e{self.e_pad}"

    def _fuse_key(self):
        return ("wl-sets", self.e_pad, self.device)

    def _eid(self, v) -> int:
        from ..checker.workloads import freeze_value

        v = freeze_value(v)
        i = self._ids.get(v)
        if i is None:
            i = self._ids[v] = len(self._ids)
        return i

    def _escalate_to(self, e_pad: int) -> None:
        """In-place element-rung escalation: host readback + pad; the
        device re-upload rides the next dispatch. O(E), never
        O(history) — the planes ARE the full state."""
        for name in ("_att", "_add", "_fr"):
            plane = _host(getattr(self, name))
            setattr(self, name,
                    np.pad(plane, (0, e_pad - plane.shape[0])))
        self.e_pad = e_pad
        self.escalations += 1

    def _encode_delta(self, ops) -> List[dict]:
        att_ids: list = []
        add_ids: list = []
        read_ids: list = []
        saw_read = False
        for op in ops:
            idx = self.op_count if op.index is None else op.index
            self.op_count += 1
            if op.value is None:
                continue
            if op.f == "add":
                if op.type == "invoke":
                    att_ids.append(self._eid(op.value))
                elif op.type == "ok":
                    i = self._eid(op.value)
                    att_ids.append(i)
                    add_ids.append(i)
            elif op.f == "read" and op.type == "ok":
                v = op.value
                if isinstance(v, (str, bytes)) or \
                        not isinstance(v, (list, tuple, set,
                                           frozenset)):
                    raise MalformedDelta(
                        f"set read value must be a collection, got "
                        f"{type(v).__name__} (op {idx})")
                saw_read = True
                read_ids = [self._eid(x) for x in v]
        if not att_ids and not add_ids and not saw_read:
            return []
        rung = bucket_of(max(len(self._ids), 1), WL_ELEMS)
        if rung is None:
            raise WlLadderOverflow(
                f"element universe exceeds the WL_ELEMS ladder "
                f"({len(self._ids)} > {WL_ELEMS[-1]})")
        if rung > self.e_pad:
            self._escalate_to(rung)
        e = self.e_pad
        att_d = np.zeros(e, bool)
        att_d[att_ids] = True
        add_d = np.zeros(e, bool)
        add_d[add_ids] = True
        read_d = np.zeros(e, bool)
        if saw_read:
            read_d[read_ids] = True
        return [{"att": att_d, "add": add_d, "read": read_d,
                 "has_read_d": saw_read}]

    def _absorb(self, lane) -> None:
        valid_now, n_lost, n_unexp = lane.flags.row(lane.row)
        self.has_read = self.has_read or lane.delta["has_read_d"]
        self._prov_valid = bool(valid_now)
        self.lost = int(n_lost)
        self.unexpected = int(n_unexp)

    def _settle_final(self) -> None:
        if not self.has_read:
            self.valid = "unknown"
            self.cause = "Set was never read"
        elif self._prov_valid is False:
            self.valid = False
            self.cause = (f"lost={self.lost} "
                          f"unexpected={self.unexpected}")

    def _family_fields(self) -> dict:
        out = {"elements": len(self._ids),
               "e_pad": self.e_pad,
               "escalations": self.escalations,
               "has_read": self.has_read,
               "lost": self.lost,
               "unexpected": self.unexpected}
        if not self.closed and self.valid is True:
            out["provisional_valid"] = (self._prov_valid
                                        if self.has_read else None)
        return out

    def _drop_carry(self) -> None:
        self._att = self._add = self._fr = None

    def carry_nbytes(self) -> int:
        return sum(int(p.numel() * p.element_size())
                   for p in (self._att, self._add, self._fr)
                   if isinstance(p, torch.Tensor))

    # -- checkpoint / restore (host numpy ONLY) ------------------------

    def checkpoint(self) -> dict:
        if self._inflight is not None:
            self._inflight()
        return {
            "v": 1,
            "wl_family": "sets",
            "e_pad": int(self.e_pad),
            "table": list(self._ids),    # first-occurrence order
            "att": (None if self._att is None else _host(self._att)),
            "add": (None if self._add is None else _host(self._add)),
            "fr": (None if self._fr is None else _host(self._fr)),
            "has_read": bool(self.has_read),
            "escalations": int(self.escalations),
            "prov_valid": self._prov_valid,
            "lost": int(self.lost),
            "unexpected": int(self.unexpected),
            "appends": int(self.appends),
            "dispatches": int(self.dispatches),
            "op_count": int(self.op_count),
            "valid": self.valid,
            "cause": self.cause,
            "fail_index": int(self.fail_index),
            "closed": bool(self.closed),
        }

    @classmethod
    def restore(cls, ck: dict, device=None) -> "WlSetsSession":
        s = cls(device=device)
        s.e_pad = int(ck["e_pad"])
        s._ids = {v: i for i, v in enumerate(ck["table"])}
        for name, k in (("_att", "att"), ("_add", "add"),
                        ("_fr", "fr")):
            p = ck[k]
            setattr(s, name,
                    None if p is None else np.asarray(p, bool))
        s.has_read = bool(ck["has_read"])
        s.escalations = int(ck["escalations"])
        s._prov_valid = ck["prov_valid"]
        s.lost = int(ck["lost"])
        s.unexpected = int(ck["unexpected"])
        s.appends = int(ck["appends"])
        s.dispatches = int(ck["dispatches"])
        s.op_count = int(ck["op_count"])
        s.valid = ck["valid"]
        s.cause = ck["cause"]
        s.fail_index = int(ck["fail_index"])
        s.closed = bool(ck["closed"])
        return s


# -- launch forms (called by MegaBatch._launch_group) ------------------


def launch_wl_group(mb, key, lanes) -> None:
    """Launch one wl fuse-key group (``mb`` is the collecting
    MegaBatch; None for direct solo launches): chunks at the
    megabatch lane-ladder top, fusing >= 2 lanes into one batched
    call — the wl analog of ``MegaBatch._launch_delta``."""
    top = _ENG.MEGABATCH_LANES[-1]
    launch = _launch_bank if key[0] == "wl-bank" else _launch_sets
    for i in range(0, len(lanes), top):
        launch(mb, key, lanes[i:i + top])


def _bank_pads(delta):
    return (bucket_of(max(len(delta["reads"]), 1), WL_DELTA_PADS),
            bucket_of(max(len(delta["transfers"]), 1),
                      WL_DELTA_PADS))


def _bank_build(sess, delta, r_pad: int, t_pad: int):
    reads = np.zeros((r_pad, sess.a_pad), np.int32)
    read_mask = np.zeros(r_pad, bool)
    wrong_n = np.zeros(r_pad, bool)
    for r, (row, _idx) in enumerate(delta["reads"]):
        read_mask[r] = True
        if len(row) != sess.n:
            wrong_n[r] = True
        else:
            reads[r, :sess.n] = row
    transfers = np.zeros((t_pad, sess.a_pad), np.int32)
    for t, d in enumerate(delta["transfers"]):
        transfers[t] = d
    return reads, read_mask, wrong_n, transfers


def _bank_planes(arrs, dev):
    """Host (reads, read_mask, wrong_n, transfers) as device tensors."""
    return (as_tensor(arrs[0], dev), as_tensor(arrs[1], dev, torch.bool),
            as_tensor(arrs[2], dev, torch.bool), as_tensor(arrs[3], dev))


def _settle_lanes(chunk, outs, n_carry: int) -> None:
    """Hand each lane its outputs and its row of the beat's verdict
    flags (everything after the ``n_carry`` carry tensors, stacked
    into one (B, k) int block on the device)."""
    flags = _Flags(torch.stack([torch.stack([x.to(torch.int32)
                                             for x in out[n_carry:]])
                                for out in outs]))
    for i, (ln, out) in enumerate(zip(chunk, outs)):
        ln.out, ln.flags, ln.row = out, flags, i


def _launch_bank(mb, key, chunk) -> None:
    t0 = _obs.monotonic()
    a_pad, dev = key[1], key[2]
    b_real = len(chunk)
    if b_real == 1:
        ln = chunk[0]
        s = ln.sess
        r_pad, t_pad = _bank_pads(ln.delta)
        planes = _bank_planes(_bank_build(s, ln.delta, r_pad, t_pad),
                              dev)
        _ENG.DISPATCHES += 1
        b_pad = 1
        outs = (_WLB.wl_bank_delta(
            as_tensor(s._balance, dev), *planes, s.total,
            n_reads=r_pad, n_accounts=a_pad, n_snaps=t_pad),)
    else:
        b_pad = next(b for b in _ENG.MEGABATCH_LANES if b >= b_real)
        r_pad = max(_bank_pads(ln.delta)[0] for ln in chunk)
        t_pad = max(_bank_pads(ln.delta)[1] for ln in chunk)
        arrs = [_bank_build(ln.sess, ln.delta, r_pad, t_pad)
                for ln in chunk]
        planes = _bank_planes([np.stack([a[j] for a in arrs])
                               for j in range(4)], dev)
        bals = tuple(as_tensor(ln.sess._balance, dev) for ln in chunk)
        totals = as_tensor(np.array([ln.sess.total for ln in chunk],
                                    np.int32), dev)
        _ENG.DISPATCHES += 1
        _ENG.MEGABATCHES += 1
        outs = _WLB.wl_bank_delta_mb(
            bals, *planes, totals, n_reads=r_pad, n_accounts=a_pad,
            n_snaps=t_pad)
    _settle_lanes(chunk, outs, 1)
    for ln, out in zip(chunk, outs):
        ln.sess._balance = out[0]    # device carry advance — no
        ln.sess.dispatches += 1      # readback until the finalize
    if mb is not None:
        mb._stat("wl-bank", b_real, b_pad, t0)


def _launch_sets(mb, key, chunk) -> None:
    t0 = _obs.monotonic()
    e_pad, dev = key[1], key[2]
    b_real = len(chunk)

    def hr(ln):
        return bool(ln.sess.has_read or ln.delta["has_read_d"])

    def planes(s):
        return tuple(as_tensor(p, dev, torch.bool)
                     for p in (s._att, s._add, s._fr))

    if b_real == 1:
        ln = chunk[0]
        d = ln.delta
        _ENG.DISPATCHES += 1
        b_pad = 1
        outs = (_WLS.wl_sets_delta(
            *planes(ln.sess), *(as_tensor(d[k], dev, torch.bool)
                                for k in ("att", "add", "read")),
            bool(d["has_read_d"]), hr(ln), n_elems=e_pad),)
    else:
        b_pad = next(b for b in _ENG.MEGABATCH_LANES if b >= b_real)
        carries = tuple(planes(ln.sess) for ln in chunk)
        ds = [ln.delta for ln in chunk]
        att, add, rd = (as_tensor(np.stack([d[k] for d in ds]), dev,
                                  torch.bool)
                        for k in ("att", "add", "read"))
        hrd = np.array([d["has_read_d"] for d in ds], bool)
        hrs = np.array([hr(ln) for ln in chunk], bool)
        _ENG.DISPATCHES += 1
        _ENG.MEGABATCHES += 1
        outs = _WLS.wl_sets_delta_mb(carries, att, add, rd, hrd, hrs,
                                     n_elems=e_pad)
    _settle_lanes(chunk, outs, 3)
    for ln, out in zip(chunk, outs):
        s = ln.sess
        s._att, s._add, s._fr = out[0], out[1], out[2]
        s.dispatches += 1
    if mb is not None:
        mb._stat("wl-sets", b_real, b_pad, t0)


__all__ = ["WL_MODELS", "WlBankSession", "WlLadderOverflow",
           "WlSetsSession", "launch_wl_group", "make_session",
           "restore_session"]
