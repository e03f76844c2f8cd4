"""Device-resident carry rungs for streaming sessions.

The counterpart of the JAX package's ``stream/engine.py``. A session's
engine carry lives ON THE DEVICE between ``append``s: each delta
dispatch consumes only the NEW segments against the resident frontier,
so per-append device work is O(delta), never O(history). Three rungs
share one interface:

- **kernel** (:mod:`..checker.seg_kernel`): the segment-search kernel
  (``kernels/seg_search.cu``) in carry mode, its ``(ws, stat)`` words
  threaded from launch to launch at the session's global segment
  offset. The kernel reads its segments from device memory at any
  length, so a delta is ONE launch of exactly its segments (split only
  above ``DELTA_PADS[-1]``, like the other rungs), and nothing is read
  back until the session asks for the verdict: one host sync per
  append. Table-bucket, slot-width and K growth re-encode the (at most
  128-config) carry in place (:meth:`KernelCarry.respec`), where the
  JAX package replays. F is fixed at 128; overflow re-routes the
  session to the next rung by replaying the RETAINED renamed segments
  (the one O(history) event a session can pay). On CPU tensors the
  rung runs the kernel's plain version,
  :func:`~..checker.seg_kernel.seg_search_reference`; on the card a
  failed build or launch raises.
- **xla** (:func:`stream_delta_chunk`, the seg2 engine's chunk form
  :func:`~..checker.linear_torch.check_device_seg2_chunk`): the
  ``(states, slots, valid, n, status, fail)`` carry; capacity
  escalates IN PLACE via ``expand_seg_carry`` (widen the pre-delta
  carry, re-run only the delta) and the slot axis widens in place via
  ``expand_seg_carry_slots`` when the live history's concurrency
  grows. The carry is portable across memo-table bucket growth: state
  ids are stable (:class:`~..models.memo.IncrementalMemo`). The name
  is the JAX package's (its seg2 ran as XLA programs); here it is torch
  ops on the session's device.
- **mxu** (:mod:`..checker.mxu`): the packed-word carry for wide-P
  sessions; ``expand_carry`` escalates in place up to the 131072 rung.
  The word layout bakes in (n_states, n_transitions, P), so table
  bucket or P growth re-plans via replay.

Every delta on the xla and mxu rungs rides the ``DELTA_PADS`` pow2
ladder (the JAX package's, so both packages dispatch the same
segments per call). The kernel rung needs no ladder: its launches
count one per delta here, where the JAX package counts one per
16-segment chunk in interpret mode.

:class:`MegaBatch` advances many sessions per beat. The xla and mxu
rungs' lanes each own a successor table and a depth column, which
the chunk engines' batch axis does not take, so a fused entry runs
its lanes one after another (:func:`stream_delta_megabatch`,
:func:`~..checker.mxu.check_device_mxu_megabatch`): one call per rung
and beat, whatever the lanes' shapes, carries bit-equal to solo
dispatches. The kernel rung's lanes each own a table and a stride, and
the kernel shares one table across a CTA's warps, so a kernel beat is
B launches queued on one stream and ONE readback of all B stats
(:func:`stream_kernel_megabatch`). Padding lanes up the
``MEGABATCH_LANES`` ladder are counted (the ``masked`` field) and
never run.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..checker import linear_torch as LT
from ..checker import mxu as MXU
from ..checker import seg_kernel as SK
from ..obs import trace as _obs
from ..utils import next_pow2 as _next_pow2
from ..utils import resolve_device

#: padded segments per delta dispatch on the xla and mxu rungs — the
#: pow2 ladder every append is bucketed onto (floor 16: tiny appends
#: share one shape; top 1024: larger appends split). The MXU rung
#: floors at 64.
DELTA_PADS = (16, 64, 256, 1024)
MXU_DELTA_FLOOR = 64

#: the xla rung's frontier ladder (``analysis``'s capacity ladder) —
#: in-place escalation; overflow at the top is the honest UNKNOWN for
#: P below the MXU crossover
STREAM_CAPACITIES = (256, 1024, 8192, 65536)

#: small-tier capacity of the adaptive closure (see check_device_seg2)
STREAM_FS = 32

#: stream delta dispatches this process (all rungs) — the O(delta)
#: counter tests assert on. Counts device calls, not session lanes: a
#: megabatched advance of 8 sessions is ONE dispatch
DISPATCHES = 0

#: megabatch calls this process (each also counts once in DISPATCHES)
MEGABATCHES = 0

#: session-lane pow2 ladder of the megabatch: a beat's same-class lanes
#: count up to the next rung (the padding lanes are recorded as
#: ``masked`` and never run); more than the top rung splits; a single
#: lane takes the solo entry
MEGABATCH_LANES = (2, 4, 8, 16)

#: ladder ceilings: a session whose renamed concurrency or per-segment
#: invoke burst outgrows them latches UNKNOWN (crash-heavy histories
#: pin ``:info`` slots forever and CAN get here)
STREAM_MAX_P = MXU.MAX_P
STREAM_MAX_K = 32

def bucket_delta(n_segments: int, floor: int = 0) -> int:
    """The delta_pad rung for one append's segment count (top rung
    when it exceeds the ladder — the caller then splits)."""
    for p in DELTA_PADS:
        if p >= max(n_segments, floor):
            return p
    return DELTA_PADS[-1]


def _host(x) -> np.ndarray:
    """A carry component as host numpy (a readback for tensors)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _host_int(x) -> np.ndarray:
    """A carry scalar as a 0-d int32 array (the JAX package's
    checkpoint holds its scalars so)."""
    return np.asarray(int(x), np.int32)


# --- the xla rung ------------------------------------------------------------

def stream_delta_chunk(succ, inv_proc, inv_tr, ok_proc, depth,
                       seg_offset, carry, *, F: int, Fs: int, P: int,
                       n_states: int, n_transitions: int, device=None):
    """One delta dispatch of the xla session rung: the adaptive
    two-tier segmented scan resumed from (and returning) a resident
    carry — :func:`~..checker.linear_torch.check_device_seg2_chunk`
    under the rung's own name."""
    return LT.check_device_seg2_chunk(
        succ, inv_proc, inv_tr, ok_proc, depth, seg_offset, carry, F=F,
        P=P, Fs=Fs, n_states=n_states, n_transitions=n_transitions,
        device=device)


def per_lane(x, b: int):
    """Lane ``b``'s value of a megabatch argument: a list or tuple holds
    one per lane, anything else is shared."""
    return x[b] if isinstance(x, (list, tuple)) else x


def stream_delta_megabatch(succs, inv_proc, inv_tr, ok_proc, depth,
                           seg_offset, carries, *, F, Fs: int, P,
                           n_states, n_transitions, device=None):
    """B session lanes of :func:`stream_delta_chunk` in one call:
    ``succs`` and ``carries`` are B-tuples (every session owns its memo
    table and resident carry), the delta arrays lane-major ``(B, S, K)``
    / ``(B, S)`` or lists of per-lane arrays, ``seg_offset`` ``(B,)``.
    Each lane owns a table and a depth column, which the seg2 engine's
    scan does not batch, so the lanes run one after another: every
    returned carry is the solo dispatch's, bit for bit. Because of that
    the lanes need not share a shape: ``F``, ``P``, ``n_states`` and
    ``n_transitions`` may be per-lane lists. Returns a B-tuple."""
    offs = np.asarray(seg_offset).tolist()
    return tuple(stream_delta_chunk(
        succs[b], inv_proc[b], inv_tr[b], ok_proc[b], depth[b], offs[b],
        carries[b], F=per_lane(F, b), Fs=Fs, P=per_lane(P, b),
        n_states=per_lane(n_states, b),
        n_transitions=per_lane(n_transitions, b), device=device)
        for b in range(len(carries)))


def _seg_carry_nbytes(carry) -> int:
    st, sl, va = carry[0], carry[1], carry[2]
    n = (st.numel(), sl.numel(), va.numel()) \
        if isinstance(st, torch.Tensor) else (st.size, sl.size, va.size)
    return int(n[0] * 4 + n[1] * 4 + n[2])


class XlaCarry:
    """The xla rung (see module docstring). ``n_states`` and
    ``n_transitions`` are the POW2-BUCKETED memo dims the table is
    padded to."""

    name = "stream-xla"

    def __init__(self, n_states: int, n_transitions: int, P2: int,
                 cap_ix: int = 0, device=None):
        self.device = resolve_device(device)
        self.ns = n_states
        self.nt = n_transitions
        self.P2 = P2
        self.cap_ix = cap_ix
        self.F = STREAM_CAPACITIES[cap_ix]
        self.carry = LT.init_seg_carry(self.F, P2, self.device)
        self._pre = self.carry          # pre-delta snapshot

    def begin_delta(self) -> None:
        self._pre = self.carry

    def dispatch(self, succ, ip, it, okp, dp, seg_offset) -> None:
        global DISPATCHES
        DISPATCHES += 1
        self.carry = stream_delta_chunk(
            succ, ip, it, okp, dp, int(seg_offset), self.carry, F=self.F,
            Fs=STREAM_FS, P=self.P2, n_states=self.ns,
            n_transitions=self.nt, device=self.device)

    def read(self) -> Tuple[int, int, int]:
        """(status, fail_seg_global, n_final) — host ints already: the
        seg2 scan reads its flags back per closure iteration."""
        return (int(self.carry[4]), int(self.carry[5]),
                int(self.carry[3]))

    def escalate(self) -> bool:
        """Widen the PRE-delta carry to the next rung; the caller
        re-dispatches the same delta. False at the ladder top."""
        if self.cap_ix + 1 >= len(STREAM_CAPACITIES):
            return False
        self.cap_ix += 1
        self.F = STREAM_CAPACITIES[self.cap_ix]
        self.carry = LT.expand_seg_carry(
            LT._carry_on(self._pre, self.device), self.F)
        self._pre = self.carry
        return True

    def widen_slots(self, P2_new: int) -> bool:
        """Slot-axis growth IN PLACE (the rung survives concurrency
        growth without replay)."""
        self.carry = LT.expand_seg_carry_slots(self.carry, P2_new)
        self._pre = LT.expand_seg_carry_slots(self._pre, P2_new)
        self.P2 = P2_new
        return True

    def rebucket(self, n_states: int, n_transitions: int) -> bool:
        """Memo-table bucket growth: the carry is portable (state ids
        stable, key layout internal) — just retarget the dims."""
        self.ns, self.nt = n_states, n_transitions
        return True

    def nbytes(self) -> int:
        return _seg_carry_nbytes(self.carry)

    def checkpoint(self) -> dict:
        """HOST-numpy snapshot of the resident carry, in the JAX
        package's layout (int32 frontier, bool valid, 0-d int32
        scalars)."""
        st, sl, va, n, status, fail = self.carry
        return {"rung": "xla", "ns": self.ns, "nt": self.nt,
                "P2": self.P2, "cap_ix": self.cap_ix,
                "carry": (_host(st).astype(np.int32),
                          _host(sl).astype(np.int32),
                          _host(va).astype(bool), _host_int(n),
                          _host_int(status), _host_int(fail))}

    @classmethod
    def restore(cls, ck: dict, device=None) -> "XlaCarry":
        eng = cls(int(ck["ns"]), int(ck["nt"]), int(ck["P2"]),
                  cap_ix=int(ck["cap_ix"]), device=device)
        eng.carry = LT._carry_on(tuple(ck["carry"]), eng.device)
        eng._pre = eng.carry
        return eng


# --- the mxu rung ------------------------------------------------------------

class MxuCarry:
    """The MXU rung: packed-word carry, B=1 chunk form."""

    name = "stream-mxu"

    def __init__(self, n_states: int, n_transitions: int, P2: int,
                 cap_ix: int = 0, device=None):
        self.device = resolve_device(device)
        self.ns = n_states
        self.nt = n_transitions
        self.P2 = P2
        self.cap_ix = cap_ix
        self.F = MXU.CAPACITIES[cap_ix]
        self.carry = MXU.init_carry(1, self.F, P2, n_states=n_states,
                                    n_transitions=n_transitions,
                                    device=self.device)
        self._pre = self.carry

    def begin_delta(self) -> None:
        self._pre = self.carry

    def dispatch(self, succ, ip, it, okp, dp, seg_offset) -> None:
        global DISPATCHES
        DISPATCHES += 1
        self.carry = MXU.check_device_mxu_chunk(
            succ, ip, it, okp, dp, int(seg_offset), self.carry, F=self.F,
            P=self.P2, n_states=self.ns, n_transitions=self.nt,
            device=self.device)

    def read(self) -> Tuple[int, int, int]:
        """(status, fail_seg_global, n_final): one readback."""
        c = self.carry
        st, fail, n = torch.stack([c[3][0], c[4][0], c[2][0]]).tolist()
        return int(st), int(fail), int(n)

    def escalate(self) -> bool:
        if self.cap_ix + 1 >= len(MXU.CAPACITIES):
            return False
        self.cap_ix += 1
        self.F = MXU.CAPACITIES[self.cap_ix]
        self.carry = MXU.expand_carry(self._pre, self.F)
        self._pre = self.carry
        return True

    def widen_slots(self, P2_new: int) -> bool:
        return False                    # word layout bakes P: replay

    def rebucket(self, n_states: int, n_transitions: int) -> bool:
        return False                    # PackPlan re-plans: replay

    def nbytes(self) -> int:
        words, valid = self.carry[0], self.carry[1]
        return int(sum(w.numel() * 4 for w in words) + valid.numel())

    def checkpoint(self) -> dict:
        words, valid, n_b, status, fail = self.carry
        return {"rung": "mxu", "ns": self.ns, "nt": self.nt,
                "P2": self.P2, "cap_ix": self.cap_ix,
                "carry": (tuple(_host(w) for w in words), _host(valid),
                          _host(n_b), _host(status), _host(fail))}

    @classmethod
    def restore(cls, ck: dict, device=None) -> "MxuCarry":
        eng = cls(int(ck["ns"]), int(ck["nt"]), int(ck["P2"]),
                  cap_ix=int(ck["cap_ix"]), device=device)
        words, valid, n_b, status, fail = ck["carry"]
        dev = eng.device
        eng.carry = (tuple(LT.as_tensor(w, dev) for w in words),
                     LT.as_tensor(valid, dev, torch.bool),
                     LT.as_tensor(n_b, dev), LT.as_tensor(status, dev),
                     LT.as_tensor(fail, dev))
        eng._pre = eng.carry
        return eng


# --- the kernel rung ---------------------------------------------------------

def stream_kernel_chunk(seg, off: int, stride: int, ws, stat, table,
                        spec):
    """One carry-mode segment search from ``(ws, stat)``: returns
    ``(ws_out, stat_out)`` on the inputs' device without reading back.
    CPU tensors run the kernel's plain version; any other tensors
    launch ``kernels/seg_search.cu`` (a failed build or launch raises,
    as does a device without CUDA)."""
    if ws.device.type != "cpu":
        return SK._launch(seg, off, stride, ws, stat, table, spec)
    status, fail, n, ws_out = SK.seg_search_reference(
        seg, off, stride, ws, stat, table, spec)
    counter = int(stat[3])
    return ws_out, torch.tensor([status, fail, n, counter],
                                dtype=torch.int32, device=ws.device)


def stream_kernel_megabatch(lanes):
    """B kernel-rung lanes in one beat: ``lanes`` holds per lane
    ``(seg, off, stride, ws, stat, table, spec)``. The launches queue
    on one stream, then ONE readback brings every lane's stat to the
    host. Returns ``(outs, stats)``: per lane ``(ws_out, stat_out)``
    and its stat as four host ints."""
    outs = [stream_kernel_chunk(*ln) for ln in lanes]
    stats = torch.stack([s for _, s in outs]).tolist()
    return outs, stats


class KernelCarry:
    """The kernel rung: the ``(ws, stat)`` word carry (int32[n_words,
    128] and int32[4] = status, fail, n, history counter) threaded
    through carry-mode launches at the session's global segment offset.
    F is the kernel's fixed 128; any overflow or growth event
    re-routes (replay on the next rung). ``read`` is the rung's one
    host sync per append."""

    name = "stream-kernel"

    def __init__(self, spec, n_states: int, n_transitions: int,
                 device=None):
        self.device = resolve_device(device)
        self.spec = spec
        self.ns = n_states
        self.nt = n_transitions
        self.ws = torch.from_numpy(SK.initial_frontier(spec)).to(
            self.device)
        self.stat = torch.from_numpy(SK._init_stat()).to(self.device)
        self._read: Optional[list] = None     # host stat, once read
        self._pre = (self.ws, self.stat)

    def begin_delta(self) -> None:
        self._pre = (self.ws, self.stat)

    def dispatch(self, table, rows: np.ndarray, seg_offset: int) -> None:
        """``rows``: int32[S, 2+2K] from ``seg_kernel.pack_segments``;
        one launch at global offset ``seg_offset`` (fail indices come
        out session-global) with the table's padded stride ``nt``."""
        global DISPATCHES
        DISPATCHES += 1
        seg = torch.from_numpy(np.ascontiguousarray(rows)).to(self.device)
        self.ws, self.stat = stream_kernel_chunk(
            seg, int(seg_offset), self.nt, self.ws, self.stat, table,
            self.spec)
        self._read = None

    def read(self) -> Tuple[int, int, int]:
        if self._read is None:
            self._read = self.stat.tolist()
        st = self._read
        return int(st[0]), int(st[1]), int(st[2])

    def escalate(self) -> bool:
        return False                    # F fixed at 128: re-route

    def respec(self, n_states: int, n_transitions: int, P2: int,
               K: int) -> bool:
        """Absorb growth of the table buckets, the slot width or K IN
        PLACE: the carry holds at most 128 configs of stable state and
        transition ids, so it re-encodes under the new key layout on
        the host (one readback, O(carry)) — the frontier a replay would
        rebuild, bit for bit, without the replay. False when the kernel
        does not serve the new shape (the caller re-routes)."""
        spec = kernel_spec(n_states, n_transitions, P2, K)
        if spec is None:
            return False
        if spec != self.spec:
            cfgs = SK.decode_frontier(self.spec, self.ws, self.spec.P)
            self.ws = torch.from_numpy(SK.encode_frontier(spec, cfgs)).to(
                self.device)
            self.spec = spec
        self.ns, self.nt = n_states, n_transitions
        return True

    def nbytes(self) -> int:
        return int(self.ws.numel() * 4 + self.stat.numel() * 4)

    def checkpoint(self) -> dict:
        """The ``(ws, stat)`` word carry; K rides along so restore can
        re-derive the identical spec (specs are pure functions of (ns,
        nt, P2, K))."""
        return {"rung": "kernel", "ns": self.ns, "nt": self.nt,
                "K": int(self.spec.K), "ws": _host(self.ws),
                "stat": _host(self.stat)}

    @classmethod
    def restore(cls, spec, ck: dict, device=None) -> "KernelCarry":
        eng = cls(spec, int(ck["ns"]), int(ck["nt"]), device=device)
        eng.ws = LT.as_tensor(ck["ws"], eng.device).contiguous()
        eng.stat = LT.as_tensor(ck["stat"], eng.device).reshape(
            4).contiguous()
        eng._pre = (eng.ws, eng.stat)
        return eng


# --- the megabatch -----------------------------------------------------------

class _Lane:
    """One session's pending delta inside a forming megabatch. The
    pack/pad closures defer array building to flush time, when the
    GROUP's pad rung (max over lanes) is known."""

    __slots__ = ("sess", "eng", "n", "k_pad", "pad_fn", "succ",
                 "seg_offset", "pack_fn", "table")

    def __init__(self, sess, eng, n, seg_offset, k_pad=0, pad_fn=None,
                 succ=None, pack_fn=None, table=None):
        self.sess = sess
        self.eng = eng
        self.n = n
        self.seg_offset = seg_offset
        self.k_pad = k_pad
        self.pad_fn = pad_fn
        self.succ = succ
        self.pack_fn = pack_fn
        self.table = table


class MegaBatch:
    """Per-beat collector fusing same-class session deltas into one
    device call per group. Sessions JOIN during staging
    (:meth:`~.session.StreamSession.append_stage` with ``collector=``)
    and the caller flushes once per beat; every staged finalize also
    flushes first, so a second append to one session (which forces
    the first's finalize) can never read a carry whose delta is still
    parked here. ``flush`` DRAINS the queue and is repeat-callable.

    Group keys are ``(rung, device)``: the JAX package's fused programs
    ``vmap`` one shape class, so it keys on ``(rung, F, P2, k_pad, ns,
    nt)`` (``spec`` for the kernel); here every lane runs its own scan
    or launch at its own shape — its own delta bucket, capacity, slot
    width, table and stride — so all the sessions of one rung in a beat
    share one call. A failed group call latches every session of that
    group and of the groups not yet run UNKNOWN — their carries never
    saw the delta — and then raises: on the card a failed launch is an
    error, never a verdict."""

    def __init__(self):
        self._groups: dict = {}
        self.launches = 0        # device calls (all forms)
        self.fused_launches = 0  # megabatched calls (>= 2 lanes)
        self.fused_lanes = 0     # real lanes riding fused calls
        self.masked_lanes = 0    # padding lanes up MEGABATCH_LANES (not run)
        self.solo_lanes = 0      # single-lane calls
        self.lane_counts: list = []   # real lanes per device call

    def add_delta(self, rung: str, sess, eng, n: int, k_pad: int,
                  pad_fn, succ, seg_offset: int) -> None:
        """Queue one xla/mxu-rung delta; ``pad_fn(s_pad)`` builds the
        (ip, it, okp, dp) host arrays at a pad rung."""
        key = (rung, eng.device)
        self._groups.setdefault(key, []).append(
            _Lane(sess, eng, n, seg_offset, k_pad=k_pad,
                  pad_fn=pad_fn, succ=succ))

    def add_kernel(self, sess, eng, n: int, pack_fn, table,
                   seg_offset: int) -> None:
        """Queue one kernel-rung delta; ``pack_fn()`` packs its rows at
        the lane's own spec."""
        key = ("kernel", eng.device)
        self._groups.setdefault(key, []).append(
            _Lane(sess, eng, n, seg_offset, pack_fn=pack_fn,
                  table=table))

    def add_wl(self, key: tuple, lane) -> None:
        """Queue one workload-family session delta (:mod:`.wl`).
        ``key`` is the wl fuse key — ``("wl-bank", a_pad, device)`` /
        ``("wl-sets", e_pad, device)`` — and ``lane`` the wl module's
        staged-lane record (it exposes ``.sess``)."""
        self._groups.setdefault(key, []).append(lane)

    def flush(self) -> None:
        while self._groups:
            groups, self._groups = self._groups, {}
            items = list(groups.items())
            for i, (key, lanes) in enumerate(items):
                try:
                    self._launch_group(key, lanes)
                except Exception as e:
                    cause = f"engine: {type(e).__name__}: {e}"
                    for _, rest in items[i:]:
                        for ln in rest:
                            ln.sess._latch_unknown(cause)
                    raise

    # -- launch forms --------------------------------------------------

    def _launch_group(self, key, lanes) -> None:
        if isinstance(key[0], str) and key[0].startswith("wl-"):
            from . import wl as _WL
            _WL.launch_wl_group(self, key, lanes)
            return
        top = MEGABATCH_LANES[-1]
        for i in range(0, len(lanes), top):
            chunk = lanes[i:i + top]
            if len(chunk) == 1:
                self._launch_solo(key, chunk[0])
            elif key[0] == "kernel":
                self._launch_kernel(chunk)
            else:
                self._launch_delta(key, chunk)

    def _stat(self, rung: str, b_real: int, b_pad: int, t0: float
              ) -> None:
        self.launches += 1
        self.lane_counts.append(b_real)
        if b_real == 1:
            self.solo_lanes += 1
        else:
            self.fused_launches += 1
            self.fused_lanes += b_real
            self.masked_lanes += b_pad - b_real
        _obs.record("stream.megabatch", t0, _obs.monotonic(),
                    rung=rung, lanes=b_real, masked=b_pad - b_real)

    def _launch_solo(self, key, ln) -> None:
        t0 = _obs.monotonic()
        if key[0] == "kernel":
            ln.eng.dispatch(ln.table, ln.pack_fn(), ln.seg_offset)
        else:
            floor = MXU_DELTA_FLOOR if key[0] == "mxu" else 0
            s_pad = bucket_delta(ln.n, floor)
            ip, it, okp, dp = ln.pad_fn(s_pad)
            ln.eng.dispatch(ln.succ, ip, it, okp, dp, ln.seg_offset)
        ln.sess.dispatches += 1
        self._stat(key[0], 1, 1, t0)

    def _launch_kernel(self, chunk) -> None:
        global DISPATCHES, MEGABATCHES
        t0 = _obs.monotonic()
        b_real = len(chunk)
        b_pad = next(b for b in MEGABATCH_LANES if b >= b_real)
        lanes = []
        for ln in chunk:
            eng = ln.eng
            seg = torch.from_numpy(np.ascontiguousarray(
                ln.pack_fn())).to(eng.device)
            lanes.append((seg, int(ln.seg_offset), eng.nt, eng.ws,
                          eng.stat, ln.table, eng.spec))
        DISPATCHES += 1
        MEGABATCHES += 1
        outs, stats = stream_kernel_megabatch(lanes)
        for ln, (ws, stat), host in zip(chunk, outs, stats):
            ln.eng.ws, ln.eng.stat, ln.eng._read = ws, stat, host
            ln.sess.dispatches += 1
        self._stat("kernel", b_real, b_pad, t0)

    def _launch_delta(self, key, chunk) -> None:
        global DISPATCHES, MEGABATCHES
        t0 = _obs.monotonic()
        rung, device = key
        b_real = len(chunk)
        b_pad = next(b for b in MEGABATCH_LANES if b >= b_real)
        floor = MXU_DELTA_FLOOR if rung == "mxu" else 0
        # every lane at its own delta bucket and shape, as solo
        arrs = [ln.pad_fn(bucket_delta(ln.n, floor)) for ln in chunk]
        ip, it, okp, dp = ([a[j] for a in arrs] for j in range(4))
        offs = np.array([ln.seg_offset for ln in chunk], np.int32)
        succs = tuple(ln.succ for ln in chunk)
        carries = tuple(ln.eng.carry for ln in chunk)
        shape = {"F": [ln.eng.F for ln in chunk],
                 "P": [ln.eng.P2 for ln in chunk],
                 "n_states": [ln.eng.ns for ln in chunk],
                 "n_transitions": [ln.eng.nt for ln in chunk]}
        DISPATCHES += 1
        MEGABATCHES += 1
        if rung == "mxu":
            outs = MXU.check_device_mxu_megabatch(
                succs, ip, it, okp, dp, offs, carries, device=device,
                **shape)
        else:
            outs = stream_delta_megabatch(
                succs, ip, it, okp, dp, offs, carries, Fs=STREAM_FS,
                device=device, **shape)
        for ln, carry in zip(chunk, outs):
            ln.eng.carry = carry
            ln.sess.dispatches += 1
        self._stat(rung, b_real, b_pad, t0)


# --- rung policy -------------------------------------------------------------

def pad_sizes(n_states: int, n_transitions: int) -> Tuple[int, int]:
    """Pow2 memo-dim buckets: the sizes every rung's table is padded
    to (every dispatch routes raw counts through here)."""
    return _next_pow2(n_states), _next_pow2(n_transitions)


def kernel_spec(n_states: int, n_transitions: int, P2: int,
                K: int) -> Optional[SK.SegKernelSpec]:
    """The session's kernel spec, or None when the shape can't run in
    the kernel (the caller then picks the MXU/xla rung). The gate is
    taken at the sizes the table is PACKED at — the pow2 buckets: a
    shape whose exact table fits ``MAX_TABLE`` but whose padded one
    does not must take another rung. No probe: on the card a missing
    ``nvcc`` or a failed build raises at the first launch."""
    ns, nt = pad_sizes(n_states, n_transitions)
    return SK.spec_for(ns, nt, P2, K + (K & 1))


def pick_rung(n_states: int, n_transitions: int, P2: int, K: int,
              engine: str = "auto") -> str:
    """Rung policy, mirroring ``analysis``'s ladder: kernel when the spec
    serves the shape, MXU for wide P, xla otherwise. ``engine`` forces
    a specific rung."""
    if engine in ("kernel", "mxu", "xla"):
        return engine
    if kernel_spec(n_states, n_transitions, P2, K) is not None:
        return "kernel"
    if MXU.serves(n_states, n_transitions, P2):
        return "mxu"
    return "xla"


__all__ = ["DELTA_PADS", "DISPATCHES", "KernelCarry", "MEGABATCHES",
           "MEGABATCH_LANES", "MXU_DELTA_FLOOR", "MegaBatch",
           "MxuCarry", "STREAM_CAPACITIES", "STREAM_MAX_K",
           "STREAM_MAX_P", "XlaCarry", "bucket_delta", "kernel_spec",
           "pad_sizes", "pick_rung", "stream_delta_chunk",
           "stream_delta_megabatch", "stream_kernel_chunk",
           "stream_kernel_megabatch"]
