"""Whole-batch columnar history generation — arrays in, arrays out.

:func:`.synth.register_history` simulates one process pool
step-at-a-time in Python (~2.5 us/event); at the 4096x2k-op batch
shape that alone is ~50 s of host time. This module generates the SAME
workload class — linearizable-by-construction cas-register histories
over N single-threaded processes — for a whole batch at once, straight
into :class:`~.packed.PackedHistory` arrays, with no Op objects on the
way (they stay a lazy ``.ops`` view at the API edge).

Construction (the standard serial-schedule trick the porcupine-style
checkers use for synthetic load):

- op ``k`` of every history APPLIES at integer time ``k`` — the serial
  order is the op order, so register semantics reduce to one
  vectorized scan over op positions with the whole batch as lanes;
- each op's invoke/completion events get continuous jitter times
  strictly inside ``(previous same-process completion, k)`` and
  ``(k, next same-process op)`` — every op takes effect between its
  invoke and completion and each process stays single-threaded, hence
  linearizable by construction with up to ``n_procs`` calls in flight;
- the per-(history, process) chains (prev/next op, crash retirement
  pid renames) come from ONE flat ``np.lexsort`` over (history,
  process, op);
- events sort into history order with one batched argsort; process /
  f / value / transition interning re-ranks ``np.unique`` ids into
  first-occurrence order, matching the dict interner exactly.

Numpy only. The same seed gives the same arrays as the JAX package's
generator of the same name (the port's parity tests hold them equal);
it is not seed-compatible with the per-op generator in :mod:`.synth`.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np

from .columnar import _first_occurrence_codes, intern_transitions
from .op import FAIL, INFO, INVOKE, OK
from .packed import PackedHistory

F_NAMES = ("read", "write", "cas")
_EPS = 1e-3


class RegisterBatchColumns(NamedTuple):
    """Per-EVENT columns for a batch of histories, in history order
    (axis 0 = history, axis 1 = the 2*n_ops events). ``vkey`` is the
    numeric value encoding (0 = nil, 1+x = int x, 1+V+a*V+b = the cas
    pair (a, b)); ``pair`` holds partner event positions (-1 for
    crashed ops)."""
    type: np.ndarray    # int8[B, 2n]
    pid: np.ndarray     # int64[B, 2n] — process names (post-retirement)
    f: np.ndarray       # int8[B, 2n]  — 0 read / 1 write / 2 cas
    vkey: np.ndarray    # int64[B, 2n]
    fails: np.ndarray   # bool[B, 2n]
    pair: np.ndarray    # int32[B, 2n]
    values: int         # the value-alphabet size (decodes vkey)


def register_batch_columns(seed: int, n_histories: int, n_ops: int,
                           n_procs: int = 5, values: int = 5,
                           p_info: float = 0.0) -> RegisterBatchColumns:
    """Generate ``n_histories`` distinct register histories of
    ``n_ops`` completed ops each, as one columnar event table."""
    B, n = n_histories, n_ops
    if n <= 0 or B <= 0:
        raise ValueError("need n_histories >= 1 and n_ops >= 1")
    rng = np.random.default_rng(seed)
    f = rng.integers(0, 3, (B, n)).astype(np.int8)
    wval = rng.integers(0, values, (B, n))
    casa = rng.integers(0, values, (B, n))
    casb = rng.integers(0, values, (B, n))
    proc = rng.integers(0, n_procs, (B, n))
    u = rng.random((B, n))
    v = rng.random((B, n))
    info = (rng.random((B, n)) < p_info) if p_info > 0 \
        else np.zeros((B, n), bool)

    # serial register semantics: op k applies at time k — one scan
    # over op positions, all histories as vector lanes (-1 = nil)
    state = np.full(B, -1, np.int64)
    readv = np.empty((B, n), np.int64)
    casok = np.zeros((B, n), bool)
    for k in range(n):
        readv[:, k] = state
        okm = (f[:, k] == 2) & (state == casa[:, k])
        casok[:, k] = okm
        state = np.where(f[:, k] == 1, wval[:, k],
                         np.where(okm, casb[:, k], state))

    # per-(history, process) chains via one flat lexsort
    flat_b = np.repeat(np.arange(B), n)
    flat_k = np.tile(np.arange(n), B)
    flat_p = proc.ravel()
    order = np.lexsort((flat_k, flat_p, flat_b))
    ks = flat_k[order].astype(np.float64)
    grp = np.empty(order.size, bool)
    grp[0] = True
    grp[1:] = (flat_b[order][1:] != flat_b[order][:-1]) \
        | (flat_p[order][1:] != flat_p[order][:-1])
    last = np.empty(order.size, bool)
    last[:-1] = grp[1:]
    last[-1] = True
    next_k = np.empty(order.size, np.float64)
    next_k[:-1] = ks[1:]
    next_k[last] = float(n)
    # completion strictly inside (k, next same-process op)
    comp_s = ks + _EPS + v.ravel()[order] * (next_k - ks - 2 * _EPS)
    prev_comp = np.empty(order.size, np.float64)
    prev_comp[1:] = comp_s[:-1]
    prev_comp[grp] = -1.0
    # invoke strictly inside (previous completion, k)
    span = np.maximum(ks - prev_comp - 2 * _EPS, 0.0)
    inv_s = ks - _EPS - u.ravel()[order] * span

    inv_t = np.empty(B * n, np.float64)
    comp_t = np.empty(B * n, np.float64)
    inv_t[order] = inv_s
    comp_t[order] = comp_s
    inv_t = inv_t.reshape(B, n)
    comp_t = comp_t.reshape(B, n)

    # crash retirement: after a process's c-th :info op, its later ops
    # carry a fresh pid = n_procs + (per-history crash counter)
    pid = proc
    if info.any():
        ret_rank = np.cumsum(info, axis=1) - 1          # per history
        flat_rank = np.where(info, ret_rank, -1).ravel()[order]
        run = np.where(grp, np.arange(order.size), 0)
        run = np.maximum.accumulate(run)                # group starts
        # carry the latest info rank forward WITHIN each group, shifted
        # one op (the rename applies after the crash completion); the
        # running max restarts at group boundaries via a per-group
        # base offset that dominates every in-group rank
        shifted = np.empty(order.size, np.int64)
        shifted[1:] = flat_rank[:-1]
        shifted[grp] = -1
        base = run * (n + 2)
        seen = np.maximum.accumulate(base + shifted + 1) - base - 1
        pid_s = np.where(seen >= 0,
                         n_procs + seen, flat_p[order])
        pid = np.empty(B * n, np.int64)
        pid[order] = pid_s
        pid = pid.reshape(B, n)

    # completion types and completed values
    ctype = np.where(info, INFO,
                     np.where((f == 2) & ~casok, FAIL,
                              OK)).astype(np.int8)
    op_fail = ctype == FAIL
    vk = np.empty((B, n), np.int64)
    rmask = f == 0
    vk[rmask] = np.where(info[rmask] | (readv[rmask] < 0),
                         0, 1 + readv[rmask])
    vk[f == 1] = 1 + wval[f == 1]
    cmask = f == 2
    vk[cmask] = 1 + values + casa[cmask] * values + casb[cmask]

    # event assembly: argsort the 2n event times per history
    ev_t = np.concatenate([inv_t, comp_t], axis=1)
    perm = np.argsort(ev_t, axis=1, kind="stable")
    rank = np.argsort(perm, axis=1, kind="stable")

    def gather(col):
        return np.take_along_axis(col, perm, axis=1)

    two = lambda a: np.concatenate([a, a], axis=1)
    ev_type = gather(np.concatenate(
        [np.full((B, n), INVOKE, np.int8), ctype], axis=1))
    ev_pid = gather(two(pid))
    ev_f = gather(two(f))
    ev_vk = gather(two(vk))
    ev_fail = gather(two(op_fail))
    pair = np.full((B, 2 * n), -1, np.int32)
    inv_pos = rank[:, :n]
    comp_pos = rank[:, n:]
    live = ~info
    bgrid = np.repeat(np.arange(B), n).reshape(B, n)
    pair[bgrid[live], inv_pos[live]] = comp_pos[live]
    pair[bgrid[live], comp_pos[live]] = inv_pos[live]
    return RegisterBatchColumns(ev_type, ev_pid, ev_f, ev_vk, ev_fail,
                                pair, values)


def _decode_vkey(key: int, values: int):
    if key == 0:
        return None
    if key <= values:
        return int(key - 1)
    k = key - 1 - values
    return (int(k // values), int(k % values))


def pack_register_columns(
        cols: RegisterBatchColumns) -> List[PackedHistory]:
    """Intern each history's event columns into a PackedHistory —
    first-occurrence table orders, exactly like the packer's."""
    B, m = cols.type.shape
    V = cols.values
    out: List[PackedHistory] = []
    is_inv = cols.type == INVOKE
    for b in range(B):
        pcodes, ptab = _first_occurrence_codes(cols.pid[b])
        fcodes, ftab = _first_occurrence_codes(cols.f[b])
        vcodes, vtab = _first_occurrence_codes(cols.vkey[b])
        fails = cols.fails[b]
        trans, ttab = intern_transitions(
            fcodes, vcodes, np.flatnonzero(is_inv[b] & ~fails),
            max(len(vtab), 1), m)
        out.append(PackedHistory(
            process=pcodes.astype(np.int32),
            type=cols.type[b].copy(),
            f=fcodes.astype(np.int32),
            value=vcodes.astype(np.int32),
            trans=trans, pair=cols.pair[b].copy(),
            fails=fails.copy(),
            time=np.full(m, -1, np.int64),
            process_table=[int(x) for x in ptab],
            f_table=[F_NAMES[x] for x in ftab],
            value_table=[_decode_vkey(int(k), V) for k in vtab],
            transition_table=ttab))
    return out


def register_batch_packed(seed: int, n_histories: int, n_ops: int,
                          n_procs: int = 5, values: int = 5,
                          p_info: float = 0.0) -> List[PackedHistory]:
    """One-call columnar generate + pack (see module docstring)."""
    return pack_register_columns(register_batch_columns(
        seed, n_histories, n_ops, n_procs=n_procs, values=values,
        p_info=p_info))


# --- genuinely-concurrent wide-P histories (MXU engine load) ---------------
#
# ``pinned_wide_history`` (ops/synth.py) exercises wide-P PackPlan
# coverage with crashed cas holding slots — it deliberately forks NO
# configs, so it can't exercise a wide-frontier engine. These waves
# do: every op of a wave is in flight at once (in-flight depth = P at
# the wave's first ok, and remap_slots reports P_eff = P), while the
# frontier stays CONTROLLED instead of the 2^P blow-up of unbounded
# concurrency:
#
# - ``n_chain`` cas ops form a strict chain (cas(v -> v+1 mod M)):
#   only one linearization order is consistent, so they contribute
#   chain-prefix configs, not subsets;
# - ``n_free`` reads all observe the chain's END value: each is
#   linearizable only once the chain completes, and then any SUBSET of
#   them may have linearized — 2^n_free configs.
#
# Peak frontier ~ n_chain + 2^n_free, tunable independently of P =
# n_chain + n_free. n_free = 16 with P = 24 exceeds the seg2 ladder's
# 65536 cap (the honest-UNKNOWN threshold this engine raises) while
# fitting the MXU ladder's 131072; the CPU tests use small n_free.
#
# Linearizable by construction: op k of the serial schedule applies at
# position k (chain ops first, then the reads), every op's
# invoke..completion window spans its whole wave, and each process
# runs exactly one op per wave (single-threaded: wave event blocks are
# disjoint in time). The seeded-violation twin makes ONE read of the
# last wave observe (end+1) mod M — a value the register never holds
# inside that wave's window (windows span n_chain+1 < M values), so
# the frontier dies exactly at that read's ok.

def wide_register_batch_columns(seed: int, n_histories: int,
                                n_waves: int, n_chain: int,
                                n_free: int, values: int = 16,
                                violation: bool = False
                                ) -> RegisterBatchColumns:
    """Columns for genuinely-concurrent bounded-in-flight register
    histories at P = ``n_chain + n_free`` (see the block comment)."""
    B = n_histories
    P = n_chain + n_free
    M = values
    if B <= 0 or n_waves <= 0 or n_chain < 1 or n_free < 0:
        raise ValueError("need n_histories/n_waves >= 1, n_chain >= 1")
    if n_chain + 1 >= M:
        raise ValueError(
            f"need values > n_chain + 1 (got {M} <= {n_chain + 1}): "
            "a wave window may not wrap the whole value alphabet, or "
            "the seeded violation value could be legitimately "
            "observable")
    if violation and n_free < 1:
        raise ValueError(
            "violation=True needs n_free >= 1: the seeded violation "
            "is a free READ observing a value outside the wave's "
            "reachable window — with no free reads the twin would "
            "silently be a valid history")
    rng = np.random.default_rng(seed)
    m = 2 * n_waves * P                      # events per history
    ev_type = np.empty((B, m), np.int8)
    ev_pid = np.empty((B, m), np.int64)
    ev_f = np.empty((B, m), np.int8)
    ev_vk = np.empty((B, m), np.int64)
    pair = np.full((B, m), -1, np.int32)
    brow = np.arange(B)

    cur = rng.integers(0, M, B)              # per-history start value
    for j in range(n_waves):
        # per-history op schedule for this wave, in SERIAL order:
        # chain ops 0..n_chain-1 then reads. Wave 0's chain starts
        # with a write (the register boots nil — a cas can't fire).
        f = np.empty((B, P), np.int8)
        vk = np.empty((B, P), np.int64)
        if j == 0:
            f[:, 0] = 1                      # write(cur)
            vk[:, 0] = 1 + cur
        else:
            f[:, 0] = 2                      # cas(cur -> cur+1)
            vk[:, 0] = 1 + M + cur * M + ((cur + 1) % M)
            cur = (cur + 1) % M
        for i in range(1, n_chain):
            f[:, i] = 2
            vk[:, i] = 1 + M + cur * M + ((cur + 1) % M)
            cur = (cur + 1) % M
        f[:, n_chain:] = 0                   # reads of the end value
        vk[:, n_chain:] = (1 + cur)[:, None]
        if violation and j == n_waves - 1 and n_free > 0:
            # the twin: one read observes a value outside the wave's
            # reachable window
            vk[:, P - 1] = 1 + ((cur + 1) % M)
        # each process runs exactly one wave op; which op lands on
        # which process is shuffled per history
        perm = np.argsort(rng.random((B, P)), axis=1)
        # event order inside the wave: all P invokes (shuffled), then
        # all P completions (shuffled; the violating read completes
        # LAST so the frontier still peaks before it dies). argsort of
        # uniform noise is a uniform permutation — its rows ARE the
        # event positions of ops 0..P-1.
        ok_order = rng.random((B, P))
        if violation and j == n_waves - 1 and n_free > 0:
            ok_order[:, P - 1] = 2.0         # sorts last
        ok_rank = np.argsort(np.argsort(ok_order, axis=1), axis=1)
        base = 2 * P * j
        inv_pos = base + np.argsort(rng.random((B, P)), axis=1)
        ok_pos = base + P + ok_rank
        for col, pos in ((inv_pos, True), (ok_pos, False)):
            idx = (brow[:, None], col)
            ev_type[idx] = INVOKE if pos else OK
            ev_pid[idx] = perm
            ev_f[idx] = f
            ev_vk[idx] = vk
        pair[brow[:, None], inv_pos] = ok_pos
        pair[brow[:, None], ok_pos] = inv_pos
    fails = np.zeros((B, m), bool)
    return RegisterBatchColumns(ev_type, ev_pid, ev_f, ev_vk, fails,
                                pair, M)


def wide_register_batch_packed(seed: int, n_histories: int,
                               n_waves: int, n_chain: int,
                               n_free: int, values: int = 16,
                               violation: bool = False
                               ) -> List[PackedHistory]:
    """One-call columnar generate + pack of the wide-P wave histories
    (see :func:`wide_register_batch_columns`)."""
    return pack_register_columns(wide_register_batch_columns(
        seed, n_histories, n_waves, n_chain, n_free, values=values,
        violation=violation))


__all__ = ["RegisterBatchColumns", "register_batch_columns",
           "pack_register_columns", "register_batch_packed",
           "wide_register_batch_columns", "wide_register_batch_packed"]
