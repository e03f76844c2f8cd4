"""Columnar host ingest — the struct-of-arrays packer.

Rebuilds history completion and packing as columnar NumPy over
parallel arrays:

- one pass extracts the op columns (the ONLY per-op loop — the Op list
  is the API edge),
- invocation/completion pairing, double-pending validation, value
  back-fill bookkeeping, and transition-id assignment are vectorized
  (per-process runs via one stable argsort; first-occurrence interning
  via ``np.unique`` re-ranked by first index),
- ``f``/``process``/``value`` interning stays an exact dict pass over
  the columns (values are arbitrary Python objects; hashing them is
  the contract).

Every output — arrays, table orders, error classes on malformed input
— matches the JAX package's packer bit for bit (the port's parity tests
hold them equal). Transition ids fix every engine's key layout, so a
packer that reordered them would shift frontier contents and fail
indices.
"""

from __future__ import annotations

from typing import Any, List, Tuple

import numpy as np

from .op import FAIL, INVOKE, OK, TYPE_CODES, Op


def _intern_column(column) -> Tuple[np.ndarray, List[Any]]:
    """First-occurrence interning of arbitrary hashable objects (ids
    in first-appearance order). The dict pass is kept because values
    mix types (``None``, ints, tuples) and any numpy coercion would
    silently merge ``1`` with ``"1"`` or unpack tuples into 2-D
    arrays."""
    ids: dict = {}
    table: List[Any] = []
    codes = np.empty(len(column), np.int32)
    get = ids.get
    for i, x in enumerate(column):
        j = get(x)
        if j is None:
            j = len(table)
            ids[x] = j
            table.append(x)
        codes[i] = j
    return codes, table


def _first_occurrence_codes(arr: np.ndarray):
    """Re-rank ``np.unique``'s sorted ids into first-appearance order
    so integer-keyed interning matches the dict interner exactly."""
    uniq, first, inv = np.unique(arr, return_index=True,
                                 return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty(order.size, np.int64)
    rank[order] = np.arange(order.size)
    return rank[inv.reshape(-1)], uniq[order]


def _per_process_prev(proc_codes: np.ndarray, sel_idx: np.ndarray,
                      is_inv: np.ndarray):
    """Per-process event chains via ONE stable argsort: for the
    selected rows, returns (sorted row ids, 'previous same-process
    event was an invoke' flags, previous same-process row ids)."""
    pr = proc_codes[sel_idx]
    order = np.argsort(pr, kind="stable")
    srt = sel_idx[order]
    psort = pr[order]
    start = np.empty(order.size, bool)
    if order.size:
        start[0] = True
        start[1:] = psort[1:] != psort[:-1]
    inv_flag = is_inv[srt]
    prev_inv = np.empty(order.size, bool)
    prev_row = np.empty(order.size, np.int64)
    if order.size:
        prev_inv[0] = False
        prev_inv[1:] = inv_flag[:-1]
        prev_row[0] = -1
        prev_row[1:] = srt[:-1]
        prev_inv[start] = False
        prev_row[start] = -1
    return srt, inv_flag, prev_inv, prev_row


def intern_transitions(f_codes: np.ndarray, value_codes: np.ndarray,
                       inv_rows: np.ndarray, n_values: int, n: int):
    """First-occurrence (f_id, value_id) transition interning over the
    non-failing invoke rows — THE id order every engine's key layout
    depends on. Returns ``(trans int32[n], transition_table)``."""
    trans = np.full(n, -1, np.int32)
    if inv_rows.size:
        combo = (f_codes[inv_rows].astype(np.int64) * n_values
                 + value_codes[inv_rows])
        tr_codes, tr_keys = _first_occurrence_codes(combo)
        trans[inv_rows] = tr_codes
        table = [(int(c // n_values), int(c % n_values))
                 for c in tr_keys]
    else:
        table = []
    return trans, table


def pack_history_columnar(history: List[Op], completed: bool = False):
    """Columnar :func:`~.packed.pack_history`; see the module
    docstring."""
    from .packed import PackedHistory

    n = len(history)
    # the API-edge pass: Op objects -> parallel columns
    procs = [op.process for op in history]
    fs = [op.f for op in history]
    vals = [op.value for op in history]
    type_codes = np.fromiter((TYPE_CODES[op.type] for op in history),
                             np.int8, n)
    fails = np.fromiter((op.fails for op in history), np.bool_, n)
    time = np.fromiter((-1 if op.time is None else op.time
                        for op in history), np.int64, n)

    proc_codes, process_table = _intern_column(procs)
    f_codes, f_table = _intern_column(fs)

    is_inv = type_codes == INVOKE
    is_ok = type_codes == OK
    is_fail = type_codes == FAIL
    sel_idx = np.flatnonzero(is_inv | is_ok | is_fail)
    srt, inv_flag, prev_inv, prev_row = _per_process_prev(
        proc_codes, sel_idx, is_inv)

    if not completed:
        # history.complete's validation, vectorized: per process the
        # invoke/completion events must strictly alternate starting
        # with an invoke
        dbl = inv_flag & prev_inv
        if dbl.any():
            i = int(srt[dbl].min())
            j = int(prev_row[dbl][np.argmin(srt[dbl])])
            raise RuntimeError(
                f"process {history[i].process!r} already running "
                f"{history[j]}, yet invoked {history[i]}")
        orphan = ~inv_flag & ~prev_inv
        if orphan.any():
            i = int(srt[orphan].min())
            raise RuntimeError(
                f"{history[i].type} without invocation: {history[i]}")
    else:
        # pre-completed input: a later invoke silently overwrites the
        # pending one (its pair stays -1); a completion with no pending
        # invoke is a KeyError
        orphan = ~inv_flag & ~prev_inv
        if orphan.any():
            i = int(srt[orphan].min())
            raise KeyError(history[i].process)

    comp = ~inv_flag & prev_inv
    crow = srt[comp]
    irow = prev_row[comp]
    pair = np.full(n, -1, np.int32)
    pair[crow] = irow
    pair[irow] = crow

    if not completed:
        vals = list(vals)
        ok_pairs = is_ok[crow]
        for c, i in zip(crow[ok_pairs].tolist(),
                        irow[ok_pairs].tolist()):
            vals[i] = vals[c]           # back-fill from the ok
        for c, i in zip(crow[~ok_pairs].tolist(),
                        irow[~ok_pairs].tolist()):
            iv, fv = vals[i], vals[c]
            if iv is not None and fv is not None and iv != fv:
                raise RuntimeError(
                    f"invocation value {iv!r} and failure value "
                    f"{fv!r} don't match: {history[c]}")
            v = iv if iv is not None else fv
            vals[i] = v
            vals[c] = v
        fails = fails.copy()
        fails[irow[~ok_pairs]] = True
        fails[crow[~ok_pairs]] = True

    value_codes, value_table = _intern_column(vals)

    trans, transition_table = intern_transitions(
        f_codes, value_codes, np.flatnonzero(is_inv & ~fails),
        max(len(value_table), 1), n)

    return PackedHistory(
        process=proc_codes, type=type_codes, f=f_codes,
        value=value_codes, trans=trans, pair=pair, fails=fails,
        time=time, process_table=process_table, f_table=f_table,
        value_table=value_table, transition_table=transition_table,
        ops_list=(list(history) if completed else None))


__all__ = ["intern_transitions", "pack_history_columnar"]
