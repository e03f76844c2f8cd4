"""Seeded workload generators with violation twins.

Each family gets a valid-BY-CONSTRUCTION generator and a provable
minimal violation twin (the ``wide_register_batch_*`` discipline): the
base history is correct because it is generated by simulating the
model itself, and the twin perturbs exactly one op in a way the
invariant provably rejects — so golden tests can assert device /
host-oracle bit-agreement on both verdict polarities without any
search.

Bank twins lean on an EVENNESS argument: every init balance and
transfer amount is even, so every reachable snapshot has all-even
entries — a ``+1`` tamper is provably wrong-total, and a ``+1/-1``
tamper on two accounts provably matches NO snapshot while keeping the
total (the ``snapshot`` twin exercises the diagnostic plane with
``valid?`` still True).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ...ops.op import Op, fail, info, invoke, ok
from .bank import default_init

_BANK_VIOLATIONS = (None, "total", "n", "snapshot")
_SETS_VIOLATIONS = (None, "lost", "phantom")
_DIRTY_VIOLATIONS = (None, "dirty", "disagree", "malformed")


def bank_batch(seed: int, n_histories: int, *, n_accounts: int = 8,
               n_transfers: int = 16, n_reads: int = 6,
               violation: Optional[str] = None
               ) -> Tuple[List[List[Op]], dict]:
    """Simulated atomic bank: even-amount transfers (some failing,
    not applied), reads of the exact current snapshot. Returns
    ``(histories, model)``."""
    if violation not in _BANK_VIOLATIONS:
        raise ValueError(f"violation must be one of {_BANK_VIOLATIONS}")
    rng = np.random.default_rng(seed)
    total = 20 * n_accounts
    model = {"n": n_accounts, "total": total}
    init = default_init(model)
    assert all(x % 2 == 0 for x in init), \
        "bank twins need even init balances"
    histories: List[List[Op]] = []
    for b in range(n_histories):
        bal = list(init)
        hist: List[Op] = []
        reads_done = 0
        n_ops = n_transfers + n_reads
        read_at = set(rng.choice(n_ops, size=n_reads, replace=False))
        p = 0
        for k in range(n_ops):
            if k in read_at:
                row = list(bal)
                hist.append(invoke(p, "read", None))
                hist.append(ok(p, "read", tuple(row)))
                reads_done += 1
            else:
                frm, to = rng.choice(n_accounts, 2, replace=False)
                amt = 2 * int(rng.integers(1, 6))
                v = (int(frm), int(to), amt)
                hist.append(invoke(p, "transfer", v))
                if rng.random() < 0.2:
                    hist.append(fail(p, "transfer", v))
                else:
                    bal[frm] -= amt
                    bal[to] += amt
                    hist.append(ok(p, "transfer", v))
            p += 1
        if violation is not None:
            ri = max(i for i, op in enumerate(hist)
                     if op.type == "ok" and op.f == "read")
            row = list(hist[ri].value)
            if violation == "total":
                row[0] += 1                 # odd entry: wrong-total
            elif violation == "n":
                row = row[:-1]              # ragged: wrong-n
            else:                           # "snapshot"
                row[0] += 1                 # odd entries, total kept:
                row[1] -= 1                 # matches NO even snapshot
            hist[ri] = hist[ri].with_(value=tuple(row))
            hist[ri - 1] = hist[ri - 1].with_(value=tuple(row))
        histories.append(hist)
    return histories, model


def sets_batch(seed: int, n_histories: int, *, n_adds: int = 24,
               violation: Optional[str] = None) -> List[List[Op]]:
    """Adds (ok / fail / info) then one final read of exactly the
    acked set plus any crashed-but-applied (recovered) adds — legal
    by the set test's rules. Twins drop one acked element (lost) or
    read back a never-attempted one (phantom)."""
    if violation not in _SETS_VIOLATIONS:
        raise ValueError(f"violation must be one of {_SETS_VIOLATIONS}")
    rng = np.random.default_rng(seed)
    histories: List[List[Op]] = []
    for b in range(n_histories):
        hist: List[Op] = []
        acked: List[int] = []
        read_back: List[int] = []
        for v in range(n_adds):
            hist.append(invoke(v, "add", v))
            roll = rng.random()
            if roll < 0.7:
                hist.append(ok(v, "add", v))
                acked.append(v)
                read_back.append(v)
            elif roll < 0.85:
                hist.append(fail(v, "add", v))
            else:
                hist.append(info(v, "add", v))
                if rng.random() < 0.5:
                    read_back.append(v)     # recovered: still valid
        if violation == "lost" and acked:
            read_back.remove(acked[int(rng.integers(len(acked)))])
        elif violation == "phantom":
            read_back.append(n_adds + 7)    # never attempted
        hist.append(invoke(n_adds, "read", None))
        hist.append(ok(n_adds, "read", tuple(read_back)))
        histories.append(hist)
    return histories


def dirty_batch(seed: int, n_histories: int, *, n_writes: int = 16,
                n_reads: int = 6, n_nodes: int = 3,
                violation: Optional[str] = None) -> List[List[Op]]:
    """Writes (some failing) and per-node row reads that always show
    one committed value on every node. Twins surface a FAILED write's
    value on one node (dirty — INVALID), split the nodes across two
    committed values (disagree — diagnostic, still valid), or hand
    the checker a scalar read (malformed — UNKNOWN)."""
    if violation not in _DIRTY_VIOLATIONS:
        raise ValueError(
            f"violation must be one of {_DIRTY_VIOLATIONS}")
    rng = np.random.default_rng(seed)
    histories: List[List[Op]] = []
    for b in range(n_histories):
        hist: List[Op] = []
        committed: List[int] = []
        failed: List[int] = []
        v = 0
        for _ in range(n_writes):
            hist.append(invoke(v, "write", v))
            if rng.random() < 0.7:
                hist.append(ok(v, "write", v))
                committed.append(v)
            else:
                hist.append(fail(v, "write", v))
                failed.append(v)
            v += 1
        for r in range(n_reads):
            pick = committed[int(rng.integers(len(committed)))] \
                if committed else -1
            row = (pick,) * n_nodes
            hist.append(invoke(v + r, "read", None))
            hist.append(ok(v + r, "read", row))
        ri = len(hist) - 1
        if violation == "dirty" and failed:
            row = list(hist[ri].value)
            row[-1] = failed[int(rng.integers(len(failed)))]
            hist[ri] = hist[ri].with_(value=tuple(row))
        elif violation == "disagree" and len(set(committed)) > 1:
            a, c = committed[0], committed[-1]
            row = [a] * n_nodes
            row[-1] = c
            hist[ri] = hist[ri].with_(value=tuple(row))
        elif violation == "malformed":
            hist[ri] = hist[ri].with_(value=int(hist[ri].value[0]))
        histories.append(hist)
    return histories


__all__ = ["bank_batch", "dirty_batch", "sets_batch"]
