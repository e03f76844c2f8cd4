"""Bank workload as a batched tensor family.

The Jepsen bank test moves money between ``n`` accounts with
``transfer`` ops and reads all balances at once; the invariant is that
every read sees exactly ``n`` balances summing to the model total
(``comdb2/core.clj:152-177``, :class:`~..workloads.BankChecker`). No
frontier search is needed — the whole check is a masked row-sum
reduction, so a batch of histories is one device call of torch ops
(the counterpart of the JAX package's ``checker/wl/bank.py``).

Tensor layout (axis 0 = history lane, all dims pow2-padded from the
``checker.wl.batch`` ladders):

- ``reads``      int32[B, R, A]  — ok-read balance rows (0-padded)
- ``read_mask``  bool[B, R]      — real read rows
- ``wrong_n``    bool[B, R]      — host-flagged ragged rows (a read
  with the wrong account count cannot be laid out in (A,) faithfully;
  the flag rides into the device reduction so the verdict is still a
  single device readback)
- ``init``       int32[B, A]     — starting balances
- ``transfers``  int32[B, T, A]  — per-ok-transfer account deltas
  (0-padded rows are no-ops)
- ``total``      int32[B]

All-int32 on device, as in the JAX package: sums, prefix sums and
snapshots are int32 with two's-complement wrap (torch is asked for
int32 results where it would widen), so even a tampered read past the
int32 range sums to the same bits in both packages.

Beyond the oracle's wrong-n / wrong-total, the device also proves a
DIAGNOSTIC snapshot-inconsistency plane: prefix snapshots
``S_t = init + cumsum(transfers)[:t]`` (t = 0..T) are the only states
a serializable bank can ever expose, so a read matching NO ``S_t``
observed a mid-transfer (fractured) state even when its total happens
to balance. Like the dirty-reads oracle's ``inconsistent-reads``, it
does not affect ``valid?`` — the device verdict stays bit-identical to
:class:`~..workloads.BankChecker`.

The JAX package scans the T + 1 snapshots one by one (``lax.scan``).
Broadcasting every read against every snapshot at once would take
B·R·(T+1)·A bools — about 17 GB at the top rungs (512 lanes, 512
reads, 513 snapshots, 128 accounts) — so the port matches the
snapshots in blocks of at most ``SNAP_BLOCK`` compared elements
(64 Mi bools, whatever the rungs).

The stream rung's delta forms (``wl_bank_delta``, ``wl_bank_delta_mb``)
advance a live session's (A,) running-balance carry by one append:
the solo form is the lane-batched body at B = 1, so a megabatched
advance is bit-identical to the solo one.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import numpy as np
import torch

#: fields of :class:`BankColumns` that :func:`wl_bank_check` takes, in
#: its argument order
DEVICE_FIELDS = ("reads", "read_mask", "wrong_n", "init", "transfers",
                 "total")

#: most elements of one (B, R, C, A) snapshot-match block
SNAP_BLOCK = 1 << 26


class BankColumns(NamedTuple):
    """Encoded bank histories (see module docstring). ``read_index``
    maps read rows back to op indices for counterexample reporting."""
    reads: np.ndarray       # int32[B, R, A]
    read_mask: np.ndarray   # bool[B, R]
    wrong_n: np.ndarray     # bool[B, R]
    wrong_len: np.ndarray   # int32[B, R] — found length of wrong-n rows
    init: np.ndarray        # int32[B, A]
    transfers: np.ndarray   # int32[B, T, A]
    total: np.ndarray       # int32[B]
    read_index: np.ndarray  # int32[B, R] — op index of each read row
    n: int                  # the model's account count (un-padded)


def default_init(model: dict) -> List[int]:
    """Starting balances: the model's ``init`` when present, else the
    Jepsen default of an even split (remainder on account 0)."""
    n, total = int(model["n"]), int(model["total"])
    if "init" in model:
        init = [int(x) for x in model["init"]]
        if len(init) != n or sum(init) != total:
            raise ValueError("model init must hold n balances summing "
                             "to total")
        return init
    per = total // n
    return [total - per * (n - 1)] + [per] * (n - 1)


def encode_bank(histories: Sequence[Sequence], model: dict, *,
                r_pad: int, a_pad: int, t_pad: int) -> BankColumns:
    """Host encode: one pass per history over its ops into the padded
    column planes. ``transfer`` op values are ``(frm, to, amount)``."""
    B = len(histories)
    n = int(model["n"])
    if a_pad < n:
        raise ValueError(f"a_pad {a_pad} < model n {n}")
    if abs(int(model["total"])) >= 1 << 30:
        raise ValueError("bank totals must fit int32 (no x64 here)")
    init_row = default_init(model)
    reads = np.zeros((B, r_pad, a_pad), np.int32)
    read_mask = np.zeros((B, r_pad), bool)
    wrong_n = np.zeros((B, r_pad), bool)
    wrong_len = np.zeros((B, r_pad), np.int32)
    read_index = np.full((B, r_pad), -1, np.int32)
    transfers = np.zeros((B, t_pad, a_pad), np.int32)
    init = np.zeros((B, a_pad), np.int32)
    init[:, :n] = init_row
    total = np.full(B, int(model["total"]), np.int32)
    for b, hist in enumerate(histories):
        r = t = 0
        for i, op in enumerate(hist):
            if op.type != "ok" or op.value is None:
                continue
            if op.f == "read":
                row = list(op.value)
                if r >= r_pad:
                    raise ValueError(f"history {b}: > {r_pad} reads")
                read_mask[b, r] = True
                read_index[b, r] = i if op.index is None else op.index
                if len(row) != n:
                    wrong_n[b, r] = True
                    wrong_len[b, r] = len(row)
                else:
                    reads[b, r, :n] = row
                r += 1
            elif op.f == "transfer":
                frm, to, amt = op.value
                if t >= t_pad:
                    raise ValueError(
                        f"history {b}: > {t_pad} transfers")
                transfers[b, t, int(frm)] -= int(amt)
                transfers[b, t, int(to)] += int(amt)
                t += 1
    return BankColumns(reads, read_mask, wrong_n, wrong_len, init,
                       transfers, total, read_index, n)


def first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis, -1 where none
    (``jnp.argmax``'s first-on-ties, without an argmax over bool)."""
    n = mask.shape[-1]
    idx = torch.arange(n, device=mask.device)
    first = torch.where(mask, idx, n).amin(-1)
    return torch.where(first < n, first, -1)


def wl_bank_check(reads, read_mask, wrong_n, init, transfers, total, *,
                  n_reads: int, n_accounts: int, n_snaps: int):
    """One batched bank verdict over tensors on one device (the torch
    counterpart of the JAX package's jit). The keyword dims restate the
    padded shapes. Returns ``(valid[B], wrong_total[B, R],
    snap_bad[B, R], first_bad[B], sums[B, R])`` on the device."""
    B = reads.shape[0]
    if tuple(reads.shape) != (B, n_reads, n_accounts) \
            or transfers.shape[1] != n_snaps:
        raise ValueError(f"bank planes {tuple(reads.shape)} / "
                         f"{tuple(transfers.shape)} are not the declared "
                         f"({n_reads}, {n_accounts}, {n_snaps})")
    sums = reads.sum(2, dtype=torch.int32)                      # (B,R)
    wrong_total = read_mask & ~wrong_n & (sums != total[:, None])
    bad = read_mask & (wrong_n | wrong_total)
    # snapshot plane: S_0 = init, S_t = init + cumsum(transfers)[t-1]
    snaps = torch.cat(
        [torch.zeros_like(transfers[:, :1]),
         torch.cumsum(transfers, 1, dtype=torch.int32)],
        dim=1) + init[:, None, :]                           # (B,T+1,A)
    seen = torch.zeros_like(read_mask)
    step = max(1, SNAP_BLOCK // max(1, B * n_reads * n_accounts))
    for t0 in range(0, n_snaps + 1, step):
        block = snaps[:, None, t0:t0 + step, :]             # (B,1,C,A)
        seen |= (reads[:, :, None, :] == block).all(3).any(2)
    snap_bad = read_mask & ~wrong_n & ~seen
    return (~bad.any(1), wrong_total, snap_bad, first_true(bad), sums)


def _bank_delta_lanes(balance, reads, read_mask, wrong_n, transfers,
                      total):
    """B lanes' bank deltas against their running-balance carries
    (``balance`` (B, A), ``total`` (B,)): the one body of the solo and
    the megabatched form. Snapshot depth counts from the carry:
    ``S_0 = balance`` (the pre-delta state is a legal read),
    ``S_t = balance + cumsum(transfers)[t-1]``. Returns ``(new_balance
    (B, A), any_bad (B,), first_bad (B,), n_bad (B,), n_snap_bad
    (B,))``."""
    snaps = torch.cat(
        [torch.zeros_like(transfers[:, :1]),
         torch.cumsum(transfers, 1, dtype=torch.int32)],
        dim=1) + balance[:, None, :]                        # (B,T+1,A)
    sums = reads.sum(2, dtype=torch.int32)                      # (B,R)
    wrong_total = read_mask & ~wrong_n & (sums != total[:, None])
    bad = read_mask & (wrong_n | wrong_total)
    seen = (reads[:, :, None, :] == snaps[:, None, :, :]).all(3).any(2)
    snap_bad = read_mask & ~wrong_n & ~seen
    return (snaps[:, -1], bad.any(1), first_true(bad),
            bad.sum(1, dtype=torch.int32),
            snap_bad.sum(1, dtype=torch.int32))


def _check_delta_shapes(reads, transfers, lead, n_reads, n_accounts,
                        n_snaps) -> None:
    if tuple(reads.shape) != lead + (n_reads, n_accounts) \
            or tuple(transfers.shape) != lead + (n_snaps, n_accounts):
        raise ValueError(f"bank delta planes {tuple(reads.shape)} / "
                         f"{tuple(transfers.shape)} are not the declared "
                         f"({n_reads}, {n_snaps}, {n_accounts})")


def wl_bank_delta(balance, reads, read_mask, wrong_n, transfers, total,
                  *, n_reads: int, n_accounts: int, n_snaps: int):
    """Stream-rung solo advance, O(delta): the carry is the (A,)
    running balance (a tensor), the delta planes are this append's
    reads and transfer rows padded up ``WL_DELTA_PADS``, on the
    carry's device. Returns ``(new_balance, any_bad, first_bad,
    n_bad, n_snap_bad)`` on the device."""
    _check_delta_shapes(reads, transfers, (), n_reads, n_accounts,
                        n_snaps)
    total = torch.as_tensor(total, dtype=torch.int32,
                            device=balance.device).reshape(1)
    out = _bank_delta_lanes(balance[None], reads[None], read_mask[None],
                            wrong_n[None], transfers[None], total)
    return tuple(o[0] for o in out)


def wl_bank_delta_mb(balances, reads, read_mask, wrong_n, transfers,
                     totals, *, n_reads: int, n_accounts: int,
                     n_snaps: int):
    """Megabatched advance: ``balances`` is a TUPLE of per-lane carry
    tensors, the delta planes carry a lane axis, ``totals`` is (B,).
    One batched pass of the solo form's body: every lane's outputs are
    bit-identical to its solo advance. Returns one output tuple per
    lane."""
    bal = torch.stack(tuple(balances))
    _check_delta_shapes(reads, transfers, (bal.shape[0],), n_reads,
                        n_accounts, n_snaps)
    outs = _bank_delta_lanes(bal, reads, read_mask, wrong_n, transfers,
                             totals)
    return tuple(tuple(o[i] for o in outs)
                 for i in range(len(balances)))


def bank_verdicts(cols: BankColumns, out) -> List[dict]:
    """Decode one device readback into per-history oracle-shaped
    verdict dicts (the ``bad-reads`` taxonomy of
    :class:`~..workloads.BankChecker`, plus the snapshot plane)."""
    valid, wrong_total, snap_bad, first_bad, sums = \
        (np.asarray(x) for x in out)
    verdicts = []
    for b in range(cols.read_mask.shape[0]):
        bad_reads = []
        for r in np.flatnonzero(cols.read_mask[b]):
            if cols.wrong_n[b, r]:
                bad_reads.append({"type": "wrong-n",
                                  "expected": cols.n,
                                  "found": int(cols.wrong_len[b, r]),
                                  "index": int(cols.read_index[b, r])})
            elif wrong_total[b, r]:
                bad_reads.append({"type": "wrong-total",
                                  "expected": int(cols.total[b]),
                                  "found": int(sums[b, r]),
                                  "index": int(cols.read_index[b, r])})
        snaps = [int(cols.read_index[b, r])
                 for r in np.flatnonzero(snap_bad[b])]
        verdicts.append({"valid?": bool(valid[b]),
                         "bad-reads": bad_reads,
                         "snapshot-inconsistent": snaps,
                         "first-bad-read": int(first_bad[b])})
    return verdicts


__all__ = ["BankColumns", "DEVICE_FIELDS", "bank_verdicts",
           "default_init", "encode_bank", "first_true", "wl_bank_check",
           "wl_bank_delta", "wl_bank_delta_mb"]
