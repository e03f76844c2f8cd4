"""Batched entry for the workload-checker families.

The counterpart of the JAX package's ``checker/wl/batch.py``.
``check_wl_batch`` is the one device surface: encode a batch of
histories into the family's column planes, pad every per-history dim
up its ladder, upload, and make ONE device call per pow2 bucket
(``DISPATCHES`` counts them; tests assert one per bucket). The ladders
are the JAX package's, so both packages see the same shapes.

Histories that exceed the top rung of a per-history axis go to the
HOST ORACLE (the ``workloads.py`` checkers) — same verdict,
``engine: "host"`` attribution — as they do in the JAX package. That
route is decided from the histories' sizes, before anything reaches
the device; no device error is ever answered from the host.

Entry points take ``device=``: ``None`` means ``cuda`` and raises
without a card; ``"cpu"`` runs the same torch ops on CPU tensors.

Not ported yet: the delta pads of the stream rungs (``WL_DELTA_PADS``),
which go with streaming.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from ...utils import resolve_device
# hashable form of a value (imported once: ``_dims`` calls it per op)
from ..workloads import freeze_value as _key
from .bank import bank_verdicts, encode_bank, wl_bank_check
from .dirty import dirty_verdicts, encode_dirty, wl_dirty_check
from .sets import encode_sets, sets_verdicts, wl_sets_check

#: the checker families this subsystem serves
FAMILIES = ("bank", "sets", "dirty")

#: batch-lane rungs (histories per dispatch; bigger batches chunk)
WL_BATCH = (1, 8, 64, 512)
#: ok-read rows per history (bank + dirty)
WL_READS = (8, 64, 512)
#: bank account columns
WL_ACCOUNTS = (8, 32, 128)
#: bank transfer rows (snapshot plane depth is T + 1)
WL_SNAPS = (8, 64, 512)
#: sets element-universe width
WL_ELEMS = (128, 1024, 8192)
#: dirty per-read node views
WL_NODES = (4, 16)
#: dirty distinct-value universe width
WL_VALUES = (128, 1024, 8192)

#: device calls of the wl programs (one per pow2 bucket — tests and
#: ``chip_smoke.py`` assert against this)
DISPATCHES = 0


def bucket_of(n: int, ladder: Tuple[int, ...]) -> int:
    """The smallest rung >= n (None past the top — the caller routes
    host)."""
    for p in ladder:
        if p >= n:
            return p
    return None


def _dims(histories, family: str, model: Optional[dict]):
    """Per-batch padded dims (max over lanes, bucketed), or None when
    any per-history axis exceeds its top rung."""
    n_reads = n_elems = n_nodes = n_vals = n_snaps = 1
    for hist in histories:
        r = t = 0
        elems = set()
        vals = set()
        for op in hist:
            if op.value is None:
                continue
            if family == "bank":
                if op.type == "ok" and op.f == "read":
                    r += 1
                elif op.type == "ok" and op.f == "transfer":
                    t += 1
            elif family == "sets":
                if op.f == "add":
                    elems.add(_key(op.value))
                elif op.type == "ok" and op.f == "read":
                    elems |= {_key(v) for v in op.value}
            elif family == "dirty":
                if op.f == "write":
                    vals.add(_key(op.value))
                elif op.type == "ok" and op.f == "read":
                    r += 1
                    if not isinstance(op.value, (str, bytes)) \
                            and isinstance(op.value, (list, tuple)):
                        n_nodes = max(n_nodes, len(op.value))
                        vals |= {_key(v) for v in op.value}
        n_reads = max(n_reads, r)
        n_snaps = max(n_snaps, t)
        n_elems = max(n_elems, len(elems))
        n_vals = max(n_vals, len(vals))
    if family == "bank":
        a = int(model["n"]) if model else 1
        dims = {"r_pad": bucket_of(n_reads, WL_READS),
                "a_pad": bucket_of(a, WL_ACCOUNTS),
                "t_pad": bucket_of(n_snaps, WL_SNAPS)}
    elif family == "sets":
        dims = {"e_pad": bucket_of(n_elems, WL_ELEMS)}
    else:
        dims = {"r_pad": bucket_of(n_reads, WL_READS),
                "n_pad": bucket_of(n_nodes, WL_NODES),
                "v_pad": bucket_of(n_vals, WL_VALUES)}
    if any(v is None for v in dims.values()):
        return None
    return dims


def _host_fallback(histories, family: str,
                   model: Optional[dict]) -> List[dict]:
    from ..checkers import check_safe, set_checker
    from ..workloads import bank_checker, dirty_reads_checker

    chk = {"bank": bank_checker, "sets": set_checker,
           "dirty": dirty_reads_checker}[family]
    out = []
    for hist in histories:
        v = check_safe(chk, {}, model, list(hist))
        v["engine"] = "host"
        out.append(v)
    return out


def agrees_with_oracle(family: str, dev: dict, host: dict,
                       history: Sequence) -> bool:
    """Whether a device verdict says what the host oracle's says (the
    JAX package's golden-twin rule): the same ``valid?``; bank: the same
    bad reads in order, by type, expected and found, the device citing
    the op index where the oracle embeds the op; sets: the same
    interval-set strings and fractions; dirty: the same dirty and
    inconsistent reads (as multisets) and malformed-read indices."""
    if dev["valid?"] != host["valid?"]:
        return False
    if family == "bank":
        db, hb = dev["bad-reads"], host["bad-reads"]
        return len(db) == len(hb) and all(
            (d["type"], d["expected"], d["found"])
            == (h["type"], h["expected"], h["found"])
            and history[d["index"]].value == h["op"].value
            for d, h in zip(db, hb))
    if family == "sets":
        if "error" in host:
            return dev.get("error") == host["error"]
        return all(dev[k] == host[k] and dev[f"{k}-frac"] == host[f"{k}-frac"]
                   for k in ("ok", "lost", "unexpected", "recovered"))
    return (sorted(dev["dirty-reads"], key=repr)
            == sorted((tuple(r) for r in host["dirty-reads"]), key=repr)
            and sorted(dev["inconsistent-reads"], key=repr)
            == sorted((tuple(r) for r in host["inconsistent-reads"]),
                      key=repr)
            and dev.get("malformed-reads") == host.get("malformed-reads"))


def stage_wl_batch(histories: Sequence[Sequence], family: str,
                   model: Optional[dict] = None, *,
                   b_pad: Optional[int] = None,
                   dims: Optional[dict] = None, device=None):
    """Encode one bucket's batch, upload it and queue its device call;
    returns a zero-arg finalize whose call is the readback point (the
    verdict list, padded lanes sliced off) — the same stage/finalize
    seam as the JAX package's. ``dims`` pins the padded per-history
    axes; without it the batch max is measured and bucketed here.
    Raises ``ValueError`` on unknown family / missing bank model; a
    batch past the rungs (or an encode-time overflow) finalizes through
    the host oracle instead."""
    global DISPATCHES
    from ...convert import wl_columns    # convert imports this package

    dev = resolve_device(device)
    if family not in FAMILIES:
        raise ValueError(f"unknown wl family {family!r}")
    if family == "bank" and (model is None or "n" not in model
                             or "total" not in model):
        raise ValueError("bank needs a model {'n':..,'total':..}")
    histories = [list(h) for h in histories]
    if not histories:
        return lambda: []
    if len(histories) > WL_BATCH[-1]:
        raise ValueError(
            f"batch of {len(histories)} exceeds the top WL_BATCH "
            f"rung ({WL_BATCH[-1]}) — chunk first (check_wl_batch "
            "does)")
    if dims is None:
        dims = _dims(histories, family, model)
    if dims is None or any(v is None for v in dims.values()):
        return lambda: _host_fallback(histories, family, model)
    B = len(histories)
    bp = b_pad if b_pad is not None else bucket_of(B, WL_BATCH)
    # pad lanes by duplicating lane 0 — padded verdicts are sliced off
    # before return
    padded = histories + [histories[0]] * (bp - B)
    # an encode-time overflow (a lane past a per-history cap the
    # pre-scan could not see, e.g. interning growth) routes host, as in
    # the JAX package; only the host encoder sits inside this try
    try:
        if family == "bank":
            cols = encode_bank(padded, model, **dims)
        elif family == "sets":
            cols = encode_sets(padded, **dims)
        else:
            cols = encode_dirty(padded, **dims)
    except ValueError:
        return lambda: _host_fallback(histories, family, model)
    planes = wl_columns(cols, dev)
    if family == "bank":
        out = wl_bank_check(*planes, n_reads=dims["r_pad"],
                            n_accounts=dims["a_pad"],
                            n_snaps=dims["t_pad"])
        verdicts = bank_verdicts
    elif family == "sets":
        out = wl_sets_check(*planes, n_elems=dims["e_pad"])
        verdicts = sets_verdicts
    else:
        out = wl_dirty_check(*planes, n_reads=dims["r_pad"],
                             n_nodes=dims["n_pad"],
                             n_values=dims["v_pad"])
        verdicts = dirty_verdicts
    DISPATCHES += 1
    return lambda: verdicts(cols, [t.cpu().numpy() for t in out])[:B]


def check_wl_batch(histories: Sequence[Sequence], family: str,
                   model: Optional[dict] = None, *,
                   b_pad: Optional[int] = None,
                   device=None) -> List[dict]:
    """Check a batch of one family's histories on the device — one
    call per pow2 bucket (:func:`stage_wl_batch` staged and finalized
    in one step). ``model`` is the bank model dict (``{"n": ..,
    "total": ..}``); other families take None. ``b_pad`` forces the
    batch rung; by default lanes bucket up ``WL_BATCH`` and over-top
    batches chunk."""
    histories = [list(h) for h in histories]
    top = WL_BATCH[-1]
    if len(histories) > top:
        out = []
        for i in range(0, len(histories), top):
            out.extend(check_wl_batch(histories[i:i + top], family,
                                      model, b_pad=top, device=device))
        return out
    return stage_wl_batch(histories, family, model, b_pad=b_pad,
                          device=device)()


def wl_dims(histories, family: str,
            model: Optional[dict] = None) -> Optional[dict]:
    """Padded per-history axes for a batch (max over lanes, bucketed
    up the family's ladders), or None when any axis exceeds its top
    rung."""
    return _dims([list(h) for h in histories], family, model)


__all__ = ["DISPATCHES", "FAMILIES", "WL_ACCOUNTS", "WL_BATCH",
           "WL_ELEMS", "WL_NODES", "WL_READS", "WL_SNAPS", "WL_VALUES",
           "agrees_with_oracle", "bucket_of", "check_wl_batch",
           "stage_wl_batch", "wl_dims"]
