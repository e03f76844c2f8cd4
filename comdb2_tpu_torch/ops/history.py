"""History preprocessing.

Reimplements the semantics of the reference's ``knossos/history.clj``:

- :func:`complete` — back-fill an invocation's ``value`` from its ``ok``
  completion, and mark invocations whose completion is a ``fail`` with
  ``fails=True`` so checkers can skip them (``history.clj:87-171``). This
  is load-bearing: get it wrong and verdicts silently diverge.
- :func:`index` — attach sequential indices (``history.clj:173-179``).

Also hosts conversion between EDN keyword-maps (the interchange format of
``ctest/register.c -j`` and ``filetest``) and :class:`~.op.Op`.
"""

from __future__ import annotations

from typing import Any, Dict, Hashable, List

from .op import Op
from .edn import Keyword, kw, write_edn


def complete(history: List[Op], index: bool = False) -> List[Op]:
    """Fill in invocation values from their completions.

    For ``ok`` completions the invocation's value becomes the completion's
    value — we construct a history in which we "already knew" the result.
    For ``fail`` completions, both carry whichever value is known and the
    invocation gets ``fails=True``. Info ops pass through unchanged; their
    invocations stay pending forever. (``knossos/history.clj:87-171``.)

    With ``index=True`` sequential ``index`` fields are attached in the
    same pass (fused :func:`index`): positions are final at append time,
    and one pass halves the object churn on large batches.
    """
    out: List[Op] = []
    inflight: Dict[Hashable, int] = {}  # process -> position in `out`
    for op in history:
        if op.type == "invoke":
            if op.process in inflight:
                raise RuntimeError(
                    f"process {op.process!r} already running "
                    f"{out[inflight[op.process]]}, yet invoked {op}")
            out.append(op.with_(index=len(out)) if index else op)
            inflight[op.process] = len(out) - 1
        elif op.type == "ok":
            i = inflight.pop(op.process, None)
            if i is None:
                raise RuntimeError(f"ok without invocation: {op}")
            out[i] = out[i].with_(value=op.value)
            out.append(op.with_(index=len(out)) if index else op)
        elif op.type == "fail":
            i = inflight.pop(op.process, None)
            if i is None:
                raise RuntimeError(f"fail without invocation: {op}")
            inv = out[i]
            if (inv.value is not None and op.value is not None
                    and inv.value != op.value):
                # the reference asserts these match (history.clj:132-137);
                # silently reconciling would let a buggy driver skew verdicts
                raise RuntimeError(
                    f"invocation value {inv.value!r} and failure value "
                    f"{op.value!r} don't match: {op}")
            value = inv.value if inv.value is not None else op.value
            out[i] = inv.with_(value=value, fails=True)
            upd = {"value": value, "fails": True}
            if index:
                upd["index"] = len(out)
            out.append(op.with_(**upd))
        else:  # info
            out.append(op.with_(index=len(out)) if index else op)
    return out


def index(history: List[Op]) -> List[Op]:
    """Attach sequential ``index`` fields."""
    return [op.with_(index=i) for i, op in enumerate(history)]


# --- EDN interchange -------------------------------------------------------

def _plain(x: Any) -> Any:
    """Normalize an EDN value: keywords → plain strings, lists/tuples →
    tuples, sets → frozensets, maps → sorted tuples of pairs, so values
    are hashable and compare naturally."""
    if isinstance(x, Keyword):
        return str.__str__(x)
    if isinstance(x, (list, tuple)):
        return tuple(_plain(e) for e in x)
    if isinstance(x, (set, frozenset)):
        return frozenset(_plain(e) for e in x)
    if isinstance(x, dict):
        return tuple(sorted(((_plain(k), _plain(v)) for k, v in x.items()),
                            key=repr))
    return x


def op_from_map(m: dict) -> Op:
    """Build an Op from an EDN keyword map like
    ``{:type :invoke, :f :cas, :value [0 3], :process 1, :time 1234}``
    (the format emitted by ``ctest/register.c:282-307``)."""
    get = lambda name: m.get(kw(name))
    return Op(
        process=_plain(get("process")),
        type=str(_plain(get("type"))),
        f=_plain(get("f")),
        value=_plain(get("value")),
        index=get("index"),
        time=get("time"),
    )


def history_from_edn(forms: Any) -> List[Op]:
    """Accept either one top-level vector of op maps, or a sequence of
    top-level maps (one per line)."""
    if isinstance(forms, dict):
        forms = [forms]
    if (isinstance(forms, list) and len(forms) == 1
            and isinstance(forms[0], list)):
        # read_edn_all of a file holding a single vector
        forms = forms[0]
    return [op_from_map(m) for m in forms]


def parse_history(text: str) -> List[Op]:
    """Parse an EDN history file (vector-of-maps or map-per-line)."""
    from .edn import read_edn_all

    return history_from_edn(read_edn_all(text))


def history_to_edn(history: List[Op]) -> str:
    """Serialize a history as one EDN op map per line (the format
    ``jepsen.store`` writes to ``history.txt`` readers can re-check)."""
    return "\n".join(write_edn(op.to_map()) for op in history)
