"""The serializability pipeline: history -> edges -> cycles -> verdict.

The counterpart of the JAX package's ``txn/check.py``. ``check_txn``
is the entry point every surface shares (the ``Serializable`` checker
class and ``filetest --checker txn``). Verdict map::

    {"valid?": True | False | "unknown",
     "txn-count": n, "edge-count": e,
     "anomalies": [...direct anomalies...],     # G1a / duplicate / ...
     "counterexample": {"class": "G2-item", "cycle": [...]} | None}

Backends: ``host`` (Tarjan SCC; touches no device), ``device`` (the
matrix closure, one device call), ``auto`` (host below
``DEVICE_THRESHOLD`` txns, device above, as in the JAX package).
``device``: where ``auto`` and ``device`` run; ``None`` means ``cuda``
and raises without a card (``"cpu"`` runs the closure on CPU tensors).
No path answers from the host after a device error.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..obs import trace as _obs
from ..ops.op import Op
from ..utils import resolve_device
from .edges import TxnGraph, infer_edges

#: auto-backend crossover: below this many txns a host SCC over a
#: sparse graph is cheaper than a device round trip
DEVICE_THRESHOLD = 1024


@_obs.traced("txn.check")
def check_txn(history: Sequence[Op],
              backend: str = "auto",
              realtime: bool = False,
              graph: Optional[TxnGraph] = None,
              device=None) -> dict:
    """Check a txn history for serializability. Malformed histories
    raise ``ValueError`` (same contract as the JAX package)."""
    dev = None if backend == "host" else resolve_device(device)
    g = graph if graph is not None else infer_edges(history,
                                                   realtime=realtime)
    cex = None
    if g.n and g.adj.any():
        if backend == "host" or (backend == "auto"
                                 and g.n < DEVICE_THRESHOLD):
            from .scc import cyclic_layers_host

            diag = cyclic_layers_host(g.adj, realtime=realtime)
        else:
            from .closure_torch import cyclic_layers_device

            diag = cyclic_layers_device(g.adj, realtime=realtime,
                                        device=dev)
        from .counterexample import decode

        cex = decode(g, np.asarray(diag), realtime=realtime)
    return verdict_map(g, cex)


def verdict_map(graph: TxnGraph, cex: Optional[dict]) -> dict:
    """The verdict for an inferred graph + decoded counterexample —
    the one place the tri-state is computed, so a partially unparseable
    history answers ``unknown`` identically everywhere."""
    anomalies = [a for a in graph.anomalies if a["name"] != "malformed"]
    malformed = len(graph.anomalies) - len(anomalies)
    valid = not anomalies and cex is None
    if valid and malformed:
        valid = "unknown"                # something was unparseable
    out = {
        "valid?": valid,
        "txn-count": graph.n,
        "edge-count": int(graph.adj.sum()),
        "anomalies": anomalies,
        "counterexample": cex,
    }
    if malformed:
        out["malformed-ops"] = malformed
    return out


__all__ = ["DEVICE_THRESHOLD", "check_txn", "verdict_map"]
