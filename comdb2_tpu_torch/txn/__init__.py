"""Transactional serializability checking — the Elle axis.

The counterpart of the JAX package's ``txn`` package. The
linearizability engines verify single-op histories; this package
verifies *transactional* ones. A txn op's value is a sequence of
micro-ops over list-append registers::

    (("append", k, v), ("r", k, (v1, v2, ...)))   # completion
    (("append", k, v), ("r", k, None))            # invocation

Reads return the whole list, so every committed read recovers a
prefix of the key's version order — the property Elle's list-append
workload is built on (elle/list_append.clj). The pipeline:

- :mod:`.edges` — host pass: version orders from reads, then ww/wr/rw
  dependency edges (realtime optional) as padded adjacency arrays.
- :mod:`.closure_torch` — device cycle engine: transitive closure by
  repeated squaring of N x N bf16 matrices on the tensor cores, one
  device call per graph or batch.
- :mod:`.scc` — host Tarjan SCC engine (oracle + small-N fast path).
- :mod:`.counterexample` — shortest-cycle decode back to actual ops.
- :mod:`.adapters` — second-opinion views of the G2 and dirty-reads
  workload histories.

``check_txn`` runs the whole pipeline; ``checker.checkers.
Serializable`` wraps it in the standard checker protocol.
"""

from __future__ import annotations

from .edges import (TXN_N_FLOOR, TxnGraph, infer_edges, txns_of_history)
from .check import check_txn

__all__ = ["TXN_N_FLOOR", "TxnGraph", "infer_edges",
           "txns_of_history", "check_txn"]
