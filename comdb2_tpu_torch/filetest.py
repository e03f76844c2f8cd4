"""Offline history checker — ``python -m comdb2_tpu_torch.filetest
hist.edn``.

The reference's minimal end-to-end slice (``linearizable/filetest/
src/jepsen/filetest.clj:8-21``): read an EDN history file, run a
checker over it, pretty-print the result. Exit codes: 0 valid, 1
invalid, 2 unknown. ``--checker`` picks linearizability (``linear``,
the frontier search; ``wgl``, the host world search), set semantics
(``set``), serializability over list-append txn ops (``txn``), or a
workload family (``bank`` / ``sets`` / ``dirty``). The device checks
run on ``cuda`` unless ``--device cpu`` is given.

Not ported yet: ``--service``, ``--shrink``, ``--trace`` and
``--follow``; they wait for the serving, shrink, tracing and streaming
slices.
"""

from __future__ import annotations

import argparse
import pprint
import sys
from typing import List, Optional

from .checker import analysis
from .checker.checkers import set_checker
from .models.model import MODELS
from .obs import trace as obs_trace
from .ops.history import parse_history

#: the workload families (``checker.wl.FAMILIES``)
_WL_FAMILIES = ("bank", "sets", "dirty")


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        description="check an EDN history file offline")
    p.add_argument("history", help="EDN history file")
    p.add_argument("--model", default="cas-register",
                   choices=sorted(MODELS),
                   help="consistency model (default cas-register)")
    p.add_argument("--checker", default="linear",
                   choices=["linear", "set", "wgl", "txn",
                            "bank", "sets", "dirty"],
                   help="linear (frontier search), wgl (world search), "
                        "set semantics, txn (serializability over "
                        "list-append txn ops), or a workload family "
                        "(bank/sets/dirty — bank needs "
                        "--wl-n/--wl-total)")
    p.add_argument("--txn", action="store_true",
                   help="shorthand for --checker txn")
    p.add_argument("--wl-n", type=int, metavar="N",
                   help="--checker bank: number of accounts")
    p.add_argument("--wl-total", type=int, metavar="T",
                   help="--checker bank: invariant balance total")
    p.add_argument("--realtime", action="store_true",
                   help="with --txn: include realtime edges (strict "
                        "serializability)")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "host", "device"])
    p.add_argument("--device", default=None,
                   help="torch device of the device checks (default "
                        "cuda; 'cpu' runs them on CPU tensors, the "
                        "kernels as their plain versions)")
    p.add_argument("--keyed", action="store_true",
                   help="re-tag [k v] op values as keyed tuples "
                        "(independent-generator histories)")
    args = p.parse_args(argv)
    if args.txn:
        args.checker = "txn"
    if args.checker == "bank" and (args.wl_n is None
                                   or args.wl_total is None):
        p.error("--checker bank needs --wl-n and --wl-total")

    with obs_trace.span("filetest.parse", path=args.history):
        with open(args.history) as fh:
            history = parse_history(fh.read())

    if (args.keyed or args.model == "cas-register-comdb2") \
            and args.checker != "txn" \
            and args.checker not in _WL_FAMILIES:
        # the comdb2 tuple model exists solely for keyed histories;
        # EDN [k v] vectors carry no type tag, so re-tag them here —
        # never for txn histories (their values are micro-op vectors)
        # nor for the workload families (a bank read's [b0 b1] balance
        # row would mis-parse as a cas pair)
        from .ops.kv import wrap_keyed_history

        history = wrap_keyed_history(history)

    if args.checker in _WL_FAMILIES:
        model = ({"n": args.wl_n, "total": args.wl_total}
                 if args.checker == "bank" else None)
        if args.backend == "host":
            from .checker.wl.batch import _host_fallback

            result = _host_fallback([history], args.checker, model)[0]
        else:
            from .checker.wl import check_wl_batch

            result = check_wl_batch([history], args.checker, model,
                                    device=args.device)[0]
        pprint.pprint(result)
        valid = result.get("valid?")
    elif args.checker == "txn":
        from .txn import check_txn

        result = check_txn(history, backend=args.backend,
                           realtime=args.realtime, device=args.device)
        cex = result.get("counterexample")
        if cex:
            from .txn.counterexample import render_text

            print(render_text(cex))
        pprint.pprint({k: v for k, v in result.items()
                       if k != "counterexample"})
        valid = result.get("valid?")
    elif args.checker == "set":
        result = set_checker.check({}, None, history)
        pprint.pprint(result)
        valid = result.get("valid?")
    elif args.checker == "wgl":
        from .checker import wgl

        result = wgl.analysis(MODELS[args.model](), history)
        pprint.pprint(result)
        valid = result.get("valid?")
    else:
        a = analysis(MODELS[args.model](), history, backend=args.backend,
                     device=args.device)
        result = a.to_map()
        result.pop("configs", None)
        pprint.pprint(result)
        valid = a.valid

    if valid is True:
        return 0
    if valid == "unknown":
        return 2
    return 1


if __name__ == "__main__":
    sys.exit(main())
