"""Offline history checker — ``python -m comdb2_tpu_torch.filetest
hist.edn``.

The reference's minimal end-to-end slice (``linearizable/filetest/
src/jepsen/filetest.clj:8-21``): read an EDN history file, run the
linearizability analysis against a model, pretty-print the result.
Exit codes: 0 valid, 1 invalid, 2 unknown. The device search runs on
``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import pprint
import sys
from typing import List, Optional

from .checker import analysis
from .models.model import MODELS
from .obs import trace as obs_trace
from .ops.history import parse_history


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        description="check an EDN history file offline")
    p.add_argument("history", help="EDN history file")
    p.add_argument("--model", default="cas-register",
                   choices=sorted(MODELS),
                   help="consistency model (default cas-register)")
    p.add_argument("--checker", default="linear", choices=["linear"],
                   help="linear (frontier search)")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "host", "device"])
    p.add_argument("--device", default=None,
                   help="torch device of the search (default cuda; "
                        "'cpu' runs the kernels' plain versions)")
    p.add_argument("--keyed", action="store_true",
                   help="re-tag [k v] op values as keyed tuples "
                        "(independent-generator histories)")
    args = p.parse_args(argv)

    with obs_trace.span("filetest.parse", path=args.history):
        with open(args.history) as fh:
            history = parse_history(fh.read())
    if args.keyed or args.model == "cas-register-comdb2":
        # the comdb2 tuple model exists solely for keyed histories;
        # EDN [k v] vectors carry no type tag, so re-tag them here
        from .ops.kv import wrap_keyed_history

        history = wrap_keyed_history(history)

    a = analysis(MODELS[args.model](), history, backend=args.backend,
                 device=args.device)
    result = a.to_map()
    result.pop("configs", None)
    pprint.pprint(result)
    if a.valid is True:
        return 0
    if a.valid == "unknown":
        return 2
    return 1


if __name__ == "__main__":
    sys.exit(main())
