"""Command-line runner (``jepsen/cli.clj``).

``single_test_cmd(test_fn)`` builds an argparse CLI with the reference's
option surface (``cli.clj:52-98``: ``--node``, ``--concurrency`` default
30, ``--time-limit`` default 60, ssh credentials) and runs
``test_fn(opts)`` through :func:`comdb2_tpu_torch.harness.core.run`, exiting
nonzero when the analysis is invalid.

The counterpart of the JAX package's ``harness/cli.py``, with one more
option: ``--device`` (default ``cuda``), the device the test's checkers
run on, passed to ``test_fn`` as ``opts["device"]``. It is resolved
before any test is built, so the default raises on a host without CUDA
before any worker runs.
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, List, Optional

from ..utils import resolve_device
from . import core


def parser(description: str = "comdb2_tpu_torch test"
           ) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("-n", "--node", action="append", dest="nodes",
                   metavar="HOST",
                   help="node to run against (repeatable)")
    p.add_argument("--nodes-file", help="file with one node per line")
    p.add_argument("-c", "--concurrency", type=int, default=30,
                   help="number of worker processes (default 30)")
    p.add_argument("--time-limit", type=float, default=60.0,
                   help="seconds to run the workload (default 60)")
    p.add_argument("--test-count", type=int, default=1,
                   help="how many times to run the test")
    p.add_argument("--username", default="root", help="ssh username")
    p.add_argument("--password", default=None, help="ssh password")
    p.add_argument("--private-key-path", default=None,
                   help="ssh identity file")
    p.add_argument("--ssh-port", type=int, default=22)
    p.add_argument("--store-root", default="store",
                   help="directory for results (default store/)")
    p.add_argument("--device", default="cuda",
                   help="device the checkers run on (default cuda; cpu "
                        "runs the kernels' plain PyTorch versions)")
    return p


def opts_from_args(args: argparse.Namespace) -> dict:
    nodes: Optional[List[str]] = args.nodes
    if args.nodes_file:
        with open(args.nodes_file) as fh:
            nodes = (nodes or []) + [l.strip() for l in fh
                                     if l.strip()]
    return {
        "nodes": nodes if nodes is not None else [],
        "concurrency": args.concurrency,
        "time-limit": args.time_limit,
        "store-root": args.store_root,
        "device": args.device,
        "ssh": {"username": args.username, "password": args.password,
                "private-key-path": args.private_key_path,
                "port": args.ssh_port},
    }


def single_test_cmd(test_fn: Callable[[dict], dict],
                    argv: Optional[List[str]] = None,
                    description: str = "comdb2_tpu_torch test") -> int:
    """Parse args, build the test via ``test_fn(opts)``, run it
    ``--test-count`` times; returns a process exit code (0 iff all runs
    valid, 2 on unknown, 1 on invalid — invalid dominates)."""
    args = parser(description).parse_args(argv)
    opts = opts_from_args(args)
    resolve_device(opts["device"])
    saw_unknown = False
    for _ in range(args.test_count):
        test = core.run(test_fn(opts))
        valid = (test.get("results") or {}).get("valid?")
        if valid is True:
            continue
        if valid == "unknown":
            saw_unknown = True
        else:
            return 1            # invalid dominates; stop immediately
    return 2 if saw_unknown else 0


def main(test_fn: Callable[[dict], dict]) -> None:
    sys.exit(single_test_cmd(test_fn))
