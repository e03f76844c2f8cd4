"""Cluster healing and coherency gates — the roles of the reference's
``scripts/heal``, ``scripts/blockcoherent.sh``, and the outer loop of
``jepsenloop.sh``: before each run, undo every partition/pause and wait
until the cluster reports itself coherent.

The counterpart of the JAX package's ``harness/cluster.py``: host code.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

from .. import control


def heal_all(test: dict, processes: Sequence[str] = ()) -> None:
    """Flush iptables DROP rules and SIGCONT the given process names on
    every node (``scripts/heal:20-29``)."""
    def heal1(test_, node):
        control.su("iptables", "-F", "-w", check=False)
        control.su("iptables", "-X", "-w", check=False)
        for p in processes:
            control.su("killall", "-s", "CONT", p, check=False)
    control.on_nodes(test, heal1)


def await_fn(probe: Callable[[], bool], timeout: float = 60.0,
             interval: float = 1.0, desc: str = "condition") -> None:
    """Poll ``probe`` until true or timeout."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if probe():
            return
        time.sleep(interval)
    raise TimeoutError(f"timed out after {timeout}s waiting for {desc}")


def await_coherent(test: dict, coherent_probe: Callable[[dict], bool],
                   timeout: float = 120.0, interval: float = 2.0) -> None:
    """Block until the SUT reports no incoherent nodes — the contract of
    ``blockcoherent.sh:15-37`` (which polls the master's ``bdb cluster``
    status); the probe is SUT-specific."""
    await_fn(lambda: coherent_probe(test), timeout=timeout,
             interval=interval, desc="cluster coherency")


def test_loop(make_test: Callable[[], dict],
              run_fn: Callable[[dict], dict],
              pre: Optional[Callable[[dict], None]] = None,
              max_runs: Optional[int] = None) -> int:
    """The ``jepsenloop.sh`` driver: heal, gate, run, fail on invalid;
    loop. Returns the number of valid runs completed (stops on the first
    invalid/unknown or after max_runs)."""
    runs = 0
    while max_runs is None or runs < max_runs:
        test = make_test()
        if pre is not None:
            pre(test)
        result = run_fn(test)
        if (result.get("results") or {}).get("valid?") is not True:
            return runs
        runs += 1
    return runs
