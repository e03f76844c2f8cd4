"""Kill-cluster diff-oracle test — crash-restart durability checking.

The reference (``killcluster/killclustertest.sh:36-84``) runs a scripted
2M-row transaction against the cluster while kill-9ing (or SIGSTOPing)
every node's SUT process mid-flight, then diffs the client's complete
output transcript against a deterministically generated oracle
(``generate_correct_out.py``). Re-designed SUT-agnostically: the
workload is any function producing a deterministic transcript through
retries; the disruptor kill-restarts the SUT on every node through the
control plane.

The counterpart of the JAX package's ``harness/killcluster.py``: host
code, the same transcripts and oracles.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Iterable, List, Optional

from .. import control


def oracle(n_rows: int = 2_000_000) -> Iterable[str]:
    """The expected transcript of the scripted transaction — setup
    echoes, one line per row, commit echoes (the shape of
    ``generate_correct_out.py:1-16``)."""
    yield "[set transaction serializable] rc 0"
    yield "[begin] rc 0"
    for i in range(n_rows):
        yield f"(a={i})"
    yield "[commit] rc 0"


def scripted_workload(client, n_rows: int) -> Iterable[str]:
    """Default workload: drive ``client`` (a
    :class:`~comdb2_tpu_torch.workloads.sqlish.Conn`) through the scripted
    transaction, emitting the oracle transcript only for work that
    actually committed; retries until it does."""
    from ..workloads.sqlish import with_txn_retries

    yield "[set transaction serializable] rc 0"
    yield "[begin] rc 0"

    def txn():
        with client.transaction() as t:
            existing = {r["a"] for r in t.select("killcluster")}
            for i in range(n_rows):
                if i not in existing:
                    t.insert("killcluster", {"a": i})

    with_txn_retries(txn)
    rows = [r["a"] for r in client.select("killcluster")]
    for a in sorted(rows)[:n_rows]:
        yield f"(a={a})"
    yield "[commit] rc 0"


def kill_restart_all(test: dict, process: str,
                     restart_cmd: Optional[str] = None,
                     stagger_s: float = 0.5) -> None:
    """kill -9 the SUT process on every node, then restart it
    (``killclustertest.sh:60``: restart under MALLOC_CHECK_)."""
    def kill1(test_, node):
        control.su("pkill", "-KILL", "-f", process, check=False)
        time.sleep(stagger_s)
        if restart_cmd:
            control.su(control.lit(restart_cmd), check=False)
    control.on_nodes(test, kill1)


def run(test: dict,
        workload: Callable[[], Iterable[str]],
        expected: Iterable[str],
        disrupt: Optional[Callable[[], None]] = None,
        disrupt_after_s: float = 1.0) -> dict:
    """Run the workload while (optionally) disrupting the cluster; diff
    the transcript against the oracle. Returns
    ``{"valid?", "diff": [first differing lines]}``."""
    lines: List[str] = []
    done = threading.Event()
    errors: List[BaseException] = []

    def drive():
        try:
            for line in workload():
                lines.append(line)
        except BaseException as e:
            errors.append(e)
        finally:
            done.set()

    t = threading.Thread(target=drive, daemon=True)
    t.start()
    if disrupt is not None:
        time.sleep(disrupt_after_s)
        if not done.is_set():
            disrupt()
    t.join()

    diff = []
    expected = list(expected)
    for i in range(max(len(expected), len(lines))):
        want = expected[i] if i < len(expected) else "<missing>"
        got = lines[i] if i < len(lines) else "<missing>"
        if want != got:
            diff.append({"line": i, "expected": want, "got": got})
            if len(diff) >= 10:
                break
    out = {"valid?": not diff, "diff": diff,
           "lines": len(lines), "expected-lines": len(expected)}
    if errors:
        # a crashed client truncates the transcript, which always
        # diffs — that is not evidence of data loss; the verdict is
        # unknown either way, with the cause attached
        out["valid?"] = "unknown"
        out["error"] = repr(errors[0])
    return out


def cluster_kill_restart(procs, rounds: int = 2, pause_s: float = 0.3,
                         between_s: float = 1.5) -> Callable[[], None]:
    """Disruptor for the in-tree replicated SUT: kill -9 EVERY
    ``sut_node`` (no shutdown path — un-fsynced state dies), restart
    them from their state dirs, repeat. The killclustertest.sh:36-84
    shape against a :class:`~comdb2_tpu_torch.workloads.tcp.ClusterProcs`."""
    def disrupt():
        for _ in range(rounds):
            procs.kill9_all()
            time.sleep(pause_s)
            procs.restart_all()
            time.sleep(between_s)
    return disrupt


def cluster_oracle(n_values: int) -> Iterable[str]:
    """Expected transcript of :func:`cluster_set_workload`: every add
    acknowledged exactly once, every acknowledged value present in the
    final committed read."""
    yield "[begin] rc 0"
    for i in range(n_values):
        yield f"[add {i}] rc 0"
    for i in range(n_values):
        yield f"(v={i})"
    yield "[commit] rc 0"


def cluster_set_workload(ports, n_values: int,
                         timeout_s: float = 0.5,
                         per_value_deadline_s: float = 20.0,
                         pace_s: float = 0.0):
    """Deterministic-transcript workload against a sut_node cluster:
    add values 0..n-1 through replay-nonce retries (each value is
    retried until one OK — exactly-once by dedup), then read the
    committed set back from the primary. A crash-restart in flight
    only delays an add; an add acked BEFORE a crash must still be in
    the final read — that is the durability contract under test."""
    import random as _random

    from ..workloads.tcp import ClusterControl, SutConnection

    session = _random.SystemRandom().getrandbits(32)

    def one_request(port, line):
        conn = SutConnection("127.0.0.1", port, timeout_s)
        try:
            conn.connect()
            return conn.request(line)
        finally:
            conn.close()

    def workload():
        yield "[begin] rc 0"
        ix = 0
        for i in range(n_values):
            nonce = (session << 24) | (i + 1)
            deadline = time.monotonic() + per_value_deadline_s
            rc = "?"
            while time.monotonic() < deadline:
                port = ports[ix % len(ports)]
                ix += 1
                try:
                    r = one_request(port, f"M {nonce} A {i}")
                except (TimeoutError, OSError):
                    time.sleep(0.05)
                    continue
                if r.startswith("OK"):
                    rc = "0"
                    break
                time.sleep(0.05)
            yield f"[add {i}] rc {rc}"
            if pace_s:
                # pace the stream so a disruptor's kill-restart lands
                # MID-RUN (a full-speed burst would finish before the
                # first kill and the test would exercise nothing)
                time.sleep(pace_s)
        # final committed read: wait for the cluster to settle, then
        # read the set from the current primary
        ctl = ClusterControl(ports, timeout_s=2.0)
        ctl.await_replicated(timeout_s=10.0)
        vals = []
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            # the primary's COMMITTED prefix must have caught up to
            # its applied log before the read counts (a freshly
            # elected post-restart primary commits the recovered tail
            # heartbeat-paced) — otherwise a correct cluster could
            # flakily read short and diff as a false loss
            pri_info = next((i for i in ctl.info()
                             if i["role"] == "primary"
                             and i.get("durable") == i.get("applied")),
                            None)
            if pri_info is None:
                time.sleep(0.1)
                continue
            try:
                r = one_request(ports[ctl.ports.index(
                    pri_info["port"])], "S")
            except (TimeoutError, OSError):
                time.sleep(0.1)
                continue
            if r.startswith("V"):
                vals = [int(x) for x in r[1:].split()]
                break
            time.sleep(0.1)
        # raw (not deduplicated): a double-applied add — the exact
        # anomaly the replay nonces exist to prevent — must show up
        # as a duplicate line and diff against the oracle
        for v in sorted(vals):
            yield f"(v={v})"
        yield "[commit] rc 0"

    return workload
