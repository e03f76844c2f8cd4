"""The port's generator DSL (``comdb2_tpu_torch.harness.generator`` and
``independent_gen``) against the JAX package's.

Every combinator is built in both packages from the same description;
the stdlib ``random`` state is seeded before each drive, and each
package's generator is drawn from on this one thread through
``op(gen, test, process)``. The op streams must be equal (no tolerance:
every value is a string, an int, a tuple of them or None). Time-based
combinators compare structure (op types and processes), not counts.

Also the reconnect wrapper (``control/reconnect.py``: reuse, teardown on
failure, reopen, bounded retries) and OS setup (``harness/os_setup.py``:
the commands ``DebianOS``, ``SmartOS`` and ``setup_hostfile`` issue over
a ``RecordingRemote``), equal to the JAX package's.
"""

import random
import time

import pytest

from comdb2_tpu import control as JCTL
from comdb2_tpu.control import reconnect as JRC
from comdb2_tpu.control import remote as JREM
from comdb2_tpu.harness import generator as JG
from comdb2_tpu.harness import independent_gen as JIG
from comdb2_tpu.harness import os_setup as JOS
from comdb2_tpu.workloads import comdb2 as JW

from comdb2_tpu_torch import control as TCTL
from comdb2_tpu_torch.control import reconnect as TRC
from comdb2_tpu_torch.control import remote as TREM
from comdb2_tpu_torch.harness import generator as TG
from comdb2_tpu_torch.harness import independent_gen as TIG
from comdb2_tpu_torch.harness import os_setup as TOS
from comdb2_tpu_torch.workloads import comdb2 as TW

from torch_harness_parity import gen_stream

TEST = {"concurrency": 4, "nodes": ["a", "b"]}
PROCS = [0, 1, 2, 3, 5, 9]
THREADS = ["nemesis", 0, 1, 2, 3]

START = {"type": "info", "f": "start"}
STOP = {"type": "info", "f": "stop"}
READ = {"type": "invoke", "f": "read", "value": None}

#: name -> (make(G, IG, W) -> generator, procs, draws, test)
CASES = {
    "constant": (lambda G, IG, W: READ, PROCS, 4, TEST),
    "fn": (lambda G, IG, W: lambda t, p: {"f": "x", "value": p},
           PROCS, 6, TEST),
    "fn_no_args": (lambda G, IG, W: lambda: {"f": "y"}, PROCS, 3, TEST),
    "none": (lambda G, IG, W: None, PROCS, 2, TEST),
    "void": (lambda G, IG, W: G.void, PROCS, 2, TEST),
    "cas_gen": (lambda G, IG, W: G.cas_gen, PROCS, 40, TEST),
    "queue_gen": (lambda G, IG, W: G.queue_gen(), PROCS, 40, TEST),
    "once": (lambda G, IG, W: G.once(G.cas_gen), PROCS, 3, TEST),
    "seq": (lambda G, IG, W: G.seq([G.void, {"f": "a"}, G.cas_gen,
                                    G.limit(2, G.cas_gen), {"f": "b"}]),
            PROCS, 8, TEST),
    "mix": (lambda G, IG, W: G.mix([G.cas_gen, {"f": "x"},
                                    G.queue_gen()]), PROCS, 60, TEST),
    "limit": (lambda G, IG, W: G.limit(7, G.cas_gen), PROCS, 10, TEST),
    "drain_queue": (lambda G, IG, W: G.drain_queue(
        G.limit(12, G.queue_gen())), PROCS, 30, TEST),
    "filter": (lambda G, IG, W: G.filter_gen(
        lambda o: o["f"] != "read", G.limit(20, G.cas_gen)),
        PROCS, 22, TEST),
    "each": (lambda G, IG, W: G.each(lambda: G.limit(2, G.cas_gen)),
             PROCS, 14, TEST),
    "on": (lambda G, IG, W: G.on(lambda t: t in (0, 2), G.cas_gen),
           PROCS, 12, TEST),
    "clients": (lambda G, IG, W: G.clients(G.limit(5, G.cas_gen)),
                ["nemesis", 0, 1], 9, TEST),
    "nemesis": (lambda G, IG, W: G.nemesis(G.seq([START, STOP]),
                                           G.limit(6, G.cas_gen)),
                ["nemesis", 0, 1], 12, TEST),
    "nemesis_only": (lambda G, IG, W: G.nemesis(G.once(STOP)),
                     ["nemesis", 0], 4, TEST),
    "reserve": (lambda G, IG, W: G.reserve(1, {"f": "a"}, 2, {"f": "b"},
                                           G.cas_gen), PROCS, 12, TEST),
    "concat": (lambda G, IG, W: G.concat(G.limit(3, G.cas_gen),
                                         G.limit(2, {"f": "x"})),
               PROCS, 7, TEST),
    "phases": (lambda G, IG, W: G.phases(G.limit(3, G.cas_gen),
                                         G.once(READ),
                                         G.limit(2, G.queue_gen())),
               [0], 8, {"concurrency": 1, "nodes": []}),
    "then": (lambda G, IG, W: G.then(G.once({"f": "a"}),
                                     G.limit(2, G.cas_gen)),
             [0], 5, {"concurrency": 1, "nodes": []}),
    "barrier": (lambda G, IG, W: G.barrier(G.limit(2, G.cas_gen)),
                [0], 4, {"concurrency": 1, "nodes": []}),
    "singlethreaded": (lambda G, IG, W: G.singlethreaded(
        G.limit(4, G.cas_gen)), PROCS, 6, TEST),
    "await_fn": (lambda G, IG, W: G.await_fn(lambda: None,
                                             G.limit(3, G.cas_gen)),
                 PROCS, 5, TEST),
    "log": (lambda G, IG, W: G.seq([G.log("phase"), G.log_star("again"),
                                    G.limit(2, G.cas_gen)]),
            PROCS, 4, TEST),
    "sleep": (lambda G, IG, W: G.seq([G.sleep(0.001), READ]), PROCS, 3,
              TEST),
    "start_stop": (lambda G, IG, W: G.start_stop(0.001, 0.001),
                   ["nemesis"], 4, TEST),
    "delay": (lambda G, IG, W: G.delay(0.001, G.limit(3, G.cas_gen)),
              PROCS, 4, TEST),
    "stagger": (lambda G, IG, W: G.stagger(0.001, G.limit(6, G.cas_gen)),
                PROCS, 7, TEST),
    "delay_til": (lambda G, IG, W: G.delay_til(0.002,
                                               G.limit(3, G.cas_gen)),
                  PROCS, 4, TEST),
    "delay_til_late": (lambda G, IG, W: G.delay_til(
        0.002, G.limit(3, G.cas_gen), precache=False), PROCS, 4, TEST),
    "sequential_generator": (lambda G, IG, W: IG.sequential_generator(
        range(3), lambda k: G.limit(3, G.cas_gen)), PROCS, 11, TEST),
    "concurrent_generator": (lambda G, IG, W: IG.concurrent_generator(
        2, range(4), lambda k: G.limit(3, G.cas_gen)), [0, 1, 2, 3], 30,
        TEST),
    "concurrent_generator_endless": (lambda G, IG, W: IG.concurrent_generator(
        2, iter(range(10 ** 6)), lambda k: G.limit(2, G.mix([
            {"f": "write", "value": 1}, READ]))), [0, 3, 5, 6], 40, TEST),
    "register_mix": (lambda G, IG, W: G.stagger(0.0005, G.clients(
        G.mix([W.w, W.cas, W.cas, W.r]))), [0, 1, 2, 3], 20, TEST),
    "bank_mix": (lambda G, IG, W: G.mix([W.bank_read,
                                         W.bank_diff_transfer]),
                 [0, 1, 2], 20, dict(TEST, _bank_n=5)),
    "g2_gen": (lambda G, IG, W: W.g2_gen(), [0, 1, 2, 3], 20, TEST),
    "list_append_gen": (lambda G, IG, W: W.list_append_gen(3, 3),
                        [0, 1, 2], 15, TEST),
}


def _drive(G, IG, W, name, seed):
    make, procs, n, test = CASES[name]
    random.seed(seed)
    g = make(G, IG, W)
    threads = (list(range(test["concurrency"]))
               if name in ("phases", "then", "barrier")
               else THREADS)
    with G.with_threads(threads):
        return gen_stream(G, g, test, procs, n)


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("name", sorted(CASES))
def test_op_streams_equal(name, seed):
    got = _drive(TG, TIG, TW, name, seed)
    want = _drive(JG, JIG, JW, name, seed)
    assert got == want
    assert any(o is not None for o in got) or name in ("none", "void")


@pytest.mark.parametrize("seed", [0, 3])
def test_time_limit_structure(seed):
    """``time_limit`` ≤ 0.5 s: both stop drawing once their time is up;
    the ops before that have the same types, functions and processes."""
    def run(G):
        random.seed(seed)
        g = G.time_limit(0.05, G.stagger(0.002, G.cas_gen))
        seen, n = set(), 0
        with G.with_threads(THREADS):
            while n < 10 ** 5:
                o = G.op(g, TEST, PROCS[n % len(PROCS)])
                if o is None:
                    break
                seen.add((o["type"], o["f"], PROCS[n % len(PROCS)]))
                n += 1
        time.sleep(0.06)
        return seen, n, G.op(g, TEST, 0)

    (s_t, n_t, after_t), (s_j, n_j, after_j) = run(TG), run(JG)
    assert after_t is None and after_j is None
    assert n_t > 0 and n_j > 0 and n_t < 10 ** 5 and n_j < 10 ** 5
    assert {t for t, _, _ in s_t} == {t for t, _, _ in s_j} == {"invoke"}
    assert {f for _, f, _ in s_t} <= {"read", "write", "cas"}
    assert {f for _, f, _ in s_j} <= {"read", "write", "cas"}
    assert {p for *_, p in s_t} <= set(PROCS)


@pytest.mark.parametrize("process", [0, 3, 6, 9, "nemesis", "x"])
def test_process_routing(process):
    assert TG.process_to_thread(TEST, process) == \
        JG.process_to_thread(TEST, process)
    assert TG.process_to_node(TEST, process) == \
        JG.process_to_node(TEST, process)


def test_concurrent_generator_rejects_what_the_reference_rejects():
    for G, IG in ((TG, TIG), (JG, JIG)):
        g = IG.concurrent_generator(3, range(4), lambda k: G.cas_gen)
        with G.with_threads(THREADS):
            with pytest.raises(AssertionError, match="multiple of 3"):
                G.op(g, TEST, 0)
        g = IG.concurrent_generator(2, range(4), lambda k: G.cas_gen)
        with G.with_threads(THREADS):
            with pytest.raises(AssertionError, match="integer worker"):
                G.op(g, TEST, "nemesis")


# --- the reconnect wrapper (control/reconnect.py) ----------------------------

class _Fragile:
    def __init__(self, gen_):
        self.gen = gen_


def _reconnect_trace(reconnect):
    """Drive a wrapper through reuse, a failure, a reopen, retries that
    succeed and retries that run out; returns every observable."""
    opens, closed, out = [], [], []

    def open_fn():
        opens.append(1)
        return _Fragile(len(opens))

    w = reconnect.wrapper(open_fn, lambda c: closed.append(c.gen),
                          name="sut")
    out.append(w.with_conn(lambda c: c.gen))
    out.append(w.with_conn(lambda c: c.gen))

    def boom(c):
        raise IOError("dropped")

    try:
        w.with_conn(boom)
    except IOError as e:
        out.append(("raised", str(e)))
    out.append(list(closed))
    out.append(w.with_conn(lambda c: c.gen))
    calls = []

    def flaky(c):
        calls.append(c.gen)
        if len(calls) == 1:
            raise IOError("once")
        return c.gen

    out.append(w.with_retry(flaky, retries=3, delay=0))
    try:
        w.with_retry(boom, retries=2, delay=0)
    except IOError as e:
        out.append(("exhausted", str(e)))
    w.reopen()
    out.append(w.with_conn(lambda c: c.gen))
    w.close()
    w.close()                       # closing twice is a no-op

    def bad_close(c):
        raise OSError("close failed")

    w2 = reconnect.Wrapper(open_fn, bad_close).open()
    w2.close()                      # a failing close is swallowed
    out.append((len(opens), list(closed), list(calls), w.name, w2.name))
    return out


def test_reconnect_wrapper_equals_the_references():
    got = _reconnect_trace(TRC)
    assert got == _reconnect_trace(JRC)
    assert got[:4] == [1, 1, ("raised", "dropped"), [1]]
    assert got[4] == 2


# --- OS setup (harness/os_setup.py) -------------------------------------------

def _os_commands(CTL, REM, OSS, which, kw):
    rec = REM.RecordingRemote()
    test = {"nodes": ["n1", "n2"], "remote": rec}
    os_ = getattr(OSS, which)(**kw)
    CTL.on_nodes(test, os_.setup)
    CTL.on_nodes(test, os_.teardown)
    out = {}
    for h, c in rec.commands:
        out.setdefault(h, []).append(c)
    return out


@pytest.mark.parametrize("which,kw", [
    ("DebianOS", dict(packages=["ntpdate", "iptables"],
                      node_ips={"n1": "10.0.0.1", "n2": "10.0.0.2"})),
    ("DebianOS", dict(update=False)),
    ("DebianOS", dict(packages=["a b"], node_ips={"n'1": "1.2.3.4"})),
    ("SmartOS", dict(packages=["gcc", "gmake"])),
    ("SmartOS", dict())])
def test_os_setup_commands_equal_the_references(which, kw):
    got = _os_commands(TCTL, TREM, TOS, which, kw)
    assert got == _os_commands(JCTL, JREM, JOS, which, kw)
    if which == "DebianOS" and kw.get("node_ips"):
        cmds = got["n1"]
        assert any("/etc/hostname" in c for c in cmds)
        assert any("apt-get install -y" in c for c in cmds)


def test_setup_hostfile_equals_the_reference():
    out = []
    for CTL, REM, OSS in ((TCTL, TREM, TOS), (JCTL, JREM, JOS)):
        rec = REM.RecordingRemote()
        with CTL.with_session(CTL.Session("n2", rec)):
            OSS.setup_hostfile("n2", {"n1": "10.0.0.1", "n2": "10.0.0.2",
                                      "n3": "10.0.0.3"})
            OSS.setup_hostfile("n2")
        out.append(rec.commands)
    assert out[0] == out[1]
    assert any("10.0.0.3 n3" in c for _, c in out[0])
