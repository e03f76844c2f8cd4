"""Network manipulation (``jepsen/net.clj`` + ``jepsen/control/net.clj``).

A ``Net`` cuts, degrades, and heals links between test nodes by driving
iptables / tc on the nodes through the control session bound to the
executing thread.

The counterpart of the JAX package's ``control/net.py``: host code, the
same command strings.
"""

from __future__ import annotations

from typing import Optional

from . import exec_, lit, on_nodes, su
from .remote import RemoteError

TC = "/sbin/tc"


def ip_of(host: str) -> str:
    """Resolve a hostname to an IP on the current session's node
    (``control/net.clj:45-53``); bare IPs pass through."""
    if all(c.isdigit() or c == "." for c in host) and host.count(".") == 3:
        return host
    out = exec_("getent", "hosts", host, check=False)
    if out:
        return out.split()[0]
    return host


class Net:
    """Protocol (``net.clj:9-20``)."""

    def drop(self, test: dict, src: str, dest: str) -> None:
        raise NotImplementedError

    def heal(self, test: dict) -> None:
        raise NotImplementedError

    def slow(self, test: dict, mean_ms: float = 50,
             variance_ms: float = 10, distribution: str = "normal") -> None:
        raise NotImplementedError

    def flaky(self, test: dict) -> None:
        raise NotImplementedError

    def fast(self, test: dict) -> None:
        raise NotImplementedError


class NoopNet(Net):
    def drop(self, test, src, dest):
        pass

    def heal(self, test):
        pass

    def slow(self, test, mean_ms=50, variance_ms=10, distribution="normal"):
        pass

    def flaky(self, test):
        pass

    def fast(self, test):
        pass


noop = NoopNet()


class IptablesNet(Net):
    """Default impl (``net.clj:34-75``): DROP rules for partitions,
    ``tc netem`` for latency/loss."""

    def __init__(self, interface: str = "eth0"):
        self.interface = interface

    def drop(self, test, src, dest):
        # run on dest: drop packets arriving from src
        def _drop(test_, node):
            su("iptables", "-A", "INPUT", "-s", ip_of(src), "-j", "DROP",
               "-w")
        on_nodes(test, _drop, nodes=[dest])

    def heal(self, test):
        def _heal(test_, node):
            su("iptables", "-F", "-w")
            su("iptables", "-X", "-w")
        on_nodes(test, _heal)

    def slow(self, test, mean_ms=50, variance_ms=10, distribution="normal"):
        def _slow(test_, node):
            su(TC, "qdisc", "add", "dev", self.interface, "root", "netem",
               "delay", f"{mean_ms}ms", f"{variance_ms}ms",
               "distribution", distribution)
        on_nodes(test, _slow)

    def flaky(self, test):
        def _flaky(test_, node):
            su(TC, "qdisc", "add", "dev", self.interface, "root", "netem",
               "loss", "20%", "75%")
        on_nodes(test, _flaky)

    def fast(self, test):
        def _fast(test_, node):
            try:
                su(TC, "qdisc", "del", "dev", self.interface, "root")
            except RemoteError as e:
                if "No such file or directory" not in (e.result.err
                                                       + e.result.out):
                    raise
        on_nodes(test, _fast)


iptables = IptablesNet()
