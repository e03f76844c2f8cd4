"""Client protocol — applies operations to a system under test
(``jepsen/client.clj:4-20``).

The counterpart of the JAX package's ``harness/client.py``: host code,
the same protocol.
"""

from __future__ import annotations


class Client:
    """Three-method SUT client. ``setup`` returns a client specialized to
    a node; ``invoke`` turns an invocation op-dict into a completion
    op-dict (same f/process, type ok/fail/info); ``teardown`` releases
    resources."""

    def setup(self, test: dict, node) -> "Client":
        return self

    def invoke(self, test: dict, op: dict) -> dict:
        raise NotImplementedError

    def teardown(self, test: dict) -> None:
        pass


class Noop(Client):
    """Acknowledges everything (``client.clj:15-20``)."""

    def invoke(self, test, op):
        return {**op, "type": "ok"}


class PassThrough(Client):
    """Returns ops unchanged — the noop *nemesis* (``nemesis.clj:12-17``):
    nemesis invocations are ``info`` and must complete as ``info``, never
    ``ok``, or the history pairing breaks."""

    def invoke(self, test, op):
        return dict(op)


noop = Noop()
noop_nemesis = PassThrough()
