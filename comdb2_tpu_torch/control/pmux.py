"""pmux client — service-name → port discovery.

The harness-side counterpart of ``ct_pmux`` (the reference's
``tools/pmux`` role): every host runs one port multiplexer; services
register their port under a name, clients resolve the name instead of
carrying host:port configuration. The native HA client resolves
port-less discovery entries the same way (``sut_tcp.cpp``
``pmux_get_port``); this module is the Python harness's handle on the
same daemon (register workloads' SUTs, resolve cluster layouts,
inspect assignments in tests).
"""

from __future__ import annotations

import socket
from typing import Dict, List, Optional, Tuple

DEFAULT_PORT = 5105


class PmuxClient:
    """One pmux conversation (line protocol; connection per client,
    reused across requests)."""

    def __init__(self, host: str = "127.0.0.1",
                 port: int = DEFAULT_PORT, timeout_s: float = 2.0):
        self.host = host
        self.port = port
        self.timeout_s = timeout_s
        self._sock: Optional[socket.socket] = None
        self._file = None

    def _conn(self):
        if self._sock is None:
            self._sock = socket.create_connection(
                (self.host, self.port), timeout=self.timeout_s)
            self._file = self._sock.makefile("rw")
        return self._file

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None
                self._file = None

    def _request(self, line: str) -> str:
        f = self._conn()
        try:
            f.write(line + "\n")
            f.flush()
            reply = f.readline()
        except OSError:
            self.close()
            raise
        if not reply:
            self.close()
            raise OSError("pmux closed the connection")
        return reply.strip()

    # -- commands ------------------------------------------------------

    def get(self, service: str) -> Optional[int]:
        """Port for ``service``, or None when unregistered."""
        r = self._request(f"get {service}")
        try:
            port = int(r.split()[0])
        except (ValueError, IndexError):
            return None
        return port if port > 0 else None

    def reg(self, service: str) -> int:
        """Allocate (or return the existing) port for ``service``."""
        port = int(self._request(f"reg {service}").split()[0])
        if port < 0:
            raise OSError(f"pmux could not allocate a port: {service}")
        return port

    def use(self, service: str, port: int) -> None:
        """Publish a fixed port for ``service``."""
        r = self._request(f"use {service} {port}")
        if not r.startswith("0"):
            raise OSError(f"pmux use failed: {r}")

    def delete(self, service: str) -> bool:
        return self._request(f"del {service}").startswith("0")

    def used(self) -> Dict[str, int]:
        """All assignments, service -> port."""
        f = self._conn()
        out: Dict[str, int] = {}
        # same error contract as _request: a daemon that died since
        # the last call raises OSError here, and the stale socket must
        # be DROPPED so the next call redials instead of failing on
        # the dead connection forever
        try:
            f.write("used\n")
            f.flush()
            while True:
                line = f.readline()
                if not line:
                    # a dropped connection mid-listing must not read
                    # as "fewer services registered"
                    raise OSError(
                        "pmux closed the connection mid-listing")
                if line.strip() == ".":
                    break
                port_s, svc = line.strip().split(" ", 1)
                out[svc] = int(port_s)
        except OSError:
            self.close()
            raise
        return out

    def hello(self) -> bool:
        try:
            return self._request("hello").startswith("0")
        except OSError:
            return False

    def __enter__(self) -> "PmuxClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def resolve_layout(entries: List[Tuple[str, int]], service: str,
                   timeout_s: float = 2.0) -> List[Tuple[str, int]]:
    """Resolve a cluster layout through per-host pmuxes:
    ``entries`` is [(host, pmux_port), ...]; returns
    [(host, service_port), ...]. Raises when any host's pmux doesn't
    know the service — an undiscoverable node is a provisioning
    failure, not a silent cluster shrink."""
    out = []
    for host, pmux_port in entries:
        with PmuxClient(host, pmux_port, timeout_s) as c:
            port = c.get(service)
        if port is None:
            raise OSError(f"pmux at {host}:{pmux_port} does not know "
                          f"{service!r}")
        out.append((host, port))
    return out
