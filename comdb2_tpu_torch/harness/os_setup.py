"""OS preparation implementations (``jepsen/os/debian.clj``,
``os/smartos.clj``): hostname/hosts-file setup and package
installation over the control plane.

The counterpart of the JAX package's ``harness/os_setup.py``: host
code, the same commands.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from .. import control
from . import db as db_ns


def setup_hostfile(node: str, node_ips: Optional[Dict[str, str]] = None
                   ) -> None:
    """Point /etc/hostname and /etc/hosts at the test's node names
    (``os/debian.clj:78-96``)."""
    control.su(control.lit(
        f"echo {control.escape(str(node))} > /etc/hostname"))
    lines = ["127.0.0.1 localhost",
             f"127.0.1.1 {node}"]
    for name, ip in (node_ips or {}).items():
        if name != node:
            lines.append(f"{ip} {name}")
    body = "\\n".join(lines)
    control.su(control.lit(f'printf "{body}\\n" > /etc/hosts'))


class DebianOS(db_ns.OS):
    """apt-based prep (``os/debian.clj``): noninteractive update +
    install of required packages."""

    def __init__(self, packages: Sequence[str] = (),
                 node_ips: Optional[Dict[str, str]] = None,
                 update: bool = True):
        self.packages = list(packages)
        self.node_ips = node_ips
        self.update = update

    def setup(self, test, node):
        setup_hostfile(node, self.node_ips)
        if self.update:
            control.su("env", "DEBIAN_FRONTEND=noninteractive",
                       "apt-get", "update", "-y", check=False)
        if self.packages:
            control.su("env", "DEBIAN_FRONTEND=noninteractive",
                       "apt-get", "install", "-y", *self.packages)

    def teardown(self, test, node):
        pass


class SmartOS(db_ns.OS):
    """pkgin-based prep (``os/smartos.clj``)."""

    def __init__(self, packages: Sequence[str] = ()):
        self.packages = list(packages)

    def setup(self, test, node):
        if self.packages:
            control.su("pkgin", "-y", "install", *self.packages)

    def teardown(self, test, node):
        pass
