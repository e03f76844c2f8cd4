"""libfaketime wrappers — divergent clock *rates* per node
(``jepsen/faketime.clj``): replace a SUT binary with a script that runs
it under faketime with an initial offset and a rate multiplier.

The counterpart of the JAX package's ``harness/faketime.py``: host
code, the same wrapper scripts.
"""

from __future__ import annotations

from .. import control
from ..control import util as cutil


def script(cmd: str, init_offset_s: float, rate: float) -> str:
    """The wrapper script body (``faketime.clj:8-19``). Fractional
    offsets are preserved — faketime accepts them, and sub-second skew
    is a realistic drift magnitude."""
    sign = "-" if init_offset_s < 0 else "+"
    return (f'#!/bin/bash\n'
            f'faketime -m -f "{sign}{abs(init_offset_s):g}s x{rate:g}" '
            f'{cmd} "$@"\n')


def wrap(cmd: str, init_offset_s: float, rate: float) -> None:
    """Replace ``cmd`` on the current node with a faketime wrapper,
    moving the original to ``cmd.no-faketime``; idempotent
    (``faketime.clj:21-31``)."""
    orig = cmd + ".no-faketime"
    body = script(orig, init_offset_s, rate)
    if not cutil.exists(orig):
        control.exec_("mv", cmd, orig)
    control.exec_(control.lit(
        f"cat > {control.escape(cmd)} <<'FAKETIME_EOF'\n{body}FAKETIME_EOF"))
    control.exec_("chmod", "a+x", cmd)


def unwrap(cmd: str) -> None:
    """Restore the original binary."""
    orig = cmd + ".no-faketime"
    if cutil.exists(orig):
        control.exec_("mv", orig, cmd)
