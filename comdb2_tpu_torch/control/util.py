"""Remote helpers (``jepsen/control/util.clj``): file tests, temp dirs,
daemon start/stop, grepkill.

The counterpart of the JAX package's ``control/util.py``: host code, the
same command strings.
"""

from __future__ import annotations

from typing import Optional, Sequence

from . import exec_, lit, su
from .remote import RemoteError


def exists(path: str) -> bool:
    """Does a file exist on the current node? (``control/util.clj:11-14``)"""
    from . import _require_session, build_cmd

    s = _require_session()
    return s.execute(build_cmd("test", "-e", path)).ok


def tmp_dir() -> str:
    """Create a fresh remote temp dir (``control/util.clj:26-36``)."""
    return exec_("mktemp", "-d")


def wget(url: str, dest: Optional[str] = None) -> str:
    """Fetch a URL on the node (``control/util.clj:38-55``)."""
    if dest:
        exec_("wget", "-q", "-O", dest, url)
        return dest
    exec_("wget", "-q", url)
    return url.rsplit("/", 1)[-1]


def install_tarball(url: str, dest_dir: str) -> str:
    """Download + unpack a tarball into dest_dir
    (``control/util.clj:57-100``)."""
    su("mkdir", "-p", dest_dir)
    tmp = exec_("mktemp")
    exec_("wget", "-q", "-O", tmp, url)
    su("tar", "-xf", tmp, "-C", dest_dir)
    exec_("rm", "-f", tmp)
    return dest_dir


def grepkill(pattern: str, signal: str = "KILL") -> None:
    """Kill processes matching a pattern (``control/util.clj:120-130``)."""
    su("pkill", f"-{signal}", "-f", pattern, check=False)


def start_daemon(binary: str, *args: str, logfile: str = "/dev/null",
                 pidfile: Optional[str] = None,
                 chdir: Optional[str] = None) -> None:
    """Start a long-running process detached from the session
    (``control/util.clj:132-164``)."""
    from . import build_cmd

    parts = []
    if chdir:
        parts += ["cd", chdir, lit("&&")]
    parts += [lit("nohup"), binary, *args,
              lit(">>"), logfile, lit("2>&1 & echo $!")]
    pid = su(lit(build_cmd(*parts)))
    if pidfile:
        su(lit(build_cmd(lit("echo"), pid, lit(">"), pidfile)))


def stop_daemon(pidfile: str, signal: str = "TERM") -> None:
    """Kill the pid recorded in pidfile (``control/util.clj:166-183``)."""
    su(lit(f"test -e {pidfile} && kill -{signal} $(cat {pidfile}) "
           f"&& rm -f {pidfile}"), check=False)
