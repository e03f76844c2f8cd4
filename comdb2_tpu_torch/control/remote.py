"""Remote execution transports.

The role of clj-ssh in the reference (``control.clj:233-256``): a
``Remote`` executes shell commands on a host and copies files. Three
implementations:

- :class:`SSHRemote` — OpenSSH subprocess (ssh/scp), with connection
  multiplexing and bounded retries on dropped connections (the
  ``reconnect.clj`` role).
- :class:`LocalRemote` — runs commands on the local machine (single-box
  clusters, CI).
- :class:`RecordingRemote` — captures commands and plays scripted
  responses; the harness's unit-test transport.

The counterpart of the JAX package's ``control/remote.py``: host code,
the same transports.
"""

from __future__ import annotations

import subprocess
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple


@dataclass
class ExecResult:
    rc: int
    out: str
    err: str

    @property
    def ok(self) -> bool:
        return self.rc == 0


class RemoteError(RuntimeError):
    def __init__(self, cmd: str, result: ExecResult):
        super().__init__(f"command failed ({result.rc}): {cmd}\n"
                         f"stdout: {result.out}\nstderr: {result.err}")
        self.cmd = cmd
        self.result = result


class Remote:
    """Transport protocol: run a shell command string on a host."""

    def execute(self, host: str, cmd: str,
                timeout: Optional[float] = None) -> ExecResult:
        raise NotImplementedError

    def upload(self, host: str, local: str, remote_path: str) -> None:
        raise NotImplementedError

    def download(self, host: str, remote_path: str, local: str) -> None:
        raise NotImplementedError

    def disconnect(self, host: str) -> None:
        pass


class SSHRemote(Remote):
    """OpenSSH subprocess transport. ``ssh_opts`` mirrors the test map's
    ssh credentials (``core.clj:324-340``): username, port,
    private-key-path, strict-host-key-checking."""

    def __init__(self, ssh_opts: Optional[dict] = None, retries: int = 3,
                 retry_delay: float = 1.0):
        self.opts = ssh_opts or {}
        self.retries = retries
        self.retry_delay = retry_delay

    def _base(self, host: str) -> List[str]:
        o = self.opts
        args = ["ssh", "-o", "BatchMode=yes",
                "-o", "ConnectTimeout=10"]
        if not o.get("strict-host-key-checking", False):
            args += ["-o", "StrictHostKeyChecking=no",
                     "-o", "UserKnownHostsFile=/dev/null",
                     "-o", "LogLevel=ERROR"]
        if o.get("port"):
            args += ["-p", str(o["port"])]
        if o.get("private-key-path"):
            args += ["-i", o["private-key-path"]]
        user = o.get("username")
        args.append(f"{user}@{host}" if user else host)
        return args

    def execute(self, host, cmd, timeout=None):
        last: Optional[ExecResult] = None
        for attempt in range(self.retries):
            try:
                p = subprocess.run(self._base(host) + [cmd],
                                   capture_output=True, text=True,
                                   timeout=timeout)
            except subprocess.TimeoutExpired:
                # the command may have run on the node — never re-send a
                # possibly-applied, non-idempotent command
                return ExecResult(-1, "", f"timeout after {timeout}s")
            res = ExecResult(p.returncode, p.stdout, p.stderr)
            # 255 is ssh's own "connection failed" code — the command
            # never started, safe to retry; anything else is the remote
            # command's exit status
            if res.rc != 255:
                return res
            last = res
            time.sleep(self.retry_delay * (attempt + 1))
        return last or ExecResult(-1, "", "unreachable")

    def _scp_base(self) -> List[str]:
        o = self.opts
        args = ["scp", "-o", "BatchMode=yes"]
        if not o.get("strict-host-key-checking", False):
            args += ["-o", "StrictHostKeyChecking=no",
                     "-o", "UserKnownHostsFile=/dev/null",
                     "-o", "LogLevel=ERROR"]
        if o.get("port"):
            args += ["-P", str(o["port"])]
        if o.get("private-key-path"):
            args += ["-i", o["private-key-path"]]
        return args

    def _dest(self, host: str, path: str) -> str:
        # scp's remote side word-splits the path through the remote
        # shell — quote it so dirs with spaces/metacharacters survive
        # (the provisioner quotes its execute() lines the same way)
        import shlex

        user = self.opts.get("username")
        q = shlex.quote(path)
        return (f"{user}@{host}:{q}" if user else f"{host}:{q}")

    def upload(self, host, local, remote_path):
        subprocess.run(self._scp_base() + [local,
                                           self._dest(host, remote_path)],
                       check=True, capture_output=True)

    def download(self, host, remote_path, local):
        subprocess.run(self._scp_base() + [self._dest(host, remote_path),
                                           local],
                       check=True, capture_output=True)


class LocalRemote(Remote):
    """Runs everything on the local machine — for single-box SUTs and
    exercising the control stack without a cluster."""

    def execute(self, host, cmd, timeout=None):
        p = subprocess.run(["/bin/sh", "-c", cmd], capture_output=True,
                           text=True, timeout=timeout)
        return ExecResult(p.returncode, p.stdout, p.stderr)

    def upload(self, host, local, remote_path):
        subprocess.run(["cp", local, remote_path], check=True)

    def download(self, host, remote_path, local):
        subprocess.run(["cp", remote_path, local], check=True)


@dataclass
class RecordingRemote(Remote):
    """Test transport: records (host, cmd) pairs; ``responder`` maps a
    command to an ExecResult (default: success, empty output)."""

    responder: Optional[Callable[[str, str], Optional[ExecResult]]] = None
    commands: List[Tuple[str, str]] = field(default_factory=list)
    uploads: List[Tuple[str, str, str]] = field(default_factory=list)
    downloads: List[Tuple[str, str, str]] = field(default_factory=list)
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def execute(self, host, cmd, timeout=None):
        with self._lock:
            self.commands.append((host, cmd))
        if self.responder:
            r = self.responder(host, cmd)
            if r is not None:
                return r
        return ExecResult(0, "", "")

    def upload(self, host, local, remote_path):
        with self._lock:
            self.uploads.append((host, local, remote_path))

    def download(self, host, remote_path, local):
        with self._lock:
            self.downloads.append((host, remote_path, local))
