"""Process helpers shared by the port's fleet scripts
(``scripts/torch_elastic.py``, ``scripts/torch_gate.py``) and
``chip_smoke.py``: a ``ct_pmux`` registry, the port's verifier daemons
as subprocesses with their stderr kept in files, and the leftover
accounting a gate needs after them (zombie children, surviving daemon
processes, CUDA compute apps).

Not a CLI; import it with ``scripts/`` on ``sys.path``.
"""
from __future__ import annotations

import json
import os
import select
import shutil
import socket
import subprocess
import sys
import time
from typing import List, Optional, Tuple

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the command-line mark of the port's daemon and supervisor processes
SERVICE_MODULE = "comdb2_tpu_torch.service"


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def find_ct_pmux() -> str:
    """The ``ct_pmux`` binary: ``native/build/ct_pmux`` when built, else
    built there with cmake, else with one direct ``g++`` line into the
    port's build directory (the two routes of ``scripts/check.sh``)."""
    built = os.path.join(REPO, "native", "build", "ct_pmux")
    if os.path.exists(built):
        return built
    if shutil.which("cmake") is not None:
        build = os.path.join(REPO, "native", "build")
        subprocess.run(["cmake", "-S", os.path.join(REPO, "native"), "-B",
                        build], check=True, stdout=subprocess.DEVNULL)
        subprocess.run(["cmake", "--build", build, "--target", "ct_pmux"],
                       check=True, stdout=subprocess.DEVNULL)
        return built
    if shutil.which("g++") is None:
        raise SystemExit("no ct_pmux build, and neither cmake nor g++ to "
                         "make one")
    out_dir = os.path.join(REPO, "comdb2_tpu_torch", "_build", "pmux")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "ct_pmux")
    tmp = f"{out}.{os.getpid()}"
    subprocess.run(["g++", "-O1", "-Wall", "-Inative/include",
                    "native/src/pmux_main.cpp", "-o", tmp, "-lpthread"],
                   cwd=REPO, check=True)
    os.replace(tmp, out)
    return out


def start_pmux(binary: str, port: int) -> subprocess.Popen:
    """``ct_pmux -p PORT``, returned once it accepts connections."""
    proc = subprocess.Popen([binary, "-p", str(port)],
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        try:
            socket.create_connection(("127.0.0.1", port),
                                     timeout=0.2).close()
            return proc
        except OSError:
            time.sleep(0.1)
    proc.kill()
    proc.wait(timeout=30)
    raise SystemExit("ct_pmux never came up")


def stop_pmux(proc: subprocess.Popen, port: int) -> None:
    """The registry's ``exit`` verb, then wait (terminate on a hang)."""
    try:
        s = socket.create_connection(("127.0.0.1", port), timeout=2)
        s.sendall(b"exit\n")
        s.close()
    except OSError:
        pass
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.terminate()
        proc.wait(timeout=30)


def start_daemon(args, err_path: str, ready_s: float = 300.0,
                 env=None) -> Tuple[subprocess.Popen, Optional[dict]]:
    """``python -m comdb2_tpu_torch.service --port 0 ARGS`` with its
    stderr in ``err_path``; returns ``(proc, ready)``, ``ready`` None
    when it printed no ready line (the caller reports the file's tail,
    ``service.supervisor.stderr_tail``, and reaps ``proc`` with
    :func:`stop_daemon`)."""
    os.makedirs(os.path.dirname(os.path.abspath(err_path)), exist_ok=True)
    with open(err_path, "wb") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", SERVICE_MODULE, "--port", "0",
             *args], cwd=REPO, stdout=subprocess.PIPE, stderr=err,
            text=True, env=env)
    ready, _, _ = select.select([proc.stdout], [], [], ready_s)
    line = proc.stdout.readline() if ready else ""
    if not line.strip():
        return proc, None
    return proc, json.loads(line)


def stop_daemon(proc: subprocess.Popen, port: Optional[int] = None) -> int:
    """The ``shutdown`` verb, then wait (terminate, kill); the exit
    code. Every branch reaps the child."""
    if port is not None and proc.poll() is None:
        try:
            from comdb2_tpu_torch.service.client import ServiceClient

            with ServiceClient("127.0.0.1", port, retries=0) as c:
                c.shutdown()
        except (OSError, ValueError):
            pass
    for stop in (None, proc.terminate, proc.kill):
        if stop is not None and proc.poll() is None:
            stop()
        try:
            proc.wait(timeout=60)
            break
        except subprocess.TimeoutExpired:
            continue
    if proc.stdout is not None:
        proc.stdout.close()
    return proc.returncode


def zombies() -> List[int]:
    """Unreaped children of this process (``Z`` in ``/proc``)."""
    me, out = os.getpid(), []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/stat") as fh:
                fields = fh.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if fields[0] == "Z" and int(fields[1]) == me:
            out.append(int(pid))
    return out


def service_pids() -> List[int]:
    """Live processes (not zombies) running the port's daemon or
    supervisor module, other than this one."""
    out = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit() or int(pid) == os.getpid():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as fh:
                cmd = fh.read().replace(b"\0", b" ").decode(errors="replace")
            with open(f"/proc/{pid}/stat") as fh:
                state = fh.read().rsplit(")", 1)[1].split()[0]
        except OSError:
            continue
        if SERVICE_MODULE in cmd and state != "Z":
            out.append(int(pid))
    return out


def compute_app_pids() -> Optional[List[int]]:
    """The pids ``nvidia-smi`` lists as CUDA compute apps, or None
    where there is no ``nvidia-smi``."""
    if shutil.which("nvidia-smi") is None:
        return None
    r = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        return None
    return [int(x) for x in r.stdout.split() if x.strip().isdigit()]


def leftovers(pids, settle_s: float = 10.0) -> dict:
    """What the given daemon ``pids`` left behind once the fleet is
    gone, after up to ``settle_s`` for a killed process's CUDA context
    to be reclaimed: ``zombies`` (those pids unreaped children
    of this process), ``alive`` (those pids still running) and
    ``compute_apps`` (those pids ``nvidia-smi`` still lists; None
    without it), with ``compute_apps_all``, every pid it lists (a
    container may see the host's pid numbers there)."""
    pids = set(pids)
    deadline = time.monotonic() + settle_s
    while True:
        alive = sorted(p for p in service_pids() if p in pids)
        apps = compute_app_pids()
        held = None if apps is None else sorted(p for p in apps
                                                if p in pids)
        out = {"zombies": sorted(p for p in zombies() if p in pids),
               "alive": alive, "compute_apps": held,
               "compute_apps_all": apps}
        if (not out["zombies"] and not alive and not held) \
                or time.monotonic() > deadline:
            return out
        time.sleep(0.2)
