"""The pools a cell's caller draws from, made from ``--seed``.

Every seed gives the same sizes: the same number of histories and
events, and INVALID histories at the same places in the pool, each
failing in its last tenth. Only the draws differ.
"""

from __future__ import annotations

import os
import pickle
import random
import subprocess
import sys
from dataclasses import dataclass
from typing import List

from .register import plant_read, register_history


@dataclass
class Item:
    """One single-history input: its events and whether it was mutated
    (the plain reference, not this flag, decides the verdict)."""
    history: list
    mutated: bool


def spread(n: int, k: int) -> List[int]:
    """``k`` places spread evenly over ``range(n)``."""
    return [int((i + 0.5) * n / k) for i in range(k)] if k else []


def _history(rng: random.Random, config: dict, mutated: bool) -> list:
    shape = dict(config["history"], fs=tuple(config["history"]["fs"]))
    h = register_history(rng, **shape)
    if mutated:
        h, _ = plant_read(rng, h, shape["values"], config["mutation_tail"])
    return h


def _make(job) -> list:
    config, seed, mutated = job
    return _history(random.Random(seed), config, mutated)


def _map(jobs: list, workers: int) -> List[list]:
    """Each job's history, made in ``workers`` child processes (each
    history hangs on its own seed alone, so the pool is the same however
    many make it). The jobs go to a child's standard input and its
    histories come back on its standard output, pickled: no shared
    memory, no file."""
    if workers <= 1 or len(jobs) <= 1:
        return [_make(j) for j in jobs]
    n = min(workers, len(jobs))
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=root)
    code = "from perfbench.gen.pool import _child; _child()"
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE)
             for _ in range(n)]
    try:
        for i, p in enumerate(procs):
            p.stdin.write(pickle.dumps(jobs[i::n]))
            p.stdin.close()
        raw = [p.stdout.read() for p in procs]
        codes = [p.wait() for p in procs]
    finally:
        for p in procs:              # reached with a child alive on error
            if p.returncode is None:
                p.kill()
                p.wait()
            p.stdout.close()
    if any(codes):
        raise RuntimeError(f"a pool maker exited with {codes}")
    parts = [pickle.loads(r) for r in raw]
    out: List[list] = [None] * len(jobs)
    for i, part in enumerate(parts):
        out[i::n] = part
    return out


def _child() -> None:
    """A pool maker's body: jobs in on standard input, histories out."""
    jobs = pickle.loads(sys.stdin.buffer.read())
    sys.stdout.buffer.write(pickle.dumps([_make(j) for j in jobs]))


def default_workers() -> int:
    """The cores this process may run on, at most 8."""
    return min(8, len(os.sched_getaffinity(0)))


def single_pool(config: dict, size: int, seed: int,
                workers: int = 1) -> List[Item]:
    """``size`` histories, ``round(size * invalid_share)`` of them
    INVALID at evenly spread places."""
    bad = set(spread(size, round(size * config["invalid_share"])))
    master = random.Random(seed)
    jobs = [(config, master.getrandbits(64), i in bad) for i in range(size)]
    return [Item(h, i in bad) for i, h in enumerate(_map(jobs, workers))]
