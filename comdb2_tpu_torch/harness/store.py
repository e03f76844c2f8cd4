"""Results store — persistence of histories and analyses.

The counterpart of the JAX package's ``harness/store.py``, host code
only, writing the same files byte for byte. Mirrors
``jepsen/store.clj``: every run persists a directory tree
``store/<name>/<start-time>/`` containing ``test.edn`` (the test map
minus function-valued keys), ``history.edn``, ``results.edn``, and
``jepsen.log``; ``latest`` symlinks point at the most recent run
(``store.clj:229-295``). Tests reload via :func:`load` and **re-check
offline** — analysis is replayable from the history artifact
(``store.clj:159-165``), which is the contract the checkers honor.
"""

from __future__ import annotations

import logging
import os
from typing import Any, List, Optional

from ..ops.edn import write_edn
from ..ops.history import parse_history, history_to_edn
from ..ops.op import Op

# keys never serialized: live objects and runtime state
# (the reference's nonserializable-keys, store.clj:146-157)
NONSERIALIZABLE = ("db", "os", "net", "client", "checker", "nemesis",
                   "generator", "model", "_clock", "sessions", "remote")


def base_dir(test: dict) -> str:
    return test.get("store-root", "store")


def path(test: dict, *more: str) -> str:
    """store/<name>/<start-time>/<more...> (``store.clj:222-227``)."""
    return os.path.join(base_dir(test), str(test.get("name", "noname")),
                        str(test.get("start-time", "notime")), *more)


def artifact_dir(test, opts=None):
    """Where a checker may drop artifacts: opts dir > test dir > the
    test's store path (when the test is named and timed); None when no
    location is known. Shared by the SVG-on-failure renderer and the
    independent checker's per-key artifact writer."""
    base = (opts or {}).get("dir") or (test or {}).get("dir")
    if base is None and (test or {}).get("name") \
            and test.get("start-time"):
        base = path(test)
    return base


def path_mkdirs(test: dict, *more: str) -> str:
    p = path(test, *more)
    os.makedirs(os.path.dirname(p), exist_ok=True)
    return p


def _edn_safe(x: Any) -> Any:
    """Coerce arbitrary result structures to EDN-writable values."""
    if isinstance(x, Op):
        return {str(k): _edn_safe(v) for k, v in x.to_map().items()}
    if isinstance(x, dict):
        return {_edn_safe(k): _edn_safe(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_edn_safe(v) for v in x]
    if isinstance(x, (set, frozenset)):
        return {_edn_safe(v) for v in x}
    if isinstance(x, (str, int, float, bool)) or x is None:
        return x
    if hasattr(x, "item") and callable(getattr(x, "item", None)):
        try:
            return x.item()       # numpy scalars
        except Exception:
            pass
    return str(x)


def serializable_test(test: dict) -> dict:
    return {k: _edn_safe(v) for k, v in test.items()
            if k not in NONSERIALIZABLE and k != "history"
            and k != "results" and not k.startswith("_")}


def save_1(test: dict) -> None:
    """Write test map + history after the run (``store.clj:272-283``)."""
    with open(path_mkdirs(test, "test.edn"), "w") as fh:
        fh.write(write_edn(serializable_test(test)))
    hist: List[Op] = test.get("history") or []
    with open(path_mkdirs(test, "history.edn"), "w") as fh:
        fh.write(history_to_edn(hist))
    update_symlinks(test)


def save_2(test: dict) -> None:
    """Write results after analysis (``store.clj:285-295``)."""
    with open(path_mkdirs(test, "results.edn"), "w") as fh:
        fh.write(write_edn(_edn_safe(test.get("results") or {})))
    update_symlinks(test)


def load(test_name: str, start_time: str,
         store_root: str = "store") -> dict:
    """Reload a persisted test for offline re-checking
    (``store.clj:159-165``)."""
    from ..ops.edn import read_edn_all

    d = os.path.join(store_root, test_name, start_time)
    out: dict = {"name": test_name, "start-time": start_time,
                 "store-root": store_root}
    tpath = os.path.join(d, "test.edn")
    if os.path.exists(tpath):
        forms = read_edn_all(open(tpath).read())
        if forms:
            out.update({str(k): v for k, v in forms[0].items()})
    hpath = os.path.join(d, "history.edn")
    if os.path.exists(hpath):
        out["history"] = parse_history(open(hpath).read())
    rpath = os.path.join(d, "results.edn")
    if os.path.exists(rpath):
        forms = read_edn_all(open(rpath).read())
        if forms:
            out["results"] = forms[0]
    return out


def tests(test_name: str, store_root: str = "store") -> List[str]:
    """All persisted start-times for a test name, sorted."""
    d = os.path.join(store_root, test_name)
    if not os.path.isdir(d):
        return []
    return sorted(e for e in os.listdir(d)
                  if e not in ("latest",)
                  and os.path.isdir(os.path.join(d, e)))


def latest(test_name: str, store_root: str = "store") -> Optional[dict]:
    """Most recent run of a test (``repl.clj:6-13``)."""
    ts = tests(test_name, store_root)
    return load(test_name, ts[-1], store_root) if ts else None


def update_symlinks(test: dict) -> None:
    """point store/<name>/latest and store/latest at this run
    (``store.clj:229-241``)."""
    target = path(test)
    if not os.path.isdir(target):
        return
    for linkdir, rel in ((os.path.join(base_dir(test),
                                       str(test.get("name"))),
                          str(test.get("start-time"))),
                         (base_dir(test),
                          os.path.join(str(test.get("name")),
                                       str(test.get("start-time"))))):
        link = os.path.join(linkdir, "latest")
        try:
            if os.path.islink(link):
                os.unlink(link)
            os.symlink(rel, link)
        except OSError:
            pass


def save_service_status(status: dict,
                        store_root: str = "store") -> str:
    """Persist a verifier-daemon status snapshot under
    ``store/service/`` next to the test runs, so a long-running
    daemon's queue / latency / bucket metrics are browsable like any
    other artifact. Appends one JSON line per snapshot to ``status.jsonl``
    (a run's history) and rewrites ``latest.json`` (the current
    state); returns the latest path."""
    import json

    d = os.path.join(store_root, "service")
    os.makedirs(d, exist_ok=True)
    line = json.dumps(status, sort_keys=True)
    with open(os.path.join(d, "status.jsonl"), "a") as fh:
        fh.write(line + "\n")
    latest = os.path.join(d, "latest.json")
    tmp = latest + ".tmp"
    with open(tmp, "w") as fh:
        fh.write(line + "\n")
    os.replace(tmp, latest)
    return latest


def save_shrink(minimal_edn: str, results: dict,
                svg: Optional[str] = None,
                store_root: str = "store",
                name: str = "shrink") -> str:
    """Persist a shrink run like a test run: ``store/<name>/<ts>/``
    with ``minimal.edn`` (the 1-minimal sub-history — re-checkable
    offline via ``filetest``, the same replayability contract as
    ``history.edn``), ``results.edn`` (the minimization stats, with
    ``valid?`` so the store web index color-codes the row like any
    other run) and, when given, the re-rendered counterexample
    ``shrink.svg``. Returns the run directory."""
    import time

    ts = (time.strftime("%Y%m%dT%H%M%S")
          + f"-{time.time_ns() % 1_000_000:06d}")
    test = {"name": name, "start-time": ts, "store-root": store_root}
    with open(path_mkdirs(test, "minimal.edn"), "w") as fh:
        fh.write(minimal_edn)
    with open(path_mkdirs(test, "results.edn"), "w") as fh:
        fh.write(write_edn(_edn_safe(results)))
    if svg is not None:
        with open(path_mkdirs(test, "shrink.svg"), "w") as fh:
            fh.write(svg)
    update_symlinks(test)
    return path(test)


_handlers: dict = {}


def start_logging(test: dict) -> None:
    """File logging into the test dir (``store.clj:301-311``)."""
    p = path_mkdirs(test, "jepsen.log")
    h = logging.FileHandler(p)
    h.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)s %(threadName)s %(message)s"))
    logger = logging.getLogger("comdb2_tpu_torch")
    logger.addHandler(h)
    if logger.level == logging.NOTSET:
        logger.setLevel(logging.INFO)
    _handlers[id(test)] = h


def stop_logging(test: dict) -> None:
    h = _handlers.pop(id(test), None)
    if h is not None:
        logging.getLogger("comdb2_tpu_torch").removeHandler(h)
        h.close()
