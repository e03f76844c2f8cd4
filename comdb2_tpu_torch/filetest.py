"""Offline history checker — ``python -m comdb2_tpu_torch.filetest
hist.edn``.

The reference's minimal end-to-end slice (``linearizable/filetest/
src/jepsen/filetest.clj:8-21``): read an EDN history file, run a
checker over it, pretty-print the result. Exit codes: 0 valid, 1
invalid, 2 unknown. ``--checker`` picks linearizability (``linear``,
the frontier search; ``wgl``, the host world search), set semantics
(``set``), serializability over list-append txn ops (``txn``), or a
workload family (``bank`` / ``sets`` / ``dirty``). The device checks
run on ``cuda`` unless ``--device cpu`` is given.

Histories parse through the native EDN loader
(:func:`.ops.native_loader.parse_history_fast`), or the Python reader
when ``native/build`` is not built. ``--trace PATH`` writes a Chrome
trace-event JSON of the run: the ``filetest.parse`` span (its ``parser``
arg names the reader), the checker's own spans (for ``linear``:
``linear.pack``, ``linear.device`` with ``linear.segments``,
``linear.kernel`` and ``linear.decode`` inside it) and
``filetest.finalize`` (the verdict map and its printing).

``--shrink`` minimizes an INVALID history to a 1-minimal sub-history
(:func:`.shrink.minimize`, on the same device) and writes
``minimal.edn``, ``results.edn`` and the re-rendered ``shrink.svg``
under ``--store``; the exit code stays the seed verdict's.

``--follow`` tails a growing map-per-line history file through a
:class:`~.stream.StreamSession` on the same device, printing each
append's progress and every verdict transition; it exits when the
verdict latches, or after ``--follow-idle`` seconds without new bytes
(then the tail settles, an unterminated last line included, and the
final verdict is a one-shot check's).

``--service HOST:PORT`` submits the history to a running verifier
daemon (``python -m comdb2_tpu_torch.service``) instead of checking it
here — this process touches no device — with the JAX package's exit
codes, and 3 when nothing was checked (an unreachable daemon, an error
reply such as overload or bad-request).
"""

from __future__ import annotations

import argparse
import pprint
import sys
from typing import List, Optional

from .checker import analysis
from .checker.checkers import set_checker
from .models.model import MODELS
from .obs import trace as obs_trace
from .ops.native_loader import parse_history_fast

#: the workload families (``checker.wl.FAMILIES``)
_WL_FAMILIES = ("bank", "sets", "dirty")


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        description="check an EDN history file offline")
    p.add_argument("history", help="EDN history file")
    p.add_argument("--model", default="cas-register",
                   choices=sorted(MODELS),
                   help="consistency model (default cas-register)")
    p.add_argument("--checker", default="linear",
                   choices=["linear", "set", "wgl", "txn",
                            "bank", "sets", "dirty"],
                   help="linear (frontier search), wgl (world search), "
                        "set semantics, txn (serializability over "
                        "list-append txn ops), or a workload family "
                        "(bank/sets/dirty — bank needs "
                        "--wl-n/--wl-total)")
    p.add_argument("--txn", action="store_true",
                   help="shorthand for --checker txn")
    p.add_argument("--wl-n", type=int, metavar="N",
                   help="--checker bank: number of accounts")
    p.add_argument("--wl-total", type=int, metavar="T",
                   help="--checker bank: invariant balance total")
    p.add_argument("--realtime", action="store_true",
                   help="with --txn: include realtime edges (strict "
                        "serializability)")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "host", "device"])
    p.add_argument("--device", default=None,
                   help="torch device of the device checks (default "
                        "cuda; 'cpu' runs them on CPU tensors, the "
                        "kernels as their plain versions)")
    p.add_argument("--keyed", action="store_true",
                   help="re-tag [k v] op values as keyed tuples "
                        "(independent-generator histories)")
    p.add_argument("--service", metavar="HOST:PORT",
                   help="submit to a running verifier daemon "
                        "(python -m comdb2_tpu_torch.service) instead "
                        "of checking locally — no local device is "
                        "touched; exits 3 on a daemon error reply "
                        "(overload/bad-request: nothing was checked)")
    p.add_argument("--shrink", action="store_true",
                   help="on INVALID, minimize to a 1-minimal "
                        "sub-history (completion-pair ddmin, batched "
                        "on the device; docs/shrink.md) and write "
                        "minimal.edn + a re-rendered SVG into the "
                        "store (see --store); the exit code stays the "
                        "seed verdict's")
    p.add_argument("--store", default="store", metavar="DIR",
                   help="store root for --shrink artifacts (default "
                        "store/)")
    p.add_argument("--trace", metavar="PATH",
                   help="write a Chrome/Perfetto trace-event JSON of "
                        "this run (parse / pack / device / finalize "
                        "stage spans)")
    p.add_argument("--follow", action="store_true",
                   help="tail mode: poll the file for appended EDN ops "
                        "(map-per-line) and feed them through a local "
                        "StreamSession, printing verdict transitions. "
                        "Exits when the verdict latches or the file goes "
                        "idle for --follow-idle seconds (then the tail "
                        "settles and the final verdict is the one-shot "
                        "check's)")
    p.add_argument("--follow-poll", type=float, default=0.2,
                   metavar="S", help="tail poll interval (s)")
    p.add_argument("--follow-idle", type=float, default=5.0,
                   metavar="S",
                   help="finalize after this long without new bytes "
                        "(0 = follow forever)")
    args = p.parse_args(argv)
    if args.txn:
        args.checker = "txn"
    if args.checker == "bank" and (args.wl_n is None
                                   or args.wl_total is None):
        p.error("--checker bank needs --wl-n and --wl-total")

    if args.trace:
        obs_trace.enable()
    try:
        return _run(args)
    finally:
        if args.trace:
            obs_trace.export_chrome(args.trace)
            print(f"trace: {len(obs_trace.spans())} span(s) -> "
                  f"{args.trace}", file=sys.stderr)
            # leave the process as found (embedders run main() too)
            obs_trace.disable()
            obs_trace.clear()


def _run(args) -> int:
    """The checker run proper (``main`` owns argument parsing and the
    trace export, which happens on every exit path)."""
    if args.follow:
        if args.checker not in ("linear",):
            print("--follow supports the linear checker only",
                  file=sys.stderr)
            return 3
        return _run_follow(args)
    if args.service:
        return _run_service(args)
    with obs_trace.span("filetest.parse", path=args.history) as sp:
        with open(args.history) as fh:
            parsed: dict = {}
            history = parse_history_fast(fh.read(), info=parsed)
        sp.set(parser=parsed["parser"], ops=len(history))

    if (args.keyed or args.model == "cas-register-comdb2") \
            and args.checker != "txn" \
            and args.checker not in _WL_FAMILIES:
        # the comdb2 tuple model exists solely for keyed histories;
        # EDN [k v] vectors carry no type tag, so re-tag them here —
        # never for txn histories (their values are micro-op vectors)
        # nor for the workload families (a bank read's [b0 b1] balance
        # row would mis-parse as a cas pair)
        from .ops.kv import wrap_keyed_history

        history = wrap_keyed_history(history)

    if args.checker in _WL_FAMILIES:
        model = ({"n": args.wl_n, "total": args.wl_total}
                 if args.checker == "bank" else None)
        if args.backend == "host":
            from .checker.wl.batch import _host_fallback

            result = _host_fallback([history], args.checker, model)[0]
        else:
            from .checker.wl import check_wl_batch

            result = check_wl_batch([history], args.checker, model,
                                    device=args.device)[0]
    elif args.checker == "txn":
        from .txn import check_txn

        result = check_txn(history, backend=args.backend,
                           realtime=args.realtime, device=args.device)
    elif args.checker == "set":
        result = set_checker.check({}, None, history)
    elif args.checker == "wgl":
        from .checker import wgl

        result = wgl.analysis(MODELS[args.model](), history)
    else:
        result = analysis(MODELS[args.model](), history,
                          backend=args.backend, device=args.device)

    with obs_trace.span("filetest.finalize", checker=args.checker):
        if args.checker == "txn":
            cex = result.get("counterexample")
            if cex:
                from .txn.counterexample import render_text

                print(render_text(cex))
            result = {k: v for k, v in result.items()
                      if k != "counterexample"}
        elif args.checker == "linear":
            result = result.to_map()
            result.pop("configs", None)
        pprint.pprint(result)
        valid = result.get("valid?")

    if args.shrink:
        _shrink(history, valid, args)

    if valid is True:
        return 0
    if valid == "unknown":
        return 2
    return 1


def _run_follow(args) -> int:
    """Tail mode: incremental byte-offset reads of a map-per-line EDN
    history, each batch of complete new lines fed as one delta to a
    local :class:`~.stream.StreamSession` on ``--device`` (keyed
    histories re-wrapped PER DELTA — the values carry no type tag).
    Prints a line per verdict TRANSITION plus a progress line per
    append; the idle timeout settles the tail and exits with the
    standard verdict code."""
    import time

    from .obs.trace import monotonic as mono
    from .ops.history import parse_history
    from .stream import StreamSession

    keyed = args.keyed or args.model == "cas-register-comdb2"
    s = StreamSession(args.model, device=args.device)
    pos = 0
    buf = ""
    last_valid = True
    last_bytes = mono()

    def parse(text):
        ops = parse_history(text)
        if keyed:
            from .ops.kv import wrap_keyed_history

            ops = wrap_keyed_history(ops)
        return ops

    def transition(out) -> None:
        nonlocal last_valid
        if out["valid"] != last_valid:
            print(f"verdict: {last_valid!r} -> {out['valid']!r} at "
                  f"op {out['op_index']} "
                  f"(checked_through={out['checked_through']})",
                  flush=True)
            last_valid = out["valid"]

    while True:
        try:
            with open(args.history) as fh:
                fh.seek(pos)
                chunk = fh.read()
                pos = fh.tell()
        except FileNotFoundError:
            chunk = ""
        if chunk:
            buf += chunk
            lines, _, buf = buf.rpartition("\n")
            if lines.strip():
                ops = parse(lines)
                out = s.append(ops)
                print(f"append: +{len(ops)} ops -> valid="
                      f"{out['valid']!r} checked_through="
                      f"{out['checked_through']}/{out['op_count']} "
                      f"engine={out['engine']} "
                      f"dispatches={out['dispatches']}", flush=True)
                transition(out)
                if out["valid"] is not True:
                    break
            last_bytes = mono()
        elif args.follow_idle > 0 and \
                mono() - last_bytes >= args.follow_idle:
            break
        else:
            time.sleep(max(args.follow_poll, 0.01))
    if buf.strip() and s.valid is True:
        # a final line without a trailing newline (the writer died or
        # never terminated the file) is still part of the history —
        # the idle timeout decided the stream ended, so feed it before
        # the final settle
        transition(s.append(parse(buf)))
    out = s.finalize_input()
    transition(out)
    pprint.pprint({k: out[k] for k in
                   ("valid", "op_index", "op_count",
                    "checked_through", "segments", "engine",
                    "dispatches", "appends", "replays")
                   if k in out}
                  | ({"cause": out["cause"]} if "cause" in out
                     else {}))
    if out["valid"] is True:
        return 0
    if out["valid"] == "unknown":
        return 2
    return 1


def _shrink(history, valid, args) -> None:
    """``--shrink``: minimize an INVALID seed and persist the result;
    any other seed verdict is reported on stderr and shrinks nothing."""
    if args.checker not in ("linear", "txn"):
        print("--shrink supports the linear and txn checkers only",
              file=sys.stderr)
        return
    if valid is not False:
        # shrinking a VALID history has nothing to preserve, shrinking
        # an UNKNOWN would loop on capacity-limited verdicts
        print(f"--shrink: seed verdict is {valid!r} — only "
              "INVALID histories shrink", file=sys.stderr)
        return
    from .shrink import SeedVerdictError, minimize

    try:
        r = minimize(history, checker=args.checker, model=args.model,
                     realtime=args.realtime, device=args.device)
    except SeedVerdictError as e:
        # the main analysis escalates frontier capacity (or ran on the
        # host); the shrinker's fixed-F seed re-check can still come
        # back UNKNOWN
        print(f"--shrink: {e}", file=sys.stderr)
        return
    _save_shrink_artifacts(r.ops, r, args)


def _run_service(args) -> int:
    """``--service HOST:PORT``: one request to the daemon; the exit code
    is the reply's verdict's, or 3 when nothing was checked."""
    from .service.client import ServiceClient

    host, _, port = args.service.rpartition(":")
    with open(args.history) as fh:
        text = fh.read()
    try:
        with ServiceClient(host or "127.0.0.1", int(port)) as c:
            if args.shrink:
                reply = c.shrink(text, txn=(args.checker == "txn"),
                                 realtime=args.realtime,
                                 model=(None if args.checker == "txn"
                                        else args.model),
                                 keyed=args.keyed, raise_on_error=False)
            elif args.checker in _WL_FAMILIES:
                reply = c.check_wl(text, args.checker,
                                   wl=({"n": args.wl_n,
                                        "total": args.wl_total}
                                       if args.checker == "bank"
                                       else None),
                                   raise_on_error=False)
            elif args.checker == "txn":
                reply = c.check(text, txn=True, realtime=args.realtime,
                                raise_on_error=False)
            else:
                reply = c.check(text, model=args.model,
                                keyed=args.keyed, raise_on_error=False)
    except (OSError, ValueError) as e:
        # unreachable daemon / bad HOST:PORT: nothing was checked, and
        # exit 1 would record a violation that never happened
        print(f"verifier service error: {e}", file=sys.stderr)
        return 3
    if args.shrink and reply.get("ok") and reply.get("minimal_history"):
        # the reply's EDN is raw: keyed [k v] values re-wrap before the
        # host re-check, as on the local path
        mops = parse_history_fast(reply["minimal_history"])
        if (args.keyed or args.model == "cas-register-comdb2") \
                and args.checker != "txn":
            from .ops.kv import wrap_keyed_history

            mops = wrap_keyed_history(mops)
        _save_shrink_artifacts(mops, reply, args)
    pprint.pprint({k: v for k, v in reply.items()
                   if k != "minimal_history"})
    if not reply.get("ok"):
        # overload/bad-request: the history was never checked
        return 3
    valid = reply.get("valid")
    if valid is True:
        return 0
    if valid == "unknown":
        return 2
    return 1


def _save_shrink_artifacts(ops, result, args) -> None:
    """Persist minimal.edn + results.edn + the re-rendered SVG into the
    store (one run dir); the SVG re-render re-checks the minimal
    history on the host and its verdict lands in results.edn.
    ``result`` is a ShrinkResult (local path) or the daemon's reply
    (``--service``)."""
    from .harness.store import save_shrink
    from .ops.history import history_to_edn
    from .report import shrink_svg

    ops = list(ops)
    checker = "txn" if args.checker == "txn" else "linear"
    rv, svg = shrink_svg.render_minimal(
        ops, checker=checker, model=args.model,
        realtime=args.realtime)
    if isinstance(result, dict):
        rm = {"valid?": result.get("valid"), "checker": checker,
              "seed-ops": result.get("seed_ops"),
              "minimal-ops": result.get("minimal_ops"),
              "rounds": result.get("rounds"),
              "candidates": result.get("candidates"),
              "dispatches": result.get("dispatches"),
              "one-minimal?": result.get("one_minimal"),
              "partial?": result.get("partial"),
              "reverified-valid?": rv}
        # the reply flattens ShrinkResult.extra (txn diagnosis etc.)
        for k in ("txns", "evidence_txns", "anomaly_class",
                  "seed_class", "anomalies", "note", "cause"):
            if k in result:
                rm[k.replace("_", "-")] = result[k]
    else:
        rm = shrink_svg.results_map(result, reverified=rv)
    d = save_shrink(history_to_edn(ops), rm, svg=svg,
                    store_root=args.store)
    print(f"shrink: {len(ops)} ops -> {d}/minimal.edn", file=sys.stderr)
    if rv is not False:
        # a clean re-check means the minimizer and the offline checker
        # disagree: surface it, never hide it
        print(f"shrink: WARNING minimal history re-checked {rv!r}",
              file=sys.stderr)


if __name__ == "__main__":
    sys.exit(main())
