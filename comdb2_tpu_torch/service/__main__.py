"""CLI: ``python -m comdb2_tpu_torch.service`` — run the verifier daemon.

Prints one JSON ready-line (``{"ready": true, "port": N, ...}``) on
stdout once listening; scripts parse it instead of racing the port.

``--backend cuda`` (the default) serves on the card: the daemon builds
both kernel libraries and primes a dispatch before its ready line, and
exits non-zero without one when that fails (no card, no ``nvcc``, a
kernel that does not build or launch) — it never falls back to the CPU.
``--backend cpu`` runs the kernels' plain PyTorch versions (tests).
The JAX package's ``--interpret``, ``--no-donate`` and
``--inject-dispatch-latency-ms`` (Pallas interpret mode, carry donation,
a modeled remote-device round trip) have no counterpart here; every
other flag keeps its name.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
from typing import List, Optional

from .bucketing import ServiceLimits
from .core import DEFAULT_PRIME, VerifierCore
from .daemon import PMUX_SERVICE, VerifierDaemon


def _resolve_backend(name: str):
    """The device of ``--backend``: ``cuda`` raises ``SystemExit`` on a
    host without a card (no silent CPU)."""
    import torch

    if name == "cuda" and not torch.cuda.is_available():
        raise SystemExit("requested --backend cuda but CUDA is not "
                         "available; --backend cpu runs the plain "
                         "versions")
    return torch.device(name)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m comdb2_tpu_torch.service",
        description="batching checker-as-a-service daemon")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0,
                   help="0 = pick a free port (printed in the "
                        "ready line)")
    p.add_argument("--model", default="cas-register")
    p.add_argument("--engine", default="auto",
                   choices=["auto", "stream", "keys", "flat", "vmap"])
    p.add_argument("--backend", default="cuda",
                   choices=["cuda", "cpu"],
                   help="where the kernels run: cuda (the card; no "
                        "fallback) or cpu (their plain PyTorch "
                        "versions)")
    p.add_argument("--frontier", type=int, default=1024,
                   help="device frontier capacity F")
    p.add_argument("--batch-cap", type=int, default=64,
                   help="max live requests per device dispatch")
    p.add_argument("--shards", type=int, default=1,
                   help="shard-placement axis: shard every bucket "
                        "dispatch D ways over a device mesh (the "
                        "batch axis pads to a pow2 multiple of D; "
                        "1 = single-device path, no mesh)")
    p.add_argument("--max-queue", type=int, default=256,
                   help="admission cap; beyond it requests get "
                        "explicit overload replies (with a "
                        "retry_after_ms hint)")
    p.add_argument("--fill-ms", "--coalesce-ms", type=float,
                   default=5.0, dest="fill_ms",
                   help="cap on how long a forming batch may wait "
                        "for batch-mates (continuous batching: a "
                        "full batch launches immediately, an idle "
                        "wire launches everything; deadlines tighten "
                        "this per request). --coalesce-ms is the "
                        "legacy spelling")
    p.add_argument("--ring", type=int, default=3, metavar="N",
                   help="bounded in-flight dispatch ring depth: N "
                        "buckets staged/running/finalizing "
                        "concurrently (host-pack vs async device "
                        "overlap)")
    p.add_argument("--max-ops", type=int, default=8192)
    p.add_argument("--max-segments", type=int, default=4096)
    p.add_argument("--max-sessions", type=int, default=64,
                   help="streaming-session cap (kind:\"stream\" — "
                        "each session holds a device-resident carry; "
                        "past the cap, open answers overload with "
                        "retry_after_ms)")
    p.add_argument("--session-idle-s", type=float, default=300.0,
                   help="idle TTL before a streaming session's carry "
                        "is checkpointed to host and evicted (the "
                        "next verb restores it with zero replay)")
    p.add_argument("--drain-s", type=float, default=10.0,
                   help="drain grace: after SIGTERM or kind:\"drain\" "
                        "the daemon deregisters from pmux, re-routes "
                        "queued work, finalizes staged dispatches, "
                        "and keeps serving session-checkpoint "
                        "handoffs this long before exiting")
    p.add_argument("--no-prime", action="store_true",
                   help="skip the priming dispatches at boot (on the "
                        "card the kernel libraries are still built "
                        "before the ready line)")
    p.add_argument("--pmux", type=int, nargs="?", const=5105,
                   default=None, metavar="PORT",
                   help="publish the port under sut/verifier via "
                        "ct_pmux at PORT (default 5105)")
    p.add_argument("--pmux-service", default=PMUX_SERVICE)
    p.add_argument("--pmux-shard", type=int, default=None,
                   metavar="IDX",
                   help="register as sut/verifier/IDX — one entry "
                        "per daemon of a horizontally scaled fleet; "
                        "RoutedClient consistent-hash routes over "
                        "all of them")
    p.add_argument("--store", default=None, metavar="DIR",
                   help="persist status snapshots under DIR/service/ "
                        "(served by the store web browser)")
    p.add_argument("--trace", action="store_true",
                   help="enable span tracing (obs.trace): with "
                        "--store, a Chrome/Perfetto trace.json is "
                        "written next to the status artifacts; "
                        "disabled-mode cost is one flag check per "
                        "span site (docs/observability.md)")
    args = p.parse_args(argv)
    import torch

    if args.trace:
        from ..obs import trace as obs_trace

        obs_trace.enable()
    device = _resolve_backend(args.backend)
    if device.type == "cuda":
        from ..utils import compile_guard

        # the scrape's compile_kernel_card_seconds_total: CUDA events
        # around every launch
        compile_guard.time_launches()
    limits = ServiceLimits(max_ops=args.max_ops,
                           max_segments=args.max_segments)
    core = VerifierCore(
        model=args.model, engine=args.engine,
        F=args.frontier, batch_cap=args.batch_cap,
        max_queue=args.max_queue, limits=limits,
        shards=args.shards,
        fill_window_s=args.fill_ms / 1e3, ring_depth=args.ring,
        max_sessions=args.max_sessions,
        session_idle_s=args.session_idle_s, device=device)
    pmux_service = args.pmux_service
    if args.pmux_shard is not None:
        pmux_service = f"{PMUX_SERVICE}/{args.pmux_shard}"
    daemon = VerifierDaemon(core, host=args.host, port=args.port,
                            pmux_port=args.pmux,
                            pmux_service=pmux_service,
                            store_root=args.store,
                            drain_grace_s=args.drain_s)
    # SIGTERM = graceful leave (deregister BEFORE the listener closes,
    # re-route queued work, serve checkpoint handoffs through the
    # grace window); SIGINT stays the immediate stop
    signal.signal(signal.SIGTERM, daemon.drain)
    signal.signal(signal.SIGINT, daemon.stop)
    try:
        primed = core.prime(() if args.no_prime else DEFAULT_PRIME)
    except Exception as e:                      # noqa: BLE001
        # no ready line: the kernels cannot serve here
        print(f"startup failed: {type(e).__name__}: {e}",
              file=sys.stderr, flush=True)
        return 1
    # publish BEFORE the ready line: "ready" must mean discoverable.
    # Publish failure keeps the daemon serving (discovery is
    # additive) but the ready line then reports pmux_service null —
    # a fleet booter gating on it sees the truth instead of racing
    # RoutedClient.discover against a registration that never
    # happened.
    daemon._pmux_publish()
    print(json.dumps({"ready": True, "host": daemon.host,
                      "port": daemon.port, "backend": args.backend,
                      "device": (torch.cuda.get_device_name(device)
                                 if device.type == "cuda" else "cpu"),
                      "model": args.model, "shards": args.shards,
                      "ring": args.ring,
                      "fill_ms": args.fill_ms,
                      "pmux_service": (pmux_service
                                       if daemon.published
                                       else None),
                      "primed": primed, "trace": args.trace}),
          flush=True)
    daemon.run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
