"""One run of one cell: set-up, the measured window, the check against
the plain reference, the result line.

The window runs the cell's calls back to back, one caller, each call
whole and synchronised; it ends with the last call that started before
``--seconds`` ran out, and not before the caller's ``least_calls`` (a
pool's every input once), so the window's time is the calls' time.
``--trace 0`` reports the cell's end-to-end metrics; ``--trace 1`` turns
on the program's spans, CUDA events around its kernel launches and
``torch.profiler``, and reports the per-layer metrics instead.

A traffic file with ``whole_passes`` ends the window on a whole pass over
the pool, so that every run checks the same inputs as often, however
fast its host.

The spans and the CUDA events cover the whole window, and their readers
read the window alone. The device trace (``torch.profiler``) covers the
slice: the whole window where the traffic file gives no ``trace_calls``;
else ``trace_calls`` more calls made once the window has closed, from
the call that ``trace_start`` names (``"mutated"``: the pool's first
call whose input is mutated), so that the profiler slows no call of the
window. The readers of the device trace read the slice alone, its time
``[t0, t1]``, what its calls' inputs need and the launches noted in it.
The slice's calls are judged with the window's.

After the window, with the peak of device memory read and the program's
state freed, the plain reference checks the answers: every answer of a
sampled set of inputs (all of them in a traced run), drawn from the
seed, every INVALID input the window checked among them. A call that
raised, an answer that differs from the reference (an unknown one
included), an INVALID answer whose counterexample the reference does
not bear out, or a sample with no INVALID answer makes ``correct``
false.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from perfbench.reference.linear import report_faults

from . import cells, devtrace

#: top-level modules that may not be loaded in a run: JAX and the JAX
#: package that the port was made from (names compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "comdb2_tpu")

#: the numbers that decide ``correct``: name -> (comparison, limit)
LIMITS = {"failed_calls": ("<=", 0), "mismatched": ("<=", 0),
          "counterexample_wrong": ("<=", 0), "invalid_compared": (">=", 1)}


@dataclass
class Call:
    """One call of the window: its times on the monotonic clock, the
    operations it checked, and its answers by unit (a history, or a
    test), each as :func:`answer` gives it."""
    index: int
    t0: float
    t1: float
    ops: int = 0
    answers: Dict[object, tuple] = field(default_factory=dict)
    error: Optional[str] = None


@dataclass
class Slice:
    """What the device trace covers: its calls, from ``t0`` to ``t1``."""
    calls: List[Call]
    t0: float
    t1: float


@dataclass
class Context:
    """What a metric's reader reads."""
    cell: cells.Cell
    calls: List[Call]
    w0: float
    w1: float
    setup_s: float
    spans: list                          # (name, t0, t1), monotonic
    trace: Optional[devtrace.Trace]      # the slice's device ops
    card_ms: Optional[float]             # the window's
    need: Dict[str, tuple]               # launch kind -> (ops, bytes),
                                         # of the slice's calls
    peaks: object
    slice: Optional[Slice] = None        # set in a traced run

    @property
    def window_s(self) -> float:
        return self.w1 - self.w0

    @property
    def slice_s(self) -> float:
        return self.slice.t1 - self.slice.t0

    @property
    def busy_s(self) -> Optional[float]:
        """Seconds of the slice in which some device op ran; None
        without a trace."""
        if self.trace is None:
            return None
        return self.trace.busy_s(self.slice.t0, self.slice.t1)

    @property
    def kops(self) -> float:
        return sum(c.ops for c in self.calls if c.error is None) / 1e3

    def span_seconds(self, names) -> float:
        """Seconds in the window covered by the program's spans of these
        names (nested ones counted once)."""
        return devtrace.union_seconds(
            [(max(a, self.w0), min(b, self.w1))
             for n, a, b in self.spans if n in names])

    def device_seconds(self, pick) -> Optional[float]:
        """Seconds of the device ops ``pick`` selects, from the trace;
        None without a trace or with none selected."""
        if self.trace is None:
            return None
        sel = [(o.t0, o.t1) for o in self.trace.ops if pick(o)]
        return devtrace.union_seconds(sel) if sel else None


def forbidden_modules() -> List[str]:
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(root: str, t_start: float, argv=None) -> int:
    args = parse(argv)
    cell = cells.load(root, args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA "
              f"card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      device="cuda", t_start=t_start)
    leaked = forbidden_modules()
    if leaked:
        print(f"perfbench: the run loaded {', '.join(leaked)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} {c['op']} {c['limit']}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


def run_cell(cell: cells.Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None) -> dict:
    """Run ``cell`` once; the result line as a dict. ``device="cpu"``
    runs the program on CPU tensors (the kernels as their plain
    versions), for the tests."""
    t_start = time.monotonic() if t_start is None else t_start
    cuda = device == "cuda"
    caller = cell.caller().Caller(cell, seed, device)
    phases = {}
    with ThreadPoolExecutor(1) as ex:      # the pool is made meanwhile
        made = ex.submit(caller.make_pool)
        import torch

        if cuda:
            torch.cuda.init()
            torch.zeros(1, device=device)
        phases["torch_and_context"] = time.monotonic() - t_start
        made.result()
    phases["pool"] = time.monotonic() - t_start
    caller.setup()
    if cuda:
        torch.cuda.synchronize()
    phases["inputs_and_warm_up"] = time.monotonic() - t_start
    print("perfbench: set-up " + ", ".join(
        f"{k} by {v:.3f} s" for k, v in phases.items()), file=sys.stderr)
    traffic = cell.traffic
    least = max(getattr(caller, "least_calls", 1), 1)
    trace_calls = traffic.get("trace_calls")
    instr = _Instruments(cuda) if trace else None
    if instr:
        instr.start()
        if trace_calls is None:
            instr.profile()
    w0 = time.monotonic()
    cpu0 = time.process_time()
    setup_s = w0 - t_start
    calls: List[Call] = []
    deadline = w0 + seconds
    whole = bool(traffic.get("whole_passes"))
    while len(calls) < least or calls[-1].t1 < deadline or \
            (whole and len(calls) % least):
        calls.append(_call(caller, len(calls), cuda))
    w1 = calls[-1].t1
    took = sorted(c.t1 - c.t0 for c in calls)
    print(f"perfbench: window {w1 - w0:.3f} s, this process's CPU "
          f"{time.process_time() - cpu0:.3f} s, {len(calls)} calls of "
          f"{took[0]:.4f} / {took[len(took) // 2]:.4f} / {took[-1]:.4f} s "
          "(least / median / most)", file=sys.stderr)
    sl = None
    if instr:
        instr.close_window()
        if trace_calls is None:
            instr.unprofile()
            sl = Slice(calls, w0, w1)
        else:
            j0 = slice_start(caller, traffic.get("trace_start", 0))
            instr.profile()
            s0 = time.monotonic()
            done = [_call(caller, j0 + k, cuda) for k in range(trace_calls)]
            instr.unprofile()
            sl = Slice(done, s0, done[-1].t1)
        spans, tr = instr.stop()
        print(f"perfbench: device trace of {len(sl.calls)} calls over "
              f"{sl.t1 - sl.t0:.3f} s, stopped in {instr.stop_s:.3f} s, "
              f"read in {instr.read_s:.3f} s", file=sys.stderr)
    every = calls + (sl.calls if sl and sl.calls is not calls else [])
    leaked = forbidden_modules()
    if leaked:
        raise RuntimeError(f"the window loaded {', '.join(leaked)}")
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": (torch.cuda.max_memory_allocated(0)
                                 if cuda else 0)}
    caller.release()
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.monotonic()
    checks, truth = check_answers(caller, every, seed, full=trace)
    print(f"perfbench: the reference checked {len(truth)} inputs in "
          f"{time.monotonic() - t_ref:.3f} s", file=sys.stderr)
    result = {"correct": all(holds(c) for c in checks.values()),
              "attempted": len(every),
              "failed": sum(1 for c in every if c.error is not None),
              "metrics": {}, "device": dev}
    ctx = Context(cell, calls, w0, w1, setup_s, [], None, None, {}, None)
    if trace:
        ctx.trace, ctx.card_ms, ctx.slice = tr, instr.card, sl
        ctx.spans = spans + [("perfbench.call", c.t0, c.t1) for c in every]
        unit_need, needs = getattr(caller, "need", None), {}
        for c in sl.calls if unit_need else ():
            for u in c.answers:
                if u not in needs:
                    needs[u] = unit_need(u)
                for kind, (o, b) in needs[u].items():
                    o0, b0 = ctx.need.get(kind, (0, 0))
                    ctx.need[kind] = (o0 + o, b0 + b)
        if cuda:
            from . import peaks as _peaks

            ctx.peaks = _peaks.read(0)
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = cell.reader(m["name"]).read(ctx)
        if v is not None:
            result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
    if trace:
        dev["busy_s"] = ctx.busy_s
        dev["window_s"] = ctx.slice_s
        dev["trace_calls"] = len(sl.calls)
        dev["trace_device_ops"] = len(tr.ops)
        dev["trace_stop_s"] = instr.stop_s
        dev["trace_read_s"] = instr.read_s
        result["breakdown"] = breakdown(ctx)
    if cuda:
        from . import peaks as _peaks

        dev["power_limit_w"] = _peaks.power_limit_w()
    result["checks"] = checks
    return result


def _call(caller, j: int, cuda: bool) -> Call:
    """Call ``j`` of the caller, whole and synchronised; one that raises
    is counted as failed."""
    call = Call(j, time.monotonic(), 0.0)
    try:
        call.ops, call.answers = caller.call(j)
    except Exception as e:
        call.error = f"{type(e).__name__}: {e}"
        print(f"perfbench: call {j}: {call.error}", file=sys.stderr)
    if cuda:
        import torch

        torch.cuda.synchronize()
    call.t1 = time.monotonic()
    return call


def slice_start(caller, start) -> int:
    """The index of the slice's first call: ``start`` itself, or for
    ``"mutated"`` the first call of a pass whose input is mutated."""
    if start == "mutated":
        return next(j for j in range(max(caller.least_calls, 1))
                    if any(caller.mutated(u) for u in caller.units(j)))
    return int(start)


def answer(valid, op_index, configs=None, paths=None) -> tuple:
    """A program's answer as the judge compares it: ``(True, None,
    None)``, ``(False, index, (configs, paths))`` with the report of the
    counterexample, or the unknown verdict with its index."""
    if valid is True:
        return (True, None, None)
    if valid is False:
        return (False, op_index, (list(configs or ()), list(paths or ())))
    return (valid, op_index, None)


def holds(c: dict) -> bool:
    return (c["value"] <= c["limit"] if c["op"] == "<="
            else c["value"] >= c["limit"])


def check_answers(caller, calls: List[Call], seed: int, full: bool):
    """The reference's verdicts on the units ``caller`` samples from the
    calls' answers (all of them when ``full``), drawn from the seed, and
    :func:`judge`'s numbers. Returns ``(checks, truth)``."""
    rng = random.Random(seed ^ 0x5EED)
    truth = {u: caller.truth(u) for u in caller.sample(calls, rng, full)}
    return judge(calls, truth), truth


def judge(calls: List[Call], truth: dict) -> dict:
    """Each call's answers on the sampled units against the reference's
    verdict and index, and each INVALID one's counterexample against the
    reference's frontier where the search died
    (:func:`perfbench.reference.linear.report_faults`); the numbers that
    decide ``correct``. A call answers every unit of its input, None
    where the program gave no answer."""
    mismatched = invalid = wrong = 0
    for c in calls:
        for u, got in c.answers.items():
            v = truth.get(u)
            if v is None:
                continue
            want = (True, None) if v.valid else (False, v.op_index)
            if got is None or tuple(got[:2]) != want:
                mismatched += 1
            elif not v.valid:
                invalid += 1
                faults = report_faults(v, *got[2])
                if faults:
                    wrong += 1
                    print(f"perfbench: call {c.index}, {u}: "
                          + "; ".join(faults), file=sys.stderr)
    values = {"failed_calls": sum(1 for c in calls if c.error is not None),
              "mismatched": mismatched, "counterexample_wrong": wrong,
              "invalid_compared": invalid}
    return {n: {"value": values[n], "op": op, "limit": lim}
            for n, (op, lim) in LIMITS.items()}


class _Instruments:
    """The traced run's instruments: the program's spans and CUDA events
    around its kernel launches, from :meth:`start` to :meth:`stop`; over
    the slice, from :meth:`profile` to :meth:`unprofile`,
    ``torch.profiler`` and the kind of each launch as its wrapper names
    it."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.prof = devtrace.Profiler()
        self.launches: List[str] = []
        self.card: Optional[float] = None
        self.stop_s = self.read_s = 0.0

    def start(self) -> None:
        from comdb2_tpu_torch.obs import trace as obs
        from comdb2_tpu_torch.utils import compile_guard

        obs.clear()
        obs.enable()
        if self.cuda:
            compile_guard.time_launches(True)
            self.card0 = compile_guard.card_ms()
        self._note = compile_guard.note_launch

    def profile(self) -> None:
        from comdb2_tpu_torch.utils import compile_guard

        def noted(kernel, *a, **kw):
            self.launches.append(kernel)
            return self._note(kernel, *a, **kw)

        compile_guard.note_launch = noted
        self.prof.start()

    def unprofile(self) -> None:
        from comdb2_tpu_torch.utils import compile_guard

        t = time.monotonic()
        self.prof.stop()
        self.stop_s = time.monotonic() - t
        compile_guard.note_launch = self._note

    def close_window(self) -> None:
        """The window's card ms, read as it closes."""
        from comdb2_tpu_torch.utils import compile_guard

        if self.cuda:
            self.card = compile_guard.card_ms() - self.card0

    def stop(self):
        """The spans, and the slice's device trace with its launches
        named."""
        from comdb2_tpu_torch.obs import trace as obs
        from comdb2_tpu_torch.utils import compile_guard

        t = time.monotonic()
        tr = self.prof.read()
        self.read_s = time.monotonic() - t
        tr.name_launches(self.launches)
        if self.cuda:
            compile_guard.time_launches(False)
        obs.disable()
        spans = [(s.name, s.t0, s.t1) for s in obs.spans()
                 if s.t1 is not None]
        obs.clear()
        return spans, tr


def breakdown(ctx: Context, top: int = 10) -> dict:
    """The device ops that took the most time in the slice, by name,
    and the card's idle time there by what the host was doing: each
    idle stretch split over the innermost spans open in it
    (``perfbench.call`` where the program opened none)."""
    tr, t0, t1 = ctx.trace, ctx.slice.t0, ctx.slice.t1
    by_op: Dict[str, float] = {}
    for o in tr.ops:
        a, b = max(o.t0, t0), min(o.t1, t1)
        if b > a:
            by_op[o.name] = by_op.get(o.name, 0.0) + (b - a)
    spans = ctx.spans
    pts = [(t, kind, i) for i, (_, a, b) in enumerate(spans)
           for t, kind in ((a, 1), (b, 0))]
    pts += [(t, kind, -1) for a, b in tr.gaps(t0, t1)
            for t, kind in ((a, 2), (b, 3))]
    by_span: Dict[str, float] = {}
    active: List[int] = []          # open spans, the innermost last
    idle, last = False, None
    for t, kind, i in sorted(pts):
        if idle and last is not None and t > last:
            name = spans[active[-1]][0] if active else "between calls"
            by_span[name] = by_span.get(name, 0.0) + (t - last)
        last = t
        if kind == 1:
            active.append(i)
        elif kind == 0:
            active.remove(i)
        else:
            idle = kind == 2

    def ranked(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                ][:top]

    return {"device_ops": ranked(by_op), "idle_gaps": ranked(by_span)}
