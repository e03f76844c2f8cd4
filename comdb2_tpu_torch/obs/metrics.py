"""Metrics registry — counters, gauges, fixed-bucket histograms.

The histogram is the load-bearing type: fixed exponential bucket
edges mean p50/p95/p99 are derivable from ~16 integers per series
(cumulative walk + linear interpolation inside the landing bucket) —
no sample storage, so a daemon serving millions of requests carries
O(metrics) memory, not O(requests). The quantile error is bounded by
the landing bucket's width; the golden test
(``tests/test_obs.py``) pins the math against exact samples.

Two render forms, both served by the verifier daemon's
``kind:"metrics"`` request (docs/service.md) and snapshotted into the
store web status:

- :meth:`Registry.snapshot` — nested JSON (``{name: {type, series:
  [{labels, ...values}]}}``), the programmatic form benches and tests
  consume;
- :meth:`Registry.render_prometheus` — the Prometheus text exposition
  format (``name_bucket{le="..."} N`` cumulative histograms,
  ``_sum``/``_count``, ``# TYPE`` headers) for scrapers.

Stdlib only; single-threaded by design (one CPU, one tick loop — no
locks). Metric names are documented in docs/observability.md.
"""

from __future__ import annotations

from bisect import bisect_left
from typing import Dict, List, Optional, Tuple

#: default latency edges (milliseconds): exponential-ish 1 ms – 60 s,
#: sized for the serving path (a 100 ms dispatch lands mid-table;
#: a 5.5 s overloaded p99 is still resolved, not clamped)
DEFAULT_MS_BUCKETS: Tuple[float, ...] = (
    1.0, 2.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 10000.0, 30000.0, 60000.0)


class Counter:
    """Monotonic count. ``value`` is assignable so process-global
    module counters (compile counters, ``VerifierCore.m``) can be
    mirrored into the registry at scrape time."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n=1) -> None:
        self.value += n

    def snapshot(self) -> dict:
        return {"value": self.value}


class Gauge:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v) -> None:
        self.value = v

    def snapshot(self) -> dict:
        return {"value": self.value}


class Histogram:
    """Fixed-bucket histogram; quantiles by cumulative walk + linear
    interpolation within the landing bucket (error <= bucket width).
    ``counts[i]`` holds observations <= ``edges[i]``; the final slot
    is the +Inf overflow bucket."""

    __slots__ = ("edges", "counts", "sum", "count")

    def __init__(self, buckets=DEFAULT_MS_BUCKETS):
        self.edges: Tuple[float, ...] = tuple(sorted(buckets))
        self.counts: List[int] = [0] * (len(self.edges) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.counts[bisect_left(self.edges, v)] += 1
        self.sum += v
        self.count += 1

    def quantile(self, q: float) -> float:
        if not self.count:
            return 0.0
        target = max(q, 0.0) * self.count
        cum, lo = 0, 0.0
        for i, edge in enumerate(self.edges):
            c = self.counts[i]
            if c and cum + c >= target:
                frac = min(max((target - cum) / c, 0.0), 1.0)
                return lo + (edge - lo) * frac
            cum += c
            lo = edge
        # landed in the +Inf overflow bucket: clamp to the last finite
        # edge — an honest "at least this much", never a fabrication
        return self.edges[-1]

    def snapshot(self) -> dict:
        cum, buckets = 0, []
        for edge, c in zip(self.edges, self.counts):
            cum += c
            buckets.append([edge, cum])
        buckets.append(["+Inf", cum + self.counts[-1]])
        return {"count": self.count, "sum": round(self.sum, 3),
                "p50": round(self.quantile(0.50), 3),
                "p95": round(self.quantile(0.95), 3),
                "p99": round(self.quantile(0.99), 3),
                "buckets": buckets}


class _Family:
    __slots__ = ("typ", "help", "series")

    def __init__(self, typ: str, help_: str):
        self.typ = typ
        self.help = help_
        self.series: Dict[tuple, object] = {}


class Registry:
    """Name -> metric family -> labeled series. Get-or-create API so
    instrumented call sites never pre-register."""

    def __init__(self) -> None:
        self._families: Dict[str, _Family] = {}

    def _series(self, name: str, typ: str, help_: str, labels: dict,
                make):
        fam = self._families.get(name)
        if fam is None:
            fam = self._families[name] = _Family(typ, help_)
        elif fam.typ != typ:
            raise ValueError(
                f"metric {name!r} is a {fam.typ}, not a {typ}")
        key = tuple(sorted(labels.items()))
        obj = fam.series.get(key)
        if obj is None:
            obj = fam.series[key] = make()
        return obj

    def counter(self, name: str, help: str = "",
                **labels) -> Counter:
        return self._series(name, "counter", help, labels, Counter)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._series(name, "gauge", help, labels, Gauge)

    def histogram(self, name: str, help: str = "",
                  buckets=DEFAULT_MS_BUCKETS, **labels) -> Histogram:
        return self._series(name, "histogram", help, labels,
                            lambda: Histogram(buckets))

    # -- render --------------------------------------------------------

    def snapshot(self) -> dict:
        out = {}
        for name in sorted(self._families):
            fam = self._families[name]
            out[name] = {
                "type": fam.typ,
                "series": [{"labels": dict(k), **obj.snapshot()}
                           for k, obj in sorted(fam.series.items())],
            }
        return out

    def render_prometheus(self) -> str:
        lines: List[str] = []
        for name in sorted(self._families):
            fam = self._families[name]
            if fam.help:
                lines.append(f"# HELP {name} {fam.help}")
            lines.append(f"# TYPE {name} {fam.typ}")
            for key, obj in sorted(fam.series.items()):
                base = _labels(dict(key))
                if fam.typ == "histogram":
                    cum = 0
                    for edge, c in zip(obj.edges, obj.counts):
                        cum += c
                        lines.append(
                            f"{name}_bucket"
                            f"{_labels(dict(key), le=_le(edge))} "
                            f"{cum}")
                    lines.append(
                        f"{name}_bucket"
                        f"{_labels(dict(key), le='+Inf')} "
                        f"{cum + obj.counts[-1]}")
                    lines.append(f"{name}_sum{base} "
                                 f"{_num(obj.sum)}")
                    lines.append(f"{name}_count{base} {obj.count}")
                else:
                    lines.append(f"{name}{base} {_num(obj.value)}")
        return "\n".join(lines) + "\n"


def _le(edge: float) -> str:
    return str(int(edge)) if float(edge).is_integer() else str(edge)


def _num(v) -> str:
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return str(v)


def _labels(labels: dict, **extra) -> str:
    labels = {**labels, **extra}
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


__all__ = ["Counter", "DEFAULT_MS_BUCKETS", "Gauge", "Histogram",
           "Registry"]
