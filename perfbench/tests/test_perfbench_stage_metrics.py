"""The readers of the stage metrics on a made-up window: each counts the
union of its spans' seconds inside the window, and nothing without a
span; the segments' spans inside ``linear.decode`` are the
counterexample's, not host ingest's; ``counterexample_s_per_invalid``
divides by the INVALID answers alone."""

import pytest

from conftest import ROOT
from perfbench.lib import cells
from perfbench.lib.harness import Call, Context, answer

#: reader -> the spans it reads
PER_KOP = {"pack_ms_per_kop": ("ops.pack",),
           "segments_ms_per_kop": ("segments.make",),
           "remap_ms_per_kop": ("segments.remap",),
           "gc_ms_per_kop": ("gc.young", "gc.full")}
W0, W1 = 100.0, 110.0


def _read(metric, spans, answers=((True, None),), error=None):
    calls = [Call(i, W0 + i, W0 + i + 1, ops=1000,
                  answers={(i,): None if a is None else answer(*a)},
                  error=error if i == 0 else None)
             for i, a in enumerate(answers)]
    ctx = Context(None, calls, W0, W1, 0.0, list(spans), None, None, {},
                  None)
    return cells.load_module(ROOT, "metrics", metric).read(ctx)


def _spans(names, pairs):
    """One span per (t0, t1), the names taken in turn."""
    return [(names[i % len(names)], W0 + a, W0 + b)
            for i, (a, b) in enumerate(pairs)]


@pytest.mark.parametrize("metric", sorted(PER_KOP))
def test_nested_and_overlapping_spans_count_once(metric):
    spans = _spans(PER_KOP[metric], [(1, 3), (2, 4), (2.5, 2.7), (6, 7)])
    spans.append(("linear.pack", W0, W1))           # another span's name
    assert _read(metric, spans) == pytest.approx(4.0 * 1e3)


@pytest.mark.parametrize("metric", sorted(PER_KOP))
def test_spans_outside_the_window_are_clipped(metric):
    spans = _spans(PER_KOP[metric], [(-2, 1), (9, 12), (-5, -1),
                                     (11, 12)])
    assert _read(metric, spans) == pytest.approx(2.0 * 1e3)


@pytest.mark.parametrize("metric",
                         sorted(PER_KOP) + ["counterexample_s_per_invalid"])
def test_no_span_reads_none(metric):
    assert _read(metric, [("linear.segments", W0, W1)],
                 answers=((False, 3, [], []),)) is None


CE = ("counterexample.rescan", "counterexample.replay",
      "counterexample.paths")


def test_counterexample_reads_none_without_an_invalid_answer():
    spans = _spans(CE, [(1, 2), (3, 4)])
    assert _read("counterexample_s_per_invalid", spans,
                 answers=((True, None), ("unknown", 5), None)) is None


def test_counterexample_divides_by_the_invalid_answers_alone():
    """Nested stages once and the last clipped (5 s in all), over the two
    INVALID answers of the calls that returned: not the VALID one, the
    one with no answer, or the failed call's."""
    spans = _spans(CE, [(1, 3), (2, 2.5), (5, 7), (9, 11)])
    got = _read("counterexample_s_per_invalid", spans,
                answers=((False, 1, [], []), (True, None),
                         (False, 2, [], []), None, (False, 4, [], [])),
                error="RuntimeError: lost")
    assert got == pytest.approx(5.0 / 2)


@pytest.mark.parametrize("metric,name", [
    ("segments_ms_per_kop", "segments.make"),
    ("remap_ms_per_kop", "segments.remap")])
def test_host_ingest_leaves_out_the_counterexamples_segments(metric, name):
    """2 s in the check, and 1.5 s of the 2.5 s in the second span inside
    ``linear.decode`` (one INVALID call's counterexample)."""
    spans = [(name, W0 + 1, W0 + 3), (name, W0 + 4, W0 + 6.5),
             ("linear.decode", W0 + 5, W0 + 8)]
    assert _read(metric, spans) == pytest.approx(3.0 * 1e3)
    assert _read(metric, [(name, W0 + 5, W0 + 6),
                          ("linear.decode", W0 + 4, W0 + 7)]) is None


def test_counterexample_counts_its_own_segments_once():
    """In ``linear.decode`` (4–9 s): the re-segmenting 4.5–6.5 s, a
    ``gc.full`` inside it (no matter), the re-scan 6.5–7.5 s, and a
    replay 7–8 s overlapping it: 3.5 s. The check's segments, outside
    the decode, do not count."""
    spans = [("segments.make", W0 + 1, W0 + 2),
             ("segments.remap", W0 + 2, W0 + 3),
             ("linear.decode", W0 + 4, W0 + 9),
             ("segments.make", W0 + 4.5, W0 + 5),
             ("segments.remap", W0 + 5, W0 + 6.5),
             ("gc.full", W0 + 5.5, W0 + 6),
             ("counterexample.rescan", W0 + 6.5, W0 + 7.5),
             ("counterexample.replay", W0 + 7, W0 + 8)]
    got = _read("counterexample_s_per_invalid", spans,
                answers=((False, 1, [], []),))
    assert got == pytest.approx(3.5)
