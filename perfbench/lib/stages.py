"""The stage readers' view of the program's spans: the stretches of the
window that spans of some names cover, and where they meet others.

``make_segments`` and ``remap_slots`` run twice for an INVALID history:
in the check (``linear.segments``, host ingest) and again in its
counterexample (inside ``linear.decode``, the verdict). The host-ingest
readers count their spans outside ``linear.decode``, and the verdict's
counterexample reader counts them inside it, so that each stage's time
falls in the layer that runs it.
"""

from __future__ import annotations

#: the span whose ``segments.*`` children are the counterexample's
DECODE = ("linear.decode",)
SEGMENTS = ("segments.make", "segments.remap")


def cover(ctx, names) -> list:
    """The stretches of ``[w0, w1]`` that the spans of these names cover,
    in order, apart from each other (nested ones merged)."""
    out: list = []
    for a, b in sorted((max(a, ctx.w0), min(b, ctx.w1))
                       for n, a, b in ctx.spans if n in names):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def meet(xs, ys) -> list:
    """The stretches that two covers (from :func:`cover`) share."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if a < b:
            out.append([a, b])
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def seconds(stretches) -> float:
    return sum(b - a for a, b in stretches)


def outside_decode(ctx, names) -> float:
    """Seconds of the window that these spans cover outside
    ``linear.decode``: host ingest's share of a stage."""
    have = cover(ctx, names)
    return seconds(have) - seconds(meet(have, cover(ctx, DECODE)))
