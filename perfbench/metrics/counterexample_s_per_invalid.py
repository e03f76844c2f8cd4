"""``counterexample_s_per_invalid``: the verdict layer's counterexample,
the seconds the window spent in the program's ``counterexample.rescan``,
``.replay`` and ``.paths`` spans and in the counterexample's own
re-segmenting (the ``segments.make`` and ``segments.remap`` spans inside
``linear.decode``), nested ones once, over the INVALID answers the
window's calls gave; None without one. Per INVALID answer, so that it
reads the same whatever share of the window's calls met an INVALID
history."""

from perfbench.lib import stages

SPANS = ("counterexample.rescan", "counterexample.replay",
         "counterexample.paths")


def read(ctx):
    invalid = sum(1 for c in ctx.calls if c.error is None
                  for a in c.answers.values()
                  if a is not None and a[0] is False)
    ce = stages.cover(ctx, SPANS)
    segs = stages.meet(stages.cover(ctx, stages.SEGMENTS),
                       stages.cover(ctx, stages.DECODE))
    s = (stages.seconds(ce) + stages.seconds(segs)
         - stages.seconds(stages.meet(ce, segs)))
    return s / invalid if s > 0 and invalid else None
