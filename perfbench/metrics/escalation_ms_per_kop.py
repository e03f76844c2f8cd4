"""``escalation_ms_per_kop``: the escalation engines, the seconds the
window spent in the program's ``linear.device`` spans outside their
children ``linear.segments``, ``linear.kernel`` and ``linear.decode``
(nested ones counted once): the engines that take over when the
kernel's frontier overflows (the seg2 ladder, the MXU frontier), in ms
per thousand operations checked."""

from perfbench.lib import stages

CHILDREN = ("linear.segments", "linear.kernel", "linear.decode")


def read(ctx):
    device = stages.cover(ctx, ("linear.device",))
    s = stages.seconds(device) - stages.seconds(
        stages.meet(device, stages.cover(ctx, CHILDREN)))
    return s * 1e3 / ctx.kops if s > 0 and ctx.kops else None
