"""Share of the time inside candidate scoring in which no kernel, copy or
memset ran on the card: the idle gaps inside the ``beam.score`` spans'
annotations in the profiled window (torch.profiler), over the
annotations' extent."""
from perfbench import spans


def read(ctx):
    return spans.idle_pct_inside(ctx.traced.profile, "beam.score")
