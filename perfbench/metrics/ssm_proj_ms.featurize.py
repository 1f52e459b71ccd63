"""Milliseconds of the card's time in the SSD mixer's projections a
batch: the ``ssm.in`` (input projection, conv, dt) and ``ssm.out`` (gated
norm, output projection) spans' device time (CUDA events) summed over
the window's ``featurize.batch`` spans, in the window with spans on."""
from perfbench import spans


def read(ctx):
    return spans.dev_ms_per(ctx.main, ("ssm.in", "ssm.out"),
                            "featurize.batch")
